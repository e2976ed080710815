// All-pairs popcount statistics and row weights on packed binary sketches.
//
// pair_stats replaces the TPU kernel repro/kernels/hamming/kernel.py:
// pair_stats (body _pair_stats_kernel):
//     inner[i, j]   = sum_w popc(a[i, w] & b[j, w])
//     hamming[i, j] = sum_w popc(a[i, w] ^ b[j, w])
// each switchable.  The TPU has no popcount unit and runs a SWAR popcount
// over (BM, BN, BK) broadcasts on its vector unit; Hopper has __popc.
//
// Bound on the H100: operations, the popcount rate.  An (M, N) product
// over W words is M*N*W popcounts (per output switched on) against
// (M + N)*W*4 bytes read and M*N*4 bytes written per output, so for M and
// N above a few dozen rows the popcounts dominate.  The design stages a
// 64-row tile of A and of B, 32 words deep, in shared memory and gives
// each of 256 threads a 4x4 block of outputs: each staged word is read
// from device memory once per tile and reused 64 times from shared memory,
// and the (i, j) layout of the tile (rows ty + 16*r, columns tx + 16*c)
// keeps the shared-memory reads free of bank conflicts.
//
// row_popcount replaces repro/kernels/hamming/kernel.py: row_popcount
// (body row_popcount_kernel): the Hamming weight of each packed row.
// Bound on the H100: bytes (M*W*4 read, M*4 written).  One warp owns one
// row, reads it in coalesced 128-byte steps, and sums with shuffles.
#include "common.cuh"

namespace {

constexpr int kTile = 64;   // output rows and columns per block
constexpr int kDepth = 32;  // words staged per step
constexpr int kSide = 16;   // threads per block side; each owns 4x4 outputs

template <bool kInner, bool kHam>
__global__ void pair_stats_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  int32_t* __restrict__ inner,
                                  int32_t* __restrict__ ham, int m, int n, int w) {
  __shared__ uint32_t as[kTile][kDepth + 1];
  __shared__ uint32_t bs[kTile][kDepth + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  int acc_in[4][4] = {};
  int acc_ham[4][4] = {};

  for (int k0 = 0; k0 < w; k0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kSide * kSide) {
      const int r = e / kDepth, c = e % kDepth;
      const int kw = k0 + c;
      as[r][c] = (i0 + r < m && kw < w) ? a[static_cast<size_t>(i0 + r) * w + kw] : 0u;
      bs[r][c] = (j0 + r < n && kw < w) ? b[static_cast<size_t>(j0 + r) * w + kw] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kDepth; ++c) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[ty + kSide * r][c];
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = bs[tx + kSide * s][c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (kInner) acc_in[r][s] += __popc(av[r] & bv[s]);
          if (kHam) acc_ham[r][s] += __popc(av[r] ^ bv[s]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + kSide * r;
    if (i >= m) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + kSide * s;
      if (j >= n) continue;
      const size_t o = static_cast<size_t>(i) * n + j;
      if (kInner) inner[o] = acc_in[r][s];
      if (kHam) ham[o] = acc_ham[r][s];
    }
  }
}

__global__ void row_popcount_kernel(const uint32_t* __restrict__ x,
                                    int32_t* __restrict__ out, int rows, int w) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const uint32_t* r = x + row * w;
  int c = 0;
  for (int i = lane; i < w; i += 32) c += __popc(r[i]);
  c = repro::warp_sum(c);
  if (lane == 0) out[row] = c;
}

}  // namespace

// a: (m, w), b: (n, w) int32; inner / ham: (m, n) int32 or null when off.
REPRO_EXPORT int pair_stats_launch(const void* a, const void* b, void* inner,
                                   void* ham, int m, int n, int w, void* stream) {
  const dim3 block(kSide, kSide);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* pi = static_cast<int32_t*>(inner);
  auto* ph = static_cast<int32_t*>(ham);
  if (m > 0 && n > 0) {
    if (pi && ph) pair_stats_kernel<true, true><<<grid, block, 0, s>>>(pa, pb, pi, ph, m, n, w);
    else if (pi) pair_stats_kernel<true, false><<<grid, block, 0, s>>>(pa, pb, pi, ph, m, n, w);
    else if (ph) pair_stats_kernel<false, true><<<grid, block, 0, s>>>(pa, pb, pi, ph, m, n, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, w) int32; out: (rows,) int32.
REPRO_EXPORT int row_popcount_launch(const void* x, void* out, int rows, int w,
                                     void* stream) {
  constexpr int kThreads = 256;  // 8 rows per block
  if (rows > 0) {
    const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    row_popcount_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<int32_t*>(out), rows, w);
  }
  return static_cast<int>(cudaGetLastError());
}
