// All-pairs popcount statistics and row weights on packed binary sketches.
//
// pair_stats replaces the TPU kernel repro/kernels/hamming/kernel.py:
// pair_stats (body _pair_stats_kernel):
//     inner[i, j]   = sum_w popc(a[i, w] & b[j, w])
//     hamming[i, j] = sum_w popc(a[i, w] ^ b[j, w])
// each switchable.  The TPU has no popcount unit and runs a SWAR popcount
// over (BM, BN, BK) broadcasts on its vector unit.
//
// Bound on the H100: operations on the int8 tensor cores.  Each word of a
// row is the 32 k-bytes of one k32 product step, a bit as a 0/1 byte
// (below), so inner is an exact s32 product: 2 * 32 * M * N * W
// int8 operations at 1,979 TOP/s, against (M + N) * W * 4 bytes read and
// M * N * 4 written per output.  hamming = wa + wb - 2 * inner, with each
// row's weight popcounted once per block from the staged words.  A sum is
// at most 32 * W, far inside s32.
//
// The design.  The rows of b (the store, N large) are the product's M side
// and the rows of a (the queries, M small) its N side, so that a few dozen
// queries still fill the instruction.  A block owns BR = 256 rows of b x
// BQ = 64 rows of a and runs two warpgroups; each computes two 64 x 64
// tiles with wgmma m64n64k32, its 128 rows on M.  Packed words are staged
// 16 deep in shared memory, double buffered with cp.async (16-byte copies
// where W is a multiple of 4 and rows start on 16 bytes, 4-byte ones
// otherwise), into rows of 80 bytes, so that the 8 rows a warp reads in
// one load fall in 8 different banks.  Per stage the block unpacks its 64
// query rows once into 0/1 bytes in shared memory, laid out as wgmma's
// K-major B operand (8-query x 16-byte core matrices), which wgmma reads
// itself; each warp builds its A fragments from the packed row words (a
// shift and a mask a register) and hands them to wgmma in registers, two
// words (four products) at a time.  The output tile goes out through
// shared memory, so that the (a row, b row)-major int32 stores are
// 16-byte and coalesced where N is a multiple of 4.
//
// row_popcount replaces repro/kernels/hamming/kernel.py: row_popcount
// (body row_popcount_kernel): the Hamming weight of each packed row.
// Bound on the H100: bytes (M*W*4 read, M*4 written).  One warp owns one
// row, reads it in coalesced 128-byte steps, and sums with shuffles.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

// Packed bits on the int8 tensor cores.  popc(a & b) over one 32-bit
// word is the s32 sum of a k32 product step whose 32 k-bytes hold the
// word's bits as 0 or 1, when both operands map bits to bytes alike.  The
// map (the same as topk_select.cu's): byte 4t + i of the step is bit t + 8i
// (t, i < 4) and byte 16 + 4t + i is bit t + 4 + 8i.  Then the four bytes
// 4r .. 4r + 3 of a word (r < 8) are one register, bit_bytes(x, r), and a
// lane (grp = lane / 4, tig = lane % 4) of a warp holds, for rows grp and
// grp + 8 of its 16, registers tig (k-bytes 4 tig ..) and tig + 4 (k-bytes
// 16 + 4 tig ..) of their words: the A operand layout of mma.m16n8k32 and,
// per warp, of wgmma's k32 A from registers.
namespace {

constexpr uint32_t kByteOnes = 0x01010101u;

// k-bytes 4r .. 4r + 3 of word x under the map above: bits r, r + 8,
// r + 16, r + 24 as bytes 0 or 1
__device__ __forceinline__ uint32_t bit_bytes(uint32_t x, int r) {
  return (x >> r) & kByteOnes;
}

// V words global -> shared (V = 1 or 4), zero-filled when !full
template <int V>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warpgroup products (wgmma, sm_90a): four warps together compute a 64-row
// x 64-column s32 tile += A (64 x 32 bytes) * B (32 x 64 bytes).  Each warp
// holds A for its 16 rows in registers, in the mma.m16n8k32 layout above;
// B is read from shared memory through a descriptor.  The accumulator:
// register i of a lane is row grp + 8 ((i >> 1) & 1) of the warp's 16,
// column 8 (i >> 2) + 2 tig + (i & 1).
__device__ __forceinline__ void wgmma_m64n64k32_s8(int* d, const uint32_t* a,
                                                   uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// The descriptor of a K-major B operand in shared memory without swizzle:
// core matrices of 8 columns x 16 bytes (128 contiguous bytes, a column's
// 16 k-bytes a row), the two k-halves of a column `lbo` bytes apart and
// successive groups of 8 columns `sbo` bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Orders this thread's register writes (A, accumulators) before the next
// wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of wgmma are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's ordinary shared-memory stores visible to wgmma's
// reads (the async proxy); a barrier must follow before other threads'
// wgmma read them.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBR = 256;        // rows of b per block (product M side)
constexpr int kBQ = 64;         // rows of a per block (product N side)
constexpr int kDepth = 16;      // words per staged step
constexpr int kLD = kDepth + 4;  // staged row stride in words (80 bytes)
constexpr int kBatch = 2;       // words of A built per round of wgmma
constexpr int kLDO = kBR + 4;   // output tile stride: conflict-free stores
// the unpacked queries of one word: 8 core matrices of 8 queries x 16
// k-bytes (256 bytes) along N, the second k-half 128 bytes after the first
constexpr uint32_t kCoreLBO = 128, kCoreSBO = 256;
constexpr int kWordBytes = kBQ * 32;
// shared memory in words: two staged steps of rows and queries, the
// unpacked queries of one step (8 words a query word), then the weights;
// the output tile reuses the first three
constexpr int kStageWords = 2 * (kBR + kBQ) * kLD;
constexpr int kUnpackWords = kDepth * kWordBytes / 4;
constexpr int kPairSmemWords = kStageWords + kUnpackWords + kBQ + kBR;
static_assert(kBQ * kLDO <= kStageWords + kUnpackWords, "output tile fits");
static_assert(kStageWords % 32 == 0, "unpacked queries on 128 bytes");
constexpr size_t kPairSmem = kPairSmemWords * sizeof(uint32_t);

template <bool kInner, bool kHam>
__global__ void __launch_bounds__(kThreads, 2)
pair_stats_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  int32_t* __restrict__ inner, int32_t* __restrict__ ham, int m,
                  int n, int w, bool copy16) {
  extern __shared__ uint4 smem_v[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_v);
  uint32_t* rows_st = smem;                        // 2 x kBR x kLD
  uint32_t* qs_st = rows_st + 2 * kBR * kLD;       // 2 x kBQ x kLD
  uint32_t* qu = qs_st + 2 * kBQ * kLD;            // kDepth x kBQ x 8
  int* wa_s = reinterpret_cast<int*>(qu + kUnpackWords);  // kBQ
  int* wb_s = wa_s + kBQ;                          // kBR
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  // warpgroup wg's two 64-row tiles: rows wg * 128 + 64 t + 16 (warp % 4)
  // + grp (+ 8) are this lane's
  const int rb = (warp >> 2) * 128 + 16 * (warp & 3);
  const int r0 = blockIdx.x * kBR, q0 = blockIdx.y * kBQ;
  const int n_steps = (w + kDepth - 1) / kDepth;
  // a warpgroup whose rows all lie past the end only stages
  const bool busy = r0 + (warp >> 2) * 128 < n;

  // words [k0, k0 + kDepth) of the block's rows and queries into buffer
  // g & 1, V words a copy; rows and words past the end are zero-filled
  auto load_by = [&](auto words, int k0, int g) {
    constexpr int V = decltype(words)::value;
    uint32_t* rs = rows_st + (g & 1) * kBR * kLD;
    uint32_t* qs = qs_st + (g & 1) * kBQ * kLD;
    for (int e = tid; e < (kBR + kBQ) * kDepth / V; e += kThreads) {
      const int r = e / (kDepth / V), c = e % (kDepth / V) * V, kw = k0 + c;
      const uint32_t* src = b;
      bool in;
      uint32_t* dst;
      if (r < kBR) {
        in = r0 + r < n && kw < w;
        if (in) src = b + static_cast<size_t>(r0 + r) * w + kw;
        dst = rs + r * kLD + c;
      } else {
        in = q0 + r - kBR < m && kw < w;
        if (in) src = a + static_cast<size_t>(q0 + r - kBR) * w + kw;
        dst = qs + (r - kBR) * kLD + c;
      }
      cp_async<V>(dst, src, in);
    }
    cp_async_commit();
  };
  auto load = [&](int k0, int g) {
    if (copy16) load_by(std::integral_constant<int, 4>(), k0, g);
    else load_by(std::integral_constant<int, 1>(), k0, g);
  };

  if (kHam && tid < kBQ) wa_s[tid] = 0;
  int acc[2][32] = {};
  int wa_part = 0, wb_part = 0;  // weights: query tid % kBQ's, row tid's
  load(0, 0);
  for (int g = 0; g < n_steps; ++g) {
    cp_async_wait<0>();
    __syncthreads();  // step g staged; every warp done with step g - 1
    if (g + 1 < n_steps) load((g + 1) * kDepth, g + 1);
    const uint32_t* rs = rows_st + (g & 1) * kBR * kLD;
    const uint32_t* qs = qs_st + (g & 1) * kBQ * kLD;
    {
      // thread (query qi, words c4 .. c4 + 3): unpack into 0/1 bytes, in
      // 16-byte rows of the core matrices of wgmma's B
      const int qi = tid % kBQ, c4 = tid / kBQ * 4;
      const uint4 x4 = *reinterpret_cast<const uint4*>(qs + qi * kLD + c4);
      const uint32_t xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t x = xs[v];
        uint4* dst = reinterpret_cast<uint4*>(
            reinterpret_cast<char*>(qu) + (c4 + v) * kWordBytes + (qi >> 3) * kCoreSBO +
            (qi & 7) * 16);
        dst[0] = make_uint4(bit_bytes(x, 0), bit_bytes(x, 1),
                            bit_bytes(x, 2), bit_bytes(x, 3));
        dst[kCoreLBO / 16] = make_uint4(bit_bytes(x, 4), bit_bytes(x, 5),
                                        bit_bytes(x, 6), bit_bytes(x, 7));
        if (kHam) wa_part += __popc(x);
      }
      if (kHam) {
#pragma unroll
        for (int c = 0; c < kDepth; c += 4) {
          const uint4 y = *reinterpret_cast<const uint4*>(rs + tid * kLD + c);
          wb_part += __popc(y.x) + __popc(y.y) + __popc(y.z) + __popc(y.w);
        }
      }
    }
    fence_proxy_async_shared();
    __syncthreads();  // the unpacked queries are in place
    if (busy) {
#pragma unroll 1
      for (int u0 = 0; u0 < kDepth; u0 += kBatch) {
        uint32_t af[kBatch][2][4];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t x0 = rs[(rb + 64 * t + grp) * kLD + u0 + u];
            const uint32_t x1 = rs[(rb + 64 * t + grp + 8) * kLD + u0 + u];
            af[u][t][0] = bit_bytes(x0, tig);
            af[u][t][1] = bit_bytes(x1, tig);
            af[u][t][2] = bit_bytes(x0, tig + 4);
            af[u][t][3] = bit_bytes(x1, tig + 4);
          }
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const uint64_t desc = wgmma_desc(
              reinterpret_cast<const char*>(qu) + (u0 + u) * kWordBytes, kCoreLBO, kCoreSBO);
#pragma unroll
          for (int t = 0; t < 2; ++t) wgmma_m64n64k32_s8(acc[t], af[u][t], desc);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
    }
  }

  // the output tile, (query, row)-major, through shared memory
  cp_async_wait<0>();  // (W = 0 leaves step 0's zero-fill in flight)
  __syncthreads();  // every warp done with the staged words
  int* ot = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      ot[(8 * (i >> 2) + 2 * tig + (i & 1)) * kLDO + rb + 64 * t + grp + 8 * ((i >> 1) & 1)] =
          acc[t][i];
  if (kHam) {
    wb_s[tid] = wb_part;
    atomicAdd(&wa_s[tid % kBQ], wa_part);
  }
  __syncthreads();
  const bool vec = (n & 3) == 0;
  for (int e = tid; e < kBQ * kBR / 4; e += kThreads) {
    const int qi = e / (kBR / 4), c = e % (kBR / 4) * 4;
    const int row = r0 + c;
    if (q0 + qi >= m || row >= n) continue;
    const int4 in4 = *reinterpret_cast<const int4*>(ot + qi * kLDO + c);
    int4 h4;
    if (kHam) {
      const int wa = wa_s[qi];
      h4 = make_int4(wa + wb_s[c] - 2 * in4.x, wa + wb_s[c + 1] - 2 * in4.y,
                     wa + wb_s[c + 2] - 2 * in4.z, wa + wb_s[c + 3] - 2 * in4.w);
    }
    const size_t o = static_cast<size_t>(q0 + qi) * n + row;
    if (vec) {  // row + 3 < n: n and row are multiples of 4
      if (kInner) *reinterpret_cast<int4*>(inner + o) = in4;
      if (kHam) *reinterpret_cast<int4*>(ham + o) = h4;
    } else {
      const int iv[4] = {in4.x, in4.y, in4.z, in4.w};
      int hv[4] = {};
      if (kHam) {
        hv[0] = h4.x;
        hv[1] = h4.y;
        hv[2] = h4.z;
        hv[3] = h4.w;
      }
      for (int k = 0; k < 4 && row + k < n; ++k) {
        if (kInner) inner[o + k] = iv[k];
        if (kHam) ham[o + k] = hv[k];
      }
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

template <bool kInner, bool kHam>
cudaError_t launch_pair(const void* a, const void* b, void* inner, void* ham, int m,
                        int n, int w, cudaStream_t s) {
  auto* kernel = pair_stats_kernel<kInner, kHam>;
  // 16-byte copies where every row starts on 16 bytes
  const bool copy16 = (w & 3) == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaError_t err = repro::allow_smem(kernel, kPairSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBR - 1) / kBR, (m + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, kPairSmem, s>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(inner), static_cast<int32_t*>(ham), m, n, w, copy16);
  return cudaGetLastError();
}

}  // namespace

// a: (m, w), b: (n, w) int32; inner / ham: (m, n) int32 or null when off.
// m <= 64 * 65535 (the grid's y axis holds the 64-row tiles of a).
REPRO_EXPORT int pair_stats_launch(const void* a, const void* b, void* inner,
                                   void* ham, int m, int n, int w, void* stream) {
  if (m > kBQ * 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (m > 0 && n > 0) {
    if (inner && ham) err = launch_pair<true, true>(a, b, inner, ham, m, n, w, s);
    else if (inner) err = launch_pair<true, false>(a, b, inner, ham, m, n, w, s);
    else if (ham) err = launch_pair<false, true>(a, b, inner, ham, m, n, w, s);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

// x: (rows, w) int32; out: (rows,) int32.
REPRO_EXPORT int row_popcount_launch(const void* x, void* out, int rows, int w,
                                     void* stream) {
  if (rows > 0) {  // 8 rows per block
    const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    row_popcount_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<int32_t*>(out), rows, w);
  }
  return static_cast<int>(cudaGetLastError());
}
