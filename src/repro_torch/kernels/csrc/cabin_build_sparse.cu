// Sparse Cabin sketch construction: padded-COO rows -> packed d-bit sketches.
//
// Replaces the TPU kernel repro/kernels/cabin_build_sparse/kernel.py:
// cabin_build_sparse (body _cabin_sparse_kernel).  The TPU has no scatter
// or atomics, so it ORs each slot into its bucket through an O(N*m*d)
// compare-reduce.  Here a group of threads owns a row at a time: a d-bit
// bitmap lives in shared memory, each thread takes COO slots, hashes psi
// and pi in registers, and atomicOr-s the bit when psi is 1.  That is
// O(N*m) work.
//
// Bound on the H100: bytes.  Each row reads 4*m bytes of values, 4 bytes
// of index per non-zero value, and writes 4*ceil(d/32) bytes of sketch;
// the hashing is a few dozen integer operations per slot, under the
// card's integer rate.  So the kernel has to keep enough loads in flight
// to cover the memory's latency:
//
//   - a group is one warp per row where eight bitmaps fit shared memory
//     (d <= 232,448; more threads a row above), and a block of 256 threads
//     holds 256 / G groups, each with its own bitmap;
//   - the grid is one wave of resident blocks, and each group walks its
//     rows (a grid stride) in chunks of 12 slots a thread; the loads of
//     the next chunk, in the same row or the next, are issued before the
//     current chunk is hashed, so they are in flight meanwhile;
//   - a thread loads VEC slots at once (16 bytes where m and the row
//     starts allow it, 8 or 4 bytes otherwise), values and indices
//     together.  Indices are read for every slot, pads too: a load that
//     waits on its value would cost a second trip to memory per chunk.
//     Padding sits at the row end, so this reads about 16% more bytes
//     than the bound counts at 199 live slots of 298;
//   - a finished row's bitmap goes out in 16-byte stores where d allows,
//     and is zeroed in the same pass for the group's next row.
//
// For d a power of two the bucket is a mask, not a division.  A bitmap
// of ceil(d/32) words fits shared memory up to d = 32 * 58112 = 1,859,584
// bits.  Above that (kGlobal) a group of 256 threads zero-fills its own
// output row in device memory and atomicOr-s into it there: the same
// bits, at the cost of atomics that go to L2.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 12;  // a chunk: G * 12 slots of one row

template <int VEC>
struct Slots;
template <>
struct Slots<1> {
  using T = int;
  static __device__ __forceinline__ int at(int v, int) { return v; }
};
template <>
struct Slots<2> {
  using T = int2;
  static __device__ __forceinline__ int at(int2 v, int e) { return e == 0 ? v.x : v.y; }
};
template <>
struct Slots<4> {
  using T = int4;
  static __device__ __forceinline__ int at(int4 v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

template <int VEC, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
cabin_sparse_kernel(const int32_t* __restrict__ indices, const int32_t* __restrict__ values,
                    int32_t* __restrict__ out, int n_rows, int m, int d, int w,
                    int rows_per_block, uint32_t psi_seed, uint32_t pi_seed) {
  using S = Slots<VEC>;
  using T = typename S::T;
  constexpr int U = kSlotsPerThread / VEC;  // loads a thread issues a chunk
  extern __shared__ uint4 smem_v[];
  const int G = kThreads / rows_per_block;  // threads of a group
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  const int groups = gridDim.x * rows_per_block;
  int row = blockIdx.x * rows_per_block + grp;
  if (row >= n_rows) return;  // whole groups leave; no barrier spans groups
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(smem_v) + static_cast<size_t>(grp) * w;
  const int chunk_slots = G * kSlotsPerThread;
  const int n_chunks = max(1, (m + chunk_slots - 1) / chunk_slots);
  const uint32_t psi_key = repro::seed_key(psi_seed);
  const uint32_t pi_key = repro::seed_key(pi_seed);
  const bool pow2 = (d & (d - 1)) == 0;
  const bool vec_words = (w & 3) == 0;
  const int bar = 1 + grp;  // named barrier of the group (0 is the block's)
  auto group_sync = [&] { asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(G) : "memory"); };

  // zero the bitmap of `r` (device memory: its output row)
  auto zero = [&](int r) {
    uint32_t* bm = kGlobal ? reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(r) * w
                           : bitmap;
    if (vec_words)
      for (int i = t * 4; i < w; i += G * 4) *reinterpret_cast<uint4*>(bm + i) = uint4{};
    else
      for (int i = t; i < w; i += G) bm[i] = 0u;
  };
  // the slots of chunk c of row r, values and indices together; slots
  // past m read as value 0
  struct Chunk {
    T v[U], ix[U];
  };
  auto load = [&](int r, int c) {
    Chunk ch;
    const size_t base = static_cast<size_t>(r) * m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = c * chunk_slots + (u * G + t) * VEC;
      ch.v[u] = T{};
      ch.ix[u] = T{};
      if (k < m) {
        ch.v[u] = *reinterpret_cast<const T*>(values + base + k);
        ch.ix[u] = *reinterpret_cast<const T*>(indices + base + k);
      }
    }
    return ch;
  };

  int chunk = 0;
  Chunk cur = load(row, chunk);  // in flight while the bitmap is zeroed
  zero(row);
  group_sync();
  while (true) {
    long long nrow = row;
    int nchunk = chunk + 1;
    if (nchunk == n_chunks) {
      nrow += groups;
      nchunk = 0;
    }
    const bool more = nrow < n_rows;
    Chunk next;
    if (more) next = load(static_cast<int>(nrow), nchunk);

    uint32_t* bm = kGlobal ? reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(row) * w
                           : bitmap;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t val = static_cast<uint32_t>(S::at(cur.v[u], e));
        if (val == 0u) continue;  // padding / missing: psi(i, 0) = 0
        const uint32_t a = static_cast<uint32_t>(S::at(cur.ix[u], e));
        if (repro::psi_bit(a, val, psi_key)) {
          const uint32_t h = repro::mix32(a + pi_key);
          const uint32_t bucket = pow2 ? h & static_cast<uint32_t>(d - 1)
                                       : h % static_cast<uint32_t>(d);
          atomicOr(&bm[bucket >> 5], 1u << (bucket & 31u));
        }
      }
    }

    if (nchunk == 0) {  // the row is done
      group_sync();
      if (kGlobal) {
        if (more) zero(static_cast<int>(nrow));
      } else {
        uint32_t* o = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(row) * w;
        if (vec_words) {
          for (int i = t * 4; i < w; i += G * 4) {
            *reinterpret_cast<uint4*>(o + i) = *reinterpret_cast<const uint4*>(bitmap + i);
            *reinterpret_cast<uint4*>(bitmap + i) = uint4{};
          }
        } else {
          for (int i = t; i < w; i += G) {
            o[i] = bitmap[i];
            bitmap[i] = 0u;
          }
        }
      }
      group_sync();
    }
    if (!more) break;
    row = static_cast<int>(nrow);
    chunk = nchunk;
    cur = next;
  }
}

template <int VEC, bool kGlobal>
cudaError_t launch(const int32_t* ip, const int32_t* vp, int32_t* op, int n_rows, int m,
                   int d, int w, int rows_per_block, uint32_t psi_seed, uint32_t pi_seed,
                   cudaStream_t st) {
  auto* kernel = cabin_sparse_kernel<VEC, kGlobal>;
  const size_t smem =
      kGlobal ? 0 : static_cast<size_t>(rows_per_block) * w * sizeof(uint32_t);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // one wave of resident blocks, no more blocks than row groups
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const long long want = (static_cast<long long>(n_rows) + rows_per_block - 1) / rows_per_block;
  const int blocks = static_cast<int>(std::min<long long>(want, static_cast<long long>(
                                                                    std::max(per_sm, 1)) * sms));
  kernel<<<blocks, kThreads, smem, st>>>(ip, vp, op, n_rows, m, d, w, rows_per_block,
                                         psi_seed, pi_seed);
  return cudaGetLastError();
}

template <bool kGlobal>
cudaError_t dispatch(int vec, const int32_t* ip, const int32_t* vp, int32_t* op, int n_rows,
                     int m, int d, int w, int rows_per_block, uint32_t psi_seed,
                     uint32_t pi_seed, cudaStream_t st) {
  if (vec == 4)
    return launch<4, kGlobal>(ip, vp, op, n_rows, m, d, w, rows_per_block, psi_seed, pi_seed, st);
  if (vec == 2)
    return launch<2, kGlobal>(ip, vp, op, n_rows, m, d, w, rows_per_block, psi_seed, pi_seed, st);
  return launch<1, kGlobal>(ip, vp, op, n_rows, m, d, w, rows_per_block, psi_seed, pi_seed, st);
}

}  // namespace

// indices, values: (n_rows, m) int32; out: (n_rows, ceil(d/32)) int32,
// 16-byte aligned.  The plan of cabin_build_sparse/ops.py: `vec` slots a
// load (1, 2 or 4; it divides m and both input pointers are 4 * vec-byte
// aligned), `rows_per_block` groups of 256 / rows_per_block threads (1, 2,
// 4 or 8; their bitmaps fit shared memory), or `device_bitmap` (one row a
// block, the bitmap in the output row).
REPRO_EXPORT int cabin_build_sparse_launch(const void* indices, const void* values,
                                           void* out, int n_rows, int m, int d,
                                           unsigned int psi_seed, unsigned int pi_seed,
                                           int vec, int rows_per_block, int device_bitmap,
                                           void* stream) {
  if (d < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>((static_cast<int64_t>(d) + 31) / 32);
  const bool vec_ok =
      (vec == 1 || vec == 2 || vec == 4) && m % vec == 0 &&
      reinterpret_cast<uintptr_t>(indices) % (4 * vec) == 0 &&
      reinterpret_cast<uintptr_t>(values) % (4 * vec) == 0;
  const bool rows_ok =
      device_bitmap ? rows_per_block == 1
                    : (rows_per_block == 1 || rows_per_block == 2 || rows_per_block == 4 ||
                       rows_per_block == 8) &&
                          static_cast<size_t>(rows_per_block) * w * sizeof(uint32_t) <=
                              repro::kMaxDynamicSmem;
  if (!vec_ok || !rows_ok || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int32_t*>(indices);
  const auto* vp = static_cast<const int32_t*>(values);
  auto* op = static_cast<int32_t*>(out);
  const cudaError_t err =
      device_bitmap
          ? dispatch<true>(vec, ip, vp, op, n_rows, m, d, w, 1, psi_seed, pi_seed, st)
          : dispatch<false>(vec, ip, vp, op, n_rows, m, d, w, rows_per_block, psi_seed,
                            pi_seed, st);
  return static_cast<int>(err);
}
