// Fused distance + k-best select: for each query row, the k nearest of the
// first m store rows, ordered by (distance, lower column), for any k up to
// 1,024 in one pass over the store.
//
// Replaces the TPU kernel repro/kernels/topk_select/kernel.py: topk_select
// (bodies _topk_select_kernel and _tile_distances).  The TPU runs a
// (Q / BQ, N / BN) grid and carries a (BQ, k) k-best in VMEM across the
// sequential column axis.  Hopper's blocks run in no order, so the columns
// are split across blocks and merged afterwards, in two launches a pass:
//
//   select  grid (ceil(Q / BQ), S): a block owns BQ queries and a
//           contiguous range of about m / S store rows (the plan in
//           topk_select/ops.py picks BQ and S), walks its range in BN-row
//           tiles and writes each query's k best keys of the range, sorted,
//           to a (Q, S, k) scratch list;
//   merge   one block per query merges its S sorted lists into the first
//           k and writes (value, index) pairs, (+inf, -1) where no key is
//           left.
//
// Distances come from exact integer statistics: wa (query weight), wb
// (row weight) and inner (popc of the AND).  Under "hamming" the distance
// is wa + wb - 2*inner; under "cham" it is read from the f32 table T of
// repro_torch.core.cham:
//     h = (2*T[wa + wb - inner] - T[wa]) - T[wb],  dist = 2 * max(h, 0)
// in exactly that order, with round-to-nearest intrinsics (and the library
// built with --fmad=false), so the bits equal the plain PyTorch version's.
// A (distance, column) pair is one 64-bit key, distance bits << 32 |
// column: distances are >= +0, so one integer compare orders by
// (distance, lower column), and keys are unique, so any selection order
// gives the same answer.
//
// Bound on the H100: operations.  The inner products run on the int8
// tensor cores (1,979 TOP/s dense): each 32-bit word of a row is the 32
// k-bytes of one mma.sync m16n8k32 step, each byte a bit as 0 or 1, so
// the s32 sum is popc(a & b) exactly; Q*m*W*32 multiply-adds (a row's
// weight is the row's alone and needs only m*W popcounts more).  The
// store's m*W*4 bytes are read once per query tile, from L2 for all but
// the first tile of a split.  What holds the kernel is the integer work of
// building each warp's fragments from the packed words (a shift and two
// masks per two registers; no unpacked tile in shared memory), not the
// tensor cores.  A block owns BQ queries x BN = 4096 / BQ rows a
// tile; each of 8 warps WM rows x WN queries, four m16n8k32 products a
// step, with the rows as M and the queries as N.  The packed operands
// are staged 16 words deep in shared memory, double buffered with
// cp.async so that step t+1 is copied while step t is multiplied: 16-byte
// copies where W is a multiple of 4 (4-byte ones otherwise), into rows of
// 80 bytes, so that the 8 rows a quarter warp reads with one 16-byte load
// fall in 8 different bank groups.  Any W: the query tile streams along
// the words with the store tile.  Each row's weight is counted once per
// block from the staged words, each query's once.  No distance reaches
// device memory.
//
// Keeping the k best without local memory: per query a threshold (the k-th
// key so far, +max until k are kept) and a candidate buffer of CAP keys in
// shared memory, CAP = max(128, pow2 >= 2k).  A key under the threshold
// (and above the optional floor) takes a slot by a shared atomicAdd.
// Whenever a query's buffer could not take another whole tile, one warp
// sorts it (bitonic, in shared memory), keeps the first k and sets the
// threshold to the k-th.  BQ shrinks as k grows so that the buffers stay at
// 128 KB: BQ = 64 up to k = 128, then 32, 16 and 8 at k = 1,024, with
// BN = 4096 / BQ rows a tile.  At k <= 64 a block needs about 100 KB of
// shared memory (with the Cham table at W = 128), so two blocks share an
// SM.
//
// k above 1,024 runs in passes (topk_select/ops.py): each pass takes an
// optional per-query floor key and keeps only keys above it, so pass r,
// floored at pass r-1's last key, writes slots [r*1024, r*1024 + 1024) of
// the (Q, k) outputs through a row stride and a column offset.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 16;  // words per staged step
constexpr u64 kNone = ULLONG_MAX;

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

// a[0, n) ascending, n a power of two, by one warp
__device__ void warp_sort(u64* a, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < n / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// d += a * b on the tensor cores, m16n8k32, 0/1 bytes -> exact s32 sums
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The select kernel's tile: BQ queries x BN = 4096 / BQ store rows.  The
// inner products run on the int8 tensor cores with the rows as M and the
// queries as N: each of the 8 warps owns WM rows x WN queries, MF x NF
// m16n8k32 products (MF * NF = 4).
template <int BQ>
struct Tile {
  static constexpr int BN = 4096 / BQ;
  static constexpr int WN = BQ < 16 ? BQ : 16;
  static constexpr int NF = WN / 8;
  static constexpr int WARPS_Q = BQ / WN;
  static constexpr int WM = BN / (kWarps / WARPS_Q);
  static constexpr int MF = WM / 16;
  // staged row stride: 80 bytes, so the 8 rows a quarter warp reads with
  // one 16-byte load fall in 8 different bank groups
  static constexpr int LD = kDepth + 4;
  static constexpr int STAGE = (BQ + BN) * LD;
  // staged row words a thread weighs per step, and the rows they span
  static constexpr int E = BN * kDepth / kThreads;
  static constexpr int R = E > kDepth ? E / kDepth : 1;
};

template <int BQ, int CAP>
constexpr size_t select_smem() {
  using T = Tile<BQ>;
  return (static_cast<size_t>(BQ) * CAP + 2 * BQ) * sizeof(u64) +
         (2 * T::STAGE + 3 * BQ + T::BN) * sizeof(uint32_t);
}

// two blocks a SM where their shared memory (with a W = 128 Cham table)
// fits, which caps registers at 128 a thread; one elsewhere
template <int BQ, int CAP>
constexpr int min_blocks() {
  return select_smem<BQ, CAP>() + 16388 <= 113 * 1024 ? 2 : 1;
}

template <int BQ, int CAP, bool kCham>
__global__ void __launch_bounds__(kThreads, (min_blocks<BQ, CAP>()))
topk_split_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ b,
                  const float* __restrict__ table, const u64* __restrict__ floor_key,
                  u64* __restrict__ lists, int nq, int m, int w, int k,
                  int rows_per_split, int table_in_smem, int table_len) {
  using T = Tile<BQ>;
  constexpr int BN = T::BN, LD = T::LD, E = T::E, MF = T::MF, NF = T::NF;
  extern __shared__ u64 smem[];
  u64* buf = smem;                                         // BQ x CAP keys
  u64* thr = buf + BQ * CAP;                               // BQ thresholds
  u64* fl_s = thr + BQ;                                    // BQ floor keys
  uint32_t* stage = reinterpret_cast<uint32_t*>(fl_s + BQ);  // 2 staged steps
  int* cnt = reinterpret_cast<int*>(stage + 2 * T::STAGE);  // BQ
  int* wa_s = cnt + BQ;                                    // BQ query weights
  float* twa_s = reinterpret_cast<float*>(wa_s + BQ);      // BQ T[wa]
  int* wb_s = reinterpret_cast<int*>(twa_s + BQ);          // BN row weights
  float* ts = reinterpret_cast<float*>(wb_s + BN);         // table, if staged

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the mma fragments' lane split
  const int wq0 = warp % T::WARPS_Q * T::WN, wr0 = warp / T::WARPS_Q * T::WM;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r0 = min(m, split * rows_per_split);
  const int r1 = min(m, r0 + rows_per_split);
  const int n_depth = max(1, (w + kDepth - 1) / kDepth);
  const int steps = (r1 - r0 + BN - 1) / BN * n_depth;

  // step g: words [k0, k0 + kDepth) of the query tile and of row tile
  // `tile` into buffer g & 1, V words a copy; rows and words past the end
  // are zero-filled
  auto load_by = [&](auto words, int tile, int k0, int g) {
    constexpr int V = decltype(words)::value;
    uint32_t* st = stage + (g & 1) * T::STAGE;
    for (int e = tid; e < (BQ + BN) * kDepth / V; e += kThreads) {
      const int r = e / (kDepth / V), c = e % (kDepth / V) * V, kw = k0 + c;
      const uint32_t* src = b;
      bool in = false;
      if (r < BQ) {
        in = q0 + r < nq && kw < w;
        if (in) src = q + static_cast<size_t>(q0 + r) * w + kw;
      } else {
        const int row = r0 + tile * BN + r - BQ;
        in = row < r1 && kw < w;
        if (in) src = b + static_cast<size_t>(row) * w + kw;
      }
      cp_async<V>(st + r * LD + c, src, in);
    }
    cp_async_commit();
  };
  // 16-byte copies where rows are 16-byte aligned
  auto load = [&](int tile, int k0, int g) {
    if ((w & 3) == 0) load_by(std::integral_constant<int, 4>(), tile, k0, g);
    else load_by(std::integral_constant<int, 1>(), tile, k0, g);
  };

  if (kCham && table_in_smem)
    for (int i = tid; i < table_len; i += kThreads) ts[i] = table[i];
  for (int i = tid; i < BQ; i += kThreads) {
    cnt[i] = 0;
    thr[i] = kNone;
    fl_s[i] = (floor_key && q0 + i < nq) ? floor_key[q0 + i] : 0ull;
  }
  for (int i = tid; i < BN; i += kThreads) wb_s[i] = 0;
  for (int i = warp; i < BQ; i += kWarps) {
    int s = 0;
    if (q0 + i < nq)
      for (int j = lane; j < w; j += 32) s += __popc(q[static_cast<size_t>(q0 + i) * w + j]);
    s = repro::warp_sum(s);
    if (lane == 0) wa_s[i] = s;
  }
  if (steps > 0) load(0, 0, 0);
  __syncthreads();
  const float* tab = (kCham && table_in_smem) ? ts : table;
  if (kCham)
    for (int i = tid; i < BQ; i += kThreads) twa_s[i] = tab[wa_s[i]];
  const bool floored = floor_key != nullptr;

  // a query's buffer, sorted: the first min(n, k) kept, the k-th the
  // threshold (one warp)
  auto compact = [&](int qi) {
    const int n = cnt[qi];
    u64* a = buf + qi * CAP;
    for (int j = n + lane; j < CAP; j += 32) a[j] = kNone;
    __syncwarp();
    warp_sort(a, CAP, lane);
    if (lane == 0) {
      const int keep = min(n, k);
      cnt[qi] = keep;
      thr[qi] = keep == k ? a[k - 1] : kNone;
    }
    __syncwarp();
  };

  int acc[MF][NF][4] = {};
  int wbp[T::R] = {};
  int tile = 0, depth = 0;  // of step g
  int ntile = 0, ndepth = 0;  // of step g + 1
  for (int g = 0; g < steps; ++g) {
    if (++ndepth == n_depth) {
      ndepth = 0;
      ++ntile;
    }
    if (g + 1 < steps) {
      load(ntile, ndepth * kDepth, g + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* as = stage + (g & 1) * T::STAGE;
    const uint32_t* bs = as + BQ * LD;
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const int e = tid * E + i;
      const uint4 x = *reinterpret_cast<const uint4*>(bs + (e / kDepth) * LD + e % kDepth);
      wbp[E > kDepth ? i / kDepth : 0] += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    }
    // Word c of a row holds 32 bits; as the k = 32 bytes of one product
    // step, byte 4t + i of a fragment register is bit t + 8i (i < 4) and
    // byte 16 + 4t + i is bit t + 4 + 8i, for rows (A) and queries (B)
    // alike, so the product sums popc(a & b) exactly.  Lane (grp, tig) of
    // a warp holds bytes 4 * tig .. + 3 and 16 + 4 * tig .. + 3 of rows
    // grp and grp + 8 (A) and of query grp (B): two masks of (w >> tig).
    constexpr uint32_t kOnes = 0x01010101u;
#pragma unroll 1
    for (int c = 0; c < kDepth; c += 4) {
      uint4 aw[MF][2], bw[NF];
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          aw[f][h] = *reinterpret_cast<const uint4*>(bs + (wr0 + f * 16 + grp + 8 * h) * LD + c);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        bw[f] = *reinterpret_cast<const uint4*>(as + (wq0 + f * 8 + grp) * LD + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t a[MF][4], bf[NF][2];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const uint32_t x0 = word(aw[f][0], u) >> tig, x1 = word(aw[f][1], u) >> tig;
          a[f][0] = x0 & kOnes;
          a[f][1] = x1 & kOnes;
          a[f][2] = (x0 >> 4) & kOnes;
          a[f][3] = (x1 >> 4) & kOnes;
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const uint32_t x = word(bw[f], u) >> tig;
          bf[f][0] = x & kOnes;
          bf[f][1] = (x >> 4) & kOnes;
        }
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_s8(acc[i][j], a[i], bf[j]);
      }
    }
    if (depth + 1 < n_depth) {
      __syncthreads();  // buffer g & 1 is free for step g + 2
      ++depth;
      continue;
    }
    // the tile is counted: weights, then distances and candidates
#pragma unroll
    for (int rr = 0; rr < T::R; ++rr) {
      atomicAdd(&wb_s[tid * E / kDepth + rr], wbp[rr]);
      wbp[rr] = 0;
    }
    __syncthreads();
    const int row0 = r0 + tile * BN;
    // accumulator e of product (i, j): row wr0 + 16i + grp + 8 (e >> 1),
    // query wq0 + 8j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int qi = wq0 + 8 * j + 2 * tig + e1;  // this thread's queries
        const bool qok = q0 + qi < nq;
        const u64 th = thr[qi], fl = fl_s[qi];
        const int wa = wa_s[qi];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
#pragma unroll
          for (int e0 = 0; e0 < 2; ++e0) {
            const int col = wr0 + 16 * i + grp + 8 * e0;  // and rows
            const int in = acc[i][j][2 * e0 + e1];
            acc[i][j][2 * e0 + e1] = 0;
            if (!qok || row0 + col >= r1) continue;
            const int wb = wb_s[col];
            float dist;
            if (kCham) {
              const float tu = tab[wa + wb - in];
              const float h = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, tu), twa_s[qi]), tab[wb]);
              dist = __fmul_rn(2.0f, h > 0.0f ? h : 0.0f);
            } else {
              dist = static_cast<float>(wa + wb - 2 * in);
            }
            const u64 key = (static_cast<u64>(__float_as_uint(dist)) << 32) |
                            static_cast<uint32_t>(row0 + col);
            if (key < th && (!floored || key > fl)) {
              const int slot = atomicAdd(&cnt[qi], 1);
              buf[qi * CAP + slot] = key;
            }
          }
        }
      }
    }
    __syncthreads();
    for (int qi = warp; qi < BQ; qi += kWarps)
      if (cnt[qi] > CAP - BN) compact(qi);  // the next tile might not fit
    for (int i = tid; i < BN; i += kThreads) wb_s[i] = 0;
    __syncthreads();
    depth = 0;
    ++tile;
  }

  for (int qi = warp; qi < BQ; qi += kWarps) {
    compact(qi);
    if (q0 + qi < nq) {
      u64* out = lists + (static_cast<size_t>(q0 + qi) * splits + split) * k;
      for (int j = lane; j < k; j += 32) out[j] = buf[qi * CAP + j];
    }
  }
}

// One block per query: the first k of its S sorted lists of k keys, merged
// two at a time by merge path (each thread finds where its outputs start by
// a binary search, then merges them in order).
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const u64* __restrict__ lists, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i, int splits, int k, int ld_out, int col0) {
  extern __shared__ u64 smem[];
  u64* best = smem;
  u64* other = smem + k;
  u64* next = smem + 2 * k;
  const int tid = threadIdx.x;
  const size_t qi = blockIdx.x;
  const u64* l = lists + qi * splits * k;
  for (int j = tid; j < k; j += kThreads) best[j] = l[j];
  __syncthreads();
  const int per = (k + kThreads - 1) / kThreads;
  const int j0 = tid * per;
  for (int s = 1; s < splits; ++s) {
    const u64* ls = l + static_cast<size_t>(s) * k;
    if (ls[0] >= best[k - 1]) continue;  // nothing of it enters the first k
    for (int j = tid; j < k; j += kThreads) other[j] = ls[j];
    __syncthreads();
    if (j0 < k) {
      // the first j0 outputs take `lo` keys of best and j0 - lo of other
      int lo = 0, hi = j0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (best[mid] > other[j0 - 1 - mid]) hi = mid;
        else lo = mid + 1;
      }
      int i = lo, j = j0 - lo;
      const int end = min(j0 + per, k);
      for (int o = j0; o < end; ++o) next[o] = best[i] <= other[j] ? best[i++] : other[j++];
    }
    __syncthreads();
    u64* t = best;
    best = next;
    next = t;
  }
  for (int j = tid; j < k; j += kThreads) {
    const u64 key = best[j];
    const size_t o = qi * ld_out + col0 + j;
    if (key == kNone) {
      out_v[o] = __uint_as_float(0x7f800000u);  // +inf
      out_i[o] = -1;
    } else {
      out_v[o] = __uint_as_float(static_cast<uint32_t>(key >> 32));
      out_i[o] = static_cast<int32_t>(key & 0xffffffffull);
    }
  }
}

struct Args {
  const void* q;
  const void* b;
  const void* table;
  const void* floor_key;
  void* lists;
  void* out_v;
  void* out_i;
  int nq, m, w, k, ld_out, col0, table_len, splits, rows_per_split;
};

template <int BQ, int CAP, bool kCham>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto* kernel = topk_split_kernel<BQ, CAP, kCham>;
  size_t smem = select_smem<BQ, CAP>();
  const size_t with_table = smem + static_cast<size_t>(a.table_len) * sizeof(float);
  const int table_in_smem = kCham && with_table <= repro::kMaxDynamicSmem;
  if (table_in_smem) smem = with_table;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + BQ - 1) / BQ, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(a.q), static_cast<const uint32_t*>(a.b),
      static_cast<const float*>(a.table), static_cast<const u64*>(a.floor_key),
      static_cast<u64*>(a.lists), a.nq, a.m, a.w, a.k, a.rows_per_split, table_in_smem,
      a.table_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<a.nq, kThreads, 3 * a.k * sizeof(u64), stream>>>(
      static_cast<const u64*>(a.lists), static_cast<float*>(a.out_v),
      static_cast<int32_t*>(a.out_i), a.splits, a.k, a.ld_out, a.col0);
  return cudaGetLastError();
}

// the (BQ, CAP) of a pass of k keys, as ops.plan gives it
template <bool kCham>
cudaError_t dispatch(const Args& a, int bq, cudaStream_t s) {
  if (a.k <= 64 && bq == 64) return launch<64, 128, kCham>(a, s);
  if (a.k > 64 && a.k <= 128 && bq == 64) return launch<64, 256, kCham>(a, s);
  if (a.k > 128 && a.k <= 256 && bq == 32) return launch<32, 512, kCham>(a, s);
  if (a.k > 256 && a.k <= 512 && bq == 16) return launch<16, 1024, kCham>(a, s);
  if (a.k > 512 && a.k <= 1024 && bq == 8) return launch<8, 2048, kCham>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (nq, w), b: (>= m, w) int32; table: (table_len,) f32 (cham only, may
// be null for hamming); floor_key: (nq,) uint64 (distance bits << 32 |
// column) or null; lists: (nq, splits, k) uint64 scratch; out_v: (nq,
// ld_out) f32; out_i: (nq, ld_out) int32.  Writes the k smallest keys above
// each query's floor to columns [col0, col0 + k) of its output row, in two
// launches: select over `splits` ranges of `rows_per_split` rows (which
// must cover m), then merge.  1 <= k <= 1024, bq the query tile of k's
// shape, col0 + k <= ld_out.  Slots with no key left come back as
// (+inf, -1).
REPRO_EXPORT int topk_select_launch(const void* q, const void* b, const void* table,
                                    const void* floor_key, void* lists, void* out_v,
                                    void* out_i, int nq, int m, int w, int k, int ld_out,
                                    int col0, int cham, int table_len, int bq, int splits,
                                    int rows_per_split, void* stream) {
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > 1024 || col0 < 0 || col0 + k > ld_out || splits < 1 ||
      splits > 65535 || rows_per_split < 0 ||
      static_cast<long long>(splits) * rows_per_split < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  b,  table,  floor_key, lists,     out_v,     out_i,  nq,
               m,  w,  k,      ld_out,    col0,      table_len, splits, rows_per_split};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cham ? dispatch<true>(a, bq, s) : dispatch<false>(a, bq, s);
  return static_cast<int>(err);
}
