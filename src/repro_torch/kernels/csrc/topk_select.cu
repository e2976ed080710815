// Fused distance + k-best select: for each query row, the k nearest of the
// first m store rows, ordered by (distance, lower column).
//
// Replaces the TPU kernel repro/kernels/topk_select/kernel.py: topk_select
// (bodies _topk_select_kernel and _tile_distances).  The TPU carries a
// (BQ, k) k-best across a sequential column grid in VMEM; Hopper's blocks
// run in no order, so one block owns one query row and loops over every
// column itself.
//
// Distances come from exact integer statistics: wa (query weight), wb
// (row weight) and inner (popc of the AND).  Under "hamming" the distance
// is wa + wb - 2*inner; under "cham" it is read from the f32 table T of
// repro_torch.core.cham:
//     h = (2*T[wa + wb - inner] - T[wa]) - T[wb],  dist = 2 * max(h, 0)
// in exactly that order, with round-to-nearest intrinsics, so the bits
// equal the plain PyTorch version's.
//
// Bound on the H100: the store's m*W*4 bytes for a few queries; for a batch
// of Q queries over one store, the Q*m*W popcounts of the ANDs (at 16 per
// clock per SM; a row's weight is the row's alone and needs only m*W more).
// Only k (value, index) pairs per query are written: no distance reaches
// device memory.  This first design is simple and stays far from the
// operations bound (it also recounts each row's weight for every query):
// one block per query reads the store on its own (from L2 when queries run
// side by side), the query words and the Cham table sit in shared memory,
// a warp takes 32 columns at a time and reads each row as coalesced
// 128-byte steps, reducing the popcounts with shuffles; lane c then owns
// column c's distance and keeps it in a thread-local sorted k-best (a
// 64-bit key, distance bits over column, so one integer compare orders by
// (distance, column)).  At the end, k rounds of a block-wide minimum over
// the threads' list heads merge the lists.
//
// k above the thread-local cap (256) runs in rounds (topk_select/ops.py):
// each round takes an optional per-query floor key and keeps only keys
// above it, so round r, floored at round r-1's last key, writes slots
// [r*256, r*256 + 256) of the (Q, k) outputs through a row stride and a
// column offset.  Keys are unique, so the rounds together are exactly the
// sorted first k; each round is one more pass over the store.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

template <int kCap, bool kCham>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ b,
                   const float* __restrict__ table,
                   const unsigned long long* __restrict__ floor_key,
                   float* __restrict__ out_v, int32_t* __restrict__ out_i, int m,
                   int w, int k, int ld_out, int col0, int table_len,
                   int table_in_smem) {
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;                                   // w words
  float* ts = reinterpret_cast<float*>(smem + w);        // table, if staged
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ unsigned long long block_best;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qi = blockIdx.x;
  for (int i = tid; i < w; i += kThreads) qs[i] = q[qi * w + i];
  if (kCham && table_in_smem)
    for (int i = tid; i < table_len; i += kThreads) ts[i] = table[i];
  __syncthreads();
  const float* tab = (kCham && table_in_smem) ? ts : table;

  int wa = 0;
  for (int i = lane; i < w; i += 32) wa += __popc(qs[i]);
  wa = repro::warp_sum(wa);

  // keys at or below the floor were taken by an earlier round
  const unsigned long long fl = floor_key ? floor_key[qi] : 0ull;
  const bool floored = floor_key != nullptr;

  unsigned long long best[kCap];
  for (int i = 0; i < k; ++i) best[i] = ULLONG_MAX;

  for (int base = warp * 32; base < m; base += kThreads) {
    int my_inner = 0, my_wb = 0;
    const int cols = min(32, m - base);
    for (int c = 0; c < cols; ++c) {
      const uint32_t* row = b + static_cast<size_t>(base + c) * w;
      int in = 0, wb = 0;
      for (int i = lane; i < w; i += 32) {
        const uint32_t x = row[i];
        in += __popc(x & qs[i]);
        wb += __popc(x);
      }
      in = repro::warp_sum(in);
      wb = repro::warp_sum(wb);
      if (lane == c) {
        my_inner = in;
        my_wb = wb;
      }
    }
    if (lane < cols) {
      float dist;
      if (kCham) {
        const float tu = tab[wa + my_wb - my_inner];
        const float h = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, tu), tab[wa]), tab[my_wb]);
        dist = __fmul_rn(2.0f, h > 0.0f ? h : 0.0f);
      } else {
        dist = static_cast<float>(wa + my_wb - 2 * my_inner);
      }
      // distances are >= +0, so their bits order like the floats
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(dist)) << 32) |
          static_cast<uint32_t>(base + lane);
      if (key < best[k - 1] && (!floored || key > fl)) {
        int p = k - 1;
        while (p > 0 && best[p - 1] > key) {
          best[p] = best[p - 1];
          --p;
        }
        best[p] = key;
      }
    }
  }

  // merge: k rounds of a block-wide minimum over the list heads
  int head = 0;
  for (int r = 0; r < k; ++r) {
    const unsigned long long mine = head < k ? best[head] : ULLONG_MAX;
    const unsigned long long wmin = warp_min(mine);
    if (lane == 0) warp_best[warp] = wmin;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < kWarps ? warp_best[lane] : ULLONG_MAX;
      v = warp_min(v);
      if (lane == 0) block_best = v;
    }
    __syncthreads();
    const unsigned long long win = block_best;
    if (win != ULLONG_MAX && mine == win) ++head;  // keys are unique
    if (tid == 0) {
      const size_t o = qi * ld_out + col0 + r;
      if (win == ULLONG_MAX) {
        out_v[o] = __uint_as_float(0x7f800000u);  // +inf
        out_i[o] = -1;
      } else {
        out_v[o] = __uint_as_float(static_cast<uint32_t>(win >> 32));
        out_i[o] = static_cast<int32_t>(win & 0xffffffffull);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* b;
  const void* table;
  const void* floor_key;
  void* out_v;
  void* out_i;
  int nq, m, w, k, ld_out, col0, table_len;
};

template <int kCap, bool kCham>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int w = a.w, table_len = a.table_len;
  size_t smem = static_cast<size_t>(w) * sizeof(uint32_t);
  const size_t with_table = smem + static_cast<size_t>(table_len) * sizeof(float);
  const int table_in_smem = kCham && with_table <= repro::kMaxDynamicSmem;
  if (table_in_smem) smem = with_table;
  if (smem > repro::kMaxDynamicSmem) return cudaErrorInvalidValue;
  cudaError_t err = repro::allow_smem(topk_select_kernel<kCap, kCham>, smem);
  if (err != cudaSuccess) return err;
  topk_select_kernel<kCap, kCham><<<a.nq, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(a.q), static_cast<const uint32_t*>(a.b),
      static_cast<const float*>(a.table),
      static_cast<const unsigned long long*>(a.floor_key), static_cast<float*>(a.out_v),
      static_cast<int32_t*>(a.out_i), a.m, w, a.k, a.ld_out, a.col0, table_len,
      table_in_smem);
  return cudaGetLastError();
}

template <bool kCham>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.k <= 16) return launch<16, kCham>(a, s);
  if (a.k <= 64) return launch<64, kCham>(a, s);
  if (a.k <= 256) return launch<256, kCham>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (nq, w), b: (>= m, w) int32; table: (table_len,) f32 (cham only, may
// be null for hamming); floor_key: (nq,) uint64 (distance bits << 32 |
// column) or null; out_v: (nq, ld_out) f32; out_i: (nq, ld_out) int32.
// Writes the k smallest keys above each query's floor to columns
// [col0, col0 + k) of its output row.  1 <= k <= 256, col0 + k <= ld_out.
// Slots with no key left come back as (+inf, -1).
REPRO_EXPORT int topk_select_launch(const void* q, const void* b, const void* table,
                                    const void* floor_key, void* out_v, void* out_i,
                                    int nq, int m, int w, int k, int ld_out, int col0,
                                    int cham, int table_len, void* stream) {
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || col0 < 0 || col0 + k > ld_out) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, b, table, floor_key, out_v, out_i, nq, m, w, k, ld_out, col0, table_len};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cham ? dispatch<true>(a, s) : dispatch<false>(a, s);
  return static_cast<int>(err);
}
