// Flash attention: online-softmax attention, causal or not, with grouped
// KV heads, for bf16 or f32 inputs, with f32 softmax and accumulators.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention (body _flash_kernel).  There the grid's last axis walks
// the KV blocks in order and carries (m, l, acc) in VMEM scratch between
// grid steps.  Hopper's blocks run in no order, so here one block owns one
// (batch, query head, 64-row query tile) and walks the KV tiles in a loop,
// keeping the running max m, the normaliser l and the output accumulator
// in f32 registers.  K/V tiles are read straight from the shared KV head
// h / (Hq / Hkv): nothing is repeated in memory.
//
// Under `causal`, KV tiles wholly above the diagonal are skipped, and the
// rest are masked by q_pos >= k_pos with both positions counted from 0,
// as the TPU kernel does (masked scores are -1e30).  Any S and Skv are
// taken: rows and keys past the end are masked, not required away.
//
// Bound on the H100: operations at the shapes of the LM prefill
// (4 * S * Skv * Dh flops per query head, halved under causal, at the
// 989 TFLOP/s bf16 tensor-core rate) against q + k + v + o bytes.
//
// bf16 (flash_mma_kernel, the LM prefill's path).  Both products run on
// the tensor cores: mma.sync m16n8k16 bf16 -> f32, fragments loaded with
// ldmatrix, in place of the scalar f32 FMAs (67 TFLOP/s at most) of the
// first version.  4 warps, each 16 query rows.  Q, K and V stay bf16 in
// shared memory with rows padded by 16 bytes, so the 8 rows an ldmatrix
// phase reads fall in 8 different 16-byte bank groups; 64-key K/V tiles
// are double-buffered with cp.async, so tile t+1 is copied while tile t
// is multiplied.  S = Q K^T sums exact bf16 products in f32 (only the
// order of the sum changes); Q fragments are re-read from shared memory
// at each 16-wide step of Dh (Dh is a run-time value; Dh_v is a template
// parameter, so the O accumulator, Dh_v / 2 f32 a thread, stays in
// registers).  The softmax runs in registers: scores are scaled by
// log2(e) / sqrt(Dh) and exponentiated with exp2f, row max and sum come
// from the four lanes that share a row.  P is rounded to bf16 in
// registers to be the A operand of P V (V fragments by ldmatrix.trans):
// the TPU kernel keeps P in f32, so this departs from it by one bf16
// rounding of each weight, within the unchanged tolerance (2 bf16 ulps of
// each output row's largest |value|).  Blocks take the query tiles last
// to first, so the longest causal rows start first.  What it still
// leaves: no wgmma, no TMA, no warp specialisation; each warp reads every
// K/V fragment itself, and two blocks (8 warps) fit an SM at Dh = 128.
// Registers (`cuobjdump -res-usage` of the sm_90a build, CUDA 12.8, as
// chip_smoke.py prints it): 80 a thread at Dh_v = 16, 161 at 128, 239 at
// 256, no local memory; only the Dh_v = 80 instance keeps a 24-byte stack
// frame (a small spill), the others none.
//
// Shared memory per block: 2 * (64 * (3 * Dh + 2 * Dh_v) + 5 * 64 * 8)
// bytes, 168,960 at Dh = Dh_v = 256, under the 227 KB limit.
//
// f32 (flash_f32_kernel): bf16 tensor cores cannot hold the 1e-5 f32
// tolerance and no main path runs f32, so it keeps the scalar design:
// scores and P.V as f32 FMAs from shared memory (each thread a 4 x 4
// block of scores and a 4 x Dh_v/16 block of the output), P in f32 as
// on the TPU; 213,760 bytes of shared memory at Dh = Dh_v = 256.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per KV tile
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int PAD = 8;            // bf16 per padded row: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two f32 -> bf16x2, lo in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0 + ROWS) of a (n_rows, cols) bf16 matrix into shared memory
// with row stride cols + PAD; rows past n_rows are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n_rows,
                                          int cols) {
  const int chunks = cols / 8;
  const int ld = cols + PAD;
  // thread i takes chunks i, i + 128, ...: (row, chunk) stepped, not
  // divided out, since cols is a run-time value for K
  const int dr = MMA_THREADS / chunks, dc = MMA_THREADS - dr * chunks;
  int r = threadIdx.x / chunks, c = threadIdx.x - r * chunks;
  for (; r < ROWS; r += dr) {
    const bool in = r0 + r < n_rows;
    const bf16* g = src + static_cast<size_t>(in ? r0 + r : 0) * cols + c * 8;
    cp_async16(smem_addr(dst + r * ld + c * 8), g, in);
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

// NDV = Dh_v / 16
template <int NDV>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int hq, int hkv, int s,
                 int skv, int dh, float scale_log2, int causal) {
  constexpr int DV = NDV * 16;
  constexpr int LDV = DV + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = dh + PAD;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x ldk
  bf16* ks = qs + BQ * ldk;                      // 2 x BK x ldk
  bf16* vs = ks + 2 * BK * ldk;                  // 2 x BK x LDV

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bf16* qp = q + (static_cast<size_t>(b) * hq + h) * s * dh;
  const bf16* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * dh;
  const bf16* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * DV;
  bf16* op = o + (static_cast<size_t>(b) * hq + h) * s * DV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int row0 = q0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8

  int n_tiles = (skv + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, s) - 1) / BK + 1);

  load_tile<BQ>(qs, qp, q0, s, dh);
  load_tile<BK>(ks, kp, 0, skv, dh);
  load_tile<BK>(vs, vp, 0, skv, DV);
  cp_async_commit();

  float acc[2 * NDV][4];
#pragma unroll
  for (int j = 0; j < 2 * NDV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums

  // ldmatrix row addresses: lane L names one row of one 8 x 8 matrix
  const uint32_t q_addr = smem_addr(qs + (warp * 16 + (lane & 15)) * ldk + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * ldk + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LDV + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; everyone is done with tile it - 1
    if (it + 1 < n_tiles) {
      load_tile<BK>(ks + (buf ^ 1) * BK * ldk, kp, (it + 1) * BK, skv, dh);
      load_tile<BK>(vs + (buf ^ 1) * BK * LDV, vp, (it + 1) * BK, skv, DV);
    }
    cp_async_commit();
    const int k0 = it * BK;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const uint32_t k_addr = smem_addr(ks + buf * BK * ldk + k_off);
#pragma unroll 4
    for (int kk = 0; kk < dh / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(q_addr + kk * 32, a0, a1, a2, a3);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_addr + (p * 16 * ldk + kk * 16) * 2, b0, b1, b2, b3);
        mma_bf16(sc[2 * p], a0, a1, a2, a3, b0, b1);
        mma_bf16(sc[2 * p + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // scale and mask; sc[j][e] is row row0 + 8 * (e >> 1), key
    // k0 + 8 * j + 2 * t + (e & 1)
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= skv) x = -INFINITY;
          else if (causal && row0 + 8 * (e >> 1) < key) x = kMasked;
        }
        sc[j][e] = x;
      }

    // online softmax in registers
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < 2 * NDV; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P (bf16, from the score registers) x V tile
    const uint32_t v_addr = smem_addr(vs + buf * BK * LDV + v_off);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int p = 0; p < NDV; ++p) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(v_addr + (kk * 16 * LDV + p * 16) * 2, b0, b1, b2, b3);
        mma_bf16(acc[2 * p], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[2 * p + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
    if (row >= s) continue;
    bf16* orow = op + static_cast<size_t>(row) * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < 2 * NDV; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

size_t mma_smem_bytes(int dh, int dv) {
  return sizeof(bf16) * (static_cast<size_t>(BQ + 2 * BK) * (dh + PAD) +
                         static_cast<size_t>(2 * BK) * (dv + PAD));
}

template <int NDV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int s, int skv, int dh, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(dh, NDV * 16);
  cudaError_t err = repro::allow_smem(flash_mma_kernel<NDV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_mma_kernel<NDV><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), hq, hkv, s, skv, dh, scale * kLog2e, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 row groups of 4 rows x 16 column lanes
constexpr int LDP = BK + 1;

// max / sum over the 16 lanes that share a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NV = Dh_v / 16: output columns per thread and row
template <int NV>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq, int hkv, int s,
                 int skv, int dh, float scale, int causal) {
  constexpr int DV = NV * 16;
  extern __shared__ float smem[];
  const int ldq = dh + 1;
  float* qs = smem;              // BQ x ldq
  float* ks = qs + BQ * ldq;     // BK x ldq
  float* vs = ks + BK * ldq;     // BK x DV
  float* ps = vs + BK * DV;      // BQ x LDP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const float* qp = q + (static_cast<size_t>(b) * hq + h) * s * dh;
  const float* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * dh;
  const float* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * DV;
  float* op = o + (static_cast<size_t>(b) * hq + h) * s * DV;

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // this thread's rows: tr * 4 + i, i < 4
  const int tc = tid % 16;  // its key / output columns: tc + 16 * j

  for (int i = tid; i < BQ * dh; i += F32_THREADS) {
    const int r = i / dh, c = i - r * dh;
    qs[r * ldq + c] = q0 + r < s ? qp[static_cast<size_t>(q0 + r) * dh + c] : 0.f;
  }

  float acc[4][NV];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (skv + BK - 1) / BK;
  if (causal) {
    // the last query row of this tile sees keys 0 .. min(q0 + BQ, s) - 1
    const int last_q = min(q0 + BQ, s) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P.V is done with ks, vs, ps
    for (int i = tid; i < BK * dh; i += F32_THREADS) {
      const int r = i / dh, c = i - r * dh;
      ks[r * ldq + c] = k0 + r < skv ? kp[static_cast<size_t>(k0 + r) * dh + c] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += F32_THREADS) {
      const int r = i / DV, c = i - r * DV;
      vs[i] = k0 + r < skv ? vp[static_cast<size_t>(k0 + r) * DV + c] : 0.f;
    }
    __syncthreads();

    // scores: rows tr*4+i, keys tc+16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < dh; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(tr * 4 + i) * ldq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tc + 16 * j) * ldq + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
      bool live[4];
      float row_max = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        live[j] = kpos < skv;
        sc[i][j] *= scale;
        if (causal && qpos < kpos) sc[i][j] = kMasked;
        if (live[j]) row_max = fmaxf(row_max, sc[i][j]);
      }
      const float m_new = fmaxf(m_run[i], group_max(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(sc[i][j] - m_new) : 0.f;
        row_sum += p;
        ps[(tr * 4 + i) * LDP + tc + 16 * j] = p;
      }
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + group_sum(row_sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P . V over this tile's keys
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float vv = vs[kk * DV + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r >= s) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j) op[static_cast<size_t>(r) * DV + tc + 16 * j] = acc[i][j] * inv;
  }
}

size_t f32_smem_bytes(int dh, int dv) {
  return sizeof(float) * (static_cast<size_t>(BQ + BK) * (dh + 1) +
                          static_cast<size_t>(BK) * dv + static_cast<size_t>(BQ) * LDP);
}

template <int NV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int s, int skv, int dh, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(dh, NV * 16);
  cudaError_t err = repro::allow_smem(flash_f32_kernel<NV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_f32_kernel<NV><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, s, skv, dh, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch(bool is_bf16, int n, const void* q, const void* k, const void* v,
                     void* o, int b, int hq, int hkv, int s, int skv, int dh, float scale,
                     int causal, cudaStream_t st) {
#define REPRO_FLASH_CASE(N)                                                              \
  case N:                                                                                \
    return is_bf16 ? launch_mma<N>(q, k, v, o, b, hq, hkv, s, skv, dh, scale, causal, st) \
                   : launch_f32<N>(q, k, v, o, b, hq, hkv, s, skv, dh, scale, causal, st);
  switch (n) {
    REPRO_FLASH_CASE(1) REPRO_FLASH_CASE(2) REPRO_FLASH_CASE(3) REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5) REPRO_FLASH_CASE(6) REPRO_FLASH_CASE(7) REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(9) REPRO_FLASH_CASE(10) REPRO_FLASH_CASE(11) REPRO_FLASH_CASE(12)
    REPRO_FLASH_CASE(13) REPRO_FLASH_CASE(14) REPRO_FLASH_CASE(15) REPRO_FLASH_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q: (b, hq, s, dh); k: (b, hkv, skv, dh); v: (b, hkv, skv, dv); o: (b, hq, s, dv);
// all contiguous, all bf16 (is_bf16 = 1, each pointer 16-byte aligned) or
// all f32.  dh and dv multiples of 16 in [16, 256], hq a multiple of hkv;
// the wrapper checks all of it.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                        int b, int hq, int hkv, int s, int skv, int dh,
                                        int dv, int causal, float scale, int is_bf16,
                                        void* stream) {
  if (dh % 16 || dv % 16 || dh < 16 || dv < 16 || dh > 256 || dv > 256 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = is_bf16 ? mma_smem_bytes(dh, dv) : f32_smem_bytes(dh, dv);
  if (smem > repro::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (is_bf16 && (addr & 15)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (b == 0 || s == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = dispatch(is_bf16 != 0, dv / 16, q, k, v, o, b, hq, hkv, s, skv, dh,
                                   scale, causal, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
