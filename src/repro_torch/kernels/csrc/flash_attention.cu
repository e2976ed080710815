// Flash attention: online-softmax attention, causal or not, with grouped
// KV heads, for bf16 or f32 inputs with f32 math.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention (body _flash_kernel).  There the grid's last axis walks
// the KV blocks in order and carries (m, l, acc) in VMEM scratch between
// grid steps.  Hopper's blocks run in no order, so here one block owns one
// (batch, query head, 64-row query tile) and walks the KV tiles in a loop,
// keeping the running max m, the normaliser l and the output accumulator
// in f32 registers.  K/V tiles are staged in shared memory straight from
// the shared KV head h / (Hq / Hkv): nothing is repeated in memory.
//
// Under `causal`, KV tiles wholly above the diagonal are skipped, and the
// rest are masked by q_pos >= k_pos with both positions counted from 0,
// as the TPU kernel does (masked scores are -1e30).  Any S and Skv are
// taken: rows and keys past the end are masked, not required away.
//
// Bound on the H100: operations at the shapes of the LM prefill
// (4 * S * Skv * Dh flops per query head, halved under causal, against
// q + k + v + o bytes).  This first version is simple rather than fast: the
// products are scalar f32 FMAs from shared memory (each thread holds a
// 4 x 4 block of scores and a 4 x Dh_v/16 block of the output), not
// tensor-core wgmma fed by TMA, which a later version needs to near the
// bf16 tensor rate.  P stays in f32 for P.V, as on the TPU.
//
// Shared memory per block, in f32: Q and K tiles (64 x (Dh + 1), padded
// against bank conflicts), the V tile (64 x Dh_v) and P (64 x 65):
// 213,760 bytes at Dh = Dh_v = 256, under the 227 KB limit.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 row groups of 4 rows x 16 column lanes
constexpr int LDP = BK + 1;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int hq, int hkv, int s, int skv, int dh, float scale,
             int causal) {
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
  const T* qp = q + (static_cast<size_t>(b) * hq + h) * s * dh;
  const T* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * dh;
  const T* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * DV;
  T* op = o + (static_cast<size_t>(b) * hq + h) * s * DV;

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // this thread's rows: tr * 4 + i, i < 4
  const int tc = tid % 16;  // its key / output columns: tc + 16 * j

  for (int i = tid; i < BQ * dh; i += THREADS) {
    const int r = i / dh, c = i - r * dh;
    qs[r * ldq + c] = q0 + r < s ? to_f32(qp[static_cast<size_t>(q0 + r) * dh + c]) : 0.f;
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
    for (int i = tid; i < BK * dh; i += THREADS) {
      const int r = i / dh, c = i - r * dh;
      ks[r * ldq + c] = k0 + r < skv ? to_f32(kp[static_cast<size_t>(k0 + r) * dh + c]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i - r * DV;
      vs[i] = k0 + r < skv ? to_f32(vp[static_cast<size_t>(k0 + r) * DV + c]) : 0.f;
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
    for (int j = 0; j < NV; ++j)
      store(&op[static_cast<size_t>(r) * DV + tc + 16 * j], acc[i][j] * inv);
  }
}

size_t smem_bytes(int dh, int dv) {
  return sizeof(float) * (static_cast<size_t>(BQ + BK) * (dh + 1) +
                          static_cast<size_t>(BK) * dv + static_cast<size_t>(BQ) * LDP);
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                   int hkv, int s, int skv, int dh, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(dh, NV * 16);
  cudaError_t err = repro::allow_smem(flash_kernel<T, NV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_kernel<T, NV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s, skv, dh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nv, const void* q, const void* k, const void* v, void* o, int b,
                     int hq, int hkv, int s, int skv, int dh, float scale, int causal,
                     cudaStream_t st) {
#define REPRO_FLASH_CASE(N) \
  case N:                   \
    return launch<T, N>(q, k, v, o, b, hq, hkv, s, skv, dh, scale, causal, st);
  switch (nv) {
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
// all contiguous, all bf16 (is_bf16 = 1) or all f32.  dh and dv multiples of
// 16 in [16, 256], hq a multiple of hkv; the wrapper checks all of it.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                        int b, int hq, int hkv, int s, int skv, int dh,
                                        int dv, int causal, float scale, int is_bf16,
                                        void* stream) {
  if (dh % 16 || dv % 16 || dh < 16 || dv < 16 || dh > 256 || dv > 256 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(dh, dv) > repro::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = dv / 16;
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(nv, q, k, v, o, b, hq, hkv, s, skv, dh, scale, causal, st)
              : dispatch<float>(nv, q, k, v, o, b, hq, hkv, s, skv, dh, scale, causal, st);
  return static_cast<int>(err);
}
