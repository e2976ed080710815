// Sparse Cabin sketch construction: padded-COO rows -> packed d-bit sketches.
//
// Replaces the TPU kernel repro/kernels/cabin_build_sparse/kernel.py:
// cabin_build_sparse (body _cabin_sparse_kernel).  The TPU has no scatter
// or atomics, so it ORs each slot into its bucket through an O(N*m*d)
// compare-reduce.  Here one block owns one row: a d-bit bitmap lives in
// shared memory, each thread takes COO slots, hashes psi and pi in
// registers, and atomicOr-s the bit when psi is 1.  That is O(N*m) work.
//
// Bound on the H100: bytes.  Each row reads 8*m bytes of COO input and
// writes 4*ceil(d/32) bytes of sketch; the hashing is a few dozen integer
// operations per slot, far under the card's integer rate.  The design
// reads every input byte once (coalesced, thread k takes slot k) and
// writes every output word once; the bitmap never leaves shared memory.
//
// A bitmap of ceil(d/32) words fits shared memory up to d = 32 * 58112 =
// 1,859,584 bits.  Above that (kGlobal) the block zero-fills its own output
// row in device memory and atomicOr-s into it there: the same bits, at
// the cost of atomics that go to L2.
#include "common.cuh"

namespace {

template <bool kGlobal>
__global__ void cabin_sparse_kernel(const int32_t* __restrict__ indices,
                                    const int32_t* __restrict__ values,
                                    int32_t* __restrict__ out, int m, int d,
                                    int w, uint32_t psi_seed, uint32_t pi_seed) {
  extern __shared__ uint32_t smem_bitmap[];
  const size_t row = blockIdx.x;
  uint32_t* bitmap =
      kGlobal ? reinterpret_cast<uint32_t*>(out + row * w) : smem_bitmap;
  for (int i = threadIdx.x; i < w; i += blockDim.x) bitmap[i] = 0u;
  __syncthreads();

  const uint32_t psi_key = repro::seed_key(psi_seed);
  const uint32_t pi_key = repro::seed_key(pi_seed);
  const int32_t* idx = indices + row * m;
  const int32_t* val = values + row * m;
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const uint32_t v = static_cast<uint32_t>(val[k]);
    if (v == 0u) continue;  // padding / missing: psi(i, 0) = 0
    const uint32_t a = static_cast<uint32_t>(idx[k]);
    if (repro::psi_bit(a, v, psi_key)) {
      const uint32_t bucket = repro::pi_bucket(a, pi_key, static_cast<uint32_t>(d));
      atomicOr(&bitmap[bucket >> 5], 1u << (bucket & 31u));
    }
  }
  if (kGlobal) return;
  __syncthreads();
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    out[row * w + i] = static_cast<int32_t>(bitmap[i]);
}

}  // namespace

// indices, values: (n_rows, m) int32; out: (n_rows, ceil(d/32)) int32.
REPRO_EXPORT int cabin_build_sparse_launch(const void* indices, const void* values,
                                           void* out, int n_rows, int m, int d,
                                           unsigned int psi_seed,
                                           unsigned int pi_seed, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>((static_cast<int64_t>(d) + 31) / 32);
  const size_t smem = static_cast<size_t>(w) * sizeof(uint32_t);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int32_t*>(indices);
  const auto* vp = static_cast<const int32_t*>(values);
  auto* op = static_cast<int32_t*>(out);
  if (smem > repro::kMaxDynamicSmem) {
    if (n_rows > 0)
      cabin_sparse_kernel<true><<<n_rows, 128, 0, st>>>(ip, vp, op, m, d, w, psi_seed, pi_seed);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = repro::allow_smem(cabin_sparse_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0)
    cabin_sparse_kernel<false><<<n_rows, 128, smem, st>>>(ip, vp, op, m, d, w, psi_seed,
                                                          pi_seed);
  return static_cast<int>(cudaGetLastError());
}
