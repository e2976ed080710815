// Dense Cabin sketch construction: dense categorical rows -> packed d-bit
// sketches.
//
// Replaces the TPU kernel repro/kernels/cabin_build/kernel.py: cabin_build
// (body _cabin_kernel).  The TPU has no scatter or atomics, so it recasts
// the OR into d buckets as a {0,1} x one-hot matmul on the MXU, and needs
// d % 128 == 0 for its lanes.  Here the design is the sparse kernel's
// (cabin_build_sparse.cu): one block owns one row, a d-bit bitmap lives in
// shared memory, each thread strides over the row's n attributes, hashes
// psi and pi in registers and atomicOr-s the bit where psi is 1.  Value 0
// is missing (psi(j, 0) = 0).  Every d >= 1 is taken.
//
// Bound on the H100: bytes.  Each row reads 4*n bytes of categories and
// writes 4*ceil(d/32) bytes of sketch; a missing value costs one compare,
// a present one a few dozen integer operations, far under the card's
// integer rate.  Neighbouring threads read neighbouring attributes, so the
// row is read once and coalesced; the bitmap never leaves shared memory.
//
// A bitmap of ceil(d/32) words fits shared memory up to d = 32 * 58112 =
// 1,859,584 bits.  Above that (kGlobal) the block zero-fills its own output
// row in device memory and atomicOr-s into it there, as the sparse kernel
// does.
#include "common.cuh"

namespace {

template <bool kGlobal>
__global__ void cabin_dense_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                                   int n, int d, int w, uint32_t psi_seed, uint32_t pi_seed) {
  extern __shared__ uint32_t smem_bitmap[];
  const size_t row = blockIdx.x;
  uint32_t* bitmap =
      kGlobal ? reinterpret_cast<uint32_t*>(out + row * w) : smem_bitmap;
  for (int i = threadIdx.x; i < w; i += blockDim.x) bitmap[i] = 0u;
  __syncthreads();

  const uint32_t psi_key = repro::seed_key(psi_seed);
  const uint32_t pi_key = repro::seed_key(pi_seed);
  const int32_t* xr = x + row * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const uint32_t v = static_cast<uint32_t>(xr[j]);
    if (v == 0u) continue;  // missing: psi(j, 0) = 0
    const uint32_t a = static_cast<uint32_t>(j);
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

// x: (n_rows, n) int32, 0 = missing; out: (n_rows, ceil(d/32)) int32.
REPRO_EXPORT int cabin_build_launch(const void* x, void* out, int n_rows, int n, int d,
                                    unsigned int psi_seed, unsigned int pi_seed,
                                    void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>((static_cast<int64_t>(d) + 31) / 32);
  const size_t smem = static_cast<size_t>(w) * sizeof(uint32_t);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  auto* op = static_cast<int32_t*>(out);
  if (smem > repro::kMaxDynamicSmem) {
    if (n_rows > 0)
      cabin_dense_kernel<true><<<n_rows, 256, 0, st>>>(xp, op, n, d, w, psi_seed, pi_seed);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = repro::allow_smem(cabin_dense_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0)
    cabin_dense_kernel<false><<<n_rows, 256, smem, st>>>(xp, op, n, d, w, psi_seed, pi_seed);
  return static_cast<int>(cudaGetLastError());
}
