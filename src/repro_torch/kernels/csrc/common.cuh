// Shared helpers of the repro_torch CUDA kernels.
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (nvcc -shared) and loaded from Python with ctypes.  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// The stateless hashes of repro_torch.core.hashing in native uint32_t
// arithmetic: murmur3's fmix32 and the seeded forms built on it.
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kM3 = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// hash_u32(x, seed) == mix32(x + seed_key(seed))
__device__ __forceinline__ uint32_t seed_key(uint32_t seed) {
  return mix32(seed * kM3);
}

// psi(a, v) = hash2_u32(a, v, psi_seed) & 1, with psi_key = seed_key(psi_seed)
__device__ __forceinline__ uint32_t psi_bit(uint32_t a, uint32_t v, uint32_t psi_key) {
  const uint32_t hx = mix32(a + psi_key);
  return mix32(hx ^ (v * kM3 + (hx >> 7))) & 1u;
}

// pi(a) = hash_u32(a, pi_seed) mod d, unsigned, with pi_key = seed_key(pi_seed)
__device__ __forceinline__ uint32_t pi_bucket(uint32_t a, uint32_t pi_key, uint32_t d) {
  return mix32(a + pi_key) % d;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Largest dynamic shared memory a block may ask for on sm_90.
constexpr size_t kMaxDynamicSmem = 232448;

// Raise a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

REPRO_EXPORT const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
