// Fake-data PRNG on Hopper: K3, the per-cell byte stream of the reference's
// mock data backend (oracle/slot.py gen_fake_cell; slot.nim:22-32).
//
// Replaces the Pallas TPU kernel codex_storage_proofs_circuits_tpu/ops/
// fake_prng.py::_prng_kernel (via _gen_pallas / gen_rows).  The plain torch
// version is ops/fake_prng.py::gen_rows_plain.
//
// Per cell, per byte:
//   s <- s * [(s + s1)(s + s2) + (s ^ 0x5A5A5A5A) + s1] + s2 + 17  (mod 2^64)
//   s <- s mod 1698428844001831;  emit the low byte of s
// with s1 = seed + 0xDEADCAFE, s2 = cell_index + 0x98765432 (mod 2^64).
//
// What bounds it here: the serial dependence chain of the recurrence (each
// byte needs the previous state) and the byte stores.  The TPU kernel ran
// the uint64 arithmetic on 16-bit limbs with a Barrett reduction because its
// VPU has no 64-bit multiply; here one thread per cell runs the recurrence
// in native unsigned 64-bit arithmetic, where wraparound is free and the
// modulus is a constant divisor.  Thousands of independent cells in flight
// hide the latency of each chain.  Row i of the output (cell_size, n) uint8
// is byte i of every cell, so a warp's byte stores are contiguous.
//
// The seeds are derived in the kernel from the two 4-limb bases and the cell
// index, so a chunk uploads 32 bytes of seed state.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint64_t kModulus = 1698428844001831ULL;

__device__ __forceinline__ uint64_t limbs4(const int32_t* v) {
  // four little-endian 16-bit limbs -> uint64
  return (uint64_t)(uint32_t)v[0] | ((uint64_t)(uint32_t)v[1] << 16) |
         ((uint64_t)(uint32_t)v[2] << 32) | ((uint64_t)(uint32_t)v[3] << 48);
}

__global__ void __launch_bounds__(kThreads)
fake_prng_rows_kernel(const int32_t* __restrict__ seed1_base,
                      const int32_t* __restrict__ seed2_base,
                      uint8_t* __restrict__ out, int n_steps, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const uint64_t s1 = limbs4(seed1_base);
  const uint64_t s2 = limbs4(seed2_base) + (uint64_t)b;
  const uint64_t s2p17 = s2 + 17;
  uint64_t s = 1;
#pragma unroll 4
  for (int i = 0; i < n_steps; i++) {
    uint64_t inner = (s + s1) * (s + s2) + (s ^ 0x5A5A5A5AULL) + s1;
    s = (s * inner + s2p17) % kModulus;
    out[(long long)i * n + b] = (uint8_t)s;
  }
}

}  // namespace

extern "C" int cspc_fake_prng_rows(const int32_t* seed1_base,
                                   const int32_t* seed2_base, uint8_t* out,
                                   int n_steps, long long n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && n_steps > 0)
    fake_prng_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                            0, (cudaStream_t)stream>>>(seed1_base, seed2_base,
                                                       out, n_steps, n);
  return (int)cudaGetLastError();
}
