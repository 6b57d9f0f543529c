// BN254 Poseidon2 t=3 on Hopper: K1 (permutation / keyed compression) and
// K2 (rate-2 sponge).
//
// Replaces the Pallas TPU kernels of
// codex_storage_proofs_circuits_tpu/ops/poseidon2_pallas.py:
//   K1  _perm_kernel     (permutation, compress)
//   K2  _sponge2_kernel  (sponge2_absorb)
// The plain torch versions are ops/poseidon2_plain.py.
//
// Semantics: initial linear layer, 4 external rounds, 56 internal rounds,
// 4 external rounds, x^5 S-box, all in Montgomery form with R = 2^256
// (the same R as the 16-bit limb planes at the boundary, so the values
// match the JAX planes bit for bit).  Inputs canonical (< P), outputs
// canonical.
//
// What bounds it here: integer multiply-add.  One permutation is about 240
// Montgomery products of 8x8 32-bit limbs; the state (3 field elements)
// and the running product fit in registers, and each thread reads and
// writes its own state once.  So the design is one thread per state, with
// the field element held as 8 x 32-bit limbs and CIOS Montgomery products on
// 64-bit accumulators (32x32->64 multiply-adds), fully reduced after every
// multiply and add.  The TPU's 16-bit limbs, lazy multi-threshold reduction
// and packed carry resolve answered the TPU VPU's lack of a wide multiply
// and are not carried over.  Round constants, keys and P sit in __constant__
// memory (every thread of a warp reads the same word: a broadcast); the
// round loops are not unrolled and the product is one called function,
// which keeps the code small.
//
// Layout: the (3, 16, B) / (nb, 2, 16, B) int32 planes of 16-bit limbs are
// read directly: thread b reads plane[i * row_stride + b * col_stride], so
// a warp's accesses are coalesced, and packs limb pairs into 32-bit words.
//
// Note the Montgomery quotient: the TPU code's mj = -acc0 rests on
// P == 1 (mod 2^16).  With 32-bit limbs the quotient factor is
// -P^-1 mod 2^32 = 0xEFFFFFFF (FR_PINV in the generated header).

#include <cstdint>
#include <cuda_runtime.h>

#include "poseidon2_bn254_constants.h"  // generated from fields/bn254.py

namespace {

constexpr int kThreads = 128;

struct Fr {
  uint32_t w[8];
};

__device__ __forceinline__ Fr fr_cond_sub_p(const uint32_t t[8]) {
  // t < 2P: return t - P if t >= P else t
  Fr d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t v = (uint64_t)t[i] - FR_P[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = v >> 63;
  }
  if (borrow) {
#pragma unroll
    for (int i = 0; i < 8; i++) d.w[i] = t[i];
  }
  return d;
}

__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  // a + b < 2P < 2^255: no carry out of the top word
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  return fr_cond_sub_p(t);
}

// Not inlined: with fr_mul inlined into the round functions, cicc of CUDA
// 12.9 crashes (segmentation fault) on this file for sm_90a.
__device__ __noinline__ Fr fr_mul(Fr a, Fr b) {
  // CIOS Montgomery product a * b * 2^-256 mod P
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];  // <= 2^64 - 1
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * FR_PINV;
    c = ((uint64_t)m * FR_P[0] + t[0]) >> 32;  // low word is 0 by choice of m
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * FR_P[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  // the result t[0..8] is < 2P < 2^255, so t[8] == 0
  return fr_cond_sub_p(t);
}

__device__ __forceinline__ Fr fr_const(const uint32_t (&k)[8]) {
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = k[i];
  return r;
}

__device__ __forceinline__ Fr sbox(const Fr& x) {
  Fr x2 = fr_mul(x, x);
  Fr x4 = fr_mul(x2, x2);
  return fr_mul(x4, x);
}

__device__ __forceinline__ void mix(Fr& x, Fr& y, Fr& z) {
  Fr s = fr_add(fr_add(x, y), z);
  x = fr_add(x, s);
  y = fr_add(y, s);
  z = fr_add(z, s);
}

__device__ __forceinline__ void external_round(Fr& x, Fr& y, Fr& z, int r) {
  x = sbox(fr_add(x, fr_const(P2_EXT_RC[r][0])));
  y = sbox(fr_add(y, fr_const(P2_EXT_RC[r][1])));
  z = sbox(fr_add(z, fr_const(P2_EXT_RC[r][2])));
  mix(x, y, z);
}

__device__ __forceinline__ void internal_round(Fr& x, Fr& y, Fr& z, int r) {
  // [[2,1,1],[1,2,1],[1,1,3]] @ (sbox(x + c), y, z)
  Fr sx = sbox(fr_add(x, fr_const(P2_INT_RC[r])));
  Fr u = fr_add(fr_add(sx, y), z);
  x = fr_add(u, sx);
  y = fr_add(u, y);
  z = fr_add(fr_add(u, z), z);
}

__device__ void permute(Fr& x, Fr& y, Fr& z) {
  mix(x, y, z);
#pragma unroll 1
  for (int r = 0; r < 4; r++) external_round(x, y, z, r);
#pragma unroll 1
  for (int r = 0; r < P2_N_INTERNAL; r++) internal_round(x, y, z, r);
#pragma unroll 1
  for (int r = 4; r < 8; r++) external_round(x, y, z, r);
}

__device__ __forceinline__ Fr load_fr(const int32_t* p, long long row_stride,
                                      long long off) {
  Fr v;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t lo = (uint32_t)p[(2 * i) * row_stride + off];
    uint32_t hi = (uint32_t)p[(2 * i + 1) * row_stride + off];
    v.w[i] = lo | (hi << 16);
  }
  return v;
}

__device__ __forceinline__ void store_fr(int32_t* p, long long row_stride,
                                         long long off, const Fr& v) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p[(2 * i) * row_stride + off] = (int32_t)(v.w[i] & 0xFFFFu);
    p[(2 * i + 1) * row_stride + off] = (int32_t)(v.w[i] >> 16);
  }
}

// K1.  Lanes x and y are (16, n) views given by pointer, row stride and
// column stride (so a layer's even and odd columns are read in place); lane
// z is a third such view, or the Montgomery key `key` when z is null.
// out is contiguous (out_lanes, 16, n), out_lanes 1 (compress) or 3.
__global__ void __launch_bounds__(kThreads)
p2_perm_kernel(const int32_t* __restrict__ x, long long xrs, long long xcs,
               const int32_t* __restrict__ y, long long yrs, long long ycs,
               const int32_t* __restrict__ z, long long zrs, long long zcs,
               int key, int32_t* __restrict__ out, int out_lanes, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  Fr X = load_fr(x, xrs, b * xcs);
  Fr Y = load_fr(y, yrs, b * ycs);
  Fr Z = z ? load_fr(z, zrs, b * zcs) : fr_const(P2_KEYS[key]);
  permute(X, Y, Z);
  store_fr(out, n, b, X);
  if (out_lanes == 3) {
    store_fr(out + 16 * n, n, b, Y);
    store_fr(out + 32 * n, n, b, Z);
  }
}

// K2.  blocks is contiguous (nb, 2, 16, n); out is (16, n).  The state
// stays in registers across all nb permutations.
__global__ void __launch_bounds__(kThreads)
p2_sponge2_kernel(const int32_t* __restrict__ blocks, int nb,
                  int32_t* __restrict__ out, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  Fr X = {}, Y = {};
  Fr Z = fr_const(P2_SPONGE2_IV);
#pragma unroll 1
  for (int k = 0; k < nb; k++) {
    const int32_t* blk = blocks + (long long)k * 32 * n;
    X = fr_add(X, load_fr(blk, n, b));
    Y = fr_add(Y, load_fr(blk + 16 * n, n, b));
    permute(X, Y, Z);
  }
  store_fr(out, n, b, X);
}

inline unsigned n_blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int cspc_p2_perm(const int32_t* x, long long xrs, long long xcs,
                 const int32_t* y, long long yrs, long long ycs,
                 const int32_t* z, long long zrs, long long zcs, int key,
                 int32_t* out, int out_lanes, long long n, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    p2_perm_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, xrs, xcs, y, yrs, ycs, z, zrs, zcs, key, out, out_lanes, n);
  return (int)cudaGetLastError();
}

int cspc_p2_sponge2(const int32_t* blocks, int nb, int32_t* out, long long n,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    p2_sponge2_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        blocks, nb, out, n);
  return (int)cudaGetLastError();
}

const char* cspc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
