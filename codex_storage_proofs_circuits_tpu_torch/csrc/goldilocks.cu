// Goldilocks (p = 2^64 - 2^32 + 1) hashes on Hopper: K4 (Poseidon2-GL t=12
// permutation / keyed digest compression), K5 (the same with Monolith-64)
// and K6 (rate-8 sponge, with either permutation).
//
// Replaces the Pallas TPU kernels of
// codex_storage_proofs_circuits_tpu/ops/goldilocks_pallas.py:
//   K4  _perm_kernel_gl, hash_fun="poseidon2"   (permutation, compress)
//   K5  _perm_kernel_gl, hash_fun="monolith"    (core: _mono_core_gl)
//   K6  _sponge8_kernel_gl, both cores          (sponge_digest_felts)
// The plain torch versions are ops/goldilocks_plain.py; the wrappers are
// ops/goldilocks_cuda.py.  The hash is a template parameter, so each
// (kernel, hash) pair is its own instantiation with its own launch count.
//
// Semantics (oracle/goldilocks.py): Poseidon2-GL is the initial external
// layer circ(2*M4, M4, M4), 4 external rounds (12 x^7 S-boxes), 22 internal
// rounds (x^7 on lane 0, then J + diag(mu - 1)), 4 external rounds.
// Monolith-64 is an initial Concrete, then 6 rounds of Bars (a bytewise map
// of the canonical values of lanes 0..3), Bricks (x_i += x_{i-1}^2 of the
// input lanes), Concrete (a 12 x 12 small-integer matrix) and round
// constants.  The sponge starts from zeros with the capacity IV in lane 11,
// adds each block of 8 felts into lanes 0..7 and permutes; the input gets
// `10*` felt padding (a 1, then zeros to a multiple of 8).
//
// What bounds it here: 64-bit modular multiplies.  Poseidon2-GL is 736 of
// them per permutation (8 x 48 in the external rounds, 22 x 16 in the
// internal ones), Monolith 66 plus the small-integer Concrete sums; the
// state is 12 words that stay in registers, and each thread reads and
// writes its own state once, so the integer multiply pipe sets the pace
// for Poseidon2 and memory comes close for Monolith.  The design is one
// thread per state, the 12 values as native uint64_t in registers, every
// round unrolled with its constants as immediate __constant__ operands.  A
// product is a * b and __umul64hi(a, b), reduced with 2^64 = 2^32 - 1 and
// 2^96 = -1 (mod p).  A linear layer with small integer entries sums each
// output row in 128 bits (two 64-bit sums of 32-bit halves) and reduces
// once.  Values stay below 2^64 between operations and are made canonical
// at exit.  The TPU kernel's 16-bit limb planes, lazy ripple/fold and
// (48, BT) limb-major rows answered the TPU vector unit's lack of a wide
// multiply and are not carried over.
//
// Layout at the boundary: int32 planes of 16-bit limbs.  A felt is read as
// its 4 limbs with a lane stride, a limb stride and a column stride, and
// packed into one uint64_t, so a compression reads a layer's even and odd
// columns in place (no stacked (12, 4, W) state), and K6 reads the encoded
// felts and pads them itself (no padded copy).

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks_constants.h"  // generated from fields/goldilocks.py

namespace {

constexpr int kThreads = 128;
constexpr uint64_t kP = 0xFFFFFFFF00000001ULL;
constexpr uint64_t kEps = 0xFFFFFFFFULL;  // 2^64 mod p

enum Hash { kPoseidon2 = 0, kMonolith = 1 };

__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  // hi * 2^64 + lo = lo + hl * (2^32 - 1) - hh  with hi = hh * 2^32 + hl
  uint64_t hh = hi >> 32, hl = hi & kEps;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= kEps;  // borrowed 2^64 = eps; t0 >= 2^64 - 2^32 here
  uint64_t t1 = (hl << 32) - hl;
  uint64_t r = t0 + t1;
  if (r < t1) r += kEps;  // carried 2^64 = eps; r <= 2^64 - 2^33 here
  return r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) {  // carried 2^64 = eps, possibly twice
    s += kEps;
    if (s < kEps) s += kEps;
  }
  return s;
}

__device__ __forceinline__ uint64_t gl_canon(uint64_t x) {
  return x >= kP ? x - kP : x;
}

// Not inlined: with sbox7 inlined into the unrolled Poseidon2-GL rounds,
// cicc of CUDA 12.9 crashes (segmentation fault) on this file for sm_90a.
// The call keeps the rounds unrolled; everything inside it is inlined.
__device__ __noinline__ uint64_t sbox7(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(gl_mul(x4, x2), x);
}

// s <- M s for a 12 x 12 matrix of small non-negative integers (row sums
// below 2^20): each row sums the 32-bit halves in 64 bits, then reduces once.
__device__ __forceinline__ void small_matvec(uint64_t s[12],
                                             const uint32_t (&m)[12][12]) {
  uint64_t out[12];
#pragma unroll
  for (int r = 0; r < 12; r++) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < 12; c++) {
      lo += (uint64_t)m[r][c] * (s[c] & 0xFFFFFFFFULL);
      hi += (uint64_t)m[r][c] * (s[c] >> 32);
    }
    uint64_t vlo = lo + (hi << 32);
    uint64_t vhi = (hi >> 32) + (vlo < lo);
    out[r] = gl_reduce128(vlo, vhi);
  }
#pragma unroll
  for (int r = 0; r < 12; r++) s[r] = out[r];
}

__device__ __forceinline__ void p2_external_round(uint64_t s[12], int r,
                                                  const uint32_t (&ext)[12][12]) {
#pragma unroll
  for (int i = 0; i < 12; i++) s[i] = sbox7(gl_add(s[i], GL_P2_EXT_RC[r][i]));
  small_matvec(s, ext);
}

__device__ __forceinline__ void poseidon2_gl(uint64_t s[12]) {
  constexpr uint32_t ext[12][12] = GL_P2_EXT_MATRIX;
  small_matvec(s, ext);
#pragma unroll
  for (int r = 0; r < GL_P2_RF / 2; r++) p2_external_round(s, r, ext);
#pragma unroll
  for (int k = 0; k < GL_P2_RP; k++) {
    s[0] = sbox7(gl_add(s[0], GL_P2_INT_RC[k]));
    uint64_t lo = 0, hi = 0;  // the lane sum in 128 bits
#pragma unroll
    for (int i = 0; i < 12; i++) {
      lo += s[i];
      hi += (lo < s[i]);
    }
    uint64_t tot = gl_reduce128(lo, hi);
#pragma unroll
    for (int i = 0; i < 12; i++) s[i] = gl_add(tot, gl_mul(s[i], GL_P2_DIAG[i]));
  }
#pragma unroll
  for (int r = GL_P2_RF / 2; r < GL_P2_RF; r++) p2_external_round(s, r, ext);
}

// Per-byte rotate left by k of the 8 bytes of x.
template <int K>
__device__ __forceinline__ uint64_t rotl_bytes(uint64_t x) {
  constexpr uint64_t hi_mask = 0x0101010101010101ULL * ((0xFFu << K) & 0xFFu);
  constexpr uint64_t lo_mask = 0x0101010101010101ULL * ((1u << K) - 1u);
  return ((x << K) & hi_mask) | ((x >> (8 - K)) & lo_mask);
}

__device__ __forceinline__ uint64_t bar64(uint64_t x) {
  // per byte: rotl1(x ^ (rotl1(~x) & rotl2(x) & rotl3(x)))
  uint64_t y = x ^ (rotl_bytes<1>(~x) & rotl_bytes<2>(x) & rotl_bytes<3>(x));
  return rotl_bytes<1>(y);
}

__device__ __forceinline__ void monolith(uint64_t s[12]) {
  constexpr uint32_t concrete[12][12] = GL_MONO_CONCRETE;
  small_matvec(s, concrete);
#pragma unroll
  for (int r = 0; r < GL_MONO_ROUNDS; r++) {
#pragma unroll
    for (int i = 0; i < GL_MONO_BARS; i++) s[i] = gl_canon(bar64(gl_canon(s[i])));
#pragma unroll
    for (int i = 11; i > 0; i--) s[i] = gl_add(s[i], gl_mul(s[i - 1], s[i - 1]));
    small_matvec(s, concrete);
#pragma unroll
    for (int i = 0; i < 12; i++) s[i] = gl_add(s[i], GL_MONO_RC[r][i]);
  }
}

template <int H>
__device__ __forceinline__ void permute(uint64_t s[12]) {
  if constexpr (H == kPoseidon2)
    poseidon2_gl(s);
  else
    monolith(s);
}

__device__ __forceinline__ uint64_t load_felt(const int32_t* p, long long limb_stride) {
  return (uint64_t)(uint32_t)p[0] | ((uint64_t)(uint32_t)p[limb_stride] << 16) |
         ((uint64_t)(uint32_t)p[2 * limb_stride] << 32) |
         ((uint64_t)(uint32_t)p[3 * limb_stride] << 48);
}

__device__ __forceinline__ void store_felt(int32_t* p, long long limb_stride, uint64_t v) {
#pragma unroll
  for (int k = 0; k < 4; k++) p[k * limb_stride] = (int32_t)((v >> (16 * k)) & 0xFFFFu);
}

// K4 / K5.  With y null, all 12 lanes come from x (a (12, 4, n) view);
// otherwise lanes 0..3 from x and 4..7 from y ((4, 4, n) views: a layer's
// even and odd columns), lane 8 is the Merkle key and lanes 9..11 are 0.
// Each view is given by pointer, lane stride, limb stride and column
// stride.  out is contiguous (out_lanes, 4, n), canonical.
template <int H>
__global__ void __launch_bounds__(kThreads)
gl_perm_kernel(const int32_t* __restrict__ x, long long xls, long long xks, long long xcs,
               const int32_t* __restrict__ y, long long yls, long long yks, long long ycs,
               int key, int32_t* __restrict__ out, int out_lanes, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[12];
  if (y == nullptr) {
#pragma unroll
    for (int i = 0; i < 12; i++) s[i] = load_felt(x + i * xls + b * xcs, xks);
  } else {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      s[i] = load_felt(x + i * xls + b * xcs, xks);
      s[4 + i] = load_felt(y + i * yls + b * ycs, yks);
    }
    s[8] = (uint64_t)key;
    s[9] = s[10] = s[11] = 0;
  }
  permute<H>(s);
#pragma unroll
  for (int i = 0; i < 12; i++)
    if (i < out_lanes) store_felt(out + i * 4 * n + b, n, gl_canon(s[i]));
}

// K6.  felts is an (nf, 4, n) view (felt stride, limb stride, column
// stride); out is contiguous (4, 4, n), the canonical digests.  The state
// stays in registers across all (nf + 8) / 8 permutations.
template <int H>
__global__ void __launch_bounds__(kThreads)
gl_sponge8_kernel(const int32_t* __restrict__ felts, long long fs, long long ks,
                  long long cs, int nf, int32_t* __restrict__ out, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 11; i++) s[i] = 0;
  s[11] = GL_SPONGE_IV;
  const int32_t* col = felts + b * cs;
  const int nblocks = (nf + GL_RATE) / GL_RATE;  // nf + 1 felts, rounded up
#pragma unroll 1
  for (int k = 0; k < nblocks; k++) {
#pragma unroll
    for (int j = 0; j < GL_RATE; j++) {
      int f = k * GL_RATE + j;
      uint64_t v = f < nf ? load_felt(col + f * fs, ks) : (f == nf ? 1 : 0);
      s[j] = gl_add(s[j], v);
    }
    permute<H>(s);
  }
#pragma unroll
  for (int i = 0; i < 4; i++) store_felt(out + i * 4 * n + b, n, gl_canon(s[i]));
}

inline unsigned n_blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// hash: 0 Poseidon2-GL (K4), 1 Monolith (K5).
int cspc_gl_perm(int hash, const int32_t* x, long long xls, long long xks, long long xcs,
                 const int32_t* y, long long yls, long long yks, long long ycs, int key,
                 int32_t* out, int out_lanes, long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hash != kPoseidon2 && hash != kMonolith) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (hash == kPoseidon2)
      gl_perm_kernel<kPoseidon2><<<n_blocks(n), kThreads, 0, st>>>(
          x, xls, xks, xcs, y, yls, yks, ycs, key, out, out_lanes, n);
    else
      gl_perm_kernel<kMonolith><<<n_blocks(n), kThreads, 0, st>>>(
          x, xls, xks, xcs, y, yls, yks, ycs, key, out, out_lanes, n);
  }
  return (int)cudaGetLastError();
}

// K6 with the core `hash` (0 Poseidon2-GL, 1 Monolith).
int cspc_gl_sponge8(int hash, const int32_t* felts, long long fs, long long ks,
                    long long cs, int nf, int32_t* out, long long n, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hash != kPoseidon2 && hash != kMonolith) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (hash == kPoseidon2)
      gl_sponge8_kernel<kPoseidon2><<<n_blocks(n), kThreads, 0, st>>>(
          felts, fs, ks, cs, nf, out, n);
    else
      gl_sponge8_kernel<kMonolith><<<n_blocks(n), kThreads, 0, st>>>(
          felts, fs, ks, cs, nf, out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
