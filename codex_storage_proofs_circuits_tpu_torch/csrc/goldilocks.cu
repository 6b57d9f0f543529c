// Goldilocks (p = 2^64 - 2^32 + 1) hashes on Hopper: K4 (Poseidon2-GL t=12
// permutation / keyed digest compression), K5 (the same with Monolith-64)
// and K6 (rate-8 sponge, with either permutation: the whole cell-digest
// step, cell bytes in).  On the main path K4 and K5 are the subtree kernel,
// which makes many Merkle tree levels a launch.
//
// Replaces the Pallas TPU kernels of
// codex_storage_proofs_circuits_tpu/ops/goldilocks_pallas.py:
//   K4  _perm_kernel_gl, hash_fun="poseidon2"   (permutation, compress)
//   K5  _perm_kernel_gl, hash_fun="monolith"    (core: _mono_core_gl)
//   K6  _sponge8_kernel_gl, both cores          (sponge_digest_felts),
//       together with the byte encode that feeds it (JAX ops/gl_encode.py)
// The plain torch versions are ops/goldilocks_plain.py; the wrappers are
// ops/goldilocks_cuda.py.  The hash is a template parameter, so each
// (kernel, hash) pair is its own instantiation.
//
// Semantics (oracle/goldilocks.py): Poseidon2-GL is the initial external
// layer circ(2*M4, M4, M4), 4 external rounds (12 x^7 S-boxes), 22 internal
// rounds (x^7 on lane 0, then J + diag(mu - 1)), 4 external rounds.
// Monolith-64 is an initial Concrete, then 6 rounds of Bars (a bytewise map
// of the canonical values of lanes 0..3), Bricks (x_i += x_{i-1}^2 of the
// input lanes), Concrete (a 12 x 12 small-integer circulant plus a
// diagonal) and round constants.  The sponge starts from zeros with the
// capacity IV in lane 11, adds each block of 8 felts into lanes 0..7 and
// permutes; the input gets `10*` felt padding (a 1, then zeros to a
// multiple of 8).  A cell's bytes get `10*` byte padding to a multiple of
// 62 bytes, and each 62-byte chunk splits little-endian into 8 felts of 62
// bits: one block.  A 2048-byte cell is 34 chunks, then the padding block:
// 35 permutations.  A Merkle compression permutes (left digest, right
// digest, key, 0, 0, 0) and keeps lanes 0..3.
//
// What bounds it here: 64-bit modular multiplies, and for the tree the
// latency of one permutation.  Poseidon2-GL is 736 products per
// permutation (8 x 48 in the external rounds, 22 x 16 in the internal
// ones), Monolith 66 squares plus the Concrete's shifts and adds; the state
// is 12 words that stay in registers, so the integer multiply pipe and the
// instruction rate set the pace.  The design is one thread per state (or three,
// below), the 12 values as native uint64_t below 2^64 (made canonical at
// exit), and a field core that runs few instructions:
//  - a product is one PTX block of 32-bit multiply-adds (4 wide products,
//    their carries in the chain; an addend rides in the chain for free, so
//    the internal layer's s_i * d_i + sum and Monolith's Bricks reduce
//    once) and a branch-free reduction with
//    2^64 = 2^32 - 1 and 2^96 = -1 (mod p) in sub.cc/subc and add.cc/addc
//    chains; x^7 is x^2, then x^3 and x^4 side by side, then x^7;
//  - an addition folds its carries (2^64 = 2^32 - 1) in a carry chain;
//  - the external layer is the M4 addition chain of JAX ops/gl_core.py
//    (block b of the output is M4 (x_b + x_0 + x_1 + x_2)), run on the
//    32-bit halves of the lanes in 64-bit sums and joined and reduced once
//    per lane, in place of a 12 x 12 multiply-add matvec;
//  - Monolith's Concrete is the cyclic convolution it is: 4-point sums and
//    differences of the halves, three 3-point convolutions with small
//    constants (powers of two up to sign for this matrix: shifts, no wide
//    multiply) and the inverse sums, in place of 288 wide multiply-adds;
//  - the round loops are rolled.  x^7 is one called function in K6, whose
//    35 permutations a thread then run from a small loop body, and inlined
//    in K4, a single permutation a thread: each measured the faster of the
//    two on an H100 (PERF.md).  Unrolled rounds measured slower in both.
//    With the product in asm, cicc compiles x^7 inlined into the rounds
//    (a C++ product made cicc of CUDA 12.9 crash there).
// The subtree kernel (gl_tree_kernel) reduces a tile of 2^11 digests 11
// levels in one CTA, the levels above the first in shared memory, and one
// CTA takes a layer of at most 2^11 digests to its roots: a 2^18-digest
// chunk is two launches where it was 18.  Below some 2^14 compressions a
// level waits on one permutation's latency, not on the card's width, so a
// narrow Poseidon2-GL level runs each permutation on a trio of threads
// (four lanes each, cross-block sums by warp shuffles), which shortens that
// chain.
// The TPU kernel's 16-bit limb planes, lazy ripple/fold and (48, BT)
// limb-major rows answered the TPU vector unit's lack of a wide multiply
// and are not carried over.
//
// Layout at the boundary: cell bytes (K6: byte i of cell b at rows[i *
// row_stride + b * col_stride], the (cell_size, B) rows the PRNG emits or a
// (B, cell_size).T view), or int32 planes of 16-bit limbs.  A felt is read
// as its 4 limbs with a lane stride, a limb stride and a column stride, and
// packed into one uint64_t, so a compression reads a layer's even and odd
// columns in place.  Digests are written as canonical (4, 4, n) planes.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks_constants.h"  // generated from fields/goldilocks.py

namespace {

constexpr int kThreads = 128;
constexpr uint64_t kEps = 0xFFFFFFFFULL;  // 2^64 mod p

enum Hash { kPoseidon2 = 0, kMonolith = 1 };

__device__ __forceinline__ uint64_t pack64(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// The 128-bit value r3:r2:r1:r0 -> a value below 2^64 congruent to it:
// lo + r2 * (2^32 - 1) - r3 with lo = r1:r0, each 2^64 borrowed or carried
// folded back as 2^32 - 1.  The borrow fold cannot borrow again (lo - r3 +
// 2^64 >= 2^64 - 2^32), nor the carry fold carry (the sum less 2^64 is at
// most 2^64 - 2^33).
__device__ __forceinline__ uint64_t gl_reduce128(uint32_t r0, uint32_t r1, uint32_t r2,
                                                 uint32_t r3) {
  uint32_t lo, hi;
  asm("{\n\t"
      ".reg .u32 rbw, ru0, ru1, rc;\n\t"
      "sub.cc.u32  %0, %2, %5;\n\t"
      "subc.cc.u32 %1, %3, 0;\n\t"
      "subc.u32    rbw, 0, 0;\n\t"
      "sub.cc.u32  %0, %0, rbw;\n\t"
      "subc.u32    %1, %1, 0;\n\t"
      "sub.cc.u32  ru0, 0, %4;\n\t"
      "subc.u32    ru1, %4, 0;\n\t"
      "add.cc.u32  %0, %0, ru0;\n\t"
      "addc.cc.u32 %1, %1, ru1;\n\t"
      "addc.u32    rc, 0, 0;\n\t"
      "sub.u32     rc, 0, rc;\n\t"
      "add.cc.u32  %0, %0, rc;\n\t"
      "addc.u32    %1, %1, 0;\n\t"
      "}"
      : "=r"(lo), "=r"(hi)
      : "r"(r0), "r"(r1), "r"(r2), "r"(r3));
  return pack64(lo, hi);
}

__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  return gl_reduce128((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
}

// a * b + c: the four 32 x 32 -> 64 products and c summed into 128 bits
// (below 2^128: (2^64 - 1)^2 + 2^64 - 1), then reduced.  c rides in the
// first chain, so it costs no instruction.  (Here wide multiply-adds
// measured slower than this chain: the 12 lanes already give each thread
// independent products to interleave.)
__device__ __forceinline__ uint64_t gl_mul_add(uint64_t a, uint64_t b, uint64_t c) {
  uint32_t r0, r1, r2, r3;
  asm("mad.lo.cc.u32  %0, %4, %6, %8;\n\t"
      "madc.hi.cc.u32 %1, %4, %6, %9;\n\t"
      "madc.lo.cc.u32 %2, %5, %7, %10;\n\t"
      "madc.hi.u32    %3, %5, %7, %10;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %7, %2;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "addc.u32       %3, %3, 0;"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)), "r"((uint32_t)c), "r"((uint32_t)(c >> 32)), "r"(0u));
  return gl_reduce128(r0, r1, r2, r3);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_mul_add(a, b, 0);
}

// a + b folded below 2^64: a carry of 2^64 adds 2^32 - 1, which can carry
// once more; the third fold cannot (the value is then below 2^33).
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint32_t lo, hi;
  asm("{\n\t"
      ".reg .u32 rc;\n\t"
      "add.cc.u32  %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32    rc, 0, 0;\n\t"
      "sub.u32     rc, 0, rc;\n\t"
      "add.cc.u32  %0, %0, rc;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32    rc, 0, 0;\n\t"
      "sub.u32     rc, 0, rc;\n\t"
      "add.cc.u32  %0, %0, rc;\n\t"
      "addc.u32    %1, %1, 0;\n\t"
      "}"
      : "=r"(lo), "=r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)));
  return pack64(lo, hi);
}

// x mod p for x < 2^64: x >= p exactly when x + (2^32 - 1) carries.
__device__ __forceinline__ uint64_t gl_canon(uint64_t x) {
  uint64_t t = x + kEps;
  return t < x ? t : x;
}

__device__ __forceinline__ uint64_t x7(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x3 = gl_mul(x2, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(x4, x3);
}

__device__ __noinline__ uint64_t x7_call(uint64_t x) { return x7(x); }

// The S-box: x^7 as a call (kCall, K6) or inlined (K4).
template <bool kCall>
__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  if constexpr (kCall)
    return x7_call(x);
  else
    return x7(x);
}

// lo + hi * 2^32 (each below 2^64), reduced below 2^64.
__device__ __forceinline__ uint64_t join_halves(uint64_t lo, uint64_t hi) {
  uint64_t v = lo + (hi << 32);
  return gl_reduce128((uint32_t)v, (uint32_t)(v >> 32),
                      (uint32_t)(hi >> 32) + (uint32_t)(v < lo), 0u);
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by its addition chain
// (JAX ops/gl_core.py::_m4_chain), on integers: each output is below 16
// times the largest input.
__device__ __forceinline__ void m4(uint64_t* x) {
  uint64_t t0 = x[0] + x[1], t1 = x[2] + x[3];
  uint64_t t2 = (x[1] << 1) + t1, t3 = (x[3] << 1) + t0;
  uint64_t t4 = (t1 << 2) + t3, t5 = (t0 << 2) + t2;
  x[0] = t3 + t5;
  x[1] = t5;
  x[2] = t2 + t4;
  x[3] = t4;
}

// s <- circ(2 M4, M4, M4) s, on the 32-bit halves of the lanes: the row
// sums are 64, so each half's outputs stay below 2^38.
__device__ __forceinline__ void external_layer(uint64_t s[12]) {
  uint64_t h[2][12];
#pragma unroll
  for (int i = 0; i < 12; i++) {
    h[0][i] = s[i] & 0xFFFFFFFFULL;
    h[1][i] = s[i] >> 32;
  }
#pragma unroll
  for (int half = 0; half < 2; half++) {
    uint64_t* x = h[half];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      uint64_t sum = x[j] + x[4 + j] + x[8 + j];
#pragma unroll
      for (int blk = 0; blk < 3; blk++) x[4 * blk + j] += sum;
    }
#pragma unroll
    for (int blk = 0; blk < 3; blk++) m4(x + 4 * blk);
  }
#pragma unroll
  for (int i = 0; i < 12; i++) s[i] = join_halves(h[0][i], h[1][i]);
}

// Monolith's Concrete, M = circ(c) + diag(d) (fields/goldilocks.py), as
// the cyclic convolution it is, on the 32-bit halves of the lanes.  Lane i
// sits at (i mod 4, i mod 3) (i = 9a + 4b mod 12), so the length-12
// convolution is a 4 x 3 two-dimensional one.  Along the 4-axis it splits
// into the rings Z (at s = 1), Z (s = -1) and Z[s]/(s^2 + 1) by sums and
// differences; in each ring it is a 3-point cyclic convolution with the
// transformed first column of c, whose values (scaled by the inverse
// transform's 1/4, and 1/2 in the complex ring, so all integers; derived in
// kernels/build.py) are the GL_MONO_CONC_* tables: for this matrix 1, 2, 4,
// 8, 16 or 32 up to sign, shifts and adds with no wide multiply; then the
// inverse sums.  All in uint64_t modulo 2^64: each output is the exact row
// sum (below 2^41), so the wrap-arounds of the signed steps cancel.
__host__ __device__ constexpr int crt12(int a, int b) { return (9 * a + 4 * b) % 12; }

__device__ __forceinline__ void concrete_half(const uint64_t x[12], uint64_t y[12]) {
  constexpr int64_t k1[3] = GL_MONO_CONC_K1, km[3] = GL_MONO_CONC_KM;
  constexpr int64_t kr[3] = GL_MONO_CONC_KR, ki[3] = GL_MONO_CONC_KI;
  uint64_t p1[3], pm[3], pr[3], pi[3];
#pragma unroll
  for (int b = 0; b < 3; b++) {
    const uint64_t v0 = x[crt12(0, b)], v1 = x[crt12(1, b)];
    const uint64_t v2 = x[crt12(2, b)], v3 = x[crt12(3, b)];
    const uint64_t e = v0 + v2, o = v1 + v3;
    p1[b] = e + o;
    pm[b] = e - o;
    pr[b] = v0 - v2;
    pi[b] = v1 - v3;
  }
#pragma unroll
  for (int b = 0; b < 3; b++) {
    uint64_t z1 = 0, zm = 0, zr = 0, zi = 0;
#pragma unroll
    for (int j = 0; j < 3; j++) {
      const int i = (b - j + 3) % 3;
      z1 += (uint64_t)k1[j] * p1[i];
      zm += (uint64_t)km[j] * pm[i];
      zr += (uint64_t)kr[j] * pr[i] - (uint64_t)ki[j] * pi[i];
      zi += (uint64_t)kr[j] * pi[i] + (uint64_t)ki[j] * pr[i];
    }
    const uint64_t e = z1 + zm, o = z1 - zm;
    y[crt12(0, b)] = e + zr;
    y[crt12(1, b)] = o + zi;
    y[crt12(2, b)] = e - zr;
    y[crt12(3, b)] = o - zi;
  }
}

// s <- M s, and with kRound the round constants of round r added to the
// exact row sums' halves before the one reduction (a third operand of the
// adds), in place of a modular addition a lane.
template <bool kRound>
__device__ __forceinline__ void concrete(uint64_t s[12], int r) {
  constexpr uint64_t diag[12] = GL_MONO_CONC_DIAG;
  uint64_t h[2][12], y[2][12];
#pragma unroll
  for (int i = 0; i < 12; i++) {
    h[0][i] = s[i] & 0xFFFFFFFFULL;
    h[1][i] = s[i] >> 32;
  }
#pragma unroll
  for (int half = 0; half < 2; half++) {
    concrete_half(h[half], y[half]);
#pragma unroll
    for (int i = 0; i < 12; i++) {
      if (diag[i]) y[half][i] += diag[i] * h[half][i];
      if constexpr (kRound)
        y[half][i] += half ? GL_MONO_RC[r][i] >> 32 : GL_MONO_RC[r][i] & 0xFFFFFFFFULL;
    }
  }
#pragma unroll
  for (int i = 0; i < 12; i++) s[i] = join_halves(y[0][i], y[1][i]);
}

template <bool kCall>
__device__ __forceinline__ void p2_external_round(uint64_t s[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; i++) s[i] = sbox7<kCall>(gl_add(s[i], GL_P2_EXT_RC[r][i]));
  external_layer(s);
}

template <bool kCall>
__device__ __forceinline__ void p2_internal_round(uint64_t s[12], int k) {
  s[0] = sbox7<kCall>(gl_add(s[0], GL_P2_INT_RC[k]));
  uint64_t lo = 0, hi = 0;  // the lane sum in 128 bits
#pragma unroll
  for (int i = 0; i < 12; i++) {
    lo += s[i];
    hi += (lo < s[i]);
  }
  uint64_t tot = gl_reduce128(lo, hi);
#pragma unroll
  for (int i = 0; i < 12; i++) s[i] = gl_mul_add(s[i], GL_P2_DIAG[i], tot);
}

template <bool kCall>
__device__ __forceinline__ void poseidon2_gl(uint64_t s[12]) {
  external_layer(s);
#pragma unroll 1
  for (int r = 0; r < GL_P2_RF / 2; r++) p2_external_round<kCall>(s, r);
#pragma unroll 1
  for (int k = 0; k < GL_P2_RP; k++) p2_internal_round<kCall>(s, k);
#pragma unroll 1
  for (int r = GL_P2_RF / 2; r < GL_P2_RF; r++) p2_external_round<kCall>(s, r);
}

// Poseidon2-GL on a trio: three threads of one warp share a state, thread
// q holding lanes 4q..4q+3 (one M4 block), so each runs a third of the
// S-boxes and internal-layer products of a permutation.  The external
// layer's cross-block sums take two shuffles of each 32-bit half; an
// internal round runs lane 0's S-box on thread 0, sums each thread's lanes,
// and exchanges the three partial sums.  Every thread forms the same
// value mod p (in its own order), so the outputs equal the one-thread
// permutation's once canonical.
struct Trio {
  unsigned mask;  // the warp's lanes taking part
  int q;          // this thread's block of lanes
  int up, down;   // the lanes of the trio's threads q + 1 and q + 2 (mod 3)
};

__device__ __forceinline__ uint64_t shfl64(unsigned mask, uint64_t v, int src) {
  return pack64(__shfl_sync(mask, (uint32_t)v, src), __shfl_sync(mask, (uint32_t)(v >> 32), src));
}

__device__ __forceinline__ void external_layer_trio(uint64_t s[4], const Trio& t) {
  uint64_t h[2][4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    h[0][i] = s[i] & 0xFFFFFFFFULL;
    h[1][i] = s[i] >> 32;
  }
#pragma unroll
  for (int half = 0; half < 2; half++) {
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const uint32_t v = (uint32_t)h[half][j];
      h[half][j] += (uint64_t)v + __shfl_sync(t.mask, v, t.up) + __shfl_sync(t.mask, v, t.down);
    }
    m4(h[half]);
  }
#pragma unroll
  for (int i = 0; i < 4; i++) s[i] = join_halves(h[0][i], h[1][i]);
}

__device__ __forceinline__ void p2_external_round_trio(uint64_t s[4], const Trio& t, int r) {
#pragma unroll
  for (int i = 0; i < 4; i++) s[i] = x7(gl_add(s[i], GL_P2_EXT_RC[r][4 * t.q + i]));
  external_layer_trio(s, t);
}

__device__ __forceinline__ void poseidon2_gl_trio(uint64_t s[4], const Trio& t) {
  uint64_t diag[4];
#pragma unroll
  for (int i = 0; i < 4; i++) diag[i] = GL_P2_DIAG[4 * t.q + i];
  external_layer_trio(s, t);
#pragma unroll 1
  for (int r = 0; r < GL_P2_RF / 2; r++) p2_external_round_trio(s, t, r);
#pragma unroll 1
  for (int k = 0; k < GL_P2_RP; k++) {
    if (t.q == 0) s[0] = x7(gl_add(s[0], GL_P2_INT_RC[k]));
    uint64_t lo = 0, hi = 0;  // this thread's lanes, lane 0 last
#pragma unroll
    for (int i = 3; i >= 0; i--) {
      lo += s[i];
      hi += (lo < s[i]);
    }
    const uint64_t part = gl_reduce128(lo, hi);
    const uint64_t tot =
        gl_add(gl_add(part, shfl64(t.mask, part, t.up)), shfl64(t.mask, part, t.down));
#pragma unroll
    for (int i = 0; i < 4; i++) s[i] = gl_mul_add(s[i], diag[i], tot);
  }
#pragma unroll 1
  for (int r = GL_P2_RF / 2; r < GL_P2_RF; r++) p2_external_round_trio(s, t, r);
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
  concrete<false>(s, 0);
#pragma unroll 1
  for (int r = 0; r < GL_MONO_ROUNDS; r++) {
#pragma unroll
    for (int i = 0; i < GL_MONO_BARS; i++) s[i] = gl_canon(bar64(gl_canon(s[i])));
#pragma unroll
    for (int i = 11; i > 0; i--) s[i] = gl_mul_add(s[i - 1], s[i - 1], s[i]);
    concrete<true>(s, r);
  }
}

// kCall: x^7 as a call (Poseidon2-GL only; Monolith has no x^7).
template <int H, bool kCall>
__device__ __forceinline__ void permute(uint64_t s[12]) {
  if constexpr (H == kPoseidon2)
    poseidon2_gl<kCall>(s);
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

// K6 source: an (nf, 4, n) felt view (felt stride, limb stride, column
// stride), with the `10*` felt padding applied here.
struct PlaneFelts {
  const int32_t* felts;
  long long fs, ks, cs;
  int nf;

  __device__ int nblocks() const { return (nf + GL_RATE) / GL_RATE; }  // nf + 1, rounded up
  __device__ void block(long long b, int k, uint64_t f[GL_RATE]) const {
    const int32_t* col = felts + b * cs;
#pragma unroll
    for (int j = 0; j < GL_RATE; j++) {
      int i = k * GL_RATE + j;
      f[j] = i < nf ? load_felt(col + i * fs, ks) : (i == nf ? 1 : 0);
    }
  }
};

// K6 source: cell bytes, byte i of cell b at rows[i * rs + b * cs]; nch =
// ceil((cell + 1) / 62) chunks of 8 felts, then the padding block [1, 0..0].
struct ByteRows {
  const uint8_t* rows;
  long long rs, cs;
  int cell, nch;

  __device__ int nblocks() const { return nch + 1; }
  __device__ void block(long long b, int k, uint64_t f[GL_RATE]) const {
    if (k == nch) {
#pragma unroll
      for (int j = 0; j < GL_RATE; j++) f[j] = j == 0;
      return;
    }
    const uint8_t* col = rows + b * cs;
    uint32_t w[16];  // the 62 bytes of chunk k, little-endian, 2 zero bytes
#pragma unroll
    for (int q = 0; q < 16; q++) w[q] = 0;
    const int base = 62 * k;
#pragma unroll
    for (int t = 0; t < 62; t++) {
      const int i = base + t;
      uint32_t v = i < cell ? (uint32_t)col[(long long)i * rs] : (i == cell ? 1u : 0u);
      w[t / 4] |= v << (8 * (t % 4));
    }
#pragma unroll
    for (int j = 0; j < GL_RATE; j++) {  // felt j: bits 62j .. 62j + 61
      constexpr int kBits = 62;
      const int q = kBits * j / 32, sh = kBits * j % 32;
      uint64_t v = pack64(w[q], w[q + 1]) >> sh;
      if (sh > 2) v |= (uint64_t)w[q + 2] << (64 - sh);
      f[j] = v & ((1ULL << kBits) - 1);
    }
  }
};

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
  permute<H, false>(s);
#pragma unroll
  for (int i = 0; i < 12; i++)
    if (i < out_lanes) store_felt(out + i * 4 * n + b, n, gl_canon(s[i]));
}

// K6.  Absorbs src's blocks of 8 felts; out is contiguous (4, 4, n), the
// canonical digests.  The state stays in registers across all permutations.
template <int H, class Src>
__global__ void __launch_bounds__(kThreads)
gl_sponge8_kernel(Src src, int32_t* __restrict__ out, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 11; i++) s[i] = 0;
  s[11] = GL_SPONGE_IV;
  const int nb = src.nblocks();
#pragma unroll 1
  for (int k = 0; k < nb; k++) {
    uint64_t f[GL_RATE];
    src.block(b, k, f);
#pragma unroll
    for (int j = 0; j < GL_RATE; j++) s[j] = gl_add(s[j], f[j]);
    permute<H, true>(s);
  }
#pragma unroll
  for (int i = 0; i < 4; i++) store_felt(out + i * 4 * n + b, n, gl_canon(s[i]));
}

// The subtree kernel: K4 / K5 on the main path.  A CTA takes `tile`
// consecutive digests of the (4, 4, w) layer x (lane, limb and column
// strides) and reduces them `levels` levels: the first level's keyed
// compressions read x's column pairs from device memory, every later one
// reads the level below from shared memory (packed uint64_t, lane-major,
// two buffers taking turns), and every node of every level is written,
// canonical, to that level's (4, 4, w >> j) plane in `out` (level 1 at out,
// each next level right after the one before).  Level j uses key bit j - 1
// of key_mask.  A level with more nodes than trios runs one permutation a
// thread; a narrower Poseidon2-GL level runs one a trio, which shortens the
// chain of each of the top levels, where a thread's permutation latency
// sets the pace.  Monolith always runs one a thread.
//
// The constants were chosen on an H100 by tools_torch/tile_sweep.py (PERF.md):
// a tile of 2^11 digests, so a 2^18-digest chunk is one wave of 128 CTAs of
// 1024 threads (at most 64 registers) and then one CTA of 512 threads for
// the top 7 levels; trios took a quarter off the Poseidon2-GL chunk tree.
constexpr int kTreeTileLog = 11;  // levels (and log2 of the digests) of a CTA of the wide launch
constexpr int kTreeThreads = 1 << (kTreeTileLog - 1);  // one per first-level compression
constexpr bool kTrios = true;     // narrow Poseidon2-GL levels run a permutation a trio
constexpr int kTopLog = 11;       // a layer of at most 2^11 digests is one CTA's
constexpr int kTopThreads = 512;

template <int H, int NT>
__global__ void __launch_bounds__(NT)
gl_tree_kernel(const int32_t* __restrict__ x, long long xls, long long xks, long long xcs,
               int32_t* __restrict__ out, long long w, int levels, long long tile,
               unsigned key_mask) {
  extern __shared__ uint64_t smem[];
  constexpr int kTriosPerCta = NT / 32 * 10;  // ten trios a warp, lanes 30 and 31 idle
  const long long base = (long long)blockIdx.x * tile;
  const long long cnt = min(tile, w - base);
  // two buffers: odd levels are written to the first, even ones to the second
  const long long cap0 = tile / 2, cap1 = max(tile / 4, 1LL);
  uint64_t* const buf0 = smem;
  uint64_t* const buf1 = smem + 4 * cap0;
  int32_t* lvl = out;
  for (int j = 1; j <= levels; j++) {
    const long long n = cnt >> j, gw = w >> j, gb = base >> j;
    const uint64_t key = (key_mask >> (j - 1)) & 1u;
    const bool odd = j & 1;
    const uint64_t* src = odd ? buf1 : buf0;
    const long long scap = odd ? cap1 : cap0;
    uint64_t* dst = odd ? buf0 : buf1;
    const long long dcap = odd ? cap0 : cap1;
    // lane l of child c (0 or 1) of node i
    auto child = [&](long long i, int c, int l) -> uint64_t {
      const long long k = 2 * i + c;
      return j == 1 ? load_felt(x + l * xls + (base + k) * xcs, xks) : src[l * scap + k];
    };
    auto emit = [&](long long i, const uint64_t* d) {
#pragma unroll
      for (int l = 0; l < 4; l++) {
        const uint64_t v = gl_canon(d[l]);
        if (j < levels) dst[l * dcap + i] = v;
        store_felt(lvl + l * 4 * gw + gb + i, gw, v);
      }
    };
    bool trio = false;
    if constexpr (H == kPoseidon2 && kTrios) trio = n <= kTriosPerCta;
    if (trio) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int m = (int)min(max(n - warp * 10LL, 0LL), 10LL);  // this warp's trios
      if (lane < 3 * m) {
        const int q = lane % 3, first = lane - q;
        const Trio t{(1u << (3 * m)) - 1u, q, first + (q + 1) % 3, first + (q + 2) % 3};
        const long long i = warp * 10LL + lane / 3;
        uint64_t s[4];
#pragma unroll
        for (int l = 0; l < 4; l++) s[l] = q < 2 ? child(i, q, l) : (l == 0 ? key : 0);
        poseidon2_gl_trio(s, t);
        if (q == 0) emit(i, s);
      }
    } else {
      for (long long i = threadIdx.x; i < n; i += NT) {
        uint64_t s[12];
#pragma unroll
        for (int l = 0; l < 4; l++) {
          s[l] = child(i, 0, l);
          s[4 + l] = child(i, 1, l);
        }
        s[8] = key;
        s[9] = s[10] = s[11] = 0;
        permute<H, false>(s);
        emit(i, s);
      }
    }
    __syncthreads();
    lvl += 16 * gw;
  }
}

template <int H>
cudaError_t launch_tree(const int32_t* x, long long xls, long long xks, long long xcs,
                        int32_t* out, long long w, int levels, long long tile, unsigned key_mask,
                        cudaStream_t st) {
  const unsigned grid = (unsigned)((w + tile - 1) / tile);
  const size_t smem = (size_t)(tile / 2 + std::max(tile / 4, 1LL)) * 4 * sizeof(uint64_t);
  if (tile == w)
    gl_tree_kernel<H, kTopThreads><<<grid, kTopThreads, smem, st>>>(
        x, xls, xks, xcs, out, w, levels, tile, key_mask);
  else
    gl_tree_kernel<H, kTreeThreads><<<grid, kTreeThreads, smem, st>>>(
        x, xls, xks, xcs, out, w, levels, tile, key_mask);
  return cudaGetLastError();
}

inline unsigned n_blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <class Src>
int launch_sponge8(int hash, const Src& src, int32_t* out, long long n, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hash != kPoseidon2 && hash != kMonolith) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (hash == kPoseidon2)
      gl_sponge8_kernel<kPoseidon2, Src><<<n_blocks(n), kThreads, 0, st>>>(src, out, n);
    else
      gl_sponge8_kernel<kMonolith, Src><<<n_blocks(n), kThreads, 0, st>>>(src, out, n);
  }
  return (int)cudaGetLastError();
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

// The subtree kernel, one launch: reduces the (4, 4, w) layer x by as many
// of `levels` levels as one launch takes (all of them when w <= 2^11, in
// one CTA; else min(levels, 11) in CTAs of 2^11 digests), writing each
// level's canonical (4, 4, w >> j) plane into out one after another, level
// j with the key bit j - 1 of key_mask.  *done is set to the levels made.
// w must be a multiple of 2^(levels made).
int cspc_gl_tree(int hash, const int32_t* x, long long xls, long long xks, long long xcs,
                 int32_t* out, long long w, int levels, unsigned key_mask, int* done, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((hash != kPoseidon2 && hash != kMonolith) || levels < 1 || levels > 31 || w < 2)
    return (int)cudaErrorInvalidValue;
  const bool top = w <= (1LL << kTopLog);
  const int lev = top ? levels : std::min(levels, kTreeTileLog);
  if (w % (1LL << lev)) return (int)cudaErrorInvalidValue;
  const long long tile = top ? w : (1LL << kTreeTileLog);
  cudaStream_t st = (cudaStream_t)stream;
  err = hash == kPoseidon2
            ? launch_tree<kPoseidon2>(x, xls, xks, xcs, out, w, lev, tile, key_mask, st)
            : launch_tree<kMonolith>(x, xls, xks, xcs, out, w, lev, tile, key_mask, st);
  *done = lev;
  return (int)err;
}

// K6 with the core `hash` (0 Poseidon2-GL, 1 Monolith) over an (nf, 4, n)
// felt view.
int cspc_gl_sponge8(int hash, const int32_t* felts, long long fs, long long ks,
                    long long cs, int nf, int32_t* out, long long n, int device,
                    void* stream) {
  return launch_sponge8(hash, PlaneFelts{felts, fs, ks, cs, nf}, out, n, device, stream);
}

// K6 with the core `hash` over cell bytes: byte i of cell b at
// rows[i * row_stride + b * col_stride].
int cspc_gl_sponge8_rows(int hash, const uint8_t* rows, long long row_stride,
                         long long col_stride, int cell_size, int32_t* out, long long n,
                         int device, void* stream) {
  if (cell_size < 0) return (int)cudaErrorInvalidValue;
  const int nch = (cell_size + 62) / 62;  // ceil((cell_size + 1) / 62)
  return launch_sponge8(hash, ByteRows{rows, row_stride, col_stride, cell_size, nch}, out, n,
                        device, stream);
}

}  // extern "C"
