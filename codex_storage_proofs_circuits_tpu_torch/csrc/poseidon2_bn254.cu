// BN254 Poseidon2 t=3 on Hopper: K1 (permutation / keyed compression, and
// on the main path the subtree kernel, which makes many Merkle tree levels
// a launch and writes them canonical) and K2 (rate-2 sponge: the whole
// cell-hash step, cell bytes in).
//
// Replaces the Pallas TPU kernels of
// codex_storage_proofs_circuits_tpu/ops/poseidon2_pallas.py:
//   K1  _perm_kernel     (permutation, compress; the tree above the cell
//       hashes, together with the plain Montgomery-to-canonical pass over
//       its layers: JAX models/hashing.py::slot_tree_from_felts)
//   K2  _sponge2_kernel  (sponge2_absorb), together with the byte encode,
//       the Montgomery conversion and the felt padding that feed it
//       (JAX ops/encode.py, models/hashing.py::hash_cells_mont).
// The plain torch versions are ops/poseidon2_plain.py.
//
// Semantics: initial linear layer, 4 external rounds, 56 internal rounds,
// 4 external rounds, x^5 S-box, all in Montgomery form with R = 2^256
// (the same R as the 16-bit limb planes at the boundary, so the values
// match the JAX planes bit for bit).  Inputs canonical (< P), outputs
// canonical.
//
// What bounds it here: integer multiply-adds.  One permutation is 240
// Montgomery products of 8 x 32-bit limbs (160 of them squarings); the
// state (3 field elements) stays in registers and each thread reads its
// cell's bytes and writes its hash once.  So the design is one thread per
// state, and the field core issues as few instructions per multiply as it
// can:
//  - each product is inline PTX: a row of partial products is 8 wide
//    multiply-adds (mad.wide.u32, one IMAD.WIDE each, folding in the running
//    word) that do not wait on each other, then one add.cc / addc.cc chain
//    over their halves (one asm block per chain: the carry flag does not
//    live from one asm statement to the next);
//  - x^2 and x^4 are squarings: 28 cross products, doubled, plus 8 squares
//    (36 partial products in place of 64), then a Montgomery reduction of
//    the low half added to the high half;
//  - reduction is lazy: values stay below 2P (P < 2^254, so 4P < R and a
//    product of two values below 2P comes out below 2P with no final
//    subtraction); an addition subtracts 2P when it reaches it; a value is
//    made canonical once, at exit;
//  - the code stays small enough for the instruction cache: the round
//    loops are rolled and the S-box (two squarings and a product, about a
//    thousand instructions) is one called function, the rest inlined.  On
//    an H100 K2 measured fastest so: inlining the S-box or unrolling the
//    rounds each made it slower (PERF.md).
// With the products written in asm, cicc compiles them inlined, rolled or
// unrolled (a C++ product with 64-bit accumulators made cicc of CUDA 12.9
// crash when inlined into the rounds).
// The TPU's 16-bit limbs, lazy multi-threshold reduction and packed carry
// resolve answered the TPU VPU's lack of a wide multiply and are not
// carried over.
//
// K2 reads cell bytes: thread b reads byte i of its cell at
// rows[i * row_stride + b * col_stride] (the (cell_size, B) rows the PRNG
// emits, or a (B, cell_size).T view), packs each 31-byte felt (with the `10*`
// byte padding: a 0x01 after the last byte, then zeros) into 8 words, takes
// it into Montgomery form with one product by R^2 mod P, appends the felt
// padding (ONE_MONT, then a 0 when the felt count is even) and absorbs two
// felts per permutation.  A 2048-byte cell is 67 felts, 34 permutations.
// The limb-plane entry (pre-padded Montgomery blocks, the JAX parity API
// sponge2_absorb) is the same kernel with another source.
//
// Layout of the limb planes (K1, the limb-plane K2 and every output): int32
// planes of 16-bit limbs; thread b reads plane[i * row_stride + b *
// col_stride], so a warp's accesses are coalesced, and packs limb pairs
// into 32-bit words.
//
// The Montgomery quotient factor with 32-bit limbs is -P^-1 mod 2^32 =
// 0xEFFFFFFF (FR_PINV in the generated header).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "poseidon2_bn254_constants.h"  // generated from fields/bn254.py

namespace {

constexpr int kThreads = 128;

struct Fr {
  uint32_t w[8];
};

// ---------------------------------------------------------------------------
// Carry chains.  Each caller guarantees that no chain carries out of its
// last word.

// t[0..8] += a[0..7] * b.  The 8 wide products a[j] * b + t[j] (each below
// 2^64) do not depend on each other; one carry chain of adds then sums
// their halves: word j = hi(w[j-1]) + lo(w[j]) + carry, word 8 = hi(w[7]) +
// t[8] + carry.  (A chain of mad.lo.cc / madc.hi.cc puts every multiply in
// the carry's path: ptxas gives each its own add-with-carry and the
// products wait on each other.)
__device__ __forceinline__ void mad_row(uint32_t* t, const uint32_t* a, uint32_t b) {
  asm("{\n\t"
      ".reg .u64 w0, w1, w2, w3, w4, w5, w6, w7, x;\n\t"
      ".reg .u32 h0, h1, h2, h3, h4, h5, h6, h7, l1, l2, l3, l4, l5, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w0, %9, %17, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w1, %10, %17, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w2, %11, %17, x;\n\t"
      "cvt.u64.u32 x, %3; mad.wide.u32 w3, %12, %17, x;\n\t"
      "cvt.u64.u32 x, %4; mad.wide.u32 w4, %13, %17, x;\n\t"
      "cvt.u64.u32 x, %5; mad.wide.u32 w5, %14, %17, x;\n\t"
      "cvt.u64.u32 x, %6; mad.wide.u32 w6, %15, %17, x;\n\t"
      "cvt.u64.u32 x, %7; mad.wide.u32 w7, %16, %17, x;\n\t"
      "mov.b64 {%0, h0}, w0; mov.b64 {l1, h1}, w1;\n\t"
      "mov.b64 {l2, h2}, w2; mov.b64 {l3, h3}, w3;\n\t"
      "mov.b64 {l4, h4}, w4; mov.b64 {l5, h5}, w5;\n\t"
      "mov.b64 {l6, h6}, w6; mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h0, l1; addc.cc.u32 %2, h1, l2;\n\t"
      "addc.cc.u32 %3, h2, l3; addc.cc.u32 %4, h3, l4;\n\t"
      "addc.cc.u32 %5, h4, l5; addc.cc.u32 %6, h5, l6;\n\t"
      "addc.cc.u32 %7, h6, l7; addc.u32 %8, h7, %8;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b));
}

// r = a + b over 8 words.
__device__ __forceinline__ void add8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// r = a - b over 8 words; returns all ones on a borrow out (a < b), else 0.
__device__ __forceinline__ uint32_t sub8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t bw;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return bw;
}

// ---------------------------------------------------------------------------
// Field operations (values below 2P unless a name says canonical)

// s >= q ? s - q : s
__device__ __forceinline__ Fr cond_sub(const uint32_t* s, const uint32_t* q) {
  Fr d;
  uint32_t bw = sub8(d.w, s, q);
#pragma unroll
  for (int j = 0; j < 8; j++) d.w[j] = (s[j] & bw) | (d.w[j] & ~bw);
  return d;
}

__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  // a + b < 4P < 2^256: no carry out of the top word
  constexpr uint32_t k2P[8] = FR_2P_WORDS;
  uint32_t s[8];
  add8(s, a.w, b.w);
  return cond_sub(s, k2P);
}

__device__ __forceinline__ Fr fr_canon(const Fr& a) {
  constexpr uint32_t kP[8] = FR_P_WORDS;
  return cond_sub(a.w, kP);
}

// One Montgomery reduction step on t[0..8]: add m * P with m = t[0] * FR_PINV,
// which zeroes word 0, then shift down one word.  Every caller keeps t + m P
// below 2^288, so no chain carries out of word 8.
__device__ __forceinline__ void redc_step(uint32_t* t) {
  constexpr uint32_t kP[8] = FR_P_WORDS;
  mad_row(t, kP, t[0] * FR_PINV);
#pragma unroll
  for (int j = 0; j < 8; j++) t[j] = t[j + 1];
  t[8] = 0;
}

// CIOS Montgomery product a * b / R mod P.  With a, b < 2P the running sum
// stays below 3.01P < 2^256 between steps and below 2^288 within one, and
// the result is below 4P^2 / R + P < 2P.
__device__ __forceinline__ Fr fr_mul(const Fr& a, const Fr& b) {
  uint32_t t[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mad_row(t, a.w, b.w[i]);
    redc_step(t);
  }
  Fr r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = t[j];
  return r;
}

// a * a / R mod P: the 16-word square from 28 cross products (row i adds
// a[i] * a[i+1..7], wide products as in mad_row, into words 2i+1..i+8; the
// sum of rows 0..i stays below 2^(32(i+9)), so no row carries out of its
// last word), doubled, plus the 8 squares on the diagonal; then the low half
// L is reduced alone, u = (L + M P) / R <= P, and the high half
// H < (2P)^2 / R added: H + u < 2P.
__device__ __forceinline__ Fr fr_sqr(const Fr& x) {
  const uint32_t* a = x.w;
  uint32_t t[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  // row 0: words 1..8 += a[0] * a[1..7]
  asm("{\n\t"
      ".reg .u64 w1, w2, w3, w4, w5, w6, w7, x;\n\t"
      ".reg .u32 h1, h2, h3, h4, h5, h6, h7, l2, l3, l4, l5, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w1, %9, %8, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w2, %10, %8, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w3, %11, %8, x;\n\t"
      "cvt.u64.u32 x, %3; mad.wide.u32 w4, %12, %8, x;\n\t"
      "cvt.u64.u32 x, %4; mad.wide.u32 w5, %13, %8, x;\n\t"
      "cvt.u64.u32 x, %5; mad.wide.u32 w6, %14, %8, x;\n\t"
      "cvt.u64.u32 x, %6; mad.wide.u32 w7, %15, %8, x;\n\t"
      "mov.b64 {%0, h1}, w1; mov.b64 {l2, h2}, w2;\n\t"
      "mov.b64 {l3, h3}, w3; mov.b64 {l4, h4}, w4;\n\t"
      "mov.b64 {l5, h5}, w5; mov.b64 {l6, h6}, w6;\n\t"
      "mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h1, l2; addc.cc.u32 %2, h2, l3;\n\t"
      "addc.cc.u32 %3, h3, l4; addc.cc.u32 %4, h4, l5;\n\t"
      "addc.cc.u32 %5, h5, l6; addc.cc.u32 %6, h6, l7;\n\t"
      "addc.u32 %7, h7, %7;\n\t"
      "}"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // row 1: words 3..9 += a[1] * a[2..7]
  asm("{\n\t"
      ".reg .u64 w2, w3, w4, w5, w6, w7, x;\n\t"
      ".reg .u32 h2, h3, h4, h5, h6, h7, l3, l4, l5, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w2, %8, %7, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w3, %9, %7, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w4, %10, %7, x;\n\t"
      "cvt.u64.u32 x, %3; mad.wide.u32 w5, %11, %7, x;\n\t"
      "cvt.u64.u32 x, %4; mad.wide.u32 w6, %12, %7, x;\n\t"
      "cvt.u64.u32 x, %5; mad.wide.u32 w7, %13, %7, x;\n\t"
      "mov.b64 {%0, h2}, w2; mov.b64 {l3, h3}, w3;\n\t"
      "mov.b64 {l4, h4}, w4; mov.b64 {l5, h5}, w5;\n\t"
      "mov.b64 {l6, h6}, w6; mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h2, l3; addc.cc.u32 %2, h3, l4;\n\t"
      "addc.cc.u32 %3, h4, l5; addc.cc.u32 %4, h5, l6;\n\t"
      "addc.cc.u32 %5, h6, l7; addc.u32 %6, h7, %6;\n\t"
      "}"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // row 2: words 5..10 += a[2] * a[3..7]
  asm("{\n\t"
      ".reg .u64 w3, w4, w5, w6, w7, x;\n\t"
      ".reg .u32 h3, h4, h5, h6, h7, l4, l5, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w3, %7, %6, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w4, %8, %6, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w5, %9, %6, x;\n\t"
      "cvt.u64.u32 x, %3; mad.wide.u32 w6, %10, %6, x;\n\t"
      "cvt.u64.u32 x, %4; mad.wide.u32 w7, %11, %6, x;\n\t"
      "mov.b64 {%0, h3}, w3; mov.b64 {l4, h4}, w4;\n\t"
      "mov.b64 {l5, h5}, w5; mov.b64 {l6, h6}, w6;\n\t"
      "mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h3, l4; addc.cc.u32 %2, h4, l5;\n\t"
      "addc.cc.u32 %3, h5, l6; addc.cc.u32 %4, h6, l7;\n\t"
      "addc.u32 %5, h7, %5;\n\t"
      "}"
      : "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10])
      : "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // row 3: words 7..11 += a[3] * a[4..7]
  asm("{\n\t"
      ".reg .u64 w4, w5, w6, w7, x;\n\t"
      ".reg .u32 h4, h5, h6, h7, l5, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w4, %6, %5, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w5, %7, %5, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w6, %8, %5, x;\n\t"
      "cvt.u64.u32 x, %3; mad.wide.u32 w7, %9, %5, x;\n\t"
      "mov.b64 {%0, h4}, w4; mov.b64 {l5, h5}, w5;\n\t"
      "mov.b64 {l6, h6}, w6; mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h4, l5; addc.cc.u32 %2, h5, l6;\n\t"
      "addc.cc.u32 %3, h6, l7; addc.u32 %4, h7, %4;\n\t"
      "}"
      : "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
      : "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // row 4: words 9..12 += a[4] * a[5..7]
  asm("{\n\t"
      ".reg .u64 w5, w6, w7, x;\n\t"
      ".reg .u32 h5, h6, h7, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w5, %5, %4, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w6, %6, %4, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w7, %7, %4, x;\n\t"
      "mov.b64 {%0, h5}, w5; mov.b64 {l6, h6}, w6;\n\t"
      "mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h5, l6; addc.cc.u32 %2, h6, l7;\n\t"
      "addc.u32 %3, h7, %3;\n\t"
      "}"
      : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // row 5: words 11..13 += a[5] * a[6..7]
  asm("{\n\t"
      ".reg .u64 w6, w7, x;\n\t"
      ".reg .u32 h6, h7, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w6, %4, %3, x;\n\t"
      "cvt.u64.u32 x, %1; mad.wide.u32 w7, %5, %3, x;\n\t"
      "mov.b64 {%0, h6}, w6; mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h6, l7; addc.u32 %2, h7, %2;\n\t"
      "}"
      : "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
      : "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // row 6: words 13..14 += a[6] * a[7..7]
  asm("{\n\t"
      ".reg .u64 w7, x;\n\t"
      ".reg .u32 h7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w7, %3, %2, x;\n\t"
      "mov.b64 {%0, h7}, w7;\n\t"
      "add.u32 %1, h7, %1;\n\t"
      "}"
      : "+r"(t[13]), "+r"(t[14])
      : "r"(a[6]), "r"(a[7]));
  // double the cross products (words 1..14; word 15 takes the carry)
  asm("add.cc.u32  %0, %0, %0;\n\t"
      "addc.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.u32    %14, %14, %14;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]),
        "+r"(t[13]), "+r"(t[14]), "+r"(t[15]));
  // the squares: a[i]^2 + t[2i] into words 2i, 2i+1
  asm("{\n\t"
      ".reg .u64 w0, w1, w2, w3, w4, w5, w6, w7, x;\n\t"
      ".reg .u32 h0, h1, h2, h3, h4, h5, h6, h7, l1, l2, l3, l4, l5, l6, l7;\n\t"
      "cvt.u64.u32 x, %0; mad.wide.u32 w0, %16, %16, x;\n\t"
      "cvt.u64.u32 x, %2; mad.wide.u32 w1, %17, %17, x;\n\t"
      "cvt.u64.u32 x, %4; mad.wide.u32 w2, %18, %18, x;\n\t"
      "cvt.u64.u32 x, %6; mad.wide.u32 w3, %19, %19, x;\n\t"
      "cvt.u64.u32 x, %8; mad.wide.u32 w4, %20, %20, x;\n\t"
      "cvt.u64.u32 x, %10; mad.wide.u32 w5, %21, %21, x;\n\t"
      "cvt.u64.u32 x, %12; mad.wide.u32 w6, %22, %22, x;\n\t"
      "cvt.u64.u32 x, %14; mad.wide.u32 w7, %23, %23, x;\n\t"
      "mov.b64 {%0, h0}, w0; mov.b64 {l1, h1}, w1;\n\t"
      "mov.b64 {l2, h2}, w2; mov.b64 {l3, h3}, w3;\n\t"
      "mov.b64 {l4, h4}, w4; mov.b64 {l5, h5}, w5;\n\t"
      "mov.b64 {l6, h6}, w6; mov.b64 {l7, h7}, w7;\n\t"
      "add.cc.u32 %1, h0, %1; addc.cc.u32 %2, l1, 0;\n\t"
      "addc.cc.u32 %3, h1, %3; addc.cc.u32 %4, l2, 0;\n\t"
      "addc.cc.u32 %5, h2, %5; addc.cc.u32 %6, l3, 0;\n\t"
      "addc.cc.u32 %7, h3, %7; addc.cc.u32 %8, l4, 0;\n\t"
      "addc.cc.u32 %9, h4, %9; addc.cc.u32 %10, l5, 0;\n\t"
      "addc.cc.u32 %11, h5, %11; addc.cc.u32 %12, l6, 0;\n\t"
      "addc.cc.u32 %13, h6, %13; addc.cc.u32 %14, l7, 0;\n\t"
      "addc.u32 %15, h7, %15;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]),
        "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]));
  uint32_t u[9] = {t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], 0};
#pragma unroll
  for (int i = 0; i < 8; i++) redc_step(u);
  Fr r;
  add8(r.w, u, t + 8);
  return r;
}

__device__ __forceinline__ Fr fr_const(const uint32_t (&k)[8]) {
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = k[i];
  return r;
}

// ---------------------------------------------------------------------------
// The permutation (values below 2P throughout)

__device__ __noinline__ Fr sbox(Fr x) {
  Fr x2 = fr_sqr(x);
  Fr x4 = fr_sqr(x2);
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

__device__ __forceinline__ void permute(Fr& x, Fr& y, Fr& z) {
  mix(x, y, z);
#pragma unroll 1
  for (int r = 0; r < 4; r++) external_round(x, y, z, r);
#pragma unroll 1
  for (int r = 0; r < P2_N_INTERNAL; r++) internal_round(x, y, z, r);
#pragma unroll 1
  for (int r = 4; r < 8; r++) external_round(x, y, z, r);
}

// ---------------------------------------------------------------------------
// Boundary: limb planes and byte rows

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

// K2 source: pre-padded canonical Montgomery blocks, contiguous (nb, 2, 16, n).
struct PlaneBlocks {
  const int32_t* blocks;
  int nb;
  long long n;

  __device__ int nblocks() const { return nb; }
  __device__ void block(long long b, int k, Fr& f0, Fr& f1) const {
    const int32_t* blk = blocks + (long long)k * 32 * n;
    f0 = load_fr(blk, n, b);
    f1 = load_fr(blk + 16 * n, n, b);
  }
};

// K2 source: cell bytes, byte i of cell b at rows[i * rs + b * cs]; nf =
// ceil((cell + 1) / 31) felts, then ONE_MONT and a 0 filler to an even count.
struct ByteRows {
  const uint8_t* rows;
  long long rs, cs;
  int cell, nf;

  __device__ int nblocks() const { return (nf + 2) / 2; }
  __device__ Fr felt(const uint8_t* col, int k) const {
    if (k >= nf) {
      constexpr uint32_t kOne[8] = FR_ONE_WORDS;
      Fr r = {};
      if (k == nf) r = fr_const(kOne);
      return r;
    }
    Fr w = {};
    const int base = 31 * k;
#pragma unroll
    for (int t = 0; t < 31; t++) {
      const int i = base + t;
      uint32_t v = i < cell ? (uint32_t)col[(long long)i * rs] : (i == cell ? 1u : 0u);
      w.w[t / 4] |= v << (8 * (t % 4));
    }
    constexpr uint32_t kR2[8] = FR_R2_WORDS;
    return fr_mul(w, fr_const(kR2));  // w < 2^248 < P: into Montgomery form, < 2P
  }
  __device__ void block(long long b, int k, Fr& f0, Fr& f1) const {
    const uint8_t* col = rows + b * cs;
    f0 = felt(col, 2 * k);
    f1 = felt(col, 2 * k + 1);
  }
};

// ---------------------------------------------------------------------------
// Kernels

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
  store_fr(out, n, b, fr_canon(X));
  if (out_lanes == 3) {
    store_fr(out + 16 * n, n, b, fr_canon(Y));
    store_fr(out + 32 * n, n, b, fr_canon(Z));
  }
}

// K2.  Absorbs src's blocks of two felts into the state [0, 0, IV] and
// writes the canonical first lane to out, (16, n).  The state stays in
// registers across all permutations.
template <class Src>
__global__ void __launch_bounds__(kThreads)
p2_sponge2_kernel(Src src, int32_t* __restrict__ out, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  Fr X = {}, Y = {};
  Fr Z = fr_const(P2_SPONGE2_IV);
  const int nb = src.nblocks();
#pragma unroll 1
  for (int k = 0; k < nb; k++) {
    Fr f0, f1;
    src.block(b, k, f0, f1);
    X = fr_add(X, f0);
    Y = fr_add(Y, f1);
    permute(X, Y, Z);
  }
  store_fr(out, n, b, fr_canon(X));
}

inline unsigned n_blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// The subtree kernel: K1 on the main path.  A CTA takes `tile` consecutive
// nodes of the (16, w) layer x (row and column strides, read in place) and
// reduces them `levels` levels: the first level's keyed compressions read
// x's column pairs from device memory (Montgomery form with mont_in, else
// canonical values, taken into Montgomery form by one product by R^2), and
// every later one reads the level below from shared memory (the Montgomery
// values below 2P, 32 B a node, word-major, two buffers taking turns).
// Every node of every level is written in canonical form (one Montgomery
// product by 1, then fr_canon: 264 multiplies, against 54,400 for the
// compression) to that level's (16, w >> j) plane in out (level 1 at out,
// each next level right after the one before); with out0, the layer x too,
// canonical, as a (16, w) plane.  Level j uses key bit j - 1 of key_mask.
//
// Below 2^14 compressions a level no longer fills the card (132 SMs x 4
// schedulers x 32 lanes) and waits on one permutation's latency whatever its
// width: 0.133 ms on an H100 (tools_torch/p2_tree_widths.py, PERF.md).  A
// launch whose first level fills the card takes tiles of 2^11 nodes in CTAs
// of 256 threads, one CTA an SM: a 2^18-node chunk cut at 2^14 nodes is 128
// CTAs, four compressions a thread at the first level, and at the fourth
// one warp on each of an SM's four schedulers (with smaller tiles several
// CTAs share an SM, and each CTA's few active warps at its narrow levels
// crowd the same schedulers).  A narrower launch, latency-bound, takes tiles
// of 2^8 nodes, one compression a thread, so that a 1 GB slot's joined
// 2^15-node frontier spreads over 128 SMs (8 levels), a warp alone on each
// scheduler; one CTA takes a layer of at most 2^8 nodes to its roots (the
// frontier's last 7 levels).  The constants were chosen on an H100 by
// tools_torch/tile_sweep.py --field=bn254 (PERF.md): tiles of 2^9 nodes in
// CTAs of 128 threads, a cap of 64 registers and an S-box inlined into the
// narrow launches each measured slower.
constexpr int kTreeThreads = 256;
constexpr int kWideTileLog = 11;   // tile of a launch whose first level fills the card
constexpr int kNarrowTileLog = 8;  // tile of a narrower launch
constexpr int kTopLog = 8;         // a layer of at most 2^8 nodes is one CTA's
constexpr int kNarrowLog = 15;     // launches on at most 2^15 nodes are narrow
constexpr int kTile = 1 << kWideTileLog;

__device__ __forceinline__ Fr fr_from_mont(const Fr& v) {
  constexpr uint32_t kOne[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  return fr_canon(fr_mul(v, fr_const(kOne)));  // v / R mod P, below 2P, then below P
}

__global__ void __launch_bounds__(kTreeThreads, 1)
p2_tree_kernel(const int32_t* __restrict__ x, long long xrs, long long xcs, int mont_in,
               int32_t* __restrict__ out0, int32_t* __restrict__ out, long long w, int levels,
               int tile, unsigned key_mask) {
  constexpr int cap0 = kTile / 2, cap1 = kTile / 4;
  __shared__ uint32_t smem[8 * (cap0 + cap1)];
  uint32_t* const buf0 = smem;             // odd levels
  uint32_t* const buf1 = smem + 8 * cap0;  // even levels
  const long long base = (long long)blockIdx.x * tile;
  const int cnt = (int)min((long long)tile, w - base);
  int32_t* lvl = out;
  for (int j = 1; j <= levels; j++) {
    const int n = cnt >> j;
    const long long gw = w >> j, gb = base >> j;
    const bool odd = j & 1;
    const uint32_t* src = odd ? buf1 : buf0;
    const int scap = odd ? cap1 : cap0;
    uint32_t* dst = odd ? buf0 : buf1;
    const int dcap = odd ? cap0 : cap1;
    const Fr key = fr_const(P2_KEYS[(key_mask >> (j - 1)) & 1u]);
    // child c (0 or 1) of node i, in Montgomery form
    auto child = [&](int i, int c) -> Fr {
      const int k = 2 * i + c;
      Fr v;
      if (j == 1) {
        v = load_fr(x, xrs, (base + k) * xcs);
        if (mont_in) {
          if (out0) store_fr(out0, w, base + k, fr_from_mont(v));
        } else {
          constexpr uint32_t kR2[8] = FR_R2_WORDS;
          v = fr_mul(v, fr_const(kR2));
        }
      } else {
#pragma unroll
        for (int l = 0; l < 8; l++) v.w[l] = src[l * scap + k];
      }
      return v;
    };
    for (int i = threadIdx.x; i < n; i += kTreeThreads) {
      Fr X = child(i, 0), Y = child(i, 1), Z = key;
      permute(X, Y, Z);
      if (j < levels) {
#pragma unroll
        for (int l = 0; l < 8; l++) dst[l * dcap + i] = X.w[l];
      }
      store_fr(lvl, gw, gb + i, fr_from_mont(X));
    }
    __syncthreads();
    lvl += 16 * gw;
  }
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

// K2 on pre-padded Montgomery limb-plane blocks (nb, 2, 16, n).
int cspc_p2_sponge2(const int32_t* blocks, int nb, int32_t* out, long long n,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    p2_sponge2_kernel<PlaneBlocks><<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        PlaneBlocks{blocks, nb, n}, out, n);
  return (int)cudaGetLastError();
}

// K2 on cell bytes: byte i of cell b at rows[i * row_stride + b * col_stride].
int cspc_p2_sponge2_rows(const uint8_t* rows, long long row_stride, long long col_stride,
                         int cell_size, int32_t* out, long long n, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cell_size < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    p2_sponge2_kernel<ByteRows><<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        ByteRows{rows, row_stride, col_stride, cell_size, (cell_size + 31) / 31}, out, n);
  return (int)cudaGetLastError();
}

// The subtree kernel, one launch: reduces the (16, w) layer x by as many
// of `levels` levels as one launch takes (all of them when w <= 2^8, in one
// CTA; else min(levels, 8) in CTAs of 2^8 nodes when w <= 2^15, else
// min(levels, 11) in CTAs of 2^11 nodes), writing each level's
// canonical (16, w >> j) plane into out one after another, level j with key
// bit j - 1 of key_mask; x is in Montgomery form when mont_in (then out0, if
// not null, receives x canonical), else canonical.  *done is set to the
// levels made.  w must be a multiple of 2^(levels made).
int cspc_p2_tree(const int32_t* x, long long xrs, long long xcs, int mont_in, int32_t* out0,
                 int32_t* out, long long w, int levels, unsigned key_mask, int* done,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > 31 || w < 2 || (out0 && !mont_in)) return (int)cudaErrorInvalidValue;
  const bool top = w <= (1LL << kTopLog), narrow = w <= (1LL << kNarrowLog);
  const int tile_log = narrow ? kNarrowTileLog : kWideTileLog;
  const int lev = top ? levels : std::min(levels, tile_log);
  if (w % (1LL << lev)) return (int)cudaErrorInvalidValue;
  const int tile = top ? (int)w : 1 << tile_log;
  const unsigned grid = (unsigned)((w + tile - 1) / tile);
  cudaStream_t st = (cudaStream_t)stream;
  p2_tree_kernel<<<grid, kTreeThreads, 0, st>>>(x, xrs, xcs, mont_in, out0, out, w, lev, tile,
                                                 key_mask);
  *done = lev;
  return (int)cudaGetLastError();
}

const char* cspc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
