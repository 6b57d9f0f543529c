/* cspc_native — C host library: fast bit-exact CPU path.
 *
 * Implements the math of the reference's pinned native dependencies
 * (constantine BN254 Fr Montgomery arithmetic, nim-poseidon2 sponge/compress;
 * see reference/nim/proof_input/proof_input.nimble:11-13) plus the data model
 * hot loops (fake-data PRNG reference/nim/proof_input/src/slot.nim:22-32,
 * cell hashing blocks/bn254.nim:23-29, Merkle tree build merkle/bn254.nim:29-63)
 * as a small multi-threaded C library with a flat-array C ABI.
 *
 * Field elements cross the ABI in CANONICAL form as 4 little-endian uint64
 * limbs (the reference chooses standard form at data boundaries,
 * reference/README.md:101-104); Montgomery form is internal.
 *
 * Build: cc -O3 -shared -fPIC -pthread cspc_native.c -o libcspc_native.so
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>
#include <pthread.h>

#include "poseidon2_constants.h"

typedef unsigned __int128 u128;
typedef uint64_t fr[4];

/* ------------------------------------------------------------------ */
/* BN254 Fr arithmetic, 4x64-bit limbs, Montgomery form (R = 2^256).   */

static inline int fr_geq_p(const uint64_t a[4]) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] > FR_P[i]) return 1;
    if (a[i] < FR_P[i]) return 0;
  }
  return 1;
}

static inline void fr_sub_p(uint64_t a[4]) {
  u128 brw = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a[i] - FR_P[i] - brw;
    a[i] = (uint64_t)d;
    brw = (d >> 64) & 1;
  }
}

static inline void fr_add(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a[i] + b[i];
    r[i] = (uint64_t)c;
    c >>= 64;
  }
  /* a,b < P < 2^254 so no limb overflow past 2^255; reduce once */
  if (fr_geq_p(r)) fr_sub_p(r);
}

/* CIOS Montgomery multiplication: r = a*b*R^-1 mod P. */
static void fr_mont_mul(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  uint64_t t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 c = 0;
    for (int j = 0; j < 4; j++) {
      c += (u128)t[j] + (u128)a[j] * b[i];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    uint64_t t4 = t[4] + (uint64_t)c; /* fits: t < 2P*2^256 */
    uint64_t m = t[0] * FR_P_INV_NEG;
    c = (u128)t[0] + (u128)m * FR_P[0];
    c >>= 64;
    for (int j = 1; j < 4; j++) {
      c += (u128)t[j] + (u128)m * FR_P[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t4;
    t[3] = (uint64_t)c;
    t[4] = (uint64_t)(c >> 64);
  }
  memcpy(r, t, 32);
  if (t[4] || fr_geq_p(r)) fr_sub_p(r);
}

static inline void fr_to_mont(uint64_t r[4], const uint64_t a[4]) {
  fr_mont_mul(r, a, FR_R2_MONT);
}

static inline void fr_from_mont(uint64_t r[4], const uint64_t a[4]) {
  static const uint64_t one[4] = {1, 0, 0, 0};
  fr_mont_mul(r, a, one);
}

/* ------------------------------------------------------------------ */
/* Poseidon2 t=3 permutation (Montgomery-form states).
 * Schedule per reference circuit/poseidon2/poseidon2_perm.circom:163-198:
 * initial linear layer, 4 external, 56 internal, 4 external rounds. */

static inline void p2_sbox(uint64_t x[4]) {
  fr x2, x4;
  fr_mont_mul(x2, x, x);
  fr_mont_mul(x4, x2, x2);
  fr_mont_mul(x, x4, x);
}

static inline void p2_linear(fr s[3]) {
  fr sum;
  fr_add(sum, s[0], s[1]);
  fr_add(sum, sum, s[2]);
  fr_add(s[0], s[0], sum);
  fr_add(s[1], s[1], sum);
  fr_add(s[2], s[2], sum);
}

static inline void p2_external(const uint64_t rc[3][4], fr s[3]) {
  fr sum;
  for (int l = 0; l < 3; l++) {
    fr_add(s[l], s[l], rc[l]);
    p2_sbox(s[l]);
  }
  fr_add(sum, s[0], s[1]);
  fr_add(sum, sum, s[2]);
  for (int l = 0; l < 3; l++) fr_add(s[l], s[l], sum);
}

/* internal matrix [[2,1,1],[1,2,1],[1,1,3]] (poseidon2_perm.circom:89-91) */
static inline void p2_internal(const uint64_t rc[4], fr s[3]) {
  fr sum, z2;
  fr_add(s[0], s[0], rc);
  p2_sbox(s[0]);
  fr_add(sum, s[0], s[1]);
  fr_add(sum, sum, s[2]);
  fr_add(z2, s[2], s[2]);
  fr_add(s[0], s[0], sum);
  fr_add(s[1], s[1], sum);
  fr_add(s[2], z2, sum);
}

static void p2_permute(fr s[3]) {
  p2_linear(s);
  for (int k = 0; k < 4; k++) p2_external(P2_EXT_RC[k], s);
  for (int k = 0; k < 56; k++) p2_internal(P2_INT_RC[k], s);
  for (int k = 4; k < 8; k++) p2_external(P2_EXT_RC[k], s);
}

/* keyed 2->1 compression, Montgomery in/out
 * (circuit/poseidon2/poseidon2_compr.circom:30-41) */
static inline void p2_compress_mont(uint64_t out[4], const uint64_t x[4],
                                    const uint64_t y[4], int key) {
  fr s[3];
  memcpy(s[0], x, 32);
  memcpy(s[1], y, 32);
  memcpy(s[2], P2_KEYS[key & 3], 32);
  p2_permute(s);
  memcpy(out, s[0], 32);
}

/* ------------------------------------------------------------------ */
/* Byte -> field encoding + cell hashing.
 * 10* byte padding, 31-byte LE chunks (reference Slot.hs:243-270), then a
 * rate-2 felt sponge with its own 10* felt padding and IV 2^64+0x0302
 * (poseidon2_sponge.circom:43-61, blocks/bn254.nim:23-29).                */

static void chunk31_to_mont(uint64_t out[4], const uint8_t c[31]) {
  uint64_t v[4] = {0, 0, 0, 0};
  for (int i = 0; i < 31; i++) v[i >> 3] |= (uint64_t)c[i] << ((i & 7) * 8);
  fr_to_mont(out, v); /* < 2^248 < P: canonical already */
}

/* hash one cell of `cell_size` bytes; out = canonical felt */
static void hash_cell(uint64_t out[4], const uint8_t *data, size_t cell_size) {
  size_t padded = cell_size + 1;
  size_t nfe = (padded + 30) / 31;  /* number of 31-byte chunks */
  fr s[3];
  memset(s, 0, sizeof s);
  memcpy(s[2], P2_SPONGE2_IV, 32);

  /* stream chunks in pairs; felt-level padding appends felt 1 (+ felt 0) */
  size_t total = nfe + 1;          /* felts incl. the felt-level 1 pad */
  if (total & 1) total++;          /* plus a 0 to a multiple of rate 2 */
  uint8_t buf[31];
  for (size_t i = 0; i < total; i += 2) {
    for (int half = 0; half < 2; half++) {
      size_t k = i + half;
      fr a;
      if (k < nfe) {
        size_t off = k * 31;
        size_t n = cell_size > off ? (cell_size - off < 31 ? cell_size - off : 31) : 0;
        memset(buf, 0, 31);
        if (n) memcpy(buf, data + off, n);
        if (n < 31) buf[n] = 0x01; /* byte-level 10* pad */
        chunk31_to_mont(a, buf);
      } else if (k == nfe) {
        memcpy(a, P2_ONE_MONT, 32); /* felt-level 10* pad */
      } else {
        memset(a, 0, 32);
      }
      fr_add(s[half], s[half], a);
    }
    p2_permute(s);
  }
  fr_from_mont(out, s[0]);
}

/* ------------------------------------------------------------------ */
/* Fake-data PRNG (reference/nim/proof_input/src/slot.nim:22-32; uint64
 * wraparound is the spec — C unsigned arithmetic gives it natively).    */

static const uint64_t FAKE_MODULUS = 1698428844001831ULL;

static void fake_cell(uint8_t *out, size_t cell_size, uint64_t seed, uint64_t idx) {
  uint64_t seed1 = seed + 0xDEADCAFEULL;
  uint64_t seed2 = idx + 0x98765432ULL;
  uint64_t state = 1;
  for (size_t i = 0; i < cell_size; i++) {
    state = state * (state + seed1) * (state + seed2)
          + state * (state ^ 0x5A5A5A5AULL)
          + seed1 * state + (seed2 + 17);
    state %= FAKE_MODULUS;
    out[i] = (uint8_t)state;
  }
}

/* ------------------------------------------------------------------ */
/* Threaded parallel-for helper.                                       */

#define MAX_THREADS 16

typedef struct {
  void (*fn)(void *, size_t, size_t);
  void *ctx;
  size_t begin, end;
} pfor_task;

static void *pfor_thread(void *arg) {
  pfor_task *t = (pfor_task *)arg;
  t->fn(t->ctx, t->begin, t->end);
  return NULL;
}

static void parallel_for(void (*fn)(void *, size_t, size_t), void *ctx,
                         size_t n, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > MAX_THREADS) nthreads = MAX_THREADS;
  if ((size_t)nthreads > n) nthreads = n ? (int)n : 1;
  if (nthreads == 1) {
    fn(ctx, 0, n);
    return;
  }
  pthread_t th[MAX_THREADS];
  pfor_task tasks[MAX_THREADS];
  size_t chunk = (n + nthreads - 1) / nthreads;
  int spawned = 0;
  for (int i = 0; i < nthreads; i++) {
    size_t b = i * chunk, e = b + chunk > n ? n : b + chunk;
    if (b >= e) break;
    tasks[i] = (pfor_task){fn, ctx, b, e};
    pthread_create(&th[i], NULL, pfor_thread, &tasks[i]);
    spawned++;
  }
  for (int i = 0; i < spawned; i++) pthread_join(th[i], NULL);
}

/* ------------------------------------------------------------------ */
/* Public ABI.  All felts canonical 4x little-endian uint64.           */

void cspc_permutation(uint64_t io[12]) {
  fr s[3];
  for (int l = 0; l < 3; l++) fr_to_mont(s[l], io + 4 * l);
  p2_permute(s);
  for (int l = 0; l < 3; l++) fr_from_mont(io + 4 * l, s[l]);
}

void cspc_keyed_compress(uint64_t out[4], const uint64_t x[4],
                         const uint64_t y[4], int key) {
  fr xm, ym, om;
  fr_to_mont(xm, x);
  fr_to_mont(ym, y);
  p2_compress_mont(om, xm, ym, key);
  fr_from_mont(out, om);
}

/* rate-2 felt sponge over n canonical felts (blocks/bn254.nim:23-29) */
void cspc_sponge2(uint64_t out[4], const uint64_t *felts, size_t n) {
  fr s[3];
  memset(s, 0, sizeof s);
  memcpy(s[2], P2_SPONGE2_IV, 32);
  size_t total = n + 1;
  if (total & 1) total++;
  for (size_t i = 0; i < total; i += 2) {
    for (int half = 0; half < 2; half++) {
      size_t k = i + half;
      fr a;
      if (k < n) fr_to_mont(a, felts + 4 * k);
      else if (k == n) memcpy(a, P2_ONE_MONT, 32);
      else memset(a, 0, 32);
      fr_add(s[half], s[half], a);
    }
    p2_permute(s);
  }
  fr_from_mont(out, s[0]);
}

/* rate-1 felt sponge (poseidon2_sponge.circom rate=1, Sponge.hs:13-26) */
void cspc_sponge1(uint64_t out[4], const uint64_t *felts, size_t n) {
  fr s[3];
  memset(s, 0, sizeof s);
  memcpy(s[2], P2_SPONGE1_IV, 32);
  for (size_t k = 0; k <= n; k++) { /* inputs then one felt-1 pad */
    fr a;
    if (k < n) fr_to_mont(a, felts + 4 * k);
    else memcpy(a, P2_ONE_MONT, 32);
    fr_add(s[0], s[0], a);
    p2_permute(s);
  }
  fr_from_mont(out, s[0]);
}

void cspc_fake_cells(uint8_t *out, size_t cell_size, uint64_t seed,
                     uint64_t start_idx, size_t n) {
  for (size_t i = 0; i < n; i++)
    fake_cell(out + i * cell_size, cell_size, seed, start_idx + i);
}

typedef struct {
  uint8_t *out;
  size_t cell_size;
  uint64_t seed, start_idx;
} fake_ctx;

static void fake_cells_range(void *vctx, size_t b, size_t e) {
  fake_ctx *c = (fake_ctx *)vctx;
  for (size_t i = b; i < e; i++)
    fake_cell(c->out + i * c->cell_size, c->cell_size, c->seed,
              c->start_idx + i);
}

/* threaded fake-data generation (cells are independent; the recurrence is
 * sequential only within a cell, slot.nim:22-32) */
void cspc_fake_cells_mt(uint8_t *out, size_t cell_size, uint64_t seed,
                        uint64_t start_idx, size_t n, int nthreads) {
  fake_ctx ctx = {out, cell_size, seed, start_idx};
  parallel_for(fake_cells_range, &ctx, n, nthreads);
}

typedef struct {
  const uint8_t *data;
  size_t cell_size;
  uint64_t *out;
} hash_ctx;

static void hash_cells_range(void *vctx, size_t b, size_t e) {
  hash_ctx *c = (hash_ctx *)vctx;
  for (size_t i = b; i < e; i++)
    hash_cell(c->out + 4 * i, c->data + i * c->cell_size, c->cell_size);
}

/* batched cell hashing: n cells of cell_size bytes -> n canonical felts */
void cspc_hash_cells(uint64_t *out, const uint8_t *data, size_t cell_size,
                     size_t n, int nthreads) {
  hash_ctx ctx = {data, cell_size, out};
  parallel_for(hash_cells_range, &ctx, n, nthreads);
}

typedef struct {
  const uint64_t *src; /* Montgomery */
  uint64_t *dst;       /* Montgomery */
  size_t width;        /* width of src layer */
  int even_key, odd_key;
} layer_ctx;

static void layer_range(void *vctx, size_t b, size_t e) {
  layer_ctx *c = (layer_ctx *)vctx;
  static const fr zero = {0, 0, 0, 0};
  for (size_t i = b; i < e; i++) {
    size_t j = 2 * i;
    if (j + 1 < c->width)
      p2_compress_mont(c->dst + 4 * i, c->src + 4 * j, c->src + 4 * (j + 1),
                       c->even_key);
    else
      p2_compress_mont(c->dst + 4 * i, c->src + 4 * j, zero, c->odd_key);
  }
}

/* Build every layer of the keyed Merkle tree over n canonical leaves
 * (convention per reference/nim/proof_input/src/merkle/bn254.nim:18-63:
 * keys None/Bottom/Odd/OddBottom = 0..3, odd node compresses (x, 0);
 * a singleton bottom layer still gets one bottom-odd compression).
 * `out` receives the leaves then each layer, canonical form, packed
 * consecutively; total felts = cspc_merkle_total_nodes(n). Returns depth. */
size_t cspc_merkle_total_nodes(size_t n) {
  size_t total = n, w = n;
  int bottom = 1;
  while (w > 1 || bottom) {
    w = (w + 1) >> 1;
    if (bottom && n == 1) w = 1; /* singleton: one compression to width 1 */
    total += w;
    bottom = 0;
  }
  return total;
}

int cspc_merkle_build(uint64_t *out, const uint64_t *leaves, size_t n,
                      int nthreads) {
  if (n == 0) return -1;
  /* copy leaves to out (canonical) and build a Montgomery scratch layer */
  memcpy(out, leaves, n * 32);
  uint64_t *cur = (uint64_t *)malloc(n * 32);
  uint64_t *nxt = (uint64_t *)malloc(((n + 1) / 2 + 1) * 32);
  if (!cur || !nxt) return -2;
  for (size_t i = 0; i < n; i++) fr_to_mont(cur + 4 * i, leaves + 4 * i);

  size_t w = n, off = n;
  int bottom = 1, depth = 0;
  while (w > 1 || bottom) {
    size_t half = (w + 1) >> 1;
    layer_ctx ctx = {cur, nxt, w, bottom ? 1 : 0, bottom ? 3 : 2};
    parallel_for(layer_range, &ctx, half, nthreads);
    for (size_t i = 0; i < half; i++)
      fr_from_mont(out + 4 * (off + i), nxt + 4 * i);
    off += half;
    w = half;
    bottom = 0;
    depth++;
    uint64_t *tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  free(cur);
  free(nxt);
  return depth;
}

typedef struct {
  const uint8_t *data; /* n_blocks * cells_per_block * cell_size bytes */
  size_t cell_size;
  size_t cells_per_block;
  uint64_t *mini;      /* per-block mini-tree layers, canonical */
  size_t mini_stride;  /* felts per block in `mini` */
  uint64_t *roots_m;   /* Montgomery block roots, n_blocks */
} block_ctx;

static void block_range(void *vctx, size_t b, size_t e) {
  block_ctx *c = (block_ctx *)vctx;
  size_t k = c->cells_per_block;
  uint64_t *leaves = (uint64_t *)malloc(k * 32);
  for (size_t blk = b; blk < e; blk++) {
    const uint8_t *bd = c->data + blk * k * c->cell_size;
    for (size_t i = 0; i < k; i++)
      hash_cell(leaves + 4 * i, bd + i * c->cell_size, c->cell_size);
    uint64_t *out = c->mini + blk * c->mini_stride;
    cspc_merkle_build(out, leaves, k, 1);
    fr_to_mont(c->roots_m + 4 * blk,
               out + (c->mini_stride - 4)); /* last felt = root */
  }
  free(leaves);
}

/* Full slot-tree build from raw slot bytes: hashes every cell, builds each
 * depth-log2(cells_per_block) block mini-tree, then the big tree over block
 * roots (gen_input/bn254.nim:21-30 built ONCE, layers kept).  `mini` gets
 * n_blocks consecutive mini-trees (cspc_merkle_total_nodes(cells_per_block)
 * felts each); `big` gets the big-tree layers over the n_blocks roots
 * (cspc_merkle_total_nodes(n_blocks) felts, leaves included). */
int cspc_slot_tree_from_bytes(uint64_t *mini, uint64_t *big,
                              const uint8_t *data, size_t cell_size,
                              size_t cells_per_block, size_t n_blocks,
                              int nthreads) {
  size_t stride = cspc_merkle_total_nodes(cells_per_block) * 4;
  uint64_t *roots_m = (uint64_t *)malloc(n_blocks * 32);
  if (!roots_m) return -2;
  block_ctx ctx = {data, cell_size, cells_per_block, mini, stride, roots_m};
  parallel_for(block_range, &ctx, n_blocks, nthreads);
  uint64_t *roots = (uint64_t *)malloc(n_blocks * 32);
  for (size_t i = 0; i < n_blocks; i++) fr_from_mont(roots + 4 * i, roots_m + 4 * i);
  int d = cspc_merkle_build(big, roots, n_blocks, nthreads);
  free(roots_m);
  free(roots);
  return d;
}

/* sampled cell index: low `log2_n_cells` bits of
 * sponge2([entropy, slotRoot, counter]) (sample/bn254.nim:16-24) */
uint64_t cspc_sample_cell_index(const uint64_t entropy[4],
                                const uint64_t slot_root[4],
                                uint64_t counter, int log2_n_cells) {
  uint64_t felts[12];
  memcpy(felts, entropy, 32);
  memcpy(felts + 4, slot_root, 32);
  felts[8] = counter;
  felts[9] = felts[10] = felts[11] = 0;
  uint64_t h[4];
  cspc_sponge2(h, felts, 3);
  return h[0] & ((1ULL << log2_n_cells) - 1);
}

/* Goldilocks track (single compilation unit: shares fake_cell and
 * parallel_for above). */
#include "cspc_gl.c"
