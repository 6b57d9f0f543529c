/* Goldilocks track of the C host library: Poseidon2-GL t=12 and
 * Monolith-64 permutations, rate-8 digest sponges, 62-byte cell encoding,
 * keyed digest Merkle trees, threaded slot-tree build and index sampling.
 *
 * Mirrors oracle/goldilocks.py + oracle/goldilocks_pipeline.py (the
 * reference call surface: reference/nim/proof_input/src/merkle/goldilocks/
 * {poseidon2,monolith}.nim, blocks/goldilocks.nim, sample/goldilocks.nim).
 *
 * This file is #included at the end of cspc_native.c (one compilation
 * unit: shares fake_cell and parallel_for). */

#include "gl_constants.h"

typedef uint64_t gl_digest[4];

/* ------------------------------------------------------------------ */
/* Field ops: p = 2^64 - 2^32 + 1; u128 product + two-fold reduction.   */

static inline uint64_t gl_reduce128(u128 x) {
  uint64_t lo = (uint64_t)x;
  uint64_t hi = (uint64_t)(x >> 64);
  uint64_t hi_lo = hi & 0xffffffffULL;
  uint64_t hi_hi = hi >> 32;
  /* lo - hi_hi  (mod p): on borrow subtract 2^32-1 more (== add p - 2^64) */
  uint64_t t = lo - hi_hi;
  if (lo < hi_hi) t -= 0xffffffffULL;
  /* + hi_lo * (2^32 - 1): cannot overflow u64 by more than one wrap */
  uint64_t t2 = hi_lo * 0xffffffffULL;
  uint64_t r = t + t2;
  if (r < t) r += 0xffffffffULL; /* carry: 2^64 ≡ 2^32 - 1 */
  if (r >= GL_P) r -= GL_P;
  return r;
}

static inline uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128((u128)a * b);
}

static inline uint64_t gl_addf(uint64_t a, uint64_t b) {
  uint64_t r = a + b;
  if (r < a) r += 0xffffffffULL; /* wrapped past 2^64 */
  if (r >= GL_P) r -= GL_P;
  return r;
}

static inline uint64_t gl_sbox7(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(gl_mul(x4, x2), x);
}

/* ------------------------------------------------------------------ */
/* Poseidon2-GL t=12 permutation. */

static void gl_m4_block(uint64_t x[4]) {
  /* M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] fast chain */
  uint64_t t0 = gl_addf(x[0], x[1]);
  uint64_t t1 = gl_addf(x[2], x[3]);
  uint64_t t2 = gl_addf(gl_addf(x[1], x[1]), t1);
  uint64_t t3 = gl_addf(gl_addf(x[3], x[3]), t0);
  uint64_t t4 = gl_addf(gl_addf(gl_addf(t1, t1), gl_addf(t1, t1)), t3);
  uint64_t t5 = gl_addf(gl_addf(gl_addf(t0, t0), gl_addf(t0, t0)), t2);
  x[0] = gl_addf(t3, t5);
  x[1] = t5;
  x[2] = gl_addf(t2, t4);
  x[3] = t4;
}

static void gl_external_linear(uint64_t s[GL_T]) {
  uint64_t sum[4];
  for (int j = 0; j < 4; j++)
    sum[j] = gl_addf(gl_addf(s[j], s[4 + j]), s[8 + j]);
  for (int b = 0; b < 3; b++) {
    uint64_t blk[4];
    for (int j = 0; j < 4; j++) blk[j] = gl_addf(s[4 * b + j], sum[j]);
    gl_m4_block(blk);
    for (int j = 0; j < 4; j++) s[4 * b + j] = blk[j];
  }
}

static void gl_internal_linear(uint64_t s[GL_T]) {
  uint64_t tot = 0;
  for (int i = 0; i < GL_T; i++) tot = gl_addf(tot, s[i]);
  for (int i = 0; i < GL_T; i++)
    s[i] = gl_addf(tot, gl_mul(GL_DIAG_M1[i], s[i]));
}

static void gl_p2_permute(uint64_t s[GL_T]) {
  gl_external_linear(s);
  for (int r = 0; r < GL_RF / 2; r++) {
    for (int i = 0; i < GL_T; i++)
      s[i] = gl_sbox7(gl_addf(s[i], GL_EXT_RC[r][i]));
    gl_external_linear(s);
  }
  for (int r = 0; r < GL_RP; r++) {
    s[0] = gl_sbox7(gl_addf(s[0], GL_INT_RC[r]));
    gl_internal_linear(s);
  }
  for (int r = GL_RF / 2; r < GL_RF; r++) {
    for (int i = 0; i < GL_T; i++)
      s[i] = gl_sbox7(gl_addf(s[i], GL_EXT_RC[r][i]));
    gl_external_linear(s);
  }
}

/* ------------------------------------------------------------------ */
/* Monolith-64 t=12 permutation. */

static inline uint8_t gl_bar8(uint8_t x) {
  uint8_t nx = (uint8_t)~x;
  uint8_t r1 = (uint8_t)((nx << 1) | (nx >> 7));
  uint8_t r2 = (uint8_t)((x << 2) | (x >> 6));
  uint8_t r3 = (uint8_t)((x << 3) | (x >> 5));
  uint8_t y = (uint8_t)(x ^ (r1 & r2 & r3));
  return (uint8_t)((y << 1) | (y >> 7));
}

static inline uint64_t gl_bar64(uint64_t x) {
  uint64_t out = 0;
  for (int b = 0; b < 8; b++)
    out |= (uint64_t)gl_bar8((uint8_t)(x >> (8 * b))) << (8 * b);
  return out >= GL_P ? out - GL_P : out; /* oracle: % P (value < 2^64) */
}

/* Monolith Concrete: Plonky2-compatible MDS matmul.  Coefficients are
 * <= 41 and sum to 264, so the u128 accumulator stays < 2^73. */
static void gl_concrete(uint64_t s[GL_T]) {
  uint64_t out[GL_T];
  for (int r = 0; r < GL_T; r++) {
    u128 acc = 0;
    for (int c = 0; c < GL_T; c++) acc += (u128)GL_MONO_CONCRETE[r][c] * s[c];
    out[r] = gl_reduce128(acc);
  }
  for (int i = 0; i < GL_T; i++) s[i] = out[i];
}

static void gl_mono_permute(uint64_t s[GL_T]) {
  gl_concrete(s); /* initial Concrete */
  for (int r = 0; r < GL_MONO_ROUNDS; r++) {
    for (int i = 0; i < GL_MONO_BARS; i++) s[i] = gl_bar64(s[i]);
    /* Bricks: out_i = x_i + x_{i-1}^2 on original values */
    uint64_t prev = s[0];
    for (int i = 1; i < GL_T; i++) {
      uint64_t cur = s[i];
      s[i] = gl_addf(cur, gl_mul(prev, prev));
      prev = cur;
    }
    gl_concrete(s);
    for (int i = 0; i < GL_T; i++) s[i] = gl_addf(s[i], GL_MONO_RC[r][i]);
  }
}

typedef void (*gl_perm_fn)(uint64_t s[GL_T]);

static gl_perm_fn gl_perm_for(int hash_fun) {
  return hash_fun == 1 ? gl_mono_permute : gl_p2_permute;
}

/* ------------------------------------------------------------------ */
/* Digest ops: compression, rate-8 felt sponge, 62-byte marshalling.   */

void cspc_gl_permutation(uint64_t io[GL_T], int hash_fun) {
  gl_perm_for(hash_fun)(io);
}

void cspc_gl_compress(uint64_t out[4], const uint64_t x[4], const uint64_t y[4],
                      uint64_t key, int hash_fun) {
  uint64_t s[GL_T];
  for (int i = 0; i < 4; i++) s[i] = x[i];
  for (int i = 0; i < 4; i++) s[4 + i] = y[i];
  s[8] = key;
  s[9] = s[10] = s[11] = 0;
  gl_perm_for(hash_fun)(s);
  for (int i = 0; i < 4; i++) out[i] = s[i];
}

/* rate-8 sponge with 10* felt padding; felts values < p expected */
void cspc_gl_digest_felts(uint64_t out[4], const uint64_t *felts, size_t n,
                          int hash_fun) {
  gl_perm_fn perm = gl_perm_for(hash_fun);
  uint64_t s[GL_T] = {0};
  s[GL_T - 1] = GL_SPONGE_IV;
  size_t total = n + 1;
  total += (GL_RATE - total % GL_RATE) % GL_RATE;
  for (size_t i = 0; i < total; i += GL_RATE) {
    for (int j = 0; j < GL_RATE; j++) {
      size_t k = i + j;
      uint64_t blk = k < n ? felts[k] : (k == n ? 1u : 0u);
      s[j] = gl_addf(s[j], blk);
    }
    perm(s);
  }
  for (int i = 0; i < 4; i++) out[i] = s[i];
}

#define GL_CHUNK_BYTES 62

/* bytes -> 62-bit felts with 10* byte padding; out must hold
 * 8 * ceil((n+1)/62) felts.  Returns the felt count. */
size_t cspc_gl_bytes_to_felts(uint64_t *out, const uint8_t *data, size_t n) {
  size_t padded = n + 1;
  padded += (GL_CHUNK_BYTES - padded % GL_CHUNK_BYTES) % GL_CHUNK_BYTES;
  size_t n_chunks = padded / GL_CHUNK_BYTES;
  size_t nf = 0;
  for (size_t c = 0; c < n_chunks; c++) {
    uint8_t buf[GL_CHUNK_BYTES];
    for (int i = 0; i < GL_CHUNK_BYTES; i++) {
      size_t g = c * GL_CHUNK_BYTES + (size_t)i;
      buf[i] = g < n ? data[g] : (g == n ? 1 : 0);
    }
    for (int j = 0; j < 8; j++) {
      int bit0 = 62 * j;
      int byte0 = bit0 / 8;
      u128 acc = 0;
      for (int b = 0; b < 9 && byte0 + b < GL_CHUNK_BYTES; b++)
        acc |= (u128)buf[byte0 + b] << (8 * b);
      out[nf++] = (uint64_t)(acc >> (bit0 % 8)) & ((1ULL << 62) - 1);
    }
  }
  return nf;
}

void cspc_gl_hash_cell(uint64_t out[4], const uint8_t *data, size_t cell_size,
                       int hash_fun) {
  size_t padded = cell_size + 1;
  padded += (GL_CHUNK_BYTES - padded % GL_CHUNK_BYTES) % GL_CHUNK_BYTES;
  size_t nf_max = padded / GL_CHUNK_BYTES * 8;
  uint64_t felts[nf_max];
  size_t nf = cspc_gl_bytes_to_felts(felts, data, cell_size);
  cspc_gl_digest_felts(out, felts, nf, hash_fun);
}

/* ------------------------------------------------------------------ */
/* Keyed digest Merkle (same convention as the BN254 track).           */

typedef struct {
  const uint64_t *cur;
  uint64_t *next;
  int key;
  int hash_fun;
} gl_layer_ctx;

static void gl_layer_range(void *vctx, size_t b, size_t e) {
  gl_layer_ctx *c = (gl_layer_ctx *)vctx;
  for (size_t i = b; i < e; i++) {
    const uint64_t *x = c->cur + 8 * i;
    const uint64_t *y = x + 4;
    cspc_gl_compress(c->next + 4 * i, x, y, (uint64_t)c->key, c->hash_fun);
  }
}

/* builds all layers over n digest leaves; out layout: leaves first, then
 * each parent layer (total cspc_merkle_total_nodes(n) digests x 4 u64). */
int cspc_gl_merkle_build(uint64_t *out, const uint64_t *leaves, size_t n,
                         int hash_fun, int nthreads) {
  if (n == 0) return -1;
  memcpy(out, leaves, n * 4 * sizeof(uint64_t));
  uint64_t *cur = out;
  size_t w = n;
  int depth = 0;
  int bottom = 1;
  static const uint64_t zero[4] = {0, 0, 0, 0};
  while (w > 1 || bottom) {
    size_t half = w / 2;
    size_t next_w = (w + 1) / 2;
    if (w == 1) next_w = 1; /* singleton: one bottom-odd compression */
    uint64_t *next = cur + 4 * w;
    int key = bottom ? 1 : 0;
    gl_layer_ctx ctx = {cur, next, key, hash_fun};
    if (half) parallel_for(gl_layer_range, &ctx, half, nthreads);
    if (w % 2 == 1) {
      cspc_gl_compress(next + 4 * (next_w - 1), cur + 4 * (w - 1), zero,
                       (uint64_t)(bottom ? 3 : 2), hash_fun);
    }
    cur = next;
    w = next_w;
    depth++;
    bottom = 0;
  }
  return depth;
}

/* ------------------------------------------------------------------ */
/* Threaded slot tree: cells -> cell digests -> flat keyed reduction.  */

typedef struct {
  const uint8_t *data;
  size_t cell_size;
  uint64_t *out;
  uint64_t seed;
  int fake;
  int hash_fun;
} gl_cells_ctx;

static void gl_hash_cells_range(void *vctx, size_t b, size_t e) {
  gl_cells_ctx *c = (gl_cells_ctx *)vctx;
  uint8_t *tmp = c->fake ? malloc(c->cell_size) : NULL;
  for (size_t i = b; i < e; i++) {
    const uint8_t *cell;
    if (c->fake) {
      fake_cell(tmp, c->cell_size, c->seed, i);
      cell = tmp;
    } else {
      cell = c->data + i * c->cell_size;
    }
    cspc_gl_hash_cell(c->out + 4 * i, cell, c->cell_size, c->hash_fun);
  }
  free(tmp);
}

/* cell digests for n cells (fake=1: generate from seed; else data). */
void cspc_gl_hash_cells(uint64_t *out, const uint8_t *data, size_t cell_size,
                        size_t n, uint64_t seed, int fake, int hash_fun,
                        int nthreads) {
  gl_cells_ctx ctx = {data, cell_size, out, seed, fake, hash_fun};
  parallel_for(gl_hash_cells_range, &ctx, n, nthreads);
}

typedef struct {
  const uint64_t *cur;
  uint64_t *next;
  uint64_t key;
  int hash_fun;
} gl_flat_ctx;

static void gl_flat_range(void *vctx, size_t b, size_t e) {
  gl_flat_ctx *c = (gl_flat_ctx *)vctx;
  for (size_t i = b; i < e; i++)
    cspc_gl_compress(c->next + 4 * i, c->cur + 8 * i, c->cur + 8 * i + 4,
                     c->key, c->hash_fun);
}

/* full flat slot-tree layer stack over power-of-two n cells with the
 * cell->block->slot key schedule (bottom keys at depth 0 and at
 * block_tree_depth).  out holds 2n-1... exactly sum_{d} n>>d digests. */
int cspc_gl_slot_tree(uint64_t *out, size_t n, size_t cell_size,
                      uint64_t seed, int block_tree_depth, int hash_fun,
                      int nthreads) {
  if (n == 0 || (n & (n - 1))) return -1;
  cspc_gl_hash_cells(out, NULL, cell_size, n, seed, 1, hash_fun, nthreads);
  uint64_t *cur = out;
  size_t w = n;
  int d = 0;
  while (w > 1) {
    uint64_t *next = cur + 4 * w;
    uint64_t key = (d == 0 || d == block_tree_depth) ? 1 : 0;
    gl_flat_ctx ctx = {cur, next, key, hash_fun};
    parallel_for(gl_flat_range, &ctx, w / 2, nthreads);
    cur = next;
    w /= 2;
    d++;
  }
  return d;
}

/* sampling: low log2(n_cells) bits of lane 0 of
 * digest([entropy, slotRoot, intToDigest(counter)]) */
uint64_t cspc_gl_sample_cell_index(const uint64_t entropy[4],
                                   const uint64_t slot_root[4],
                                   uint64_t n_cells, uint64_t counter,
                                   int hash_fun) {
  uint64_t felts[12];
  for (int i = 0; i < 4; i++) felts[i] = entropy[i];
  for (int i = 0; i < 4; i++) felts[4 + i] = slot_root[i];
  felts[8] = counter % GL_P;
  felts[9] = felts[10] = felts[11] = 0;
  uint64_t d[4];
  cspc_gl_digest_felts(d, felts, 12, hash_fun);
  uint64_t mask = n_cells - 1;
  return d[0] & mask;
}
