// The TPU microbenchmarks on Hopper: M1-M6, the rate probes behind every
// kernel bound of the port (the integer multiply pipe, the other integer
// ops, conversions between integers and floats, the tensor cores).
//
// Replaces the Pallas TPU kernels of tools/microbench.py and
// tools/microbench2.py:
//   M1  microbench.py  _mul_kernel   a = a * b; b = b + a          (x512)
//   M2  microbench.py  _add_kernel   a = a + b; b = b ^ a          (x512)
//   M3  microbench.py  _mix_kernel   2 products, 13 adds, shifts and
//                                    logic ops: a Montgomery step   (x128)
//   M4  microbench2.py _ilp_kernel   4 or 8 independent chains
//                                    x_i = (a + i) * b * b * ...    (256 products)
//   M5  microbench2.py _conv_kernel  u32 -> i32 -> f32 -> i32 -> u32 of
//                                    a & 0xFF, summed               (x128)
//   M6  microbench2.py _dot_kernel_factory
//                                    acc += W (M, K) @ A (K, cols) in f32 from
//                                    bf16, n_dots times, A = bf16(A + 1) after
//                                    each product
// The plain torch versions are ops/microbench_plain.py; the wrappers are
// ops/microbench_cuda.py.  All arithmetic of M1-M5 is u32 with wraparound.
//
// What bounds them here: M1-M5 are a chain of register ops per element, so
// the issue rate of one pipe: the multiply pipe (IMAD, 64 a clock an SM)
// for M1 and M4; the integer ALU (64 a clock an SM) for M2's xors (its adds
// issue on the multiply pipe as IMAD.IADD) and for M3, whose 2 products a
// group sit among some 7 instructions that only the ALU issues (LOP3,
// LEA.HI, IADD3); the conversion pipe (16 a clock an SM) for M5's float ->
// int conversions.  M6 is bound by the tensor cores (989 TFLOP/s dense
// bf16 on an H100 SXM), the bytes of A and of the output after them.
//
// Design, M1-M5: one thread an element and its whole chain in registers,
// 256 threads a CTA, a grid over all elements (the TPU's 64 sequential
// tiles would fill 64 of the 132 SMs), loops fully unrolled so that the
// SASS holds each issued instruction once (its static count is the count
// a thread executes).  The compiler may remove the work the kernel is
// there to measure: LLVM turns a chain of products by one b into
// squarings, and a round trip of an 8-bit value through a float folds to
// nothing.  So each multiply and each conversion is inline PTX
// (`asm volatile`, which NVVM neither merges nor moves).  ptxas, which
// optimizes that PTX, still merged work in a first build (H100, CUDA
// 12.8): it factored M4's sum of chains, sum_i (a + i) b^k, into one chain
// (sum_i (a + i)) b^k (32 products where the source has 256), and merged
// M3's two products a * b and b * a into one.  So the kernels take a
// `zero` argument, 0 at run time, which ptxas cannot see: M4's stream i
// multiplies by b + i * zero, and M3's second product is b * a + zero in
// one multiply-add.  Each round trip of M5 converts the result of the one
// before, which equals a & 0xFF (the round trip is exact for 8-bit
// values), so that ptxas cannot merge 128 conversions of one register into
// one.  On sm_90 ptxas makes the int -> float conversion I2FP, which does
// not issue on the 16-a-clock conversion pipe; F2I does.
//
// Design, M6: wgmma (warpgroup matrix multiply, sm_90a) with the operand
// that changes between products in registers.  The kernel computes the
// transpose, out^T (cols, M) = sum_d A_d^T (cols, K) @ W^T (K, M): wgmma's
// m64 rows are 64 columns of A (a CTA of one warpgroup owns a strip of
// kDotCols = 64 columns, 512 CTAs over the tools' 32768), its N is W's M
// (64 or 128), and W^T is the B operand in shared memory.  W is row-major
// (M, K), so W^T is K-major, the layout B takes untransposed; it is
// written once a CTA into wgmma's layout without swizzle (core matrices of
// 8 rows by 16 bytes).  The strip of A is staged once through shared
// memory (16-byte copies) and read into A fragments with ldmatrix.trans;
// from then on it lives in registers.  The bf16 +1 between products is an
// add.rn.bf16x2 on the thread's own fragment registers (round to nearest
// even: 257 rounds to 256, so no product may be folded into another), and
// the f32 accumulator (M / 2 registers a thread) stays in registers across
// all n_dots products.  The A registers of a wgmma in flight may be
// neither read nor written, so the strip is held twice: buffer 0 holds
// A_d for even d, buffer 1 for odd d; a buffer is advanced two steps
// (two rounded adds, as two products apart apply them) once the wgmma
// that read it has retired (wgmma.wait_group 1: one product stays in
// flight while the next one's registers are made).  A third copy kept as
// the source of both would cost K / 4 more registers a thread: 160 at K =
// 128 against 128, two CTAs an SM instead of three.
// The output strip is staged through shared memory so that out's rows are
// written with 16-byte stores.  What this leaves above the bound is a
// call's fixed cost: every CTA loads its strip, then multiplies, then
// writes its output (8 or 16 MB in all), and the CTAs of one wave do so in
// step, so the copies do not overlap the products.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kReps = 512;   // op groups of M1 and M2; M3 runs kReps / 4
constexpr int kReps2 = 256;  // products of M4; M5 runs kReps2 / 2 round trips
constexpr int kThreads = 256;
constexpr int kDotCols = 64;      // columns of A a CTA of M6 owns: wgmma's 64 rows
constexpr int kDotThreads = 128;  // one warpgroup a CTA
constexpr int kStripPad = 8;      // bf16 of padding a row of the staged strip of A
constexpr int kOutPad = 4;        // f32 of padding a row of the staged output
constexpr uint32_t kBf16x2One = 0x3F803F80u;  // (1.0, 1.0) as two bf16

enum Op { kMul = 0, kAdd = 1, kMix = 2, kIlp4 = 3, kIlp8 = 4, kConv = 5 };

__device__ __forceinline__ uint32_t mul_lo(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t round_trip(uint32_t v) {
  // u32 -> i32 -> f32 -> i32 -> u32
  float f;
  int32_t i;
  asm volatile("cvt.rn.f32.s32 %0, %1;" : "=f"(f) : "r"((int32_t)v));
  asm volatile("cvt.rzi.s32.f32 %0, %1;" : "=r"(i) : "f"(f));
  return (uint32_t)i;
}

__device__ __forceinline__ uint32_t mad_lo(uint32_t x, uint32_t y, uint32_t z) {
  uint32_t r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(z));
  return r;
}

template <int N>
__device__ __forceinline__ uint32_t ilp(uint32_t a, uint32_t b, uint32_t zero) {
  uint32_t x[N], bi[N];
#pragma unroll
  for (int i = 0; i < N; i++) {
    x[i] = a + (uint32_t)i;
    bi[i] = b + (uint32_t)i * zero;  // b, in a register ptxas cannot prove equal to b
  }
#pragma unroll
  for (int r = 0; r < kReps2 / N; r++) {
#pragma unroll
    for (int i = 0; i < N; i++) x[i] = mul_lo(x[i], bi[i]);
  }
  uint32_t acc = x[0];
#pragma unroll
  for (int i = 1; i < N; i++) acc += x[i];
  return acc;
}

template <int OP>
__device__ __forceinline__ uint32_t body(uint32_t a, uint32_t b, uint32_t zero) {
  if constexpr (OP == kMul) {
#pragma unroll
    for (int r = 0; r < kReps; r++) {
      a = mul_lo(a, b);
      b = b + a;
    }
    return a + b;
  } else if constexpr (OP == kAdd) {
#pragma unroll
    for (int r = 0; r < kReps; r++) {
      a = a + b;
      b = b ^ a;
    }
    return a + b;
  } else if constexpr (OP == kMix) {
#pragma unroll
    for (int r = 0; r < kReps / 4; r++) {
      const uint32_t t = mul_lo(a, b);
      const uint32_t q = mad_lo(b, a, zero);
      a = (t & 0xFFFFu) + (q >> 16);
      b = (b + (t >> 16)) ^ (q & 0xFFFFu);
      a = a + b;
      b = b + t;
      a = a ^ q;
      b = b + a;
      a = a + q;
      b = b ^ t;
    }
    return a + b;
  } else if constexpr (OP == kIlp4) {
    return ilp<4>(a, b, zero);
  } else if constexpr (OP == kIlp8) {
    return ilp<8>(a, b, zero);
  } else {
    static_assert(OP == kConv, "unknown op");
    uint32_t v = a & 0xFFu, acc = 0;
#pragma unroll
    for (int r = 0; r < kReps2 / 2; r++) {
      v = round_trip(v);
      acc += v;
    }
    return acc;
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
elem_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
            uint32_t* __restrict__ out, long long n, uint32_t zero) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = body<OP>(a[i], b[i], zero);
}

// M6's shared memory.  w: W (M, K) as wgmma's B operand (K-major, no
// swizzle): core matrices of 8 rows of W by 8 of its K values (8 x 16
// bytes), the K / 8 core matrices of 8 rows side by side, then the next 8
// rows.  strip: the CTA's columns of A as A lays them out (K rows
// of kDotCols bf16, padded so that ldmatrix's 8 row addresses fall in
// distinct banks); out: the output strip (M rows of kDotCols f32, padded
// so that the accumulator's stores meet no bank conflict).  Raw 16-bit
// words: the kernel only moves them.
template <int M, int K>
struct DotSmem {
  uint16_t w[M * K];
  union {
    uint16_t strip[K][kDotCols + kStripPad];
    float out[M][kDotCols + kOutPad];
  };
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's descriptor of an operand in shared memory without swizzle: the
// start address, the leading byte offset (between the core matrices of
// neighbouring K) and the stride byte offset (between neighbouring groups
// of 8 rows), each in 16-byte units; layout type 0 (no swizzle) in bits
// 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_add_one(uint32_t x) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(kBf16x2One));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a register's reads and writes across the
// wgmma waits around this point (the wgmma reads and writes it unseen).
template <int S>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; s++)
#pragma unroll
    for (int i = 0; i < 4; i++) asm volatile("" : "+r"(r[s][i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; i++) asm volatile("" : "+f"(r[i])::"memory");
}

#define CSPC_ACC8(d, i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64, N) f32 += a (64, 16) bf16 in registers @ B (16, N) bf16 in shared
// memory (K-major), one warpgroup.  Fragments (PTX ISA): warp w of the
// warpgroup holds rows 16w .. 16w + 15; with g = lane / 4 and t = lane %
// 4, a[0] holds row g at columns 2t, 2t + 1, a[1] row g + 8, a[2] and a[3]
// the same rows at columns 2t + 8, 2t + 9; d[4j + 2h + e] is row g + 8h,
// column 8j + 2t + e.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : CSPC_ACC8(d, 0), CSPC_ACC8(d, 8), CSPC_ACC8(d, 16), CSPC_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : CSPC_ACC8(d, 0), CSPC_ACC8(d, 8), CSPC_ACC8(d, 16), CSPC_ACC8(d, 24),
        CSPC_ACC8(d, 32), CSPC_ACC8(d, 40), CSPC_ACC8(d, 48), CSPC_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef CSPC_ACC8

// One product: acc += A_d^T @ W^T over K / 16 slices of k16, one commit
// group.  The descriptor of slice s starts 2 core matrices (256 bytes, 16
// units) after slice s - 1's.
template <int M, int K>
__device__ __forceinline__ void dot_product(float (&acc)[M / 2], uint32_t (&f)[K / 16][4],
                                            uint64_t desc) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; s++) wgmma_rs<M>(acc, f[s], desc + 16 * s);
  wgmma_commit();
}

// Two bf16 steps A = bf16(A + 1) on a buffer of fragments.
template <int K>
__device__ __forceinline__ void advance_two(uint32_t (&f)[K / 16][4]) {
#pragma unroll
  for (int s = 0; s < K / 16; s++)
#pragma unroll
    for (int i = 0; i < 4; i++) f[s][i] = bf16x2_add_one(bf16x2_add_one(f[s][i]));
}

// out (M, cols) f32 = sum over n_dots of W @ A_d, A_0 = a (K, cols) bf16,
// A_{d+1} = bf16(A_d + 1); W (M, K) bf16; all row-major, a and w 16-byte
// aligned.  One warpgroup a CTA, 64 columns.
template <int M, int K>
__global__ void __launch_bounds__(kDotThreads)
dot_wgmma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                 float* __restrict__ out, int n_dots, long long cols) {
  static_assert(M == 64 || M == 128, "wgmma's N is W's M: 64 or 128");
  static_assert(K % 16 == 0, "K is a multiple of wgmma's k16");
  constexpr int kSlices = K / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DotSmem<M, K>& sm = *reinterpret_cast<DotSmem<M, K>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c0 = (long long)blockIdx.x * kDotCols;

  // W into B's layout, 16 bytes a thread a step in shared memory's order:
  // chunk j is row 8 (j / K) + j % 8 of W, its K values 8 (j / 8 % (K / 8)) on
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  uint4* sw4 = reinterpret_cast<uint4*>(sm.w);
  for (int j = tid; j < M * K / 8; j += kDotThreads) {
    const int n = (j / K) * 8 + (j & 7), kc = (j >> 3) % (K / 8);
    sw4[j] = w4[n * (K / 8) + kc];
  }
  for (int j = tid; j < K * kDotCols / 8; j += kDotThreads) {
    const int k = j / (kDotCols / 8), q = j % (kDotCols / 8);
    *reinterpret_cast<uint4*>(&sm.strip[k][8 * q]) =
        *reinterpret_cast<const uint4*>(a + k * cols + c0 + 8 * q);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // W, for wgmma's reads
  __syncthreads();

  // A fragments of slice s: 8 x 8 matrices (k0, c0), (k0, c0 + 8), (k0 +
  // 8, c0), (k0 + 8, c0 + 8) of the strip, k0 = 16 s, c0 = 16 warp, each
  // transposed; lane L gives row L % 8 of matrix L / 8
  uint32_t f0[kSlices][4], f1[kSlices][4];
  {
    const int i = lane >> 3, r = lane & 7;
#pragma unroll
    for (int s = 0; s < kSlices; s++) {
      const uint16_t* row = sm.strip[16 * s + 8 * (i >> 1) + r];
      ldmatrix_x4_trans(f0[s], smem_addr(row + 16 * warp + 8 * (i & 1)));
#pragma unroll
      for (int e = 0; e < 4; e++) f1[s][e] = bf16x2_add_one(f0[s][e]);
    }
  }
  const uint64_t desc = smem_desc(smem_addr(sm.w), 128, (K / 8) * 128);

  float acc[M / 2];
#pragma unroll
  for (int i = 0; i < M / 2; i++) acc[i] = 0.f;

  // product d reads buffer d % 2, which holds A_d; a buffer is advanced
  // once the product two before has retired
  for (int d = 0; d < n_dots; d += 2) {
    if (d > 0) advance_two<K>(f0);
    dot_product<M, K>(acc, f0, desc);
    wgmma_wait<1>();  // product d - 1 has retired: buffer 1 is free
    fence_regs(f1);
    if (d + 1 == n_dots) break;
    if (d > 0) advance_two<K>(f1);
    dot_product<M, K>(acc, f1, desc);
    wgmma_wait<1>();  // product d has retired: buffer 0 is free
    fence_regs(f0);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  __syncthreads();  // every warp has read the strip: out takes its place
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < M / 8; j++)
#pragma unroll
    for (int h = 0; h < 2; h++)
#pragma unroll
      for (int e = 0; e < 2; e++)
        sm.out[8 * j + 2 * t + e][16 * warp + g + 8 * h] = acc[4 * j + 2 * h + e];
  __syncthreads();
  for (int j = tid; j < M * kDotCols / 4; j += kDotThreads) {
    const int m = j / (kDotCols / 4), q = j % (kDotCols / 4);
    *reinterpret_cast<float4*>(out + m * cols + c0 + 4 * q) =
        *reinterpret_cast<const float4*>(&sm.out[m][4 * q]);
  }
}

template <int OP>
void launch_elem(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
                 cudaStream_t stream) {
  elem_kernel<OP><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      a, b, out, n, 0u);
}

template <int M, int K>
cudaError_t launch_dot(const __nv_bfloat16* a, const __nv_bfloat16* w, float* out,
                       int n_dots, long long cols, cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(DotSmem<M, K>);
  cudaError_t err = cudaFuncSetAttribute(dot_wgmma_kernel<M, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)  // as much shared memory as the SM has: three CTAs at (128, 128)
    err = cudaFuncSetAttribute(dot_wgmma_kernel<M, K>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dot_wgmma_kernel<M, K><<<(unsigned)(cols / kDotCols), kDotThreads, bytes, stream>>>(
      a, w, out, n_dots, cols);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// op: 0 mul (M1), 1 add (M2), 2 mix (M3), 3 ilp4, 4 ilp8 (M4), 5 conv (M5)
// over n elements of a, b -> out, all u32.
int cspc_mb_elem(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kMul: launch_elem<kMul>(a, b, out, n, s); break;
    case kAdd: launch_elem<kAdd>(a, b, out, n, s); break;
    case kMix: launch_elem<kMix>(a, b, out, n, s); break;
    case kIlp4: launch_elem<kIlp4>(a, b, out, n, s); break;
    case kIlp8: launch_elem<kIlp8>(a, b, out, n, s); break;
    case kConv: launch_elem<kConv>(a, b, out, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// M6 for (m, k) = (64, 32) or (128, 128); cols a multiple of 64; a and w
// 16-byte aligned.
int cspc_mb_dot(int m, int k, const void* a, const void* w, float* out, int n_dots,
                long long cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cols <= 0 || cols % kDotCols != 0 || n_dots < 0) return (int)cudaErrorInvalidValue;
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 64 && k == 32)
    err = launch_dot<64, 32>(ab, wb, out, n_dots, cols, s);
  else if (m == 128 && k == 128)
    err = launch_dot<128, 128>(ab, wb, out, n_dots, cols, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
