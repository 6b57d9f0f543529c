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
// Design, M6: warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate) in
// inline PTX.  A CTA owns a strip of kDotCols = 64 columns (512 CTAs over
// the tools' 32768 columns), and M / 16 warps, each 16 rows of W by the
// whole strip (its (16, 64) f32 accumulator is 32 registers a thread).  W
// goes into shared memory once a CTA and each warp keeps its rows' A
// fragments in registers for all products; the strip of A stays in shared
// memory (column-major, padded by 8 bf16 a column so that B fragment loads
// meet no bank conflict) across the n_dots products, and the CTA adds 1 to
// it in bf16 (round to nearest even) between two products.  wgmma, which
// the full tensor-core rate needs, is work for a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kReps = 512;   // op groups of M1 and M2; M3 runs kReps / 4
constexpr int kReps2 = 256;  // products of M4; M5 runs kReps2 / 2 round trips
constexpr int kThreads = 256;
constexpr int kDotCols = 64;  // columns of A a CTA of M6 owns
constexpr int kDotPad = 8;    // bf16 of padding a row of W and a column of A

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int M, int K>
constexpr int dot_smem_bytes() {
  return (M + kDotCols) * (K + kDotPad) * (int)sizeof(__nv_bfloat16);
}

// out (M, cols) f32 = sum over n_dots of W @ A_d, A_0 = a (K, cols) bf16,
// A_{d+1} = bf16(A_d + 1); W (M, K) bf16; all row-major.  Fragment layouts
// of mma.m16n8k16 (PTX ISA): with g = lane / 4 and t = lane % 4, the A
// fragment holds rows g and g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// the B fragment rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; the
// accumulator rows g and g + 8 at columns 2t and 2t + 1.
template <int M, int K>
__global__ void __launch_bounds__(M / 16 * 32)
dot_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
           float* __restrict__ out, int n_dots, long long cols) {
  static_assert(M % 16 == 0 && K % 16 == 0, "M and K are multiples of 16");
  constexpr int kStride = K + kDotPad;  // bf16 a row of sW, a column of sA
  constexpr int kWarpThreads = M / 16 * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem);  // [M][kStride]
  __nv_bfloat16* sA = sW + M * kStride;                       // [kDotCols][kStride]
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = (tid >> 5) * 16;
  const long long c0 = (long long)blockIdx.x * kDotCols;

  for (int i = tid; i < M * K; i += kWarpThreads) sW[(i / K) * kStride + i % K] = w[i];
  for (int i = tid; i < K * kDotCols; i += kWarpThreads) {
    const int k = i / kDotCols, n = i % kDotCols;
    sA[n * kStride + k] = a[(long long)k * cols + c0 + n];
  }
  __syncthreads();

  uint32_t wf[K / 16][4];  // this warp's 16 rows of W as A fragments
#pragma unroll
  for (int ks = 0; ks < K / 16; ks++) {
    const __nv_bfloat16* p = sW + (r0 + g) * kStride + ks * 16 + 2 * t;
    wf[ks][0] = ld32(p);
    wf[ks][1] = ld32(p + 8 * kStride);
    wf[ks][2] = ld32(p + 8);
    wf[ks][3] = ld32(p + 8 * kStride + 8);
  }

  float acc[kDotCols / 8][4];
#pragma unroll
  for (int nb = 0; nb < kDotCols / 8; nb++)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  for (int d = 0; d < n_dots; d++) {
#pragma unroll
    for (int nb = 0; nb < kDotCols / 8; nb++) {
      const __nv_bfloat16* col = sA + (nb * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int ks = 0; ks < K / 16; ks++)
        mma_bf16(acc[nb], wf[ks], ld32(col + ks * 16), ld32(col + ks * 16 + 8));
    }
    if (d + 1 < n_dots) {
      __syncthreads();  // every warp has read this A
      for (int i = tid; i < kDotCols * K / 2; i += kWarpThreads) {
        __nv_bfloat162* p =
            reinterpret_cast<__nv_bfloat162*>(sA + (i / (K / 2)) * kStride) + i % (K / 2);
        const float2 f = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(f.x + 1.f, f.y + 1.f);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int nb = 0; nb < kDotCols / 8; nb++) {
    float* o = out + (long long)(r0 + g) * cols + c0 + nb * 8 + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(o + 8 * cols) = make_float2(acc[nb][2], acc[nb][3]);
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
  constexpr int bytes = dot_smem_bytes<M, K>();
  cudaError_t err = cudaFuncSetAttribute(dot_kernel<M, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dot_kernel<M, K><<<(unsigned)(cols / kDotCols), M / 16 * 32, bytes, stream>>>(
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

// M6 for (m, k) = (64, 32) or (128, 128); cols a multiple of 64.
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
