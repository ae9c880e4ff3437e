// K3: per-row dynamic signed-int8 quantization (kernels/quantize_rows.py).
//
// One block per row.  Pass 1 reduces the row's min and max (warp shuffles,
// then one value per warp in shared memory); every thread derives
//   alpha = max(xmax - xmin, 1e-12) / 255,  beta = xmin + 128 * alpha;
// pass 2 writes q = clip(rint((x - beta) / alpha), -128, 127).
// Every float operation is the plain version's, rounded the same way:
// explicit _rn intrinsics (no FMA contraction), IEEE division and rintf
// (round half to even), so q, alpha and beta are bit-exact with it.
//
// The input is float or bfloat16, converted to float in registers: the
// conversion is exact, so a bf16 row gives the same q, alpha and beta as
// its float32 cast, and no cast kernel runs before this one.  Rows whose
// start is 16-byte aligned are read 16 bytes a thread at a time, all of a
// thread's words at once, and kept in registers for pass 2 (min and max
// do not depend on the order).
//
// What bounds a call is its launch, not its bytes (at most 1.4 MB on the
// serving paths, under half a microsecond at 3.35 TB/s).  So K3 is a
// programmatic-dependent-launch primary: every block lets the next kernel
// of the stream launch as soon as it starts (griddepcontrol.
// launch_dependents).  That kernel is K1, launched with programmatic
// stream serialization; its launch and prologue overlap this kernel, and
// its griddepcontrol.wait returns only once this grid has completed and
// its writes are visible.  K3 is itself launched as the dependent of the
// kernel before it and waits for that grid before any global access.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 4;               // 16-byte words a thread keeps

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the elements of one 16-byte word as floats
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& w, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  } else {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // bf16 -> f32 is a 16-bit shift
      out[2 * i] = __uint_as_float(u[i] << 16);
      out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ int8_t quantize(float x, float a, float b) {
  float v = rintf(__fdiv_rn(__fsub_rn(x, b), a));
  v = fminf(fmaxf(v, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ alpha, float* __restrict__ beta,
                     int n) {
  constexpr int kPer = 16 / sizeof(T);  // elements in a 16-byte word
  __shared__ float s_lo[kWarps];
  __shared__ float s_hi[kWarps];

  // the next kernel (K1) may launch now; it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // and this kernel may have been launched as the dependent of the one
  // before it: no global access until that grid has completed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int64_t row = blockIdx.x;
  const T* xr = x + row * n;
  int8_t* qr = q + row * n;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  const int nv = VEC ? n / kPer : 0;    // 16-byte words of the row

  // the row's first kCache words a thread are loaded at once and kept in
  // registers for the second pass (RWKV rows of 7168 bf16 fit); the rest
  // of a longer row is read again
  uint4 cache[kCache];
  float lo = INFINITY;
  float hi = -INFINITY;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < kCache; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w < nv) cache[i] = xv[w];
    }
#pragma unroll
    for (int i = 0; i < kCache; ++i) {
      if (threadIdx.x + i * kThreads >= nv) continue;
      float f[kPer];
      unpack16<T>(cache[i], f);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        lo = fminf(lo, f[e]);
        hi = fmaxf(hi, f[e]);
      }
    }
    for (int w = threadIdx.x + kCache * kThreads; w < nv; w += kThreads) {
      float f[kPer];
      unpack16<T>(xv[w], f);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        lo = fminf(lo, f[e]);
        hi = fmaxf(hi, f[e]);
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float v = to_float(xr[j]);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  // every thread derives alpha and beta itself (one barrier, not two)
  float l = s_lo[0];
  float h = s_hi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    l = fminf(l, s_lo[w]);
    h = fmaxf(h, s_hi[w]);
  }
  const float span = fmaxf(__fsub_rn(h, l), 1e-12f);
  const float a = __fdiv_rn(span, 255.0f);
  const float b = __fadd_rn(l, __fmul_rn(128.0f, a));
  if (threadIdx.x == 0) {
    alpha[row] = a;
    beta[row] = b;
  }
  if constexpr (VEC) {
    auto store = [&](int w, const uint4& word) {
      float f[kPer];
      unpack16<T>(word, f);
      unsigned packed[kPer / 4];
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        packed[i] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed[i] |= static_cast<unsigned>(static_cast<uint8_t>(
                           quantize(f[4 * i + e], a, b)))
                       << (8 * e);
      }
      if constexpr (kPer == 8) {        // 8 bytes of q
        reinterpret_cast<uint2*>(qr)[w] = make_uint2(packed[0], packed[1]);
      } else {                          // 4 bytes of q
        reinterpret_cast<unsigned*>(qr)[w] = packed[0];
      }
    };
#pragma unroll
    for (int i = 0; i < kCache; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w < nv) store(w, cache[i]);
    }
    for (int w = threadIdx.x + kCache * kThreads; w < nv; w += kThreads)
      store(w, xv[w]);
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads)
      qr[j] = quantize(to_float(xr[j]), a, b);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* alpha, void* beta, int m,
                   int n, bool pdl, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  // every row starts on a 16-byte boundary (and its q row on a multiple
  // of kPer bytes) when the base does and n is a whole number of words
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % kPer == 0 &&
                   n % kPer == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = s;
  // a programmatic dependent of the previous kernel in the stream
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = pdl ? 1 : 0;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* af = static_cast<float*>(alpha);
  float* bf = static_cast<float*>(beta);
  return vec ? cudaLaunchKernelEx(&cfg, quantize_rows_kernel<T, true>, xt,
                                  qt, af, bf, n)
             : cudaLaunchKernelEx(&cfg, quantize_rows_kernel<T, false>, xt,
                                  qt, af, bf, n);
}

}  // namespace

// x float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1) [m, n] row-major ->
// q int8 [m, n], alpha f32 [m], beta f32 [m].  pdl = 1 launches it as the
// programmatic dependent of the previous kernel in the stream (0 only to
// measure what that buys).
REPRO_API int quantize_rows_launch(const void* x, int x_bf16, void* q,
                                   void* alpha, void* beta, int m, int n,
                                   int pdl, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_bf16 ? launch<__nv_bfloat16>(x, q, alpha, beta, m, n, pdl != 0, s)
             : launch<float>(x, q, alpha, beta, m, n, pdl != 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
