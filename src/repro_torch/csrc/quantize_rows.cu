// K3: per-row dynamic signed-int8 quantization (kernels/quantize_rows.py).
//
// One block per row.  Pass 1 reduces the row's min and max (warp shuffles,
// then one value per warp in shared memory); thread 0 derives
//   alpha = max(xmax - xmin, 1e-12) / 255,  beta = xmin + 128 * alpha;
// pass 2 writes q = clip(rint((x - beta) / alpha), -128, 127).
// Every float operation is the plain version's, rounded the same way:
// explicit _rn intrinsics (no FMA contraction), IEEE division and rintf
// (round half to even), so q, alpha and beta are bit-exact with it.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ alpha, float* __restrict__ beta,
                     int n) {
  __shared__ float s_lo[kWarps];
  __shared__ float s_hi[kWarps];
  __shared__ float s_ab[2];

  const int64_t row = blockIdx.x;
  const float* xr = x + row * n;
  int8_t* qr = q + row * n;

  float lo = INFINITY;
  float hi = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float v = xr[j];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
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
  if (threadIdx.x == 0) {
    float l = s_lo[0];
    float h = s_hi[0];
    for (int w = 1; w < kWarps; ++w) {
      l = fminf(l, s_lo[w]);
      h = fmaxf(h, s_hi[w]);
    }
    const float span = fmaxf(__fsub_rn(h, l), 1e-12f);
    const float a = __fdiv_rn(span, 255.0f);
    const float b = __fadd_rn(l, __fmul_rn(128.0f, a));
    s_ab[0] = a;
    s_ab[1] = b;
    alpha[row] = a;
    beta[row] = b;
  }
  __syncthreads();
  const float a = s_ab[0];
  const float b = s_ab[1];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float v = rintf(__fdiv_rn(__fsub_rn(xr[j], b), a));
    v = fminf(fmaxf(v, -128.0f), 127.0f);
    qr[j] = static_cast<int8_t>(static_cast<int>(v));
  }
}

}  // namespace

// x f32 [m, n] row-major -> q int8 [m, n], alpha f32 [m], beta f32 [m].
REPRO_API int quantize_rows_launch(const void* x, void* q, void* alpha,
                                   void* beta, int m, int n, void* stream) {
  if (m > 0 && n > 0) {
    quantize_rows_kernel<<<m, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(alpha), static_cast<float*>(beta), n);
  }
  return static_cast<int>(cudaGetLastError());
}
