// K4: chunked WKV6 forward (kernels/wkv6_chunked.py).
//
// One block per (batch, head) walks that head's chunks of C tokens in
// order; the dh x dh float32 state S stays in shared memory from the
// first chunk to the last and is written out once.  Per chunk, with
// la = cumsum(lw) over the chunk, la_prev = la - lw, la_end = la[C-1]:
//
//   rt  = r * exp(la_prev)         kin = k * exp(-la)
//   kst = k * exp(la_end - la)     diag[t] = sum_j r[t,j] u[j] k[t,j]
//   y   = rt S + tril_{-1}(rt kin^T) v + diag * v
//   S   = exp(la_end) * S + kst^T v
//
// the four small products of the Pallas kernel, here as float32 FMAs on
// tiles in shared memory.  The exponents stay finite because the caller
// clamps lw to [LOG_W_MIN, 0] and C * |LOG_W_MIN| <= 80: kin reaches
// e^80, so expf (not __expf) is used throughout.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDh = 64;
constexpr int kMaxChunk = 16;
constexpr int kPad = kMaxDh + 1;    // row stride of the tiles read by column

__global__ void __launch_bounds__(kThreads)
wkv6_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ s_out,
                    int seq, int heads, int dh, int chunk) {
  __shared__ float s_state[kMaxDh * kMaxDh];    // S[key][value]
  __shared__ float s_rt[kMaxChunk * kPad];      // r, then rt
  __shared__ float s_kin[kMaxChunk * kPad];
  __shared__ float s_kst[kMaxChunk * kMaxDh];   // k, then kst
  __shared__ float s_v[kMaxChunk * kMaxDh];
  __shared__ float s_lw[kMaxChunk * kMaxDh];
  __shared__ float s_scores[kMaxChunk * kMaxChunk];
  __shared__ float s_diag[kMaxChunk];
  __shared__ float s_decay[kMaxDh];
  __shared__ float s_u[kMaxDh];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int64_t row_stride = static_cast<int64_t>(heads) * dh;  // one token
  const int64_t base = static_cast<int64_t>(b) * seq * row_stride
                       + static_cast<int64_t>(h) * dh;
  const int64_t state_off = static_cast<int64_t>(bh) * dh * dh;

  for (int i = tid; i < dh * dh; i += kThreads) {
    s_state[(i / dh) * kMaxDh + i % dh] = s0[state_off + i];
  }
  for (int j = tid; j < dh; j += kThreads) s_u[j] = u[h * dh + j];

  const int n_chunks = seq / chunk;
  const int tile = chunk * dh;
  for (int c = 0; c < n_chunks; ++c) {
    // 1. the chunk's r, k, v, lw tiles (a token's dh values are contiguous)
    const int64_t t0 = static_cast<int64_t>(c) * chunk;
    for (int i = tid; i < tile; i += kThreads) {
      const int t = i / dh;
      const int j = i - t * dh;
      const int64_t g = base + (t0 + t) * row_stride + j;
      s_rt[t * kPad + j] = r[g];
      s_kst[t * kMaxDh + j] = k[g];
      s_v[t * kMaxDh + j] = v[g];
      s_lw[t * kMaxDh + j] = lw[g];
    }
    __syncthreads();

    // 2. the bonus diagonal from the raw r and k: one warp per token
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int t = warp; t < chunk; t += kThreads / 32) {
      float acc = 0.0f;
      for (int j = lane; j < dh; j += 32) {
        acc = fmaf(s_rt[t * kPad + j] * s_u[j], s_kst[t * kMaxDh + j], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) s_diag[t] = acc;
    }
    __syncthreads();

    // 3. cumulative log decay down each column, and the decayed operands
    for (int j = tid; j < dh; j += kThreads) {
      float la[kMaxChunk];
      float run = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxChunk; ++t) {
        if (t < chunk) {
          const float w = s_lw[t * kMaxDh + j];
          run += w;
          la[t] = run;
          const float kk = s_kst[t * kMaxDh + j];
          s_rt[t * kPad + j] *= expf(run - w);
          s_kin[t * kPad + j] = kk * expf(-run);
        }
      }
      const float la_end = run;
#pragma unroll
      for (int t = 0; t < kMaxChunk; ++t) {
        if (t < chunk) s_kst[t * kMaxDh + j] *= expf(la_end - la[t]);
      }
      s_decay[j] = expf(la_end);
    }
    __syncthreads();

    // 4. the strictly lower-triangular score tile rt kin^T
    for (int i = tid; i < chunk * chunk; i += kThreads) {
      const int t = i / chunk;
      const int s = i - t * chunk;
      float acc = 0.0f;
      if (s < t) {
        for (int j = 0; j < dh; ++j) {
          acc = fmaf(s_rt[t * kPad + j], s_kin[s * kPad + j], acc);
        }
      }
      s_scores[i] = acc;
    }
    __syncthreads();

    // 5. y = rt S + scores v + diag * v, straight to global memory
    for (int i = tid; i < tile; i += kThreads) {
      const int t = i / dh;
      const int col = i - t * dh;
      float inter = 0.0f;
      for (int j = 0; j < dh; ++j) {
        inter = fmaf(s_rt[t * kPad + j], s_state[j * kMaxDh + col], inter);
      }
      float intra = 0.0f;
      for (int s = 0; s < t; ++s) {
        intra = fmaf(s_scores[t * chunk + s], s_v[s * kMaxDh + col], intra);
      }
      const float vv = s_v[t * kMaxDh + col];
      y[base + (t0 + t) * row_stride + col] = (inter + intra) + s_diag[t] * vv;
    }
    __syncthreads();

    // 6. S = exp(la_end) * S + kst^T v
    for (int i = tid; i < dh * dh; i += kThreads) {
      const int j = i / dh;
      const int col = i - j * dh;
      float acc = 0.0f;
      for (int t = 0; t < chunk; ++t) {
        acc = fmaf(s_kst[t * kMaxDh + j], s_v[t * kMaxDh + col], acc);
      }
      float* sj = &s_state[j * kMaxDh + col];
      *sj = s_decay[j] * *sj + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < dh * dh; i += kThreads) {
    s_out[state_off + i] = s_state[(i / dh) * kMaxDh + i % dh];
  }
}

}  // namespace

// r, k, v, lw f32 [B, S, H, dh]; u f32 [H, dh]; s0 f32 [B, H, dh, dh]
// -> y f32 [B, S, H, dh], s_out f32 [B, H, dh, dh].  All row-major and
// contiguous; dh <= 64, chunk <= 16, S % chunk == 0 (else
// cudaErrorInvalidValue, nothing launched).
REPRO_API int wkv6_chunked_launch(const void* r, const void* k,
                                  const void* v, const void* lw,
                                  const void* u, const void* s0, void* y,
                                  void* s_out, int batch, int seq, int heads,
                                  int dh, int chunk, void* stream) {
  if (dh < 1 || dh > kMaxDh || chunk < 1 || chunk > kMaxChunk ||
      seq < 0 || seq % chunk != 0 || batch < 0 || heads < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(batch) * heads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    wkv6_chunked_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(y), static_cast<float*>(s_out), seq, heads, dh,
        chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
