// K2: quantized EmbeddingBag with the Eq. (5) row sum fused in
// (kernels/abft_embeddingbag.py).
//
// One launch covers every table: the grid is (bags, tables) and a block's
// threads cover the embedding width d.  A block walks its bag's pool in
// slot order, so each output element is one thread's sequential sum and
// no atomics are needed; a block reduction then gives rsum = Σ_j R[j].
// Padded slots (index < 0) read row 0 with weight 0, as in the plain
// version.  Each term is w * (alpha * row + beta) with explicit _rn
// intrinsics, so it is rounded exactly as the plain version rounds it;
// only the order of the sums differs.  Row offsets are 64-bit: a stack of
// 26 tables of 4M x 128 int8 is 1.33e10 bytes.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
abft_eb_kernel(const int8_t* __restrict__ table,
               const float* __restrict__ alphas,
               const float* __restrict__ betas,
               const int32_t* __restrict__ indices,
               const float* __restrict__ weights, float* __restrict__ r,
               float* __restrict__ rsum, int64_t rows, int d, int bags,
               int pool) {
  __shared__ float s_part[kMaxThreads / 32];

  const int64_t t = blockIdx.y;
  const int64_t bag = t * bags + blockIdx.x;   // flat (table, bag)
  const int8_t* tab = table + t * rows * d;
  const float* al = alphas + t * rows;
  const float* be = betas + t * rows;
  const int32_t* idx = indices + bag * pool;
  const float* w = weights == nullptr ? nullptr : weights + bag * pool;
  float* out = r + bag * d;

  float local = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < pool; ++p) {
      const int i = idx[p];
      const bool valid = i >= 0;
      // an index past the table reads its last row (the clamp of an XLA
      // gather) rather than memory outside it; callers validate indices
      const int64_t row = valid ? (i < rows ? i : rows - 1) : 0;
      const float wp = valid ? (w == nullptr ? 1.0f : w[p]) : 0.0f;
      const float v = static_cast<float>(tab[row * d + j]);
      acc = __fadd_rn(acc,
                      __fmul_rn(wp, __fadd_rn(__fmul_rn(al[row], v),
                                              be[row])));
    }
    out[j] = acc;
    local = __fadd_rn(local, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = __fadd_rn(local, __shfl_xor_sync(0xffffffffu, local, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s_part[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = s_part[0];
    for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k)
      s = __fadd_rn(s, s_part[k]);
    rsum[bag] = s;
  }
}

}  // namespace

// table int8 [tables, rows, d]; alphas, betas f32 [tables, rows]; indices
// int32 [tables, bags, pool] (-1 padded); weights f32 [tables, bags, pool]
// or null -> r f32 [tables, bags, d], rsum f32 [tables, bags].
REPRO_API int abft_eb_launch(const void* table, const void* alphas,
                             const void* betas, const void* indices,
                             const void* weights, void* r, void* rsum,
                             int tables, long long rows, int d, int bags,
                             int pool, void* stream) {
  if (tables > 0 && bags > 0) {
    int threads = ((d + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                          : threads);
    const dim3 grid(bags, tables);
    abft_eb_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(table), static_cast<const float*>(alphas),
        static_cast<const float*>(betas),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(weights), static_cast<float*>(r),
        static_cast<float*>(rsum), static_cast<int64_t>(rows), d, bags,
        pool);
  }
  return static_cast<int>(cudaGetLastError());
}
