// K4: chunked WKV6 forward (kernels/wkv6_chunked.py).  Replaces
// wkv_chunked_pallas (src/repro/kernels/wkv6_chunked.py).
//
// Per chunk of C tokens, with la = cumsum(lw) over the chunk,
// la_prev = la - lw, la_end = la[C-1]:
//
//   rt  = r * exp(la_prev)         kin = k * exp(-la)
//   kst = k * exp(la_end - la)     diag[t] = sum_j r[t,j] u[j] k[t,j]
//   y   = rt S + tril_{-1}(rt kin^T) v + diag * v
//   S   = exp(la_end) * S + kst^T v
//
// Both updates are separable along the value dimension:
//
//   y[:, c] = rt S[:, c] + tril(rt kin^T) v[:, c] + diag v[:, c]
//   S[:, c] = exp(la_end) * S[:, c] + kst^T v[:, c]
//
// so the grid is (B * H, dh / DV): each block owns the DV value columns
// c0..c0+DV of one head's state, S[:, c0:c0+DV] in shared memory from the
// first chunk to the last, and the y columns of its slice.  At the RWKV
// prefill shape (B 1, H 32, dh 64, DV 16) that is 128 blocks, one wave on
// the H100's 132 SMs, where one block a head left 100 SMs idle.  Each block
// recomputes the chunk's state-independent values (la, rt, kin, kst, the
// decay, the diagonal and the C x C score tile) from the full r, k and lw
// tiles: sharing them among a head's blocks as a thread-block cluster,
// through distributed shared memory, measured slower on an H100 80GB HBM3
// at 700 W (a cluster barrier and remote reads each chunk against a
// quarter of the decay work; PERF.md).
//
// What bounds it: latency.  A 64-token prefill moves 3.7 MB (in f32) for
// ~42 MFLOP, but each block walks its chunks in order, one block an SM,
// and each chunk is a chain of dependent phases.  The design keeps the
// chain short, its phases few and its instructions few:
//
// - Each chunk runs the loop body's code once, so that code is kept small:
//   loops stay loops (unrolled by 2 at most, enough to overlap one step's
//   loads with the last step's FMAs), and threads map onto (row, column)
//   by shifts, not divisions.
// - The next chunk's tiles are copied with cp.async (16 bytes a copy where
//   rows and pointers allow, else 4) into the other of two staging slots
//   while this chunk computes.
// - The cumulative decay is a scan over the chunk's tokens per key column,
//   spread over the whole block: 8 groups of tokens x the key columns.
//   Each thread adds lw in token order from the chunk's start (at most 16
//   adds), so la is the plain version's cumsum bit for bit: an exponent
//   near 80 off by one ulp would move e^la by 1e-5.
// - 16 warps, and three barriers a chunk: the decayed operands; then, side
//   by side, rt S for y, the score tile and the next state (S is
//   double-buffered, so the update need not wait for y to read it); then
//   y.  The products are limited by shared memory's load rate, not by
//   FMAs, so each thread of step 2 works on a register tile (4 values of
//   y, or a 4 x 4 block of S) fed by 16-byte loads.
// - r, k and v are read in their own type (float or bf16; bf16 -> f32 is
//   exact), so the RWKV path hands its bf16 projections over with no cast.
//
// Every sum runs in key or token order, one FMA after another: the same
// operations in the same order whatever the grid, and the plain version's
// order where it has one (its cumsum), which keeps the card's prefill close
// to the CPU's.  expf (not __expf) throughout: kin = k e^{-la} reaches e^80
// at chunk 16 (the caller clamps lw to [LOG_W_MIN, 0] and
// C |LOG_W_MIN| <= 80).  The products are f32 FMAs on the CUDA cores: TF32
// tensor cores would not hold the 2e-4 tolerance, and arithmetic does not
// limit this kernel.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDh = 64;
constexpr int kMaxChunk = 16;
constexpr int kMaxDv = 16;
// rows of the tiles read 4 keys at a time: 16-byte aligned, and 4 banks
// apart from one row to the next
constexpr int kPad = kMaxDh + 4;
constexpr int kScorePad = kMaxChunk + 1;
constexpr int kGroups = kThreads / kMaxDh;        // token groups of the scan
constexpr int kRowsPerPass = kThreads / kMaxDv;   // state rows a pass
constexpr int kRowPasses = kMaxDh / kRowsPerPass;
// step 2's roles, by thread: 4 values of y's product, one score, or a
// 4 x 4 block of the next state
constexpr int kYThreads = kMaxChunk * kMaxDv / 4;
constexpr int kScoreThreads = kMaxChunk * (kMaxChunk - 1) / 2;
constexpr int kStateThreads = kMaxDh * kMaxDv / 16;
constexpr int kScore0 = kYThreads;
constexpr int kState0 = kScore0 + 128;            // warp-aligned roles
static_assert(kScoreThreads <= 128 && kState0 + kStateThreads <= kThreads,
              "the roles of step 2 fit the block");

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float4 ld4(const float* p) {   // shared, aligned
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    static_assert(VEC == 4, "16- or 4-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}

// `rows` (<= kMaxChunk) rows of `row_bytes` (<= kMaxDh floats) each,
// `src_stride` bytes apart in global memory, packed into dst.  A thread
// takes copy unit tid % kU of rows tid / kU + i * kThreads / kU.
template <int VEC>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src,
                                          int64_t src_stride, int rows,
                                          int row_bytes, int tid) {
  constexpr int kU = kMaxDh * 4 / VEC;  // the most units a row can have
  constexpr int kStep = kThreads / kU;  // rows a pass
  const int w = tid % kU;
  if (w * VEC >= row_bytes) return;
#pragma unroll
  for (int i = 0; i < (kMaxChunk + kStep - 1) / kStep; ++i) {
    const int t = tid / kU + i * kStep;
    if (t < rows)
      cp_async<VEC>(dst + t * row_bytes + w * VEC,
                    src + t * src_stride + w * VEC);
  }
}

// the row t of the strictly lower triangle's p-th entry, p = t(t-1)/2 + s
__device__ __forceinline__ int tri_row(int p) {
  int t = static_cast<int>(0.5f * (1.0f + sqrtf(8.0f * p + 1.0f)));
  if (t * (t - 1) / 2 > p) --t;
  if (t * (t + 1) / 2 <= p) ++t;
  return t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
wkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u,
                    const float* __restrict__ s0, float* __restrict__ y,
                    float* __restrict__ s_out, int seq, int heads, int dh,
                    int chunk, int dv, int slot_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];   // 2 staging slots
  __shared__ __align__(16) float s_rt[kMaxChunk * kPad];
  __shared__ __align__(16) float s_kin[kMaxChunk * kPad];
  __shared__ __align__(16) float s_kst[kMaxChunk * kMaxDh];
  // S[:, c0:c0+dv], two buffers: step 2 reads one and writes the other
  __shared__ __align__(16) float s_state[2][kMaxDh * kMaxDv];
  __shared__ float s_scores[kMaxChunk * kScorePad];
  __shared__ float s_diag[kMaxChunk];
  __shared__ float s_decay[kMaxDh];
  __shared__ float s_u[kMaxDh];

  constexpr int es = sizeof(T);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int c0 = blockIdx.y * dv;       // this block's value columns
  const int64_t row_stride = static_cast<int64_t>(heads) * dh;  // a token
  const int64_t base = static_cast<int64_t>(b) * seq * row_stride +
                       static_cast<int64_t>(h) * dh;
  const int64_t state_off = static_cast<int64_t>(bh) * dh * dh;
  const int n_chunks = seq / chunk;
  // the column and first row of the S slice the thread loads and stores
  // (rows sr, sr + 32)
  const int cc = tid % kMaxDv;
  const int sr = tid / kMaxDv;
  const bool col_ok = cc < dv;

  // chunk c's r, k, lw (every key) and v (values c0..c0+dv) into staging
  // slot c % 2, as one cp.async group
  auto stage = [&](int c) {
    uint8_t* dst = smem + (c & 1) * slot_bytes;
    const int64_t g = base + static_cast<int64_t>(c) * chunk * row_stride;
    copy_rows<VEC>(dst, reinterpret_cast<const uint8_t*>(r + g),
                   row_stride * es, chunk, dh * es, tid);
    dst += chunk * dh * es;
    copy_rows<VEC>(dst, reinterpret_cast<const uint8_t*>(k + g),
                   row_stride * es, chunk, dh * es, tid);
    dst += chunk * dh * es;
    copy_rows<VEC>(dst, reinterpret_cast<const uint8_t*>(lw + g),
                   row_stride * 4, chunk, dh * 4, tid);
    dst += chunk * dh * 4;
    copy_rows<VEC>(dst, reinterpret_cast<const uint8_t*>(v + g + c0),
                   row_stride * es, chunk, dv * es, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (n_chunks > 0) stage(0);
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {
    const int j = sr + i * kRowsPerPass;
    if (j < dh && col_ok)
      s_state[0][j * kMaxDv + cc] =
          s0[state_off + static_cast<int64_t>(j) * dh + c0 + cc];
  }
  if (tid < dh) s_u[tid] = u[h * dh + tid];
  for (int i = tid; i < kMaxChunk * kScorePad; i += kThreads)
    s_scores[i] = 0.0f;                 // the upper triangle stays zero

  const int ct = (chunk + kGroups - 1) / kGroups;   // tokens per group
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();          // chunk c staged; chunk c - 1 done with slots
    if (c + 1 < n_chunks) stage(c + 1);       // in flight while c computes
    const uint8_t* slot = smem + (c & 1) * slot_bytes;
    const T* t_r = reinterpret_cast<const T*>(slot);
    const T* t_k = t_r + chunk * dh;
    const float* t_lw = reinterpret_cast<const float*>(t_k + chunk * dh);
    const T* t_v = reinterpret_cast<const T*>(t_lw + chunk * dh);
    const float* s_old = s_state[c & 1];
    float* s_new = s_state[(c + 1) & 1];

    // 1a. the bonus diagonal from the raw r and k (one warp a token)
#pragma unroll 1
    for (int t = warp; t < chunk; t += kThreads / 32) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxDh / 32; ++i) {
        const int j = lane + 32 * i;
        if (j < dh)
          acc = fmaf(ldf(t_r + t * dh + j) * s_u[j], ldf(t_k + t * dh + j),
                     acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_diag[t] = acc;
    }

    // 1b. the cumulative log decay and the decayed operands, over (token
    //     group, key column): each thread sums lw in token order up to its
    //     group, so la is the plain version's cumsum bit for bit, and runs
    //     on to the chunk's end for la_end
    {
      const int g = tid / kMaxDh;
      const int j = tid % kMaxDh;
      const int t0 = g * ct;
      const int t1 = min(chunk, t0 + ct);
      if (j < dh) {
        float la = 0.0f;
        float end = 0.0f;
#pragma unroll
        for (int t = 0; t < kMaxChunk; ++t) {
          if (t < chunk) end += t_lw[t * dh + j];
          if (t == t0 - 1) la = end;    // the sum of the tokens before t0
        }
#pragma unroll 1
        for (int t = t0; t < t1; ++t) {
          const float w = t_lw[t * dh + j];
          la += w;
          const float kk = ldf(t_k + t * dh + j);
          s_rt[t * kPad + j] = ldf(t_r + t * dh + j) * expf(la - w);
          s_kin[t * kPad + j] = kk * expf(-la);
          s_kst[t * kMaxDh + j] = kk * expf(end - la);
        }
        if (g == 0) s_decay[j] = expf(end);
      }
    }
    __syncthreads();

    // 2. side by side, all on the decayed operands, each thread on a
    //    register tile read by 16-byte loads (shared memory's load rate, not
    //    arithmetic, limits these products): rt S for y (thread (t, q):
    //    columns 4q..4q+3, kept for step 3), the strictly lower-triangular
    //    score tile rt kin^T (one thread a score), and the next state
    //    S_new = decay * S + kst^T v (rows 4jb.., columns 4q..) into the
    //    other buffer.  Every sum still runs in key or token order.  The
    //    loops stay loops: each chunk runs this code once, so its size, not
    //    its unrolled latency, is what costs.
    const int t_y = tid >> 2;
    const int q = tid & 3;
    float inter[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (tid < kYThreads) {
      if (t_y < chunk) {
        const float* rt = s_rt + t_y * kPad;
        const float* sq = s_old + 4 * q;
        int j = 0;
#pragma unroll 2
        for (; j + 4 <= dh; j += 4) {
          const float4 rt4 = ld4(rt + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 st = ld4(sq + (j + jj) * kMaxDv);
            inter[0] = fmaf(at(rt4, jj), st.x, inter[0]);
            inter[1] = fmaf(at(rt4, jj), st.y, inter[1]);
            inter[2] = fmaf(at(rt4, jj), st.z, inter[2]);
            inter[3] = fmaf(at(rt4, jj), st.w, inter[3]);
          }
        }
#pragma unroll 1
        for (; j < dh; ++j) {
          const float4 st = ld4(sq + j * kMaxDv);
          inter[0] = fmaf(rt[j], st.x, inter[0]);
          inter[1] = fmaf(rt[j], st.y, inter[1]);
          inter[2] = fmaf(rt[j], st.z, inter[2]);
          inter[3] = fmaf(rt[j], st.w, inter[3]);
        }
      }
    } else if (tid < kScore0 + kScoreThreads) {
      const int p = tid - kScore0;
      if (p < chunk * (chunk - 1) / 2) {
        const int t = tri_row(p);
        const int s = p - t * (t - 1) / 2;
        const float* a = s_rt + t * kPad;
        const float* bk = s_kin + s * kPad;
        float acc = 0.0f;
        int j = 0;
#pragma unroll 2
        for (; j + 4 <= dh; j += 4) {
          const float4 a4 = ld4(a + j);
          const float4 b4 = ld4(bk + j);
          acc = fmaf(a4.x, b4.x, acc);
          acc = fmaf(a4.y, b4.y, acc);
          acc = fmaf(a4.z, b4.z, acc);
          acc = fmaf(a4.w, b4.w, acc);
        }
#pragma unroll 1
        for (; j < dh; ++j) acc = fmaf(a[j], bk[j], acc);
        s_scores[t * kScorePad + s] = acc;
      }
    } else if (tid >= kState0 && tid < kState0 + kStateThreads) {
      const int jb = (tid - kState0) >> 2;          // rows 4jb..4jb+3
      float acc[4][4] = {};
#pragma unroll 2
      for (int t = 0; t < chunk; ++t) {
        const float4 ks = ld4(s_kst + t * kMaxDh + 4 * jb);
        float vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = 4 * q + e < dv ? ldf(t_v + t * dv + 4 * q + e) : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][e] = fmaf(ks.x, vv[e], acc[0][e]);
          acc[1][e] = fmaf(ks.y, vv[e], acc[1][e]);
          acc[2][e] = fmaf(ks.z, vv[e], acc[2][e]);
          acc[3][e] = fmaf(ks.w, vv[e], acc[3][e]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = 4 * jb + a;
        if (j < dh) {
          const float4 so = ld4(s_old + j * kMaxDv + 4 * q);
          const float dec = s_decay[j];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < dv)
              s_new[j * kMaxDv + 4 * q + e] = dec * at(so, e) + acc[a][e];
        }
      }
    }
    __syncthreads();

    // 3. y = rt S + scores v + diag * v for this block's value columns,
    //    by the threads that hold rt S
    if (tid < kYThreads && t_y < chunk) {
      float intra[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int s = 0; s < t_y; ++s) {
        const float sc = s_scores[t_y * kScorePad + s];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < dv)
            intra[e] = fmaf(sc, ldf(t_v + s * dv + 4 * q + e), intra[e]);
      }
      const float dg = s_diag[t_y];
      float* yr = y + base + static_cast<int64_t>(c * chunk + t_y) *
                                 row_stride + c0 + 4 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < dv)
          yr[e] = (inter[e] + intra[e]) +
                  dg * ldf(t_v + t_y * dv + 4 * q + e);
    }
  }
  __syncthreads();

  const float* s_fin = s_state[n_chunks & 1];
#pragma unroll
  for (int i = 0; i < kRowPasses; ++i) {
    const int j = sr + i * kRowsPerPass;
    if (j < dh && col_ok)
      s_out[state_off + static_cast<int64_t>(j) * dh + c0 + cc] =
          s_fin[j * kMaxDv + cc];
  }
}

// the staging slot's bytes: r, k (es each) and lw (4) over dh key columns
// and v (es) over dv value columns, for chunk tokens
int slot_bytes(int chunk, int dh, int dv, int es) {
  return (chunk * (2 * dh * es + 4 * dh + dv * es) + 15) / 16 * 16;
}

template <typename T, int VEC>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* y,
                   void* s_out, int batch, int seq, int heads, int dh,
                   int chunk, int dv, int smem, cudaStream_t stream) {
  auto kernel = wkv6_chunked_kernel<T, VEC>;
  // static and dynamic shared memory pass 48 KB at f32 and dh 64: allow
  // the most this instance can need, once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * slot_bytes(kMaxChunk, kMaxDh, kMaxDv, sizeof(T)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(batch) * heads, dh / dv, 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), seq, heads, dh,
      chunk, dv, smem / 2);
  return cudaGetLastError();
}

}  // namespace

// r, k, v f32 (rkv_bf16 = 0) or bf16 (1) [B, S, H, dh]; lw f32 [B, S, H,
// dh]; u f32 [H, dh]; s0 f32 [B, H, dh, dh] -> y f32 [B, S, H, dh], s_out
// f32 [B, H, dh, dh].  All row-major and contiguous; dh <= 64, chunk <= 16,
// S % chunk == 0.  The plan (kernels/wkv6_chunked.py, wkv_plan): dv value
// columns a block (<= 16, dividing dh), vec bytes a copy (16 or 4; rows,
// column offsets and pointers on multiples of it) and smem, the dynamic
// shared bytes (two staging slots), which must be what this entry
// computes.  Else cudaErrorInvalidValue and nothing launched.
REPRO_API int wkv6_chunked_launch(const void* r, const void* k,
                                  const void* v, const void* lw,
                                  const void* u, const void* s0, void* y,
                                  void* s_out, int rkv_bf16, int batch,
                                  int seq, int heads, int dh, int chunk,
                                  int dv, int vec, int smem, void* stream) {
  const int es = rkv_bf16 ? 2 : 4;
  const bool shape_ok = dh >= 1 && dh <= kMaxDh && chunk >= 1 &&
                        chunk <= kMaxChunk && seq >= 0 && seq % chunk == 0 &&
                        batch >= 0 && heads >= 0 &&
                        static_cast<int64_t>(batch) * heads <= 0x7fffffff;
  const bool plan_ok =
      dv >= 1 && dv <= kMaxDv && dh % dv == 0 && (vec == 16 || vec == 4) &&
      (dh * es) % vec == 0 && (dh * 4) % vec == 0 && (dv * es) % vec == 0 &&
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(lw)) %
       vec) == 0 &&
      smem == 2 * slot_bytes(chunk, dh, dv, es);
  if (!shape_ok || !plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rkv_bf16)
    e = vec == 16 ? launch<__nv_bfloat16, 16>(r, k, v, lw, u, s0, y, s_out,
                                             batch, seq, heads, dh, chunk,
                                             dv, smem, s)
                  : launch<__nv_bfloat16, 4>(r, k, v, lw, u, s0, y, s_out,
                                            batch, seq, heads, dh, chunk, dv,
                                            smem, s);
  else
    e = vec == 16 ? launch<float, 16>(r, k, v, lw, u, s0, y, s_out, batch,
                                      seq, heads, dh, chunk, dv, smem, s)
                  : launch<float, 4>(r, k, v, lw, u, s0, y, s_out, batch,
                                     seq, heads, dh, chunk, dv, smem, s);
  return static_cast<int>(e);
}
