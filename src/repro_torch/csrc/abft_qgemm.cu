// K1: int8 ABFT GEMM with the mod-127 row verify fused in
// (kernels/abft_qgemm.py).
//
// C_full = A @ B'[:, :n+1] with int32 accumulation, where B' = [B | block]
// is the packed weight and column n is lane 0 of its checksum block.  Lanes
// 1-127 of the block are zero padding for the TPU's matrix unit; they are
// never read.  Tiles of 64 x 64 outputs over (m, n+1), 256 threads with a
// 4 x 4 register tile each, k in steps of 32 through shared memory.
//
// The verify needs Σ_j (C[i,j] mod 127) over all n columns, but blocks run
// in no order, so nothing carries from one N tile to the next: each block
// reduces its tile's share to a value below 127 and atomically adds it to
// rowsum[i] (sums mod 127 are additive), the block holding column n
// writes check[i] = C_full[i,n] mod 127, and a finisher kernel sets
// err[i] = (rowsum[i] mod 127) != check[i].
//
// uint8 A is multiplied as its unsigned values (the integer MACs take them
// directly), so no zero-point shift is needed and C and the flags are the
// unsigned product's.  With a column-check buffer, each block also adds
// colsum(A tile) @ B tile to col[j]: a matvec over the operand tiles, not
// a fold of C, so an accumulator fault shows up as a disagreement.  The
// atomics are unsigned, i.e. the int32 wraparound of the JAX reference.
#include "common.cuh"

namespace {

constexpr int kMod = 127;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;           // rows per thread: ty, ty+16, ty+32, ty+48
constexpr int TN = 4;           // cols per thread: tx, tx+16, tx+32, tx+48
constexpr int kThreads = 256;   // 16 x 16

template <typename TA>
__global__ void __launch_bounds__(kThreads)
abft_qgemm_kernel(const TA* __restrict__ a, const int8_t* __restrict__ b,
                  int32_t* __restrict__ c, int32_t* __restrict__ rowsum,
                  int32_t* __restrict__ check, int32_t* __restrict__ col,
                  int m, int n, int k, int ldb) {
  __shared__ int as[BK][BM + 1];  // A tile, k-major; +1 spreads the stores
  __shared__ int bs[BK][BN];
  __shared__ int asum[BK];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ncols = n + 1;        // C columns plus the checksum column

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  unsigned colacc = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK;
      const int kk = e % BK;
      const int gr = m0 + r;
      const int gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
                      ? static_cast<int>(a[static_cast<int64_t>(gr) * k + gk])
                      : 0;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN;
      const int cc = e % BN;
      const int gk = k0 + kk;
      const int gc = n0 + cc;
      bs[kk][cc] =
          (gk < k && gc < ncols)
              ? static_cast<int>(b[static_cast<int64_t>(gk) * ldb + gc])
              : 0;
    }
    __syncthreads();

    if (col != nullptr) {
      if (tid < BK) {
        int s = 0;
        for (int r = 0; r < BM; ++r) s += as[tid][r];
        asum[tid] = s;
      }
      __syncthreads();
      if (tid < BN) {
        for (int kk = 0; kk < BK; ++kk)
          colacc += static_cast<unsigned>(asum[kk]) *
                    static_cast<unsigned>(bs[kk][tid]);
      }
    }

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int av[TM];
      int bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty + 16 * i;
    int part = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tx + 16 * j;
      const int v = acc[i][j];
      if (gr < m) {
        if (gc < n) {
          c[static_cast<int64_t>(gr) * n + gc] = v;
          part += floor_mod(v, kMod);
        } else if (gc == n) {
          check[gr] = floor_mod(v, kMod);
        }
      }
    }
    // the 16 threads of a row are one half-warp: lanes differ in tx only
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && gr < m && part != 0) atomicAdd(&rowsum[gr], part % kMod);
  }
  if (col != nullptr && tid < BN && n0 + tid < n)
    atomicAdd(reinterpret_cast<unsigned*>(&col[n0 + tid]), colacc);
}

__global__ void abft_verify_kernel(const int32_t* __restrict__ rowsum,
                                   const int32_t* __restrict__ check,
                                   int32_t* __restrict__ err, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) err[i] = (rowsum[i] % kMod) != check[i] ? 1 : 0;
}

}  // namespace

// a int8/uint8 [m, k] row-major (a_unsigned selects uint8), b int8 [k, ldb]
// row-major with ldb = n + 128 -> c int32 [m, n], err int32 [m] and, when
// col is not null, col int32 [n].  scratch: int32 [2 m] (rowsum, check).
REPRO_API int abft_qgemm_launch(const void* a, int a_unsigned, const void* b,
                                void* c, void* err, void* col, void* scratch,
                                int m, int n, int k, int ldb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* rowsum = static_cast<int32_t*>(scratch);
  int32_t* check = rowsum + m;
  cudaError_t e = cudaMemsetAsync(rowsum, 0, sizeof(int32_t) * m, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (col != nullptr) {
    e = cudaMemsetAsync(col, 0, sizeof(int32_t) * n, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + 1 + BN - 1) / BN, (m + BM - 1) / BM);
  if (a_unsigned) {
    abft_qgemm_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int32_t*>(c), rowsum, check, static_cast<int32_t*>(col),
        m, n, k, ldb);
  } else {
    abft_qgemm_kernel<int8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int32_t*>(c), rowsum, check, static_cast<int32_t*>(col),
        m, n, k, ldb);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  abft_verify_kernel<<<(m + 255) / 256, 256, 0, s>>>(
      rowsum, check, static_cast<int32_t*>(err), m);
  return static_cast<int>(cudaGetLastError());
}
