// K1: int8 ABFT GEMM with the mod-127 row verify fused in
// (kernels/abft_qgemm.py).  Replaces abft_qgemm_pallas
// (src/repro/kernels/abft_qgemm.py).
//
// Computes C_full = A @ B'[:, :n+1] (int32), where B' = [B | block] is the
// packed weight [k, ldb = n + 128] and column n is lane 0 of its checksum
// block (lanes 1-127 are padding for the TPU's matrix unit and are never
// read), then err[i] = (Σ_j C[i,j] mod 127) mod 127 != C_full[i,n] mod 127,
// and optionally the Eq.-1 column check colsum(A) @ B with int32 wraparound.
//
// What bounds it: bytes.  Every serving shape has m <= 64, so each weight
// byte feeds at most 128 int8 operations, far below the ~590 per byte at
// which the H100's tensor cores rather than HBM would be the limit.  The
// least time is one read of B'[:, :n+1].  The design streams B' once, at
// full width, from enough SMs:
//
// - Tensor cores: mma.sync m16n8k32 (s8 x s8, or u8 x s8 for uint8 A, so no
//   zero-point shift).  Its rate is far above what HBM feeds at these m.
// - B' stays N-major as stored (the fault campaign corrupts these very
//   bytes), but int8 MMA takes B K-major.  Each thread reads one 32-bit word
//   from each of 4 consecutive k rows and transposes the 4 x 4 bytes with
//   __byte_perm into the K-contiguous fragments of 4 columns.  The fragment
//   of n8 slice q then holds physical columns 4g + q (g the lane's group),
//   a permutation the epilogue undoes.
// - Tiles are 128 columns wide (one 128-byte line per k row) and 128 k rows
//   deep, in a 4-stage ring of dynamic shared memory that the TMA fills
//   (one 2-D tensor copy per operand tile, completing on an mbarrier), so
//   three tiles (48 KB of B') are in flight while the MMAs run.  The TMA's
//   128-byte swizzle spreads the fragment reads over the banks.  The map of
//   B' ends 16 columns past n, so the tile past the checksum column (n a
//   multiple of 128) reads 16 bytes a row, and rows past m or k read as
//   zeros without touching memory.
// - Split K fills the card at m <= 64: the blocks of one output tile form
//   a thread-block cluster of <= 8, each over its own k range.  Partial sums
//   are reduced through distributed shared memory; each block of the cluster
//   reduces, stores and checks its own slice of the tile's columns.  The
//   plan takes the largest cluster that keeps the grid to one wave (one
//   block an SM): an SM streams at about its share of HBM, so a second
//   block on an SM doubles that SM's time.
// - The row verify across N tiles: each block adds its slice's
//   Σ (C mod 127), already below 127, to rowsum[i] with atomics (sums mod
//   127 are additive) and the block holding column n stores
//   check[i] = C_full[i,n] mod 127.  The last block of a row tile to arrive
//   (an atomic ticket) sets the flags and leaves the row sums and the
//   ticket zeroed for the next call, so the call is this kernel alone (plus
//   a zeroed column-check buffer under `correct`).
// - 8 warps a block: 4 groups of 32 columns, each over one 64-row half of
//   a stage, so two warps per SM quadrant hide each other's load-to-MMA
//   latency; the halves are summed in shared memory before the cluster
//   reduce.
// - The column check (only under the `correct` policy) is a matvec over the
//   staged operand tiles, colsum(A tile) @ B tile, each split adding its k
//   range with unsigned atomics (the int32 wraparound of the reference).
// - Ragged shapes (k or ldb not a multiple of 16, or an operand off 16-byte
//   alignment, which the TMA cannot map) stage the same swizzled tiles with
//   masked byte loads; the compute and epilogue are shared.
//
// - Programmatic dependent launch: the kernel is launched with programmatic
//   stream serialization, so it may start while the kernel before it runs
//   (K3, the row quantizer that writes A, lets it at once).  Until its
//   griddepcontrol.wait it only sets up shared memory: the mbarriers, the
//   zeroed row partials and a prefetch of the two tensor maps (kernel
//   parameters, not global memory).  No global read or write comes before
//   the wait, on the TMA and the masked path alike, so the launch is safe
//   whatever kernel precedes it.
//
// The unprotected instance (PROT = false) is the overhead benchmarks'
// baseline, the counterpart of the plain int8 GEMM the JAX benchmarks time
// (benchmarks/gemm_overhead.py::_plain): C = A @ B'[:, :n] from the same
// packed operand, through the same mainloop, tile shapes and split of K,
// without the checksum column (its tile when n is a multiple of 128, and
// its lane in the map), the mod-127 epilogue, the row-sum scratch or the
// ticket.  It is
// built for int8 A (what a disabled plan rule runs on the serving path) and
// for uint8 A (the benchmark's A).
//
// The launch plan (row tile, split count, aligned or ragged) is made in
// Python and checked here.
#include "common.cuh"

#include <cuda.h>
#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMod = 127;
constexpr int BN = 128;          // tile columns: one 128-byte line per k row
constexpr int BK = 128;          // k rows per stage
constexpr int kStages = 4;
static_assert(BK == 128 && BN == 128, "staged rows are 128 bytes");
constexpr int kRedStride = BN + 4;  // int32 partials, rows 16-byte aligned
constexpr int kRedUnroll = 2;    // 4-column vectors reduced per batch
constexpr int kThreads = 256;    // 8 warps: 4 column groups x 2 k halves
constexpr int kMaxSplits = 8;    // portable cluster size
constexpr int kLane = 128;       // width of B's packed checksum block

// the ring of stages, each [BM + BK rows][128 bytes], plus the slack that
// aligns it to the 1024 bytes the TMA's swizzle needs
template <int MFRAG>
constexpr int smem_bytes() {
  return kStages * (16 * MFRAG + BK) * 128 + 1024;
}

// Byte offset of column byte `col` of staged row r: 16-byte chunk c of a
// row sits at c ^ (r % 8), the TMA's 128-byte swizzle (the ragged path
// stages the same layout).  The A fragment reads (rows g, 4 bytes at
// 4 tig) then fall in 32 distinct banks, the B fragment reads in 16.
__device__ __forceinline__ int swz(int r, int col) {
  return r * 128 + ((((col >> 4) ^ r) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier primitives: a stage's TMA copies complete on one
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive on bar and add bytes to the transaction count it waits for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// the 2-D tile of map at (x = column, y = row) into shared dst by the TMA,
// completing on bar; rows and columns outside the tensor read as zero
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

template <bool kUnsigned>
__device__ __forceinline__ void mma_k32(int (&d)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  if constexpr (kUnsigned) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Masked byte loads of 16 bytes at src[0..len) (zeros past len) into dst.
__device__ __forceinline__ void copy16_masked(uint8_t* dst,
                                              const uint8_t* src, int len) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < len) w[i >> 2] |= static_cast<unsigned>(src[i]) << (8 * (i & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage the A tile [BM, BK] and the B tile [BK, BN] of k0 into one slot;
// ncols = n + 1 (C and the checksum column) or n (unprotected).
// Aligned: one thread has the TMA copy both tiles, completing on bar (the
// B map of the protected kernel ends 16 columns past n, so a tile past the
// checksum column reads 16 bytes a row).  Ragged: every thread stages with
// masked byte loads.  Either way rows past m and k rows past ke read as
// zero.
template <int BM, bool ALIGNED>
__device__ __forceinline__ void load_stage(
    uint8_t* as, uint8_t* bs, uint64_t* bar, const CUtensorMap* amap,
    const CUtensorMap* bmap, const uint8_t* a, const uint8_t* b, int m0,
    int n0, int k0, int ke, int m, int ncols, int k, int ldb, int tid) {
  if constexpr (ALIGNED) {
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar, (BM + BK) * 128);
      tma_load(bs, bmap, n0, k0, bar);
      tma_load(as, amap, k0, m0, bar);
    }
  } else {
    const int krows = min(BK, ke - k0);
    for (int e = tid; e < BK * 8; e += kThreads) {
      const int r = e >> 3;
      const int ch = e & 7;
      if (n0 + 16 * ch >= ncols) continue;    // past the columns used: unread
      copy16_masked(bs + swz(r, 16 * ch),
                    b + static_cast<int64_t>(k0 + r) * ldb + n0 + 16 * ch,
                    r < krows ? 16 : 0);
    }
    for (int e = tid; e < BM * 8; e += kThreads) {
      const int r = e >> 3;
      const int ch = e & 7;
      copy16_masked(as + swz(r, 16 * ch),
                    a + static_cast<int64_t>(m0 + r) * k + k0 + 16 * ch,
                    m0 + r < m ? min(16, krows - 16 * ch) : 0);
    }
  }
}

template <typename TA, int MFRAG, bool ALIGNED, bool COLCHK, bool PROT>
__global__ void __launch_bounds__(kThreads)
abft_qgemm_kernel(const TA* __restrict__ a_in, const int8_t* __restrict__ b_in,
                  int32_t* __restrict__ c, int32_t* __restrict__ err,
                  int32_t* __restrict__ rowsum, int32_t* __restrict__ check,
                  unsigned* __restrict__ ticket, unsigned* __restrict__ col,
                  const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, int m, int n,
                  int k, int ldb, int k_per_split) {
  constexpr int BM = 16 * MFRAG;
  constexpr int kABytes = BM * 128;
  constexpr int kStageBytes = kABytes + BK * 128;
  constexpr bool kUnsigned = std::is_same<TA, uint8_t>::value;
  static_assert(BM * kRedStride * 4 <= kStages * kStageBytes,
                "the partial sums reuse the drained ring");
  static_assert(PROT || !COLCHK, "the column check is the protected kernel's");
  const int ncols = PROT ? n + 1 : n;     // the columns of B' read

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __shared__ int rowpart[BM];
  __shared__ int asum[BK];
  __shared__ int is_last;
  __shared__ uint64_t full[kStages];     // a stage's bulk copies landed

  const uint8_t* a = reinterpret_cast<const uint8_t*>(a_in);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(b_in);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = (tid >> 5) & 3;         // the warp's 32 columns
  const int wk = tid >> 7;               // the warp's half of a stage's k rows
  const int g = lane >> 2;               // mma group
  const int tig = lane & 3;              // thread in group
  const int n0 = (blockIdx.x / splits) * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = rank * k_per_split;
  const int ke = min(k, kb + k_per_split);
  const int nsteps = (ke - kb + BK - 1) / BK;

  // Nothing global before the wait: the kernel before this one may still
  // be running (see the note on programmatic dependent launch above).
  if (tid < BM) rowpart[tid] = 0;
  if constexpr (ALIGNED) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&amap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&bmap))
                   : "memory");
    }
  }
  // returns once the previous grid has completed and its writes are
  // visible (at once when the kernel was not launched as a dependent)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();

  int acc[MFRAG][4][4];
#pragma unroll
  for (int f = 0; f < MFRAG; ++f)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][q][i] = 0;
  unsigned colacc = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps)
      load_stage<BM, ALIGNED>(ring + s * kStageBytes,
                              ring + s * kStageBytes + kABytes, &full[s],
                              &amap, &bmap, a, b, m0, n0, kb + s * BK, ke, m,
                              ncols, k, ldb, tid);
  }

  for (int step = 0; step < nsteps; ++step) {
    if constexpr (ALIGNED) mbar_wait(&full[step % kStages],
                                     (step / kStages) & 1);
    __syncthreads();
    const int nx = step + kStages - 1;
    if (nx < nsteps) {
      uint8_t* slot = ring + (nx % kStages) * kStageBytes;
      load_stage<BM, ALIGNED>(slot, slot + kABytes, &full[nx % kStages],
                              &amap, &bmap, a, b, m0, n0, kb + nx * BK, ke, m,
                              ncols, k, ldb, tid);
    }

    const uint8_t* as = ring + (step % kStages) * kStageBytes;
    const uint8_t* bs = as + kABytes;

    if constexpr (COLCHK) {
      if (tid < BK) {
        int s = 0;
#pragma unroll 4
        for (int r = 0; r < BM; ++r)
          s += static_cast<int>(static_cast<TA>(as[swz(r, tid)]));
        asum[tid] = s;
      }
      __syncthreads();
      if (tid < BN) {
#pragma unroll 4
        for (int r = 0; r < BK; ++r) {
          const int8_t bv = static_cast<int8_t>(bs[swz(r, tid)]);
          colacc += static_cast<unsigned>(asum[r]) *
                    static_cast<unsigned>(static_cast<int>(bv));
        }
      }
    }

#pragma unroll
    for (int ks = wk * (BK / 2); ks < (wk + 1) * (BK / 2); ks += 32) {
      // B fragments of the warp's 32 columns: words at columns 4g..4g+3 of
      // rows ks + 16h + 4 tig + j, transposed to K-contiguous bytes
      unsigned bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ks + 16 * h + 4 * tig + j;
          w[j] = *reinterpret_cast<const unsigned*>(
              bs + swz(r, 32 * wn + 4 * g));
        }
        const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
        const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
        const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
        const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
        bf[0][h] = __byte_perm(t0, t1, 0x5410);
        bf[1][h] = __byte_perm(t0, t1, 0x7632);
        bf[2][h] = __byte_perm(t2, t3, 0x5410);
        bf[3][h] = __byte_perm(t2, t3, 0x7632);
      }
#pragma unroll
      for (int f = 0; f < MFRAG; ++f) {
        const int r0 = 16 * f + g;
        const int c0 = ks + 4 * tig;
        const unsigned af[4] = {
            *reinterpret_cast<const unsigned*>(as + swz(r0, c0)),
            *reinterpret_cast<const unsigned*>(as + swz(r0 + 8, c0)),
            *reinterpret_cast<const unsigned*>(as + swz(r0, c0 + 16)),
            *reinterpret_cast<const unsigned*>(as + swz(r0 + 8, c0 + 16))};
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_k32<kUnsigned>(acc[f][q], af, bf[q]);
      }
    }
  }
  __syncthreads();

  // this split's partial sums, [BM][kRedStride] over the drained ring: the
  // first k half stores, the second adds.  The mma column 2 tig (+1) of
  // slice q is physical column 8 tig + q (+4)
  int* red = reinterpret_cast<int*>(ring);
  for (int half = 0; half < 2; ++half) {
    if (wk == half) {
#pragma unroll
      for (int f = 0; f < MFRAG; ++f)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int* r0 = red + (16 * f + g) * kRedStride + 32 * wn + 8 * tig + q;
          int* r8 = r0 + 8 * kRedStride;
          r0[0] = half ? r0[0] + acc[f][q][0] : acc[f][q][0];
          r0[4] = half ? r0[4] + acc[f][q][1] : acc[f][q][1];
          r8[0] = half ? r8[0] + acc[f][q][2] : acc[f][q][2];
          r8[4] = half ? r8[4] + acc[f][q][3] : acc[f][q][3];
        }
    }
    if (half == 0) __syncthreads();
  }
  cluster.sync();                       // every split's partials are staged

  // this block's slice of the tile's columns, in 4-column vectors: sum the
  // splits' partials (all of a batch's remote loads in flight at once),
  // store C, and fold the row check
  const int mrows = min(BM, m - m0);
  const int cw = 4 * ((BN / 4 + splits - 1) / splits);
  const int c_lo = rank * cw;
  const int vpr = max(0, min(BN, c_lo + cw) - c_lo) / 4;   // vectors a row
  const int total = mrows * vpr;
  for (int e0 = tid; e0 < total; e0 += kThreads * kRedUnroll) {
    int4 sum[kRedUnroll];
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      sum[u] = make_int4(0, 0, 0, 0);
      const int e = e0 + u * kThreads;
      if (e >= total) continue;
      int* part = red + (e / vpr) * kRedStride + c_lo + 4 * (e % vpr);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s >= splits) continue;
        const int4 p =
            *reinterpret_cast<const int4*>(cluster.map_shared_rank(part, s));
        sum[u].x += p.x;
        sum[u].y += p.y;
        sum[u].z += p.z;
        sum[u].w += p.w;
      }
    }
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) continue;
      const int i = e / vpr;
      const int gc0 = n0 + c_lo + 4 * (e % vpr);
      const int v[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
      int part = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (gc0 + t < n) {
          c[static_cast<int64_t>(m0 + i) * n + gc0 + t] = v[t];
          if constexpr (PROT) part += floor_mod(v[t], kMod);
        } else if (PROT && gc0 + t == n) {
          check[m0 + i] = floor_mod(v[t], kMod);
        }
      }
      if (PROT && part) atomicAdd(&rowpart[i], part);
    }
  }
  cluster.sync();                       // peers leave after all reads
  if constexpr (!PROT) return;

  if (tid < mrows && rowpart[tid])
    atomicAdd(&rowsum[m0 + tid], rowpart[tid] % kMod);
  if constexpr (COLCHK) {
    if (tid < BN && n0 + tid < n) atomicAdd(&col[n0 + tid], colacc);
  }
  __syncthreads();
  if (tid == 0) {               // the block's writes, then its arrival
    __threadfence();
    is_last = atomicAdd(&ticket[blockIdx.y], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last) {                        // every block of this row tile is in
    __threadfence();
    for (int i = tid; i < mrows; i += kThreads) {
      err[m0 + i] =
          (__ldcg(&rowsum[m0 + i]) % kMod) != __ldcg(&check[m0 + i]) ? 1 : 0;
      rowsum[m0 + i] = 0;               // left zeroed for the next call
    }
    if (tid == 0) ticket[blockIdx.y] = 0;
  }
}

struct Args {
  const void* a;
  const void* b;
  int32_t* c;
  int32_t* err;
  int32_t* rowsum;
  int32_t* check;
  unsigned* ticket;
  unsigned* col;
  int m, n, k, ldb, splits, k_per_split;
  bool pdl;
};

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (the
// library links no libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// map of a row-major uint8 [rows, cols] tensor with rows ld bytes apart,
// read in 128-byte-swizzled boxes of box_rows x 128 bytes
bool make_map(CUtensorMap* map, const void* base, uint64_t cols,
              uint64_t rows, uint64_t ld, uint32_t box_rows) {
  const EncodeTiled enc = encoder();
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {128, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc != nullptr &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TA, int MFRAG, bool ALIGNED, bool COLCHK, bool PROT = true>
cudaError_t launch(const Args& p, cudaStream_t s) {
  auto kernel = abft_qgemm_kernel<TA, MFRAG, ALIGNED, COLCHK, PROT>;
  const int ncols = PROT ? p.n + 1 : p.n;
  constexpr int kSmem = smem_bytes<MFRAG>();
  // the ring is above the 48 KB default: allow it once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap amap{}, bmap{};           // unused on the ragged path
  // the protected kernel maps B' 16 columns past n: the checksum lane's
  // 16-byte chunk; the unprotected one its first n columns
  if (ALIGNED && !(make_map(&amap, p.a, p.k, p.m, p.k, 16 * MFRAG) &&
                   make_map(&bmap, p.b, PROT ? p.n + 16 : p.n, p.k, p.ldb,
                            BK)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((ncols + BN - 1) / BN * p.splits,
                     (p.m + 16 * MFRAG - 1) / (16 * MFRAG), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  // a programmatic dependent of the previous kernel in the stream: it may
  // launch while that kernel runs (K3 lets it), and waits in the kernel
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const TA*>(p.a),
                            static_cast<const int8_t*>(p.b), p.c, p.err,
                            p.rowsum, p.check, p.ticket, p.col, amap, bmap,
                            p.m, p.n, p.k, p.ldb, p.k_per_split);
}

template <typename TA, int MFRAG>
cudaError_t dispatch(bool aligned, const Args& p, cudaStream_t s) {
  if (aligned)
    return p.col ? launch<TA, MFRAG, true, true>(p, s)
                 : launch<TA, MFRAG, true, false>(p, s);
  return p.col ? launch<TA, MFRAG, false, true>(p, s)
               : launch<TA, MFRAG, false, false>(p, s);
}

template <typename TA>
cudaError_t dispatch_rows(int bm, bool aligned, const Args& p,
                          cudaStream_t s) {
  switch (bm) {
    case 16: return dispatch<TA, 1>(aligned, p, s);
    case 32: return dispatch<TA, 2>(aligned, p, s);
    case 64: return dispatch<TA, 4>(aligned, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// the plan fits the shape: splits of whole stages covering k with none
// empty, and 16-byte copies only where both operands and rows allow them
bool plan_ok(const void* a, const void* b, int m, int n, int k, int ldb,
             int splits, int k_per_split, int aligned) {
  const bool split_ok = splits >= 1 && splits <= kMaxSplits &&
                        k_per_split > 0 && k_per_split % BK == 0 &&
                        static_cast<int64_t>(splits) * k_per_split >= k &&
                        static_cast<int64_t>(splits - 1) * k_per_split < k;
  const bool align_ok =
      !aligned || ((reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) % 16 == 0 &&
                   k % 16 == 0 && ldb % 16 == 0);
  return split_ok && align_ok && m >= 1 && n >= 1 && k >= 1 &&
         ldb == n + kLane;
}

}  // namespace

// a int8/uint8 [m, k] row-major (a_unsigned selects uint8), b int8 [k, ldb]
// row-major with ldb = n + 128 -> c int32 [m, n], err int32 [m], and with
// col (zeroed int32 [n]) the column check colsum(A) @ B added into it.
// rowsum int32 [m] and ticket int32 [row tiles] must be zero on entry and
// are left zero (the last block of each row tile resets its own); check
// int32 [m] is scratch.  The plan: row tile bm (16, 32 or 64), splits (the
// cluster size, 1-8) of k_per_split rows each (a multiple of 64, covering
// k with no empty split), and aligned (16-byte copies; needs both operands
// and k, ldb on 16-byte multiples).  pdl = 1 launches it as the programmatic
// dependent of the previous kernel in the stream (0 only to measure what
// that buys).
REPRO_API int abft_qgemm_launch(const void* a, int a_unsigned, const void* b,
                                void* c, void* err, void* rowsum, void* check,
                                void* ticket, void* col, int m, int n, int k,
                                int ldb, int bm, int splits, int k_per_split,
                                int aligned, int pdl, void* stream) {
  if (!plan_ok(a, b, m, n, k, ldb, splits, k_per_split, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p = {a, b, static_cast<int32_t*>(c), static_cast<int32_t*>(err),
                  static_cast<int32_t*>(rowsum), static_cast<int32_t*>(check),
                  static_cast<unsigned*>(ticket), static_cast<unsigned*>(col),
                  m, n, k, ldb, splits, k_per_split, pdl != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a_unsigned
                            ? dispatch_rows<uint8_t>(bm, aligned, p, s)
                            : dispatch_rows<int8_t>(bm, aligned, p, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename TA>
cudaError_t dispatch_unprotected(int bm, bool aligned, const Args& p,
                                 cudaStream_t s) {
  switch (bm) {
    case 16:
      return aligned ? launch<TA, 1, true, false, false>(p, s)
                     : launch<TA, 1, false, false, false>(p, s);
    case 32:
      return aligned ? launch<TA, 2, true, false, false>(p, s)
                     : launch<TA, 2, false, false, false>(p, s);
    case 64:
      return aligned ? launch<TA, 4, true, false, false>(p, s)
                     : launch<TA, 4, false, false, false>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The unprotected instance: a int8/uint8 [m, k] (a_unsigned selects
// uint8), b the same packed int8 [k, ldb = n + 128] -> c int32 [m, n] =
// a @ b[:, :n]; the plan as above, made for the n columns alone
// (kernels/abft_qgemm.launch_plan with protect=False).  Launched as a
// programmatic dependent, as K1 is.
REPRO_API int qgemm_unprotected_launch(const void* a, int a_unsigned,
                                       const void* b, void* c, int m, int n,
                                       int k, int ldb, int bm, int splits,
                                       int k_per_split, int aligned,
                                       void* stream) {
  if (!plan_ok(a, b, m, n, k, ldb, splits, k_per_split, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p = {a, b, static_cast<int32_t*>(c), nullptr, nullptr, nullptr,
                  nullptr, nullptr, m, n, k, ldb, splits, k_per_split, true};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      a_unsigned ? dispatch_unprotected<uint8_t>(bm, aligned, p, s)
                 : dispatch_unprotected<int8_t>(bm, aligned, p, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
