// K2: quantized EmbeddingBag with the Eq. (5) check fused in
// (kernels/abft_embeddingbag.py; replaces
// src/repro/kernels/abft_embeddingbag.py::abft_eb_pallas and the compare
// its wrapper leaves to XLA).
//
// What bounds it on the H100: random HBM requests, four a slot -- the
// d-byte row and, each in its own array, alpha, beta and C_T (a 32-byte
// sector each) -- against ~5 float operations a row byte.
//  - The paper's Table I pooling (26 x 2048 bags x 100, d 128): 0.24 ms
//    of useful bytes, 0.37 ms of sectors at 3.35 TB/s: the rate of
//    random requests, four a slot, sets the time (PERF.md).  Each lane
//    keeps kInflight 16-byte row words in flight (8 warps x 3 blocks x
//    32 lanes x 8 x 16 B = 96 KB an SM, against ~30 KB that 25 GB/s an
//    SM times ~1.2 us of loaded latency needs).
//  - One DLRM request (26 tables x 10 bags x <= 16 slots, ~0.6 MB): the
//    launch (chained under PDL), the index load, one round of row and
//    scale loads, the arithmetic and the count's atomic.
//  - The RWKV token table (65536 x 2048, pool 1, 64 or 4 bags): the
//    launch and one round of loads.
//
// Design.  A bag whose row is 1, 2, 4 or 8 words of 16 bytes (d 16 to
// 128) is one warp, G = 4 slots a warp load; any other is a team of up to
// 8 warps, one slot a load, in 16-byte words or, where d is not a
// multiple of 16 or the table not 16-byte aligned, in bytes.  A block
// holds bags_per_block bags of one table.  The warp loads up to 32 of its
// bag's indices at once, coalesced, and in the same pass gathers each
// slot's alpha, beta, weight and C_T lane-parallel into shared memory
// (one 16-byte broadcast read a slot later).  Rows come as 16-byte words
// (ld.global.nc, no L1 allocation: each is read once), kInflight words a
// lane issued before the first is used.  At d
// 128 a warp load brings 4 slots in 4 lane groups of 8; a register
// transpose (__shfl_sync) then gives each lane 4 whole columns of the 4
// slots, so every element of R is one lane's sum over the slots in slot
// order from 0 -- the order of the first version of this kernel -- and
// each term is w * (alpha * row + beta) with _rn intrinsics (no FMA): R
// is bit-exact with a slot-order sum of the plain terms.  int8 -> float
// is a byte permute into 2^23's mantissa and an exact subtraction, on the
// float pipe.  Padded slots (index < 0) read row 0 with weight 0, as the
// plain version does; an index past the table reads its last row (the
// clamp of an XLA gather).  Row offsets are 64-bit: a stack of 26 tables
// of 4M x 128 int8 is 1.33e10 bytes.
//
// The check: every lane adds, over the same slots in slot order, the
// terms of core/abft_embedding.py::verify_bags one for one,
//   csum = sum w (alpha C_T + d beta),
//   mag = sum |w| (|alpha| |C_T| + d |beta|),
// and the bag's leader flags |rsum - csum| > rel_bound * max(mag, 1), rsum
// being the bag's sum of R (lanes, then warps).  The lane that gathers a
// slot makes its two terms, and every lane adds them from shared memory
// in slot order.  Each table's flag count and block ticket share one
// 64-bit word kept zero at rest (kernels/abft_embeddingbag._scratch): a
// block adds (its flags << 32) + 1 in one atomic, with no fence, and the
// block that draws the last ticket writes the count and re-zeroes the
// word, so a call is this one kernel.
//
// Launched with programmatic stream serialization (Hopper PDL): it may
// start while the kernel before it runs, so it touches no global memory
// before griddepcontrol.wait (that kernel may be writing the indices, a
// flipped table byte or alpha, or the counters); it lets the kernel after
// it launch at once.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPass = 32;       // slots whose indices a warp loads at once
constexpr int kInflight = 8;    // row words a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

struct EbArgs {
  const int8_t* table;          // [tables, rows, d]
  const float* alphas;          // [tables, rows]
  const float* betas;           // [tables, rows]
  const int32_t* rowsums;       // [tables, rows], C_T
  const int32_t* indices;       // [tables, bags, pool], -1 padded
  const float* weights;         // [tables, bags, pool] or null
  float* r;                     // [tables, bags, d]
  float* rsum;                  // [tables, bags]
  uint8_t* err_bags;            // [tables, bags] (bool)
  int32_t* err_count;           // [tables]
  unsigned long long* tally;    // [tables]: flags << 32 | tickets, 0 at rest
  int64_t rows;
  int d, bags, pool;
  int lanes;                    // words of a row: d / 16, or d bytes
  int warps_per_bag, bags_per_block, blocks_per_table;
  float rel_bound;
};

// 16 bytes of a table row, read once: not kept in L1
__device__ __forceinline__ uint4 load_row16(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The 4 signed bytes of x as exact floats: b ^ 0x80 is b + 128 in
// 0..255; in the mantissa of 2^23 that is 2^23 + b + 128, and subtracting
// 2^23 + 128 leaves b exactly.
__device__ __forceinline__ void bytes4(unsigned x, float* f) {
  const unsigned u = x ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + k)),
                     8388736.0f);
}

// A slot's terms of R, added to acc: w * (alpha * row + beta), rounded as
// the plain version rounds it (q = (alpha, beta, w, .)).  Always times w,
// with no branch where w == 1, so the slots' products overlap.
template <int N>
__device__ __forceinline__ void add_terms(const float4& q, const float* v,
                                          float* acc) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    acc[e] = __fadd_rn(acc[e],
                       __fmul_rn(q.z, __fadd_rn(__fmul_rn(q.x, v[e]), q.y)));
}

__device__ __forceinline__ unsigned pick(const uint4& v, int i) {
  const unsigned lo = (i & 1) ? v.y : v.x;
  const unsigned hi = (i & 1) ? v.w : v.z;
  return (i & 2) ? hi : lo;
}

// The slot's terms of verify_bags, one for one: q.w = w (alpha C_T + d beta)
// and the returned |w| (|alpha| |C_T| + d |beta|).
__device__ __forceinline__ float check_terms(float4& q, int ct, float df) {
  const float c = __int2float_rn(ct);
  q.w = __fmul_rn(q.z, __fadd_rn(__fmul_rn(q.x, c), __fmul_rn(df, q.y)));
  return __fmul_rn(fabsf(q.z), __fadd_rn(__fmul_rn(fabsf(q.x), fabsf(c)),
                                         __fmul_rn(df, fabsf(q.y))));
}

// The register transpose of one warp load of G slots.  Lane l = g * lanes
// + w holds word w (16 bytes) of slot group g's row.  Afterwards lane l
// holds, for each group in order, the C = 16 / G bytes of columns
// l * C .. l * C + C - 1 (NC = C / 4 words).  Round r: lane l (m = l mod
// G) reads group (m + r) mod G, and each word's holder sends the bytes of
// the one reader with m = (g - r) mod G, so every round is one shuffle a
// word; a rotation by m then puts the groups in order.
template <int G>
__device__ __forceinline__ void transpose(const uint4& v, int g, int m,
                                          int src_word, int lanes,
                                          unsigned (&out)[G][4 / G]) {
  constexpr int NC = 4 / G;
  unsigned got[G][NC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int src = (((m + r) & (G - 1)) * lanes + src_word) & 31;
    const int c0 = ((g - r) & (G - 1)) * NC;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      got[r][c] = __shfl_sync(kFull, pick(v, c0 + c), src);
  }
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    const int r = (gg - m) & (G - 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      unsigned x = got[0][c];
#pragma unroll
      for (int k = 1; k < G; ++k) x = r == k ? got[k][c] : x;
      out[gg][c] = x;
    }
  }
}

// Shared memory of a warp's pass: each slot's (alpha, beta, w, its csum
// term) and its mag term.
struct PassSlots {
  float4 q[kPass];
  float mag[kPass];
};

// Slot s of the bag as one lane gathers it: its row, (alpha, beta, w,
// its csum term) and its mag term.
struct Gathered {
  int row;
  float4 q;
  float mag;
};

// The pass's slot base + lane, gathered by this lane (nothing where it is
// past the pool).  A padded slot is row 0 with weight 0; an index past the
// table reads its last row.
__device__ __forceinline__ Gathered gather(const EbArgs& p, int t,
                                           int64_t flat, int base, int n,
                                           int lane, float df) {
  Gathered g = {0, make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0.0f};
  if (lane >= n) return g;
  const int64_t at = flat * p.pool + base + lane;
  const int i = __ldg(p.indices + at);
  const bool valid = i >= 0;
  g.row = valid ? (i < p.rows ? i : static_cast<int>(p.rows - 1)) : 0;
  const int64_t tr = static_cast<int64_t>(t) * p.rows + g.row;
  g.q.x = __ldg(p.alphas + tr);
  g.q.y = __ldg(p.betas + tr);
  g.q.z = valid ? (p.weights == nullptr ? 1.0f : __ldg(p.weights + at))
                : 0.0f;
  g.mag = check_terms(g.q, __ldg(p.rowsums + tr), df);
  return g;
}

// The gathered slots into the warp's shared memory; the caller issues its
// row loads first, so they fly with the scales.
__device__ __forceinline__ void publish(PassSlots& ps, const Gathered& g,
                                        int lane) {
  ps.q[lane] = g.q;
  ps.mag[lane] = g.mag;
  __syncwarp();
}

// A bag on one warp, G slots a warp load (16-byte words, lanes * G <= 32).
template <int G>
__device__ void bag_grouped(const EbArgs& p, int t, int64_t flat, int lane,
                            PassSlots& ps, float& part, float& csum,
                            float& mag) {
  constexpr int C = 16 / G;
  constexpr int NC = 4 / G;
  const int lanes = p.lanes;
  const int g = lane / lanes;               // >= G: the lane loads nothing
  const int w = lane - g * lanes;
  const int m = lane & (G - 1);
  const float df = static_cast<float>(p.d);
  const int8_t* tab = p.table + static_cast<int64_t>(t) * p.rows * p.d +
                      16 * w;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int base = 0; base < p.pool; base += kPass) {
    const int n = min(kPass, p.pool - base);
    const Gathered gs = gather(p, t, flat, base, n, lane, df);
    for (int c0 = 0; c0 < n; c0 += kInflight * G) {
      uint4 v[kInflight];
#pragma unroll
      for (int k = 0; k < kInflight; ++k) {
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + k * G >= n) break;         // the same on every lane
        const int s = c0 + k * G + g;
        const int rs = __shfl_sync(kFull, gs.row, s & 31);
        if (g < G && s < n)
          v[k] = load_row16(tab + static_cast<int64_t>(rs) * p.d);
      }
      if (c0 == 0) publish(ps, gs, lane);   // the rows are on their way
#pragma unroll
      for (int k = 0; k < kInflight; ++k) {
        if (c0 + k * G >= n) break;
        unsigned x[G][NC];
        transpose<G>(v[k], g, m, lane / G, lanes, x);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const int s = c0 + k * G + gg;
          if (s >= n) break;
          const float4 q = ps.q[s];
          csum = __fadd_rn(csum, q.w);
          mag = __fadd_rn(mag, ps.mag[s]);
          float f[C];
#pragma unroll
          for (int c = 0; c < NC; ++c) bytes4(x[gg][c], f + 4 * c);
          add_terms<C>(q, f, acc);
        }
      }
    }
    __syncwarp();                           // the pass's slots are used
  }
  if (lane < G * lanes) {                   // the lane owns columns
    float4* out = reinterpret_cast<float4*>(p.r + flat * p.d + lane * C);
#pragma unroll
    for (int c = 0; c < C / 4; ++c) {
      out[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                           acc[4 * c + 3]);
      part = __fadd_rn(part, __fadd_rn(__fadd_rn(acc[4 * c], acc[4 * c + 1]),
                                       __fadd_rn(acc[4 * c + 2],
                                                 acc[4 * c + 3])));
    }
  }
}

// A bag on a team of warps_per_bag warps, one slot a load: each lane owns
// one word (16 bytes on the vector path, 1 on the byte path) of the row
// at a time, over the row in steps of the team's lanes.
template <bool VEC>
__device__ void bag_wide(const EbArgs& p, int t, int64_t flat, int wit,
                         int lane, PassSlots& ps, float& part, float& csum,
                         float& mag) {
  constexpr int E = VEC ? 16 : 1;           // row bytes a word
  using Word = typename std::conditional<VEC, uint4, int>::type;
  const int team_lanes = 32 * p.warps_per_bag;
  const float df = static_cast<float>(p.d);
  const int8_t* tab = p.table + static_cast<int64_t>(t) * p.rows * p.d;
  float* out = p.r + flat * p.d;
  for (int w0 = 0; w0 < p.lanes; w0 += team_lanes) {
    const int w = w0 + 32 * wit + lane;
    const bool mine = w < p.lanes;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    for (int base = 0; base < p.pool; base += kPass) {
      const int n = min(kPass, p.pool - base);
      const Gathered gs = gather(p, t, flat, base, n, lane, df);
      for (int c0 = 0; c0 < n; c0 += kInflight) {
        Word v[kInflight];
#pragma unroll
        for (int k = 0; k < kInflight; ++k) {
          v[k] = Word{};
          if (c0 + k >= n) break;
          const int rs = __shfl_sync(kFull, gs.row, (c0 + k) & 31);
          if (mine) {
            const int8_t* at = tab + static_cast<int64_t>(rs) * p.d + E * w;
            if constexpr (VEC)
              v[k] = load_row16(at);
            else
              v[k] = __ldg(at);
          }
        }
        if (c0 == 0) publish(ps, gs, lane);
#pragma unroll
        for (int k = 0; k < kInflight; ++k) {
          if (c0 + k >= n) break;
          const float4 q = ps.q[c0 + k];
          if (w0 == 0) {
            csum = __fadd_rn(csum, q.w);
            mag = __fadd_rn(mag, ps.mag[c0 + k]);
          }
          float f[E];
          if constexpr (VEC) {
            bytes4(v[k].x, f);
            bytes4(v[k].y, f + 4);
            bytes4(v[k].z, f + 8);
            bytes4(v[k].w, f + 12);
          } else {
            f[0] = static_cast<float>(v[k]);
          }
          add_terms<E>(q, f, acc);
        }
      }
      __syncwarp();
    }
    if (mine) {
      if constexpr (VEC) {
        float4* o = reinterpret_cast<float4*>(out + 16 * w);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                             acc[4 * c + 3]);
      } else {
        out[w] = acc[0];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) part = __fadd_rn(part, acc[e]);
    }
  }
}

// G = 4: one warp a bag, 4 slots a warp load (vector path); G = 1: a
// team of warps a bag, 16-byte (VEC) or byte words.  The d-128 path
// (G = 4) fits 3 blocks an SM without spilling; the others keep 2.
template <int G, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, G == 4 ? 3 : 2)
abft_eb_kernel(const EbArgs p) {
  __shared__ PassSlots s_slots[kMaxWarps];
  __shared__ float s_part[kMaxWarps];
  __shared__ unsigned s_flagged;

  // the next kernel may launch now; it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) s_flagged = 0u;
  // no global access until the kernel before this one has completed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x / p.blocks_per_table;
  const int team = warp / p.warps_per_bag;
  const int wit = warp - team * p.warps_per_bag;
  const int bag = (blockIdx.x - t * p.blocks_per_table) * p.bags_per_block +
                  team;
  const bool live = bag < p.bags;
  const int64_t flat = static_cast<int64_t>(t) * p.bags + bag;

  float part = 0.0f;    // this lane's share of rsum
  float csum = 0.0f;
  float mag = 0.0f;
  if (live) {
    if constexpr (G > 1)
      bag_grouped<G>(p, t, flat, lane, s_slots[warp], part, csum, mag);
    else
      bag_wide<VEC>(p, t, flat, wit, lane, s_slots[warp], part, csum, mag);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
  if (lane == 0) s_part[warp] = part;
  __syncthreads();
  if (live && wit == 0 && lane == 0) {
    float rs = s_part[warp];
    for (int k = 1; k < p.warps_per_bag; ++k)
      rs = __fadd_rn(rs, s_part[warp + k]);
    // torch.clamp(mag, min=1) keeps a NaN, so the compare is then false
    const float tol = __fmul_rn(p.rel_bound, mag < 1.0f ? 1.0f : mag);
    const bool flag = fabsf(__fsub_rn(rs, csum)) > tol;
    p.rsum[flat] = rs;
    p.err_bags[flat] = flag ? 1 : 0;
    if (flag) atomicAdd(&s_flagged, 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // one atomic: every earlier block's flags are in what it returns
    const unsigned long long was = atomicAdd(
        p.tally + t, (static_cast<unsigned long long>(s_flagged) << 32) + 1);
    if (static_cast<unsigned>(was) ==
        static_cast<unsigned>(p.blocks_per_table - 1)) {
      p.err_count[t] = static_cast<int32_t>((was >> 32) + s_flagged);
      p.tally[t] = 0ull;
    }
  }
}

template <int G, bool VEC>
cudaError_t launch(const EbArgs& a, int blocks, int threads,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = s;
  // a programmatic dependent of the previous kernel in the stream
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, abft_eb_kernel<G, VEC>, a);
}

}  // namespace

// table int8 [tables, rows, d]; alphas, betas f32 and rowsums int32
// [tables, rows]; indices int32 [tables, bags, pool] (-1 padded); weights
// f32 [tables, bags, pool] or null -> r f32 [tables, bags, d], rsum f32
// and err_bags bool [tables, bags], err_count int32 [tables].  tally:
// uint64 [tables], zero on entry, left zero.  The plan
// (vec, lanes, groups, warps_per_bag, bags_per_block, blocks_per_table)
// is kernels/abft_embeddingbag.eb_plan's; one that does not fit returns
// cudaErrorInvalidValue.  Launched as the programmatic dependent of the
// previous kernel in the stream.
REPRO_API int abft_eb_launch(
    const void* table, const void* alphas, const void* betas,
    const void* rowsums, const void* indices, const void* weights, void* r,
    void* rsum, void* err_bags, void* err_count, void* tally,
    int tables, long long rows, int d, int bags, int pool, float rel_bound,
    int vec, int lanes, int groups, int warps_per_bag, int bags_per_block,
    int blocks_per_table, void* stream) {
  const int team = warps_per_bag * bags_per_block;
  const bool fits =
      tables >= 1 && bags >= 1 && pool >= 0 && d >= 1 && rows >= 1 &&
      rows < (1ll << 31) && warps_per_bag >= 1 &&
      bags_per_block >= 1 && team <= kMaxWarps &&
      blocks_per_table == (bags + bags_per_block - 1) / bags_per_block &&
      static_cast<long long>(tables) * blocks_per_table < (1ll << 31) &&
      (vec ? d % 16 == 0 && lanes == d / 16 &&
                 reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(r) % 16 == 0
           : lanes == d && groups == 1) &&
      (groups == 1 ||
       (groups == 4 && vec && warps_per_bag == 1 && lanes * groups <= 32 &&
        32 % lanes == 0));
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  EbArgs a;
  a.table = static_cast<const int8_t*>(table);
  a.alphas = static_cast<const float*>(alphas);
  a.betas = static_cast<const float*>(betas);
  a.rowsums = static_cast<const int32_t*>(rowsums);
  a.indices = static_cast<const int32_t*>(indices);
  a.weights = static_cast<const float*>(weights);
  a.r = static_cast<float*>(r);
  a.rsum = static_cast<float*>(rsum);
  a.err_bags = static_cast<uint8_t*>(err_bags);
  a.err_count = static_cast<int32_t*>(err_count);
  a.tally = static_cast<unsigned long long*>(tally);
  a.rows = rows;
  a.d = d;
  a.bags = bags;
  a.pool = pool;
  a.lanes = lanes;
  a.warps_per_bag = warps_per_bag;
  a.bags_per_block = bags_per_block;
  a.blocks_per_table = blocks_per_table;
  a.rel_bound = rel_bound;
  const int blocks = tables * blocks_per_table;
  const int threads = 32 * team;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = groups == 4 ? launch<4, true>(a, blocks, threads, s)
                        : vec       ? launch<1, true>(a, blocks, threads, s)
                                    : launch<1, false>(a, blocks, threads, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
