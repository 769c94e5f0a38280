// Exact 2-NN descriptor matching, batched over image pairs, for Hopper (sm_90a).
//
// Replaces bundler_sfm_tpu/ops/matching_pallas.py::two_nn_pallas (its three
// VMEM-sized variants: oneblock, resident, streamed), vmapped over pairs as
// bundler_sfm_tpu/ops/matching.py::_match_pairs_from_table_masked does.
//
// For pair b, query rows are qtab[pi[b]] and db rows are dbtab[pj[b]], of
// which the first db_counts[pj[b]] are valid.  For every query row the kernel
// returns the squared L2 distance d0 and index i0 of the nearest valid db
// row and the distance d1 of the second nearest.  Ties go to the lowest db
// index; with fewer than two valid rows the missing distance is 3e38, and
// with none i0 is 0, as in the XLA path (ops/matching.py::two_nn), whatever
// the rows past the count hold.
//
// Entry points:
//   two_nn_pairs_i8      — the main path.  Centered int8 descriptors
//                          (u8 - 128), a warp-specialised wgmma kernel (below),
//                          one launch.
//   two_nn_pairs_f32     — f32 tables on the same machinery, operands rounded
//                          to bf16, f32 accumulate, norms from the unrounded
//                          values, d = (|q|^2 + |b|^2) - 2 q.b and the top-2 in
//                          f32 (exact for integer-valued descriptors with
//                          |x| <= 255: every quantity is an integer below 2^24
//                          until the last subtraction, rounded as the plain
//                          version rounds it); two_nn_prepass_f32 first.
//
// Bound on an H100: 2*B*Nq*Nd*128 int8 tensor-core operations (1979 TOP/s
// dense, 4096 int8 MAC per clock per SM), and B*Nq*Nd top-2 updates on the
// CUDA cores.  Every int8 distance is an integer below 2^23, so all of it
// runs in int32 and is converted to f32 once: bit-identical to the XLA path.
//
// What held a first design (mma.sync m16n8k32 / m16n8k16, db tiles staged
// synchronously by all warps) back, and what this one does about it:
//  * Operand bandwidth.  Each of 8 warps loaded its own B fragments from
//    shared memory with 32-bit loads: 256 B per m16n8k32 (4096 MAC, one SM
//    clock at peak), against the 128 B per clock shared memory gives, so
//    the product loop was capped near 50 % of peak before any conflict.
//    Here each consumer warpgroup keeps its 64 query rows' A fragments in
//    registers (16 a thread) for the whole db sweep and issues
//    wgmma.m64n128k32.s32.s8.s8 with B read by the tensor cores from the
//    swizzled ring stage: 4 KB per 64x128x32 product (64 clocks at peak),
//    so two warpgroups need 64 B per clock.
//  * Staging.  The db tile was a global load, a shared store, dp4a norms and
//    two __syncthreads per 64 rows, overlapping nothing.  Here a producer
//    warp keeps STAGES 128-row tiles in flight with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle: a descriptor row is one
//    swizzle atom, so the box lands in the K-major layout wgmma reads, with
//    no padding) plus a bulk copy of the tile's column constants, on an
//    mbarrier ring; consumers wait on full barriers and release empty ones.
//    The persistent grid walks (pair, query tile) items in order, so the
//    ring runs on across items and the pairs that share a db image run
//    close together while it sits in L2.
//  * Norms.  Every block recomputed every db row's norm.  Here they are
//    written once per call: c = |b|^2 * 256 + (row % 128) for valid rows,
//    KEY_POISON for rows at or past the count, [n_img, Kp] int32 with Kp =
//    K rounded up to 128, by the launch itself: a first phase over the
//    whole grid (eight lanes a row, several loads in flight a thread) into
//    scratch the wrapper allocates with the outputs, then a grid-wide
//    barrier (a cooperative launch keeps every block resident; the grid is
//    one block per SM at most), then the ring copies each tile's constants
//    beside it.  So an int8 call is one launch.  Two other designs were
//    measured first (PERF.md, section 6): a separate norms kernel costs a
//    launch and an allocation, 20-50 us of host time a call against its
//    3-6 us of device time; and two idle producer warps
//    writing each staged tile's constants from shared memory slowed the
//    kernel by a third at 128 query rows a tile, because they share the
//    issue slots with the consumers' epilogue, which bounds the kernel and
//    would pay for 4096 dp4a a tile again for every item.  The pre-phase
//    costs about 1 % of a call's device time.
//  * Epilogue.  It took ~6 integer instructions a score (qsq + bsq - 2 acc,
//    a compare, three selects).  Here the per-row |q|^2 leaves the
//    comparison: key = c - 512 acc = (|b|^2 - 2 q.b) * 256 + column is one
//    IMAD (e = |b|^2 - 2 q.b lies in [-2^21, 2^23), so the key fits int32
//    and orders by (distance, column)).  Two keys fold into a tile-local
//    top-2 with six min/max: 4 instructions a score in all.  Once per
//    tile the tile's top-2 merges into the running (e0, i0, e1) with the
//    running entry winning ties (tiles arrive in increasing column order);
//    |q|^2 is added back at the end.  Rows past the count occur only in a
//    pair's last tile, whose keys are raised to KEY_POISON there.  Two
//    accumulator sets let tile n's epilogue run while tile n+1's wgmma
//    flies; setmaxnreg moves registers from the producer warpgroup to the
//    consumers.
// What bounds it now is the epilogue: per 128-column tile each consumer
// thread issues 64 IMAD, 192 min/max, 16 shared loads and ~20 instructions
// of merge, so the 8 consumer warps of an SM put ~1000 clocks of integer
// work (64 lanes a clock) against 512 clocks of tensor-core work.  That is a
// reckoning from the instruction mix, not a measurement; PERF.md has the
// measured times.
//
// The f32 tables (two_nn_f32_ws_kernel) replaced the first design's mma.sync
// instantiation, which paid the first design's costs twice over at the bf16
// rate and converted f32 to bf16 per staged tile.  TMA cannot convert, so a
// pre-pass writes a bf16 copy of the db table and f32 |b|^2 (3e38 past the
// count) once per call, and a bf16 copy of the query table with |q|^2
// (one copy when both are one table); the ring then holds 128-row bf16
// tiles (two 64-column boxes, 32 KB a stage), each item's query tile is
// loaded once into shared memory, and the consumers issue
// wgmma.m64n128k16.f32.bf16.bf16 with A and B from shared memory (96 B of
// operands a clock at peak, under the 128 B shared memory gives).  Packed int32 keys
// do not carry over (they are exact only for centered int8 values), so the
// top-2 stays in f32 in the plain version's order and rounding: one FADD
// and one FFMA a score for d, then a strict `<` and three min/max into a
// tile-local top-2 with its column, merged once per tile.  That is ~7
// instructions a score against a product at half the int8 rate: per tile
// ~900 clocks of epilogue against ~1000 of tensor-core work on an SM, so
// the two overlap at best (a reckoning; PERF.md has the measured split).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_ring.cuh"

namespace {

using namespace wsk;

constexpr int DIM = 128;          // descriptor length

// ------------------------------------------------- int8 wgmma kernel ----

constexpr int QT_WS = 128;                   // query rows per work item
constexpr int STAGES = 4;
constexpr int WS_THREADS = 3 * WG;           // 2 consumer warpgroups + producer
constexpr int TILE_BYTES = NT * DIM;
constexpr int SMEM_WS = 1024 + STAGES * (TILE_BYTES + NORM_BYTES) + 2 * STAGES * 8;

// One 64x128 int32 product tile: the warpgroup's A (registers) against the
// 128 db rows of ring stage `b_addr`, four k32 steps of 32 bytes each.
__device__ __forceinline__ void issue_tile(int (&d)[64], const uint32_t (&a)[4][4],
                                           uint32_t b_addr) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_k32<0>(d, a[0], desc_sw128(b_addr));
  wgmma_k32<1>(d, a[1], desc_sw128(b_addr + 32));
  wgmma_k32<1>(d, a[2], desc_sw128(b_addr + 64));
  wgmma_k32<1>(d, a[3], desc_sw128(b_addr + 96));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The product-only ablation (two_nn_product_max_i8): the row max of q.b
// over the tile's valid columns, one max a score.
template <bool LAST>
__device__ __forceinline__ void max_epilogue(const int (&acc)[64], const int* cst,
                                             int t, int& mlo, int& mhi) {
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    int a0 = acc[4 * i], a1 = acc[4 * i + 1];
    int a2 = acc[4 * i + 2], a3 = acc[4 * i + 3];
    if (LAST) {
      const int2 c = *reinterpret_cast<const int2*>(cst + 8 * i + 2 * t);
      a0 = c.x == KEY_POISON ? INT32_MIN : a0;
      a1 = c.y == KEY_POISON ? INT32_MIN : a1;
      a2 = c.x == KEY_POISON ? INT32_MIN : a2;
      a3 = c.y == KEY_POISON ? INT32_MIN : a3;
    }
    mlo = max(mlo, max(a0, a1));
    mhi = max(mhi, max(a2, a3));
  }
}

__device__ __forceinline__ int dp4a_sq(uint32_t v, int acc) {
  return __dp4a(static_cast<int>(v), static_cast<int>(v), acc);
}

// The grid barrier's counter (grid_barrier in wgmma_ring.cuh).
__device__ unsigned int grid_arrived;

// TOP2: the exact 2-NN; else the product-only ablation (row max of q.b,
// i0 = d1 = 0), which splits the kernel's time between product and top-2.
// The launch writes the column constants into `norms` itself in a
// pre-phase over the db table, then meets at a grid barrier (a cooperative
// launch), and the ring loads them beside each db tile.
template <bool TOP2>
__global__ void __launch_bounds__(WS_THREADS, 1)
two_nn_ws_kernel(const __grid_constant__ CUtensorMap db_map,
                 const int8_t* __restrict__ qtab, long long q_stride, int nq,
                 const int8_t* __restrict__ dbtab, int n_img, int nd,
                 const int* __restrict__ db_counts, int* __restrict__ norms,
                 int kp, const int* __restrict__ pi,
                 const int* __restrict__ pj, int num_items,
                 float* __restrict__ d0_out, int* __restrict__ i0_out,
                 float* __restrict__ d1_out) {
  table_constants(dbtab, n_img, nd, kp, db_counts, 0, norms, nullptr);
  fence_proxy_async_global();
  grid_barrier(&grid_arrived);
  fence_proxy_async_global();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t tiles = smem_u32(smem);
  const int* norm_s = reinterpret_cast<const int*>(smem + STAGES * TILE_BYTES);
  const uint32_t norm_u = tiles + STAGES * TILE_BYTES;
  const uint32_t full = norm_u + STAGES * NORM_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const int q_tiles = nq / QT_WS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // Producer warpgroup: one thread walks every item's db tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * WG) {
      int seq = 0;
      for (int item = blockIdx.x; item < num_items; item += gridDim.x) {
        const int dj = pj[item / q_tiles];
        const int n_tiles = (db_counts[dj] + NT - 1) / NT;
        for (int n = 0; n < n_tiles; ++n, ++seq) {
          const int s = seq % STAGES;
          mbar_wait(empty + 8 * s, ((seq / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, TILE_BYTES + NORM_BYTES);
          tma_load_2d(tiles + s * TILE_BYTES, &db_map, 0, dj * nd + n * NT,
                      full + 8 * s);
          bulk_load(norm_u + s * NORM_BYTES,
                    norms + static_cast<long long>(dj) * kp + n * NT,
                    NORM_BYTES, full + 8 * s);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / WG;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rlo = wg * 64 + ((threadIdx.x % WG) / 32) * 16 + g;
    int acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
    int seq = 0;
    for (int item = blockIdx.x; item < num_items; item += gridDim.x) {
      const int b = item / q_tiles;
      const int row = (item % q_tiles) * QT_WS + rlo;
      const int dj = pj[b];
      const int dbc = db_counts[dj];
      const int8_t* qlo = qtab + static_cast<long long>(pi[b]) * q_stride +
                          static_cast<long long>(row) * DIM + t * 4;
      const int8_t* qhi = qlo + 8 * DIM;
      // A fragments (the m16n8k32 layout per warp) and the two rows' norms.
      uint32_t a[4][4];
      int qsq_lo = 0, qsq_hi = 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = *reinterpret_cast<const uint32_t*>(qlo + kk * 32);
        a[kk][1] = *reinterpret_cast<const uint32_t*>(qhi + kk * 32);
        a[kk][2] = *reinterpret_cast<const uint32_t*>(qlo + kk * 32 + 16);
        a[kk][3] = *reinterpret_cast<const uint32_t*>(qhi + kk * 32 + 16);
        qsq_lo = dp4a_sq(a[kk][0], qsq_lo);
        qsq_lo = dp4a_sq(a[kk][2], qsq_lo);
        qsq_hi = dp4a_sq(a[kk][1], qsq_hi);
        qsq_hi = dp4a_sq(a[kk][3], qsq_hi);
      }
      qsq_lo += __shfl_xor_sync(0xffffffffu, qsq_lo, 1);
      qsq_lo += __shfl_xor_sync(0xffffffffu, qsq_lo, 2);
      qsq_hi += __shfl_xor_sync(0xffffffffu, qsq_hi, 1);
      qsq_hi += __shfl_xor_sync(0xffffffffu, qsq_hi, 2);

      const int init = TOP2 ? E_POISON : INT32_MIN;
      int e0lo = init, e1lo = init, e0hi = init, e1hi = init;
      int i0lo = 0, i0hi = 0;
      const int n_tiles = (dbc + NT - 1) / NT;

      // Tile n sits in stage (seq + n) % STAGES (run_tiles has the order of
      // products and epilogues).  Only a pair's last tile can hold rows past
      // the count.
      auto stage_of = [&](int n) { return (seq + n) % STAGES; };
      auto issue = [&](int (&acc)[64], int n) {
        mbar_wait(full + 8 * stage_of(n), ((seq + n) / STAGES) & 1);
        issue_tile(acc, a, tiles + stage_of(n) * TILE_BYTES);
      };
      auto tile_epilogue = [&](const int (&acc)[64], int n, auto last) {
        const int* cst = norm_s + stage_of(n) * NT;
        if constexpr (TOP2)
          epilogue<decltype(last)::value>(acc, cst, t, n * NT, e0lo, i0lo,
                                          e1lo, e0hi, i0hi, e1hi);
        else
          max_epilogue<decltype(last)::value>(acc, cst, t, e0lo, e0hi);
        mbar_arrive(empty + 8 * stage_of(n));
      };
      auto finish = [&](const int (&acc)[64], int n) {
        tile_epilogue(acc, n, std::false_type());
      };
      auto finish_last = [&](const int (&acc)[64], int n) {
        if (dbc % NT)
          tile_epilogue(acc, n, std::true_type());
        else
          tile_epilogue(acc, n, std::false_type());
      };

      run_tiles(n_tiles, acc0, acc1, issue, finish, finish_last);
      seq += n_tiles;

      // The four lanes of a row group hold interleaved columns: merge them.
      const long long o = static_cast<long long>(b) * nq + row;
      if constexpr (TOP2) {
        merge_lanes(e0lo, i0lo, e1lo, 1);
        merge_lanes(e0lo, i0lo, e1lo, 2);
        merge_lanes(e0hi, i0hi, e1hi, 1);
        merge_lanes(e0hi, i0hi, e1hi, 2);
        if (t == 0) {
          d0_out[o] = to_dist(qsq_lo, e0lo);
          i0_out[o] = i0lo;
          d1_out[o] = to_dist(qsq_lo, e1lo);
          d0_out[o + 8] = to_dist(qsq_hi, e0hi);
          i0_out[o + 8] = i0hi;
          d1_out[o + 8] = to_dist(qsq_hi, e1hi);
        }
      } else {
        for (int mask = 1; mask <= 2; mask *= 2) {
          e0lo = max(e0lo, __shfl_xor_sync(0xffffffffu, e0lo, mask));
          e0hi = max(e0hi, __shfl_xor_sync(0xffffffffu, e0hi, mask));
        }
        if (t == 0) {
          d0_out[o] = e0lo == INT32_MIN ? -BIG : static_cast<float>(e0lo);
          d0_out[o + 8] = e0hi == INT32_MIN ? -BIG : static_cast<float>(e0hi);
          i0_out[o] = i0_out[o + 8] = 0;
          d1_out[o] = d1_out[o + 8] = 0.f;
        }
      }
    }
  }
}

// ------------------------------------------------- f32 wgmma kernel ----

constexpr int F32_TILE_BYTES = 2 * BOX_BYTES;   // 128 bf16 rows: two boxes
// The item's query tile, then the ring, its |b|^2, and the ring's and the
// query tile's full / empty barriers.
constexpr int SMEM_F32 = 1024 + F32_TILE_BYTES +
                         STAGES * (F32_TILE_BYTES + NORM_BYTES) +
                         (2 * STAGES + 2) * 8;

// One 64x128 f32 product tile: the warpgroup's 64 bf16 query rows (the m64
// tile of the query buffer at `a_addr`) against the 128 bf16 db rows of
// ring stage `b_addr`, eight k16 steps, both from shared memory.
__device__ __forceinline__ void issue_tile_bf16(float (&d)[64], uint32_t a_addr,
                                                uint32_t b_addr) {
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t ad = desc_sw128(kstep_addr(a_addr, kk));
    const uint64_t bd = desc_sw128(kstep_addr(b_addr, kk));
    if (kk == 0) wgmma_k16_ss<0>(d, ad, bd);
    else wgmma_k16_ss<1>(d, ad, bd);
  }
  wgmma_commit();
}

// One score into a row's tile-local f32 top-2 (b0 <= b1, k0 the column of
// b0): columns arrive in increasing order, so a strict `<` keeps the lowest
// column on ties, and an equal distance becomes the runner-up.
__device__ __forceinline__ void top2f(float d, int col, float& b0, int& k0,
                                      float& b1) {
  k0 = d < b0 ? col : k0;
  b1 = fminf(b1, fmaxf(b0, d));
  b0 = fminf(b0, d);
}

// Merge the running top-2 of the lanes `lane ^ lane_mask` (on ties the
// lower column wins; afterwards both lanes hold the same entry).
__device__ __forceinline__ void top2_merge(float& b0, int& i0, float& b1,
                                           int lane_mask) {
  const float o0 = __shfl_xor_sync(0xffffffffu, b0, lane_mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i0, lane_mask);
  const float o1 = __shfl_xor_sync(0xffffffffu, b1, lane_mask);
  const bool other = (o0 < b0) || (o0 == b0 && oi < i0);
  const float n1 = other ? fminf(b0, o1) : fminf(o0, b1);
  b0 = other ? o0 : b0;
  i0 = other ? oi : i0;
  b1 = n1;
}

// Merge a tile's top-2 (b0, column col0 + k0, b1) into the running
// (e0, i0, e1); the running entry has the lower columns, so it wins ties.
__device__ __forceinline__ void merge_tile_f32(float b0, int k0, float b1,
                                               int col0, float& e0, int& i0,
                                               float& e1) {
  const bool lt = b0 < e0;
  e1 = lt ? fminf(e0, b1) : fminf(e1, b0);
  i0 = lt ? col0 + k0 : i0;
  e0 = lt ? b0 : e0;
}

// The f32 top-2 of this thread's 2 rows x 32 columns of one tile (the
// layout of `epilogue` in wgmma_ring.cuh), merged into the running state.
// d = (|q|^2 + |b|^2) - 2 q.b in the plain version's order: 2 q.b is exact,
// so one FMA rounds as the subtraction does.  With LAST, columns at or past
// `valid` (rows past the count) are 3e38.
template <bool LAST>
__device__ __forceinline__ void f32_epilogue(const float (&acc)[64],
                                             const float* bsq, int t, int col0,
                                             int valid, float qlo, float qhi,
                                             float& e0lo, int& i0lo,
                                             float& e1lo, float& e0hi,
                                             int& i0hi, float& e1hi) {
  float b0lo = BIG, b1lo = BIG, b0hi = BIG, b1hi = BIG;
  int klo = 0, khi = 0;
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    const int c = 8 * i + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(bsq + c);
    float d0 = __fmaf_rn(-2.0f, acc[4 * i], __fadd_rn(qlo, s.x));
    float d1 = __fmaf_rn(-2.0f, acc[4 * i + 1], __fadd_rn(qlo, s.y));
    float d2 = __fmaf_rn(-2.0f, acc[4 * i + 2], __fadd_rn(qhi, s.x));
    float d3 = __fmaf_rn(-2.0f, acc[4 * i + 3], __fadd_rn(qhi, s.y));
    if (LAST) {
      d0 = c < valid ? d0 : BIG;
      d2 = c < valid ? d2 : BIG;
      d1 = c + 1 < valid ? d1 : BIG;
      d3 = c + 1 < valid ? d3 : BIG;
    }
    top2f(d0, c, b0lo, klo, b1lo);
    top2f(d1, c + 1, b0lo, klo, b1lo);
    top2f(d2, c, b0hi, khi, b1hi);
    top2f(d3, c + 1, b0hi, khi, b1hi);
  }
  merge_tile_f32(b0lo, klo, b1lo, col0, e0lo, i0lo, e1lo);
  merge_tile_f32(b0hi, khi, b1hi, col0, e0hi, i0hi, e1hi);
}

// The product-only split of the f32 kernel: the row max of q.b over the
// tile's valid columns, one max a score.
template <bool LAST>
__device__ __forceinline__ void f32_max_epilogue(const float (&acc)[64], int t,
                                                 int valid, float& mlo,
                                                 float& mhi) {
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    const int c = 8 * i + 2 * t;
    float a0 = acc[4 * i], a1 = acc[4 * i + 1];
    float a2 = acc[4 * i + 2], a3 = acc[4 * i + 3];
    if (LAST) {
      a0 = c < valid ? a0 : -BIG;
      a2 = c < valid ? a2 : -BIG;
      a1 = c + 1 < valid ? a1 : -BIG;
      a3 = c + 1 < valid ? a3 : -BIG;
    }
    mlo = fmaxf(mlo, fmaxf(a0, a1));
    mhi = fmaxf(mhi, fmaxf(a2, a3));
  }
}

// f32 tables on the int8 kernel's machinery: a producer thread keeps a
// STAGES-deep TMA ring of 128-row bf16 db tiles (two 64-column boxes with
// 128-byte swizzle, from the pre-pass's bf16 copy) and their f32 |b|^2,
// and loads each item's 128 bf16 query rows into a swizzled buffer once;
// two consumer warpgroups of 64 query rows issue
// wgmma.m64n128k16.f32.bf16.bf16 with A and B from shared memory.  (A in
// registers would take 32 of the 168 registers a consumer thread is
// compiled for, beside 128 of accumulators: the f32 top-2 state then
// spills.)  The top-2 stays in f32 (packed int32 keys are exact only for
// centered int8 values).  TOP2: the exact 2-NN; else the product-only
// split (d0 = row max of q.b over the valid rows, -3e38 if none;
// i0 = d1 = 0).
template <bool TOP2>
__global__ void __launch_bounds__(WS_THREADS, 1)
two_nn_f32_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap db_map,
                     long long q_rows_per_img, const float* __restrict__ qsq,
                     int nq, int nd, const int* __restrict__ db_counts,
                     const float* __restrict__ bsq, int kp,
                     const int* __restrict__ pi, const int* __restrict__ pj,
                     int num_items, float* __restrict__ d0_out,
                     int* __restrict__ i0_out, float* __restrict__ d1_out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_buf = smem_u32(smem);
  const uint32_t tiles = q_buf + F32_TILE_BYTES;
  const float* bsq_s = reinterpret_cast<const float*>(
      smem + (STAGES + 1) * F32_TILE_BYTES);
  const uint32_t bsq_u = tiles + STAGES * F32_TILE_BYTES;
  const uint32_t full = bsq_u + STAGES * NORM_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const uint32_t qfull = empty + STAGES * 8;
  const uint32_t qempty = qfull + 8;
  const int q_tiles = nq / QT_WS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * WG);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 2 * WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // Producer warpgroup: one thread walks every item's tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * WG) {
      int seq = 0, k = 0;
      for (int item = blockIdx.x; item < num_items; item += gridDim.x, ++k) {
        const int b = item / q_tiles;
        const int dj = pj[b];
        const int n_tiles = (db_counts[dj] + NT - 1) / NT;
        auto load_tile = [&](int n) {
          const int s = seq % STAGES;
          mbar_wait(empty + 8 * s, ((seq / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, F32_TILE_BYTES + NORM_BYTES);
          for (int h = 0; h < 2; ++h)
            tma_load_2d(tiles + s * F32_TILE_BYTES + h * BOX_BYTES, &db_map,
                        h * (DIM / 2), dj * nd + n * NT, full + 8 * s);
          bulk_load(bsq_u + s * NORM_BYTES,
                    bsq + static_cast<long long>(dj) * kp + n * NT,
                    NORM_BYTES, full + 8 * s);
          ++seq;
        };
        // This item's first db tiles go into the ring while the consumers
        // finish the last item; its query tile waits for them to let go.
        int n = 0;
        for (; n < n_tiles && n < STAGES; ++n) load_tile(n);
        mbar_wait(qempty, (k & 1) ^ 1);
        mbar_expect_tx(qfull, F32_TILE_BYTES);
        const int row0 = static_cast<int>(pi[b] * q_rows_per_img) +
                         (item % q_tiles) * QT_WS;
        for (int h = 0; h < 2; ++h)
          tma_load_2d(q_buf + h * BOX_BYTES, &q_map, h * (DIM / 2), row0,
                      qfull);
        for (; n < n_tiles; ++n) load_tile(n);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / WG;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rlo = wg * 64 + ((threadIdx.x % WG) / 32) * 16 + g;
    // The warpgroup's m64 tile of the query buffer: rows 64 wg.. of each
    // 128-row box.
    const uint32_t a_addr = q_buf + wg * 64 * 128;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    int seq = 0, k = 0;
    for (int item = blockIdx.x; item < num_items; item += gridDim.x, ++k) {
      const int b = item / q_tiles;
      const int row = (item % q_tiles) * QT_WS + rlo;
      const int dj = pj[b];
      const int dbc = db_counts[dj];
      const long long qrow = static_cast<long long>(pi[b]) * nq + row;
      const float qs_lo = qsq[qrow];
      const float qs_hi = qsq[qrow + 8];

      const float init = TOP2 ? BIG : -BIG;
      float e0lo = init, e1lo = init, e0hi = init, e1hi = init;
      int i0lo = 0, i0hi = 0;
      const int n_tiles = (dbc + NT - 1) / NT;

      // Tile n sits in stage (seq + n) % STAGES.
      auto stage_of = [&](int n) { return (seq + n) % STAGES; };
      auto issue = [&](float (&acc)[64], int n) {
        mbar_wait(full + 8 * stage_of(n), ((seq + n) / STAGES) & 1);
        issue_tile_bf16(acc, a_addr, tiles + stage_of(n) * F32_TILE_BYTES);
      };
      auto tile_epilogue = [&](const float (&acc)[64], int n, auto last) {
        constexpr bool LAST = decltype(last)::value;
        const int valid = dbc - n * NT;
        if constexpr (TOP2)
          f32_epilogue<LAST>(acc, bsq_s + stage_of(n) * NT, t, n * NT, valid,
                             qs_lo, qs_hi, e0lo, i0lo, e1lo, e0hi, i0hi, e1hi);
        else
          f32_max_epilogue<LAST>(acc, t, valid, e0lo, e0hi);
        mbar_arrive(empty + 8 * stage_of(n));
      };
      auto finish = [&](const float (&acc)[64], int n) {
        tile_epilogue(acc, n, std::false_type());
      };
      auto finish_last = [&](const float (&acc)[64], int n) {
        if (dbc % NT)
          tile_epilogue(acc, n, std::true_type());
        else
          tile_epilogue(acc, n, std::false_type());
      };

      mbar_wait(qfull, k & 1);
      run_tiles(n_tiles, acc0, acc1, issue, finish, finish_last);
      mbar_arrive(qempty);     // every product of the item has retired
      seq += n_tiles;

      // The four lanes of a row group hold interleaved columns: merge them.
      const long long o = static_cast<long long>(b) * nq + row;
      if constexpr (TOP2) {
        top2_merge(e0lo, i0lo, e1lo, 1);
        top2_merge(e0lo, i0lo, e1lo, 2);
        top2_merge(e0hi, i0hi, e1hi, 1);
        top2_merge(e0hi, i0hi, e1hi, 2);
        if (t == 0) {
          d0_out[o] = e0lo;
          i0_out[o] = i0lo;
          d1_out[o] = e1lo;
          d0_out[o + 8] = e0hi;
          i0_out[o + 8] = i0hi;
          d1_out[o + 8] = e1hi;
        }
      } else {
        for (int mask = 1; mask <= 2; mask *= 2) {
          e0lo = fmaxf(e0lo, __shfl_xor_sync(0xffffffffu, e0lo, mask));
          e0hi = fmaxf(e0hi, __shfl_xor_sync(0xffffffffu, e0hi, mask));
        }
        if (t == 0) {
          d0_out[o] = e0lo;
          d0_out[o + 8] = e0hi;
          i0_out[o] = i0_out[o + 8] = 0;
          d1_out[o] = d1_out[o + 8] = 0.f;
        }
      }
    }
  }
}

// The f32 kernel's per-call pre-pass over an f32 table [n_img, nd, 128],
// eight threads a row of the table padded to kp rows: the bf16 copy (TMA
// cannot convert), |x|^2 of every row from the unrounded values (sixteen
// elements a thread in order, then a tree over the eight threads, no FMA;
// `prepass_f32_plain` repeats that order), and, with counts, |b|^2 per
// column (3e38 at or past the count and in the padding).
__global__ void __launch_bounds__(256)
f32_prepass_kernel(const float* __restrict__ tab, int n_img, int nd, int kp,
                   const int* __restrict__ counts,
                   __nv_bfloat16* __restrict__ tab16, float* __restrict__ sq,
                   float* __restrict__ bsq) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  const bool live = row < static_cast<long long>(n_img) * kp;
  const int j = live ? static_cast<int>(row / kp) : 0;
  const int r = live ? static_cast<int>(row % kp) : 0;
  const bool data = live && r < nd;
  float s = 0.f;
  if (data) {
    const long long e = (static_cast<long long>(j) * nd + r) * DIM + part * 16;
    const float4* src = reinterpret_cast<const float4*>(tab + e);
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = src[i];
      s = __fadd_rn(s, __fmul_rn(v.x, v.x));
      s = __fadd_rn(s, __fmul_rn(v.y, v.y));
      s = __fadd_rn(s, __fmul_rn(v.z, v.z));
      s = __fadd_rn(s, __fmul_rn(v.w, v.w));
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      h[2 * i] = *reinterpret_cast<uint32_t*>(&lo);
      h[2 * i + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
    uint4* d = reinterpret_cast<uint4*>(tab16 + e);
    d[0] = make_uint4(h[0], h[1], h[2], h[3]);
    d[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
  if (live && part == 0) {
    if (data) sq[static_cast<long long>(j) * nd + r] = s;
    if (bsq != nullptr) bsq[row] = data && r < counts[j] ? s : BIG;
  }
}

template <bool TOP2>
int launch_f32(const void* q16, long long q_stride, int n_img_q, int nq,
               const float* qsq, const void* db16, int n_img, int nd,
               const int* db_counts, const float* bsq, const int* pi,
               const int* pj, int num_pairs, float* d0, int* i0, float* d1,
               cudaStream_t stream) {
  if (num_pairs == 0 || nq == 0) return 0;
  if (nq % QT_WS || q_stride % DIM || q_stride < static_cast<long long>(nq) * DIM ||
      reinterpret_cast<uintptr_t>(q16) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(db16) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bsq) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long q_rows = q_stride / DIM;      // table rows per query image
  CUtensorMap q_map, map;
  if (!encode_rows(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q16, DIM,
                   static_cast<long long>(n_img_q) * q_rows, 2 * DIM, DIM / 2) ||
      !encode_rows(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, db16, DIM,
                   static_cast<long long>(n_img) * nd, 2 * DIM, DIM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[MAX_DEVICES];
  const int sms = sm_count_for(two_nn_f32_ws_kernel<TOP2>, SMEM_F32, cache);
  if (sms < 0) return -sms;
  const long long items = static_cast<long long>(num_pairs) * (nq / QT_WS);
  const int grid = static_cast<int>(items < sms ? items : sms);
  const int kp = (nd + NT - 1) / NT * NT;
  two_nn_f32_ws_kernel<TOP2><<<grid, WS_THREADS, SMEM_F32, stream>>>(
      q_map, map, q_rows, qsq, nq, nd, db_counts, bsq, kp, pi, pj,
      static_cast<int>(items), d0, i0, d1);
  return static_cast<int>(cudaGetLastError());
}

template <bool TOP2>
int launch_ws(const void* qtab, long long q_stride, int nq, const void* dbtab,
              int n_img, int nd, const int* db_counts, int* norms,
              const int* pi, const int* pj, int num_pairs, float* d0, int* i0,
              float* d1, cudaStream_t stream) {
  if (num_pairs == 0 || nq == 0) return 0;
  if (reinterpret_cast<uintptr_t>(dbtab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  if (!encode_rows(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, dbtab, DIM,
                   static_cast<long long>(n_img) * nd, DIM, DIM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = (nd + NT - 1) / NT * NT;
  if (static_cast<long long>(n_img) * kp >= PRE_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[MAX_DEVICES];
  const int sms = sm_count_for(two_nn_ws_kernel<TOP2>, SMEM_WS, cache);
  if (sms < 0) return -sms;
  const long long items = static_cast<long long>(num_pairs) * (nq / QT_WS);
  const int grid = static_cast<int>(items < sms ? items : sms);
  return launch_kernel(two_nn_ws_kernel<TOP2>, grid, WS_THREADS, SMEM_WS,
                       stream, true, map, static_cast<const int8_t*>(qtab),
                       q_stride, nq, static_cast<const int8_t*>(dbtab), n_img,
                       nd, db_counts, norms, kp, pi, pj,
                       static_cast<int>(items), d0, i0, d1);
}

}  // namespace

extern "C" {

// Centered int8 tables: qtab [*, nq, 128] with per-image element stride
// q_stride, dbtab [n_img, nd, 128] contiguous and 16-byte aligned, norms
// int32 [n_img, kp] (kp = nd rounded up to 128): scratch the kernel writes
// the column constants to itself (one launch).  nq % 128 == 0,
// db_counts[j] <= nd.  Outputs are [num_pairs, nq].  Returns a CUDA error
// code (0 on success).
int two_nn_pairs_i8(const void* qtab, long long q_stride, int nq,
                    const void* dbtab, int n_img, int nd, const int* db_counts,
                    int* norms, const int* pi, const int* pj, int num_pairs,
                    float* d0, int* i0, float* d1, void* stream) {
  return launch_ws<true>(qtab, q_stride, nq, dbtab, n_img, nd, db_counts,
                         norms, pi, pj, num_pairs, d0, i0, d1,
                         static_cast<cudaStream_t>(stream));
}

// The same kernel with the top-2 epilogue replaced by one max a score:
// d0 = max of q.b over the valid db rows (-3e38 if none), i0 = d1 = 0.
int two_nn_product_max_i8(const void* qtab, long long q_stride, int nq,
                          const void* dbtab, int n_img, int nd,
                          const int* db_counts, int* norms, const int* pi,
                          const int* pj, int num_pairs, float* d0, int* i0,
                          float* d1, void* stream) {
  return launch_ws<false>(qtab, q_stride, nq, dbtab, n_img, nd, db_counts,
                          norms, pi, pj, num_pairs, d0, i0, d1,
                          static_cast<cudaStream_t>(stream));
}

// The f32 kernel's pre-pass: tab f32 [n_img, nd, 128] contiguous and
// 16-byte aligned -> tab16 bf16 [n_img, nd, 128] and sq f32 [n_img, nd];
// with counts (else null) also bsq f32 [n_img, kp], kp = nd rounded up to
// 128.
int two_nn_prepass_f32(const void* tab, int n_img, int nd, const int* counts,
                       void* tab16, float* sq, float* bsq, void* stream) {
  if ((counts == nullptr) != (bsq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = (nd + NT - 1) / NT * NT;
  const long long threads = static_cast<long long>(n_img) * kp * 8;
  if (threads == 0) return 0;
  f32_prepass_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), n_img, nd, kp, counts,
      static_cast<__nv_bfloat16*>(tab16), sq, bsq);
  return static_cast<int>(cudaGetLastError());
}

// f32 tables on the wgmma design, from the pre-pass: q16 bf16 [n_img_q,
// *, 128] with per-image element stride q_stride (a multiple of 128) and
// qsq f32 [n_img_q, nq] (the query table's copy and |q|^2), db16 bf16
// [n_img, nd, 128] contiguous and bsq f32 [n_img, kp] (the db table's
// copy and column norms, with the same counts), all 16-byte aligned.
// nq % 128 == 0, db_counts[j] <= nd.  Outputs are [num_pairs, nq].
// Returns a CUDA error code (0 on success).
int two_nn_pairs_f32(const void* q16, long long q_stride, int n_img_q, int nq,
                     const float* qsq, const void* db16, int n_img, int nd,
                     const int* db_counts, const float* bsq, const int* pi,
                     const int* pj, int num_pairs, float* d0, int* i0,
                     float* d1, void* stream) {
  return launch_f32<true>(q16, q_stride, n_img_q, nq, qsq, db16, n_img, nd,
                          db_counts, bsq, pi, pj, num_pairs, d0, i0, d1,
                          static_cast<cudaStream_t>(stream));
}

// The same kernel with the top-2 epilogue replaced by one max a score:
// d0 = max of q.b (bf16 operands) over the valid db rows (-3e38 if none),
// i0 = d1 = 0.
int two_nn_product_max_f32(const void* q16, long long q_stride, int n_img_q,
                           int nq, const float* qsq, const void* db16,
                           int n_img, int nd, const int* db_counts,
                           const float* bsq, const int* pi, const int* pj,
                           int num_pairs, float* d0, int* i0, float* d1,
                           void* stream) {
  return launch_f32<false>(q16, q_stride, n_img_q, nq, qsq, db16, n_img, nd,
                           db_counts, bsq, pi, pj, num_pairs, d0, i0, d1,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
