// Variants of the exact 2-NN matcher for Hopper (sm_90a): the ceiling probes
// of the matcher's epilogue, batched over image pairs of one descriptor table.
//
// Replaces the three TPU kernels of benchmarks/probes/probe_pallas_variants.py,
// each vmapped over pairs by that file's `batched` (:223-238):
//
//   two_nn_oneblock        one_block_kernel(tq, int8dot)  (:62, make_oneblock
//                          :85, pallas_call :88): exact 2-NN in max form with
//                          one top-2 pass over the whole score row; query tile
//                          TQ in {128, 256, 512, 1024}; int8 or bf16 dot.
//   two_nn_blockmerge_bf16 bf16_resident_kernel (:111, make_bf16_resident
//                          :140, pallas_call :144): the same with a bf16 dot,
//                          256 query rows, the db taken in 512-row blocks whose
//                          top-2 is folded into a running top-2.
//   two_nn_ablation        ablation_kernel(mode) (:171, make_ablation :198,
//                          pallas_call :201), 128 query rows, int8 dot.  Not a
//                          matcher: "matmul_max" is the row max of f32(dot)
//                          over all db rows (no norms, no count; i0 = d1 = 0),
//                          "top1" the nearest neighbour only (d1 = 0).
//
// For pair b, the query rows are table[pi[b]] (all K of them) and the db rows
// table[pj[b]], of which the first counts[pj[b]] are valid.  The TPU kernels
// work in max form (m = f32(dot) - 0.5*|b|^2, poisoned past the count; the
// nearest row is the first argmax of m; d = |q|^2 - 2m).  Every value there
// is a half-integer below 2^23, so the exact variants equal the int32
// distances of two_nn.cu bit for bit, d1 = 3e38 and i0 = 0 where fewer than
// two db rows are valid included, and ties go to the lowest db index
// (_tile_top2; the 512-row fold keeps the running entry, _merge_top2).
//
// The design: a warp-specialised kernel (variant_ws_kernel) for every
// oneblock instantiation of both dots, blockmerge and both ablations.
//    The machinery of two_nn.cu's int8 kernel (wgmma_ring.cuh), generalised to TQ:
//    a persistent grid walks (pair, query tile of TQ rows) items; a producer
//    thread keeps a 4-stage TMA + mbarrier ring of 128-row db tiles
//    (128-byte swizzle) and their column constants full; two consumer
//    warpgroups of 64*MT query rows each (MT = TQ/128 m64 tiles, of a
//    CTA's rows in a cluster, below) issue
//    wgmma m64n128 with B read from the ring stage, so every staged db tile
//    serves all TQ query rows before it is released.  At TQ 128 each
//    warpgroup's A fragments stay in registers for the item; at TQ >= 256
//    the query tile is loaded once per item into swizzled shared memory by
//    TMA and wgmma reads A through a shared-memory descriptor, so nothing is
//    reloaded through registers per db tile.  The producer puts the next
//    item's first db tiles into the ring before it waits for the query
//    buffer to be released.  The launch's first phase writes the column
//    constants c = |b|^2*256 + row%128 (KEY_POISON past the count) and
//    |q|^2 of every table row once, into scratch the wrapper allocates
//    with the outputs, and the grid meets at a barrier (a cooperative
//    launch) before the ring starts; as in two_nn.cu, neither a separate
//    pre-pass kernel (a launch and 30-60 us of host time for 3-6 us of
//    device work) nor producer warps writing constants per staged
//    tile (a third slower at TQ 128, twice as slow with the bf16 dot, in
//    the issue slots the epilogue needs) did as well (PERF.md, section 6).
//    The epilogue is two_nn.cu's: packed (distance,
//    column) int32 keys, one IMAD and three min/max a score into a
//    tile-local top-2, merged into the running (e0, i0, e1) once per tile;
//    the epilogue of product n runs while product n+1's wgmma flies (two
//    accumulator sets; with MT > 1 the products run m-tile by m-tile, so
//    m-tile mt's epilogue overlaps m-tile mt+1's wgmma), and setmaxnreg
//    moves registers from the producer to the consumers.  Only a pair's last
//    tile can hold rows past the count; its keys of poisoned columns are
//    raised to KEY_POISON.
//    The bf16 dot: wgmma m64n128k16.f32.bf16.bf16.  The ring needs bf16 B,
//    and TMA cannot convert, so it loads a bf16 copy of the table, which
//    prepass_kernel writes once per table: the caller makes it and passes
//    it to every call on that table
//    (the probe: one launch for all its bf16 calls), else the wrapper
//    makes it per call.  It is 12.6 MB at 24 x 2048 rows, a few
//    microseconds of bytes, and stands in for the TPU kernel's in-VMEM
//    astype(bf16), probe_pallas_variants.py:71, :121.  Converting int8
//    stages into bf16 ones in the producer warpgroup instead would take
//    about half as many instructions again as the epilogue, in the issue
//    slots the epilogue needs, and its int8 landing stages do not fit
//    beside blockmerge's query tile and ring in shared memory.  At
//    TQ 128 the query fragments are converted to bf16 once per item (32
//    registers); blockmerge reads its 256 bf16 query rows (64 KB) from
//    shared memory.  The f32 accumulators hold exact integers (|q.b| <=
//    2^21, products of int8 values exact in bf16 and f32); acc_bits turns
//    one into its int32 value with one FADD, and the first phase adds the
//    matching offset to the bf16 column constants, so the key is the same.
//    Oneblock bf16 above 256 rows: a thread-block cluster.  A bf16 query
//    tile of TQ rows is TQ * 256 B, and at TQ 512 (128 KB) or 1024 (256 KB)
//    it does not fit beside a 4-stage bf16 ring (4 x 32.5 KB) in one CTA's
//    227 KB.  So a work item of TQ rows runs on a cluster of TQ/256 CTAs,
//    each the TQ-256 CTA (two consumer warpgroups of two m64 tiles, its 256
//    query rows, 64 KB, in shared memory; 199760 B a CTA), CTA r of the
//    cluster owning rows r*256 ... of the item.  The cluster shares one
//    ring: the leader (rank 0) issues every db tile and its column
//    constants with TMA multicast into the same offsets of all its CTAs,
//    so each staged tile still serves all TQ query rows and is read from
//    L2 once.  The leader issues all of a stage (two 16 KB boxes and 512 B:
//    three instructions) rather than a share from each CTA: two boxes do
//    not split among four CTAs without a second tensor map, and the
//    leader's empty barrier is then the one place that knows when every
//    CTA has let a stage go.  The others' producers only arrive with the
//    stage's bytes expected on their own full barrier, once its previous
//    phase has completed.  A consumer warp releases a stage with one
//    remote arrival on the leader's empty barrier (mapa + mbarrier.arrive
//    .shared::cluster, after __syncwarp), so its count is CL x 8 warps
//    (2 x 128 threads without a cluster); the leader refills the stage
//    only when every CTA's consumers have arrived.  Each CTA loads its own
//    query tile.  Clusters walk the items persistently, as many as
//    cudaOccupancyMaxActiveClusters says fit; the first phase and the grid
//    barrier run as for every one-launch kernel, under a launch that is
//    both cooperative and clustered; a cluster barrier at the start (no
//    copy or arrival before the barriers are initialised) and at the end
//    (no CTA leaves while a peer may still arrive on its barriers or copy
//    into its shared memory).
//    Blockmerge: TQ = 256, BD = 512.  A 512-row block does not fit in one
//    key (the column has 8 bits), so the tile-local keys fold into a block
//    state (e0, i0, e1) over four 128-row tiles, and the block state folds
//    into the running one at each 512-row boundary, ties keeping the
//    running entry; the four lanes of a row are merged once at the end.
//    The ablations are the same kernel at TQ 128 with the int8 dot and a
//    MODE template parameter beside TOP2 (the exact 2-NN): TOP1 keeps one
//    running key a row (one IMAD and one min a score, folded into (e0, i0)
//    once per tile; counts 0 and 1 give the top-2 kernels' i0 = 0 and 3e38
//    from KEY_POISON), MAX one max a score on the int32 accumulator.  MAX
//    follows the TPU kernel: the row max over all K db rows whatever the
//    count, so its producer streams every tile of the db image, no column
//    is poisoned and it needs no first phase (no constants, no |q|^2).
//    Bound on an H100: 2*128*K^2 tensor-core operations per pair (1979 TOP/s
//    int8, 989 TFLOP/s bf16).  What bounds this design is its epilogue, as
//    in two_nn.cu: 4 integer instructions a score (5 with the bf16 FADD, 2
//    for TOP1, 1 for MAX) against one m64n128k32 wgmma (64 tensor clocks)
//    per 8192 scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "wgmma_ring.cuh"

namespace {

using namespace wsk;

constexpr int DIM = 128;              // descriptor length
constexpr int BD = 512;               // db rows per block of the blockmerge fold

enum Mode { TOP2 = 0, TOP1 = 1, MAX = 2 };

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte `k` of w, sign-extended.
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  return static_cast<int>(w << (24 - 8 * k)) >> 24;
}

__device__ __forceinline__ uint32_t pack_bf16x2(int lo, int hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two int8 values as a pair of bf16.
__device__ __forceinline__ uint32_t cvt2(const unsigned char* p) {
  const signed char* s = reinterpret_cast<const signed char*>(p);
  return pack_bf16x2(s[0], s[1]);
}

// ------------------------------------------- warp-specialised design ----

constexpr int WS_THREADS = 3 * WG;   // two consumer warpgroups + a producer
constexpr int STAGES = 4;            // ring depth

template <int TQ, bool BF16_>
struct Ws {
  static constexpr bool BF16 = BF16_;
  // CTAs a work item of TQ query rows: the bf16 dot above 256 rows runs on
  // a cluster of TQ/256 CTAs of 256 rows each sharing one ring (a bf16
  // query tile of more than 256 rows does not fit beside the ring).
  static constexpr int CL = BF16 && TQ > 256 ? TQ / 256 : 1;
  static constexpr int ROWS = TQ / CL;          // query rows per CTA
  static constexpr int MT = ROWS / 128;         // m64 tiles per consumer warpgroup
  static constexpr bool A_SMEM = TQ > 128;      // else A in registers
  static constexpr int HALVES = BF16 ? 2 : 1;   // 128-byte boxes per table row
  static constexpr int KSTEPS = BF16 ? 8 : 4;   // k16 (bf16) or k32 (int8) steps
  static constexpr int A_REGS = A_SMEM ? 1 : KSTEPS;
  static constexpr int TILE_BYTES = HALVES * BOX_BYTES;          // 128 rows
  static constexpr int Q_BYTES = A_SMEM ? (ROWS / NT) * TILE_BYTES : 0;
  // Arrivals that release a ring stage: every consumer thread of the CTA,
  // or in a cluster one a consumer warp of every CTA, on the leader's.
  static constexpr int RELEASES = CL > 1 ? CL * (2 * WG / 32) : 2 * WG;
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * (TILE_BYTES + NORM_BYTES) + (2 * STAGES + 2) * 8;
  using Acc = typename std::conditional<BF16, float, int>::type;
};

// int8 x int8, A from shared memory.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_k32_ss(int (&d)[64], uint64_t a_desc,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WSK_ACC
      ", %64, %65, p;\n}\n"
      : WSK_D64(WSK_R)
      : "l"(a_desc), "l"(b_desc), "r"(SCALE_D));
}

// One 64x128 product: A (registers, or the m64 tile at a_base) against the
// 128 db rows of the ring stage at b_base, accumulated over the row.
template <class C>
__device__ __forceinline__ void issue_product(typename C::Acc (&d)[64],
                                              const uint32_t (&a)[C::A_REGS][4],
                                              uint32_t a_base, uint32_t b_base) {
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    const uint64_t bd = desc_sw128(kstep_addr(b_base, kk));
    if constexpr (C::A_SMEM) {
      const uint64_t ad = desc_sw128(kstep_addr(a_base, kk));
      if constexpr (C::BF16) {
        if (kk == 0) wgmma_k16_ss<0>(d, ad, bd);
        else wgmma_k16_ss<1>(d, ad, bd);
      } else {
        if (kk == 0) wgmma_k32_ss<0>(d, ad, bd);
        else wgmma_k32_ss<1>(d, ad, bd);
      }
    } else if constexpr (C::BF16) {
      if (kk == 0) wgmma_k16_rs<0>(d, a[kk], bd);
      else wgmma_k16_rs<1>(d, a[kk], bd);
    } else {
      if (kk == 0) wgmma_k32<0>(d, a[kk], bd);
      else wgmma_k32<1>(d, a[kk], bd);
    }
  }
  wgmma_commit();
}

// A fragments of rows `row` and `row` + 8 (a warp's 16-row slice; `row`
// points at row g of it), lane t: int8 as stored (m16n8k32 layout) or
// converted to bf16 pairs (m16n8k16 layout).
template <class C>
__device__ __forceinline__ void load_a(uint32_t (&a)[C::A_REGS][4],
                                       const int8_t* row, int t) {
  const unsigned char* lo = reinterpret_cast<const unsigned char*>(row);
  const unsigned char* hi = lo + 8 * DIM;
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    if constexpr (C::BF16) {
      const int c = kk * 16 + 2 * t;
      a[kk][0] = cvt2(lo + c);
      a[kk][1] = cvt2(hi + c);
      a[kk][2] = cvt2(lo + c + 8);
      a[kk][3] = cvt2(hi + c + 8);
    } else {
      const int c = kk * 32 + 4 * t;
      a[kk][0] = ld32(lo + c);
      a[kk][1] = ld32(hi + c);
      a[kk][2] = ld32(lo + c + 16);
      a[kk][3] = ld32(hi + c + 16);
    }
  }
}

// Fold a 512-row block's top-2 into the running one (_merge_top2 in min
// form): ties keep the running entry, whose columns are lower.
__device__ __forceinline__ void fold_running(int& e0, int& i0, int& e1, int f0,
                                             int fi, int f1) {
  const bool lt = f0 < e0;
  e1 = lt ? min(e0, f1) : min(e1, f0);
  i0 = lt ? fi : i0;
  e0 = lt ? f0 : e0;
}

// The "top1" ablation's epilogue: the tile-local smallest key of this
// thread's 2 rows x 32 columns (one IMAD and one min a score), merged into
// the running (e0, i0); ties keep the running entry.  With LAST, the keys
// of poisoned columns are raised to KEY_POISON, as in `epilogue`.
template <bool LAST>
__device__ __forceinline__ void top1_epilogue(const int (&acc)[64],
                                              const int* cst, int t, int col0,
                                              int& e0lo, int& i0lo, int& e0hi,
                                              int& i0hi) {
  int blo = KEY_POISON, bhi = KEY_POISON;
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    const int2 c = *reinterpret_cast<const int2*>(cst + 8 * i + 2 * t);
    int k0 = key(c.x, acc[4 * i]);
    int k1 = key(c.y, acc[4 * i + 1]);
    int k2 = key(c.x, acc[4 * i + 2]);
    int k3 = key(c.y, acc[4 * i + 3]);
    if (LAST) {
      const int fx = c.x == KEY_POISON ? KEY_POISON : INT32_MIN;
      const int fy = c.y == KEY_POISON ? KEY_POISON : INT32_MIN;
      k0 = max(k0, fx);
      k1 = max(k1, fy);
      k2 = max(k2, fx);
      k3 = max(k3, fy);
    }
    blo = min(blo, min(k0, k1));
    bhi = min(bhi, min(k2, k3));
  }
  if ((blo >> 8) < e0lo) {
    e0lo = blo >> 8;
    i0lo = col0 + (blo & 255);
  }
  if ((bhi >> 8) < e0hi) {
    e0hi = bhi >> 8;
    i0hi = col0 + (bhi & 255);
  }
}

// The "matmul_max" ablation's epilogue: the row max of q.b over the tile,
// one max a score on the int32 accumulators.  No column is poisoned: the
// TPU kernel takes the max over all K db rows, whatever the count.
__device__ __forceinline__ void max_epilogue(const int (&acc)[64], int& mlo,
                                             int& mhi) {
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    mlo = max(mlo, max(acc[4 * i], acc[4 * i + 1]));
    mhi = max(mhi, max(acc[4 * i + 2], acc[4 * i + 3]));
  }
}

template <int N, class T>
__device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (N == 0) return a;
  else return b;
}

template <class F, int... I>
__device__ __forceinline__ void static_for_impl(F&& f,
                                                std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>()), ...);
}

template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>());
}

// The grid barrier's counter (grid_barrier in wgmma_ring.cuh).
__device__ unsigned int grid_arrived;

// MODE TOP2: the exact 2-NN (oneblock, blockmerge).  TOP1 and MAX, at
// TQ 128 with the int8 dot only: the ablations "top1" (d0, i0 of the
// nearest valid row, d1 = 0) and "matmul_max" (d0 = row max of q.b over all
// K db rows, i0 = d1 = 0; the producer streams every tile of the db image
// and no column constants).  The launch writes the column constants and
// |q|^2 into `norms` and `qsq` itself in a pre-phase over the table, then
// meets at a grid barrier (a cooperative launch).  MAX reads neither.
template <int TQ, bool BF16, bool MERGE, int MODE>
__global__ void __launch_bounds__(WS_THREADS, 1)
variant_ws_kernel(const __grid_constant__ CUtensorMap map,
                  const int8_t* __restrict__ table, int n_img, int K,
                  const int* __restrict__ counts, int* __restrict__ norms,
                  int* __restrict__ qsq, const int* __restrict__ pi,
                  const int* __restrict__ pj, int num_items,
                  float* __restrict__ d0_out, int* __restrict__ i0_out,
                  float* __restrict__ d1_out) {
  if constexpr (MODE != MAX) {
    table_constants(table, n_img, K, K, counts, BF16 ? F32_MAGIC_BIAS : 0,
                    norms, qsq);
    fence_proxy_async_global();
    grid_barrier(&grid_arrived);
    fence_proxy_async_global();
  }
  using C = Ws<TQ, BF16>;
  using Acc = typename C::Acc;
  constexpr int MT = C::MT;
  constexpr int CL = C::CL;
  // Clusters of CL consecutive blocks walk the items; CTA `rank` of a
  // cluster owns query rows rank*ROWS ... of each (CL 1: a block an item).
  const int rank = blockIdx.x % CL;
  const int first_item = blockIdx.x / CL;
  const int item_step = gridDim.x / CL;
  static_assert(MODE == TOP2 || (TQ == 128 && !BF16 && !MERGE),
                "the ablations run at TQ 128 with the int8 dot");
  // Column constants travel with each db tile except for MAX.
  constexpr int CST_BYTES = MODE == MAX ? 0 : NORM_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_buf = smem_u32(smem);          // the item's query tile
  const uint32_t tiles = q_buf + C::Q_BYTES;      // the ring of db tiles
  const int* norm_s =
      reinterpret_cast<const int*>(smem + C::Q_BYTES + STAGES * C::TILE_BYTES);
  const uint32_t norm_u = tiles + STAGES * C::TILE_BYTES;
  const uint32_t full = norm_u + STAGES * NORM_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const uint32_t qfull = empty + STAGES * 8;
  const uint32_t qempty = qfull + 8;
  const int q_tiles = K / TQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C::RELEASES);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 2 * WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL > 1)
    cluster_sync();   // no peer copies into or arrives on a barrier before
  else                // it is initialised
    __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // Producer warpgroup: one thread walks every item's tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * WG) {
      int seq = 0, k = 0;
      for (int item = first_item; item < num_items; item += item_step, ++k) {
        const int b = item / q_tiles;
        const int dj = pj[b];
        const int n_tiles =
            MODE == MAX ? K / NT : (counts[dj] + NT - 1) / NT;
        auto load_tile = [&](int n) {
          const int s = seq % STAGES;
          const uint32_t prev = ((seq / STAGES) & 1) ^ 1;   // the last phase
          if constexpr (CL == 1) {
            mbar_wait(empty + 8 * s, prev);
            mbar_expect_tx(full + 8 * s, C::TILE_BYTES + CST_BYTES);
            for (int h = 0; h < C::HALVES; ++h)
              tma_load_2d(tiles + s * C::TILE_BYTES + h * BOX_BYTES, &map,
                          h * (DIM / C::HALVES), dj * K + n * NT, full + 8 * s);
            if constexpr (MODE != MAX)
              bulk_load(norm_u + s * NORM_BYTES,
                        norms + static_cast<long long>(dj) * K + n * NT,
                        NORM_BYTES, full + 8 * s);
          } else if (rank == 0) {
            // The leader refills a stage once every CTA's consumers have
            // let it go, and multicasts the tile and its constants into
            // every CTA of the cluster.
            constexpr uint16_t ALL = (1u << CL) - 1;
            mbar_wait(empty + 8 * s, prev);
            mbar_expect_tx(full + 8 * s, C::TILE_BYTES + CST_BYTES);
            for (int h = 0; h < C::HALVES; ++h)
              tma_load_2d_multicast(tiles + s * C::TILE_BYTES + h * BOX_BYTES,
                                    &map, h * (DIM / C::HALVES),
                                    dj * K + n * NT, full + 8 * s, ALL);
            bulk_load_multicast(norm_u + s * NORM_BYTES,
                                norms + static_cast<long long>(dj) * K + n * NT,
                                NORM_BYTES, full + 8 * s, ALL);
          } else {
            // The others expect the whole stage on their own full barrier
            // once its last phase has completed (the leader's bytes may
            // land before or after this arrival).
            mbar_wait(full + 8 * s, prev);
            mbar_expect_tx(full + 8 * s, C::TILE_BYTES + CST_BYTES);
          }
          ++seq;
        };
        int n = 0;
        if constexpr (C::A_SMEM) {
          // This item's first db tiles go into the ring while the consumers
          // finish the last item; its query tile waits for them to let go.
          for (; n < n_tiles && n < STAGES; ++n) load_tile(n);
          mbar_wait(qempty, (k & 1) ^ 1);
          mbar_expect_tx(qfull, C::Q_BYTES);
          const int row0 = pi[b] * K + (item % q_tiles) * TQ + rank * C::ROWS;
          for (int rb = 0; rb < C::ROWS / NT; ++rb)
            for (int h = 0; h < C::HALVES; ++h)
              tma_load_2d(q_buf + rb * C::TILE_BYTES + h * BOX_BYTES, &map,
                          h * (DIM / C::HALVES), row0 + rb * NT, qfull);
        }
        for (; n < n_tiles; ++n) load_tile(n);
      }
    }
  } else {
    // Consumer warpgroups: 64 * MT query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / WG;
    const int warp = (threadIdx.x % WG) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    Acc acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
    uint32_t a[C::A_REGS][4];
    int seq = 0, k = 0;
    for (int item = first_item; item < num_items; item += item_step, ++k) {
      const int b = item / q_tiles;
      const int q0 = (item % q_tiles) * TQ + rank * C::ROWS;   // CTA's rows
      const int qi = pi[b];
      const int dj = pj[b];
      const int n_tiles =
          MODE == MAX ? K / NT : (counts[dj] + NT - 1) / NT;
      if constexpr (C::A_SMEM)
        mbar_wait(qfull, k & 1);
      else
        load_a<C>(a, table + (static_cast<long long>(qi) * K + q0 + wg * 64 +
                              warp * 16 + g) * DIM, t);

      // Running (e0, i0, e1) of rows g and g + 8 of each m-tile (MAX: the
      // running max in e0); with MERGE also the 512-row block's.
      int e0[MT][2], i0[MT][2], e1[MT][2];
      int f0[MT][2], fi[MT][2], f1[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          e0[mt][h] = e1[mt][h] = f0[mt][h] = f1[mt][h] = E_POISON;
          i0[mt][h] = fi[mt][h] = 0;
          if constexpr (MODE == MAX) e0[mt][h] = INT32_MIN;
        }
      }

      // Product (n, mt) is db tile n (ring stage (seq + n) % STAGES) against
      // m-tile mt.  Products run in (n, mt) order with two accumulator sets:
      // the next product is issued before this one's epilogue and waited for
      // after it, so every wgmma group is retired inside the step that
      // issued it (ptxas serialises groups in flight across a loop's back
      // edge).  The ring stage goes back to the producer after the epilogue
      // of its last m-tile.
      auto stage_of = [&](int n) { return (seq + n) % STAGES; };
      auto issue = [&](Acc (&acc)[64], int n, int mt) {
        if (mt == 0)
          mbar_wait(full + 8 * stage_of(n), ((seq + n) / STAGES) & 1);
        const int gm = wg * MT + mt;
        issue_product<C>(acc, a, q_buf + (gm / 2) * C::TILE_BYTES + (gm % 2) * 8192,
                         tiles + stage_of(n) * C::TILE_BYTES);
      };
      auto finish = [&](const Acc (&acc)[64], int n, auto mtc, auto lastc) {
        constexpr int mt = decltype(mtc)::value;
        [[maybe_unused]] constexpr bool LAST = decltype(lastc)::value;
        const int* cst = norm_s + stage_of(n) * NT;
        if constexpr (MODE == MAX) {
          max_epilogue(acc, e0[mt][0], e0[mt][1]);
        } else if constexpr (MODE == TOP1) {
          top1_epilogue<LAST>(acc, cst, t, n * NT, e0[mt][0], i0[mt][0],
                              e0[mt][1], i0[mt][1]);
        } else if constexpr (MERGE) {
          epilogue<LAST>(acc, cst, t, n * NT, f0[mt][0], fi[mt][0], f1[mt][0],
                         f0[mt][1], fi[mt][1], f1[mt][1]);
          if (LAST || n % (BD / NT) == BD / NT - 1) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              fold_running(e0[mt][h], i0[mt][h], e1[mt][h], f0[mt][h],
                           fi[mt][h], f1[mt][h]);
              f0[mt][h] = f1[mt][h] = E_POISON;
              fi[mt][h] = 0;
            }
          }
        } else {
          epilogue<LAST>(acc, cst, t, n * NT, e0[mt][0], i0[mt][0], e1[mt][0],
                         e0[mt][1], i0[mt][1], e1[mt][1]);
        }
        if constexpr (mt == MT - 1) {
          if constexpr (CL == 1) {
            mbar_arrive(empty + 8 * stage_of(n));
          } else {
            __syncwarp();   // the warp's reads of the stage are done
            if (lane == 0) mbar_arrive_cluster(empty + 8 * stage_of(n), 0);
          }
        }
      };
      using M0 = std::integral_constant<int, 0>;
      using Body = std::false_type;
      using Last = std::true_type;

      if constexpr (MT == 1) {
        run_tiles(
            n_tiles, acc0, acc1,
            [&](Acc (&acc)[64], int n) { issue(acc, n, 0); },
            [&](const Acc (&acc)[64], int n) { finish(acc, n, M0(), Body()); },
            [&](const Acc (&acc)[64], int n) { finish(acc, n, M0(), Last()); });
      } else if (n_tiles > 0) {
        issue(acc0, 0, 0);
        wgmma_wait<0>(acc0);
        // MT is even: m-tile mt's product is in acc0 for even mt.
        int n = 0;
        for (; n + 1 < n_tiles; ++n) {
          static_for<MT>([&](auto mtc) {
            constexpr int mt = decltype(mtc)::value;
            auto& cur = pick<mt % 2>(acc0, acc1);
            auto& nxt = pick<(mt + 1) % 2>(acc0, acc1);
            if constexpr (mt + 1 < MT)
              issue(nxt, n, mt + 1);
            else
              issue(nxt, n + 1, 0);
            finish(cur, n, mtc, Body());
            wgmma_wait<0>(nxt);
          });
        }
        static_for<MT>([&](auto mtc) {   // the pair's last db tile
          constexpr int mt = decltype(mtc)::value;
          auto& cur = pick<mt % 2>(acc0, acc1);
          auto& nxt = pick<(mt + 1) % 2>(acc0, acc1);
          if constexpr (mt + 1 < MT) {
            issue(nxt, n, mt + 1);
            finish(cur, n, mtc, Last());
            wgmma_wait<0>(nxt);
          } else {
            finish(cur, n, mtc, Last());
          }
        });
      }
      if constexpr (C::A_SMEM) mbar_arrive(qempty);
      seq += n_tiles;

      // The four lanes of a row group hold interleaved columns: merge them.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int mask = 1; mask <= 2; mask *= 2) {
            if constexpr (MODE == MAX) {
              e0[mt][h] = max(e0[mt][h],
                              __shfl_xor_sync(0xffffffffu, e0[mt][h], mask));
            } else if constexpr (MODE == TOP1) {
              // Ties go to the lower index; e1 stays E_POISON.
              const int o0 = __shfl_xor_sync(0xffffffffu, e0[mt][h], mask);
              const int oi = __shfl_xor_sync(0xffffffffu, i0[mt][h], mask);
              if (o0 < e0[mt][h] || (o0 == e0[mt][h] && oi < i0[mt][h])) {
                e0[mt][h] = o0;
                i0[mt][h] = oi;
              }
            } else {
              wsk::merge_lanes(e0[mt][h], i0[mt][h], e1[mt][h], mask);
            }
          }
          if (t == 0) {
            const int row = q0 + (wg * MT + mt) * 64 + warp * 16 + g + 8 * h;
            const long long o = static_cast<long long>(b) * K + row;
            if constexpr (MODE == MAX) {
              d0_out[o] = static_cast<float>(e0[mt][h]);
              i0_out[o] = 0;
              d1_out[o] = 0.0f;
            } else {
              const int qs = qsq[static_cast<long long>(qi) * K + row];
              d0_out[o] = to_dist(qs, e0[mt][h]);
              i0_out[o] = i0[mt][h];
              d1_out[o] = MODE == TOP2 ? to_dist(qs, e1[mt][h]) : 0.0f;
            }
          }
        }
      }
    }
  }
  // No CTA leaves while a peer may still arrive on its barriers (the
  // leader's) or copy into its shared memory (the others').
  if constexpr (CL > 1) cluster_sync();
}

// The warp-specialised design's pre-pass: the table as bf16 (what the bf16
// dot's ring loads: TMA cannot convert), eight threads a row.
__global__ void __launch_bounds__(256)
prepass_kernel(const int8_t* __restrict__ tab, long long rows,
               __nv_bfloat16* __restrict__ tab16) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  if (row >= rows) return;
  const uint4 v = *reinterpret_cast<const uint4*>(tab + row * DIM + part * 16);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[2 * i] = pack_bf16x2(sbyte(w[i], 0), sbyte(w[i], 1));
    h[2 * i + 1] = pack_bf16x2(sbyte(w[i], 2), sbyte(w[i], 3));
  }
  uint4* d = reinterpret_cast<uint4*>(tab16 + row * DIM + part * 16);
  d[0] = make_uint4(h[0], h[1], h[2], h[3]);
  d[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

struct WsArgs {
  const void* table;     // int8 [n_img, K, 128]
  const void* tab16;     // its bf16 copy (bf16 dot), else unused
  int n_img;
  int K;
  const int* counts;
  int* norms;            // [n_img, K]: scratch the kernel fills itself
  int* qsq;              // [n_img, K]
  const int* pi;
  const int* pj;
  int num_pairs;
  float* d0;
  int* i0;
  float* d1;
  cudaStream_t stream;
};

// The work items an instantiation's grid takes at once: one block an SM
// (one fits, at 227 KB of shared memory), or with clusters the clusters
// that can be resident together.  Minus the CUDA error on failure.
template <int TQ, bool BF16, bool MERGE, int MODE>
int resident_ws() {
  using C = Ws<TQ, BF16>;
  static std::atomic<int> cache[MAX_DEVICES];
  return resident_for(variant_ws_kernel<TQ, BF16, MERGE, MODE>, C::SMEM,
                      C::CL, WS_THREADS, cache);
}

template <int TQ, bool BF16, bool MERGE, int MODE = TOP2>
int launch_ws(const WsArgs& x) {
  using C = Ws<TQ, BF16>;
  if (x.K <= 0 || x.K % TQ || (MERGE && x.K % BD))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x.num_pairs == 0) return 0;
  const void* base = BF16 ? x.tab16 : x.table;
  if (base == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  if (!encode_rows(&map,
                   BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   base, DIM, static_cast<long long>(x.n_img) * x.K,
                   BF16 ? 2 * DIM : DIM, DIM / C::HALVES))
    return static_cast<int>(cudaErrorInvalidValue);
  if (MODE != MAX && (x.norms == nullptr || x.qsq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (MODE != MAX && static_cast<long long>(x.n_img) * x.K >= PRE_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = resident_ws<TQ, BF16, MERGE, MODE>();
  if (slots < 0) return -slots;
  const long long items = static_cast<long long>(x.num_pairs) * (x.K / TQ);
  const int grid = static_cast<int>(items < slots ? items : slots) * C::CL;
  return launch_kernel_cluster(
      variant_ws_kernel<TQ, BF16, MERGE, MODE>, grid, C::CL, WS_THREADS,
      C::SMEM, x.stream, MODE != MAX, map,
      static_cast<const int8_t*>(x.table), x.n_img, x.K, x.counts, x.norms,
      x.qsq, x.pi, x.pj, static_cast<int>(items), x.d0, x.i0, x.d1);
}

template <bool BF16>
int launch_oneblock_ws(const WsArgs& x, int tq) {
  switch (tq) {
    case 128: return launch_ws<128, BF16, false>(x);
    case 256: return launch_ws<256, BF16, false>(x);
    case 512: return launch_ws<512, BF16, false>(x);
    case 1024: return launch_ws<1024, BF16, false>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int TQ, bool BF16>
int layout_ws(int* out) {
  using C = Ws<TQ, BF16>;
  const int slots = resident_ws<TQ, BF16, false, TOP2>();
  out[0] = C::CL;
  out[1] = C::SMEM;
  out[2] = slots;
  return slots < 0 ? -slots : 0;
}

template <bool BF16>
int layout_oneblock(int tq, int* out) {
  switch (tq) {
    case 128: return layout_ws<128, BF16>(out);
    case 256: return layout_ws<256, BF16>(out);
    case 512: return layout_ws<512, BF16>(out);
    case 1024: return layout_ws<1024, BF16>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The table is contiguous [n_img, K, 128] centered int8; counts [n_img],
// pi / pj [num_pairs] int32, all on the device, indices in range and
// counts <= K (the wrapper checks).  Outputs are [num_pairs, K].  Each entry
// point returns the CUDA error code of the launch (0 on success), or
// cudaErrorInvalidValue for a shape or parameter it does not take.

// The warp-specialised design's pre-pass: tab16, the table as bf16
// [n_img, K, 128].  K % 128 == 0.
int two_nn_variants_bf16_table(const void* table, int n_img, int K,
                                void* tab16, void* stream) {
  if (K <= 0 || K % NT) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_img) * K;
  if (rows == 0) return 0;
  prepass_kernel<<<static_cast<unsigned>((rows * 8 + 255) / 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(table), rows,
      static_cast<__nv_bfloat16*>(tab16));
  return static_cast<int>(cudaGetLastError());
}

// Exact 2-NN on the warp-specialised design: int8 or bf16 dot at tq in
// {128, 256, 512, 1024}, K % tq == 0 (bf16 at 512 and 1024 on clusters of
// 2 and 4 CTAs).  norms and qsq int32 [n_img, K]: scratch the kernel
// writes the column constants and |q|^2 to itself (one launch).  The bf16
// dot's ring loads tab16, the table as bf16 (two_nn_variants_bf16_table).
int two_nn_oneblock(const void* table, const void* tab16, int n_img, int K,
                    const int* counts, int* norms, int* qsq, const int* pi,
                    const int* pj, int num_pairs, int tq, int bf16, float* d0,
                    int* i0, float* d1, void* stream) {
  const WsArgs x{table, tab16, n_img, K, counts, norms, qsq,
                 pi, pj, num_pairs, d0, i0, d1,
                 static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_oneblock_ws<true>(x, tq)
              : launch_oneblock_ws<false>(x, tq);
}

// How the one-launch oneblock instantiation at (tq, bf16) is laid out:
// out[0] CTAs a cluster, out[1] dynamic shared memory a CTA in bytes,
// out[2] the clusters (CTAs, without clusters) resident at once on the
// current device.  Returns the CUDA error of the query, or
// cudaErrorInvalidValue for a tq it does not take.
int two_nn_oneblock_layout(int tq, int bf16, int* out) {
  return bf16 ? layout_oneblock<true>(tq, out) : layout_oneblock<false>(tq, out);
}

// Exact 2-NN, bf16 dot, 256 query rows, 512-row db blocks; K % 512 == 0;
// the other arguments as for two_nn_oneblock's bf16 dot.
int two_nn_blockmerge_bf16(const void* table, const void* tab16, int n_img,
                           int K, const int* counts, int* norms, int* qsq,
                           const int* pi, const int* pj, int num_pairs,
                           float* d0, int* i0, float* d1, void* stream) {
  const WsArgs x{table, tab16, n_img, K, counts, norms, qsq,
                 pi, pj, num_pairs, d0, i0, d1,
                 static_cast<cudaStream_t>(stream)};
  return launch_ws<256, true, true>(x);
}

// Epilogue ablations on the warp-specialised design, int8 dot, 128 query
// rows; K % 128 == 0; the arguments of two_nn_oneblock (tab16 unused).
// mode 0: "matmul_max" (norms and qsq unused), mode 1: "top1".
int two_nn_ablation(const void* table, const void* tab16, int n_img, int K,
                    const int* counts, int* norms, int* qsq, const int* pi,
                    const int* pj, int num_pairs, int mode, float* d0, int* i0,
                    float* d1, void* stream) {
  const WsArgs x{table, tab16, n_img, K, counts, norms, qsq,
                 pi, pj, num_pairs, d0, i0, d1,
                 static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case 0: return launch_ws<128, false, false, MAX>(x);
    case 1: return launch_ws<128, false, false, TOP1>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
