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
// table[pj[b]], of which the first counts[pj[b]] are valid.  Max form: with
// bsq = |b|^2, poisoned to 3e38 for rows at or past the count, the score is
// m = f32(dot) - 0.5*bsq, the nearest row is the first argmax of m, and the
// distances are d = |q|^2 - 2m, taken once per query row at the end.  Every
// value is a half-integer below 2^23 (products <= 128^2, dot sums < 2^24, the
// bf16 products of int8 values exact in f32), so the exact variants are
// bit-identical to two_nn.cu's int32 distances, d1 = 3e38 and i0 = 0 where
// fewer than two db rows are valid included: a poisoned score is -1.5e38 for
// every dot, and |q|^2 + 3e38 rounds to 3e38.
//
// Ties go to the lowest db index, as _tile_top2 takes them: each lane sees its
// columns in increasing order and replaces its best only on a strictly larger
// score (an equal one becomes the runner-up); lanes are merged on (score,
// index).  The 512-row fold keeps the running entry on ties (_merge_top2).
//
// What TQ means here.  On the TPU, TQ rows of queries meet the whole db in one
// [TQ, K] f32 score tile in VMEM.  Here no score tile exists in memory (128 x
// 2048 x 4 B = 1 MB would not fit in 227 KB of shared memory): scores live in
// mma accumulators and are folded into per-row registers at once.  TQ is the
// number of query rows that share one 64-row db tile staged in shared memory,
// i.e. how often a db row is reloaded from L2 (K/TQ times per pair).
//
// Where the query rows live.  A 16-row m-tile costs 16 registers per thread
// of A fragments with the int8 dot (32 with bf16).  At TQ = 1024, holding all
// of them in registers would take 32 warps with 2 m-tiles each, inside 64
// registers per thread, which leaves no room for the bf16 fragments (64
// registers) and the six registers of top-2 state per m-tile.  So the block
// has 8 warps at every TQ, the query tile is staged once in shared memory as
// int8 (TQ x 144 B, 147 KB at TQ = 1024), and each warp owns TQ/128 m-tiles
// whose top-2 state stays in registers; a warp reloads an m-tile's A
// fragments from shared memory once per db tile (16 loads per 32 mma with
// int8) and converts int8 to bf16 there for the bf16 dot.  At TQ = 128 the
// one m-tile's fragments are loaded once and stay in registers.
//
// Bound on an H100: 2*128*K^2 int8 tensor-core operations per pair (1979 TOP/s
// dense; bf16 at 989 TFLOP/s), the table read once and 12 B per query row
// written once (bytes are ~1 % of the time).  The epilogue is the other wall:
// every one of the K^2 scores per pair costs a convert, a subtract, a compare
// and three selects on the CUDA cores (~2 ms at 2208 pairs x 2048^2 at perfect
// issue, against 1.2 ms of int8 tensor-core time).  The design keeps the
// epilogue branch-free with the poison in the norm (no validity test per
// score), skips db tiles past the count (all-poisoned tiles cannot change the
// result), and merges lanes once per row.  The ablations remove pieces of that
// epilogue to measure them.  mma.sync, not wgmma or TMA: those come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DIM = 128;              // descriptor length
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DT = 64;                // db rows per staged shared-memory tile
constexpr int BD = 512;               // db rows per block of the blockmerge fold
constexpr int Q_ROW = DIM + 16;       // staged int8 query row (+16: conflict-free)
constexpr float BIG = 3.0e38f;
constexpr float HALF_POISON = 0.5f * BIG;

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

// int8 operands, int32 accumulators: mma.sync.m16n8k32.
struct I8Dot {
  using acc = int;
  static constexpr int KSTEPS = DIM / 32;
  static constexpr int DB_ROW = DIM + 16;        // staged db row, bytes

  // A fragments of k-step kk for rows g and g + 8 of the m-tile at `row_g`.
  __device__ static void load_a(uint32_t a[4], const unsigned char* row_g,
                                int kk, int t) {
    const unsigned char* p0 = row_g + kk * 32 + t * 4;
    const unsigned char* p1 = p0 + 8 * Q_ROW;
    a[0] = ld32(p0);
    a[1] = ld32(p1);
    a[2] = ld32(p0 + 16);
    a[3] = ld32(p1 + 16);
  }
  // Thread's 32 int8 of a db row (words w[0..7]) into the staged row.
  __device__ static void stage(const uint32_t w[8], unsigned char* row, int c) {
    uint4* d = reinterpret_cast<uint4*>(row + c * 32);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  // B fragments of k-step kk; `brow` = staged row g of the n-tile + t*4 bytes.
  __device__ static void load_b(uint32_t& b0, uint32_t& b1,
                                const unsigned char* brow, int kk) {
    b0 = ld32(brow + kk * 32);
    b1 = ld32(brow + kk * 32 + 16);
  }
  __device__ static void mma(int c[4], const uint32_t a[4], uint32_t b0,
                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static float to_f32(int c) { return __int2float_rn(c); }
};

// The int8 values as bf16 operands, f32 accumulators: mma.sync.m16n8k16.
struct Bf16Dot {
  using acc = float;
  static constexpr int KSTEPS = DIM / 16;
  static constexpr int DB_ROW = 2 * DIM + 16;    // staged as bf16

  __device__ static uint32_t cvt2(const unsigned char* p) {
    const signed char* s = reinterpret_cast<const signed char*>(p);
    return pack_bf16x2(s[0], s[1]);
  }
  __device__ static void load_a(uint32_t a[4], const unsigned char* row_g,
                                int kk, int t) {
    const unsigned char* p0 = row_g + kk * 16 + t * 2;
    const unsigned char* p1 = p0 + 8 * Q_ROW;
    a[0] = cvt2(p0);
    a[1] = cvt2(p1);
    a[2] = cvt2(p0 + 8);
    a[3] = cvt2(p1 + 8);
  }
  __device__ static void stage(const uint32_t w[8], unsigned char* row, int c) {
    uint32_t h[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[2 * i] = pack_bf16x2(sbyte(w[i], 0), sbyte(w[i], 1));
      h[2 * i + 1] = pack_bf16x2(sbyte(w[i], 2), sbyte(w[i], 3));
    }
    uint4* d = reinterpret_cast<uint4*>(row + c * 64);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_uint4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
  __device__ static void load_b(uint32_t& b0, uint32_t& b1,
                                const unsigned char* brow, int kk) {
    b0 = ld32(brow + kk * 32);
    b1 = ld32(brow + kk * 32 + 16);
  }
  __device__ static void mma(float c[4], const uint32_t a[4], uint32_t b0,
                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static float to_f32(float c) { return c; }
};

// Thread `tid` loads 32 int8 (row tid/4, chunk tid%4) as 8 words and returns
// the squared norm of the whole row (summed over the row's 4 lanes).
__device__ __forceinline__ int load_chunk(const int8_t* row_src, int c,
                                          uint32_t w[8]) {
  const uint4* s = reinterpret_cast<const uint4*>(row_src + c * 32);
  const uint4 v0 = s[0], v1 = s[1];
  w[0] = v0.x; w[1] = v0.y; w[2] = v0.z; w[3] = v0.w;
  w[4] = v1.x; w[5] = v1.y; w[6] = v1.z; w[7] = v1.w;
  int acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc = __dp4a(static_cast<int>(w[i]), static_cast<int>(w[i]), acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// Running top-2 of one query row on one lane, in max form.
struct Top2 {
  float b0, b1;
  int i0;
  __device__ void reset() { b0 = -BIG; b1 = -BIG; i0 = 0; }
};

template <int MODE>
__device__ __forceinline__ void consider(Top2& s, float m, int col) {
  if (MODE == MAX) {
    s.b0 = fmaxf(s.b0, m);
  } else {
    const bool gt = m > s.b0;
    if (MODE == TOP2) s.b1 = gt ? s.b0 : fmaxf(s.b1, m);
    s.i0 = gt ? col : s.i0;
    s.b0 = gt ? m : s.b0;
  }
}

// Merge the top-2 of the lanes `lane ^ mask` (on ties the lower index wins;
// afterwards both lanes hold the same entry).
__device__ __forceinline__ void merge_lanes(Top2& s, int mask) {
  const float o0 = __shfl_xor_sync(0xffffffffu, s.b0, mask);
  const int oi = __shfl_xor_sync(0xffffffffu, s.i0, mask);
  const float o1 = __shfl_xor_sync(0xffffffffu, s.b1, mask);
  const bool other = o0 > s.b0 || (o0 == s.b0 && oi < s.i0);
  const float n1 = other ? fmaxf(s.b0, o1) : fmaxf(o0, s.b1);
  s.b0 = other ? o0 : s.b0;
  s.i0 = other ? oi : s.i0;
  s.b1 = n1;
}

// _merge_top2: fold a block's top-2 into the running one; ties keep the
// running (earlier, lower-index) entry.
__device__ __forceinline__ void fold_block(Top2& r, const Top2& m) {
  const bool a_first = r.b0 >= m.b0;
  const float loser = a_first ? m.b0 : r.b0;
  const float own2 = a_first ? r.b1 : m.b1;
  r.i0 = a_first ? r.i0 : m.i0;
  r.b0 = a_first ? r.b0 : m.b0;
  r.b1 = fmaxf(loser, own2);
}

__device__ __forceinline__ float distance(float qsq, float m) {
  return __fsub_rn(qsq, __fmul_rn(2.0f, m));
}

// One block: TQ query rows of one pair against that pair's db, 8 warps, each
// owning MT = TQ/128 m-tiles of 16 rows (rows (mt*8 + warp)*16 ...).  With
// MERGE, per-lane state is reset every BD db rows and the block's top-2 is
// folded into a running top-2 (the blockmerge variant).
template <int TQ, class D, int MODE, bool MERGE>
__global__ void __launch_bounds__(THREADS)
variant_kernel(const int8_t* __restrict__ table, int K,
               const int* __restrict__ counts, const int* __restrict__ pi,
               const int* __restrict__ pj, float* __restrict__ d0_out,
               int* __restrict__ i0_out, float* __restrict__ d1_out) {
  constexpr int MT = TQ / (WARPS * 16);
  constexpr bool NORMS = MODE != MAX;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* db_s = q_s + TQ * Q_ROW;
  float* hb_s = reinterpret_cast<float*>(db_s + DT * D::DB_ROW);
  int* qsq_s = reinterpret_cast<int*>(hb_s + DT);

  const int q_tiles = K / TQ;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int dj = pj[b];
  const int count = counts[dj];
  const int8_t* qbase =
      table + (static_cast<long long>(pi[b]) * K + q0) * DIM;
  const int8_t* dbase = table + static_cast<long long>(dj) * K * DIM;

  const int c = threadIdx.x % 4;
  for (int r = threadIdx.x / 4; r < TQ; r += THREADS / 4) {
    uint32_t w[8];
    const int sq = load_chunk(qbase + static_cast<long long>(r) * DIM, c, w);
    I8Dot::stage(w, q_s + r * Q_ROW, c);
    if (c == 0) qsq_s[r] = sq;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  Top2 run[MT][2], blk[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    run[mt][0].reset(); run[mt][1].reset();
    blk[mt][0].reset(); blk[mt][1].reset();
  }
  uint32_t a[D::KSTEPS][4];
  auto load_tile_a = [&](int mt) {
    const unsigned char* row_g = q_s + ((mt * WARPS + warp) * 16 + g) * Q_ROW;
#pragma unroll
    for (int kk = 0; kk < D::KSTEPS; ++kk) D::load_a(a[kk], row_g, kk, t);
  };
  if constexpr (MT == 1) load_tile_a(0);

  // Tiles past the count hold only poisoned rows and cannot change the
  // top-2 (at least one tile always runs); "matmul_max" reads all K rows.
  const int n_tiles =
      MODE == MAX ? K / DT : max(1, (count + DT - 1) / DT);
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // every warp is done with the previous tile
    {
      const int r = threadIdx.x / 4;   // DT * 4 == THREADS: one chunk each
      uint32_t w[8];
      const int sq = load_chunk(
          dbase + (static_cast<long long>(tile) * DT + r) * DIM, c, w);
      D::stage(w, db_s + r * D::DB_ROW, c);
      if (NORMS && c == 0)
        hb_s[r] = tile * DT + r < count ? 0.5f * __int2float_rn(sq)
                                        : HALF_POISON;
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (MT > 1) load_tile_a(mt);
      Top2& lo = MERGE ? blk[mt][0] : run[mt][0];
      Top2& hi = MERGE ? blk[mt][1] : run[mt][1];
#pragma unroll 2
      for (int nt = 0; nt < DT / 8; ++nt) {
        typename D::acc acc[4] = {0, 0, 0, 0};
        const unsigned char* brow = db_s + (nt * 8 + g) * D::DB_ROW + t * 4;
#pragma unroll
        for (int kk = 0; kk < D::KSTEPS; ++kk) {
          uint32_t b0, b1;
          D::load_b(b0, b1, brow, kk);
          D::mma(acc, a[kk], b0, b1);
        }
        const int cl = nt * 8 + t * 2;
        const int col = tile * DT + cl;
        float s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = D::to_f32(acc[i]);
        if (NORMS) {
          const float h0 = hb_s[cl], h1 = hb_s[cl + 1];
          s[0] = __fsub_rn(s[0], h0);
          s[1] = __fsub_rn(s[1], h1);
          s[2] = __fsub_rn(s[2], h0);
          s[3] = __fsub_rn(s[3], h1);
        }
        consider<MODE>(lo, s[0], col);
        consider<MODE>(lo, s[1], col + 1);
        consider<MODE>(hi, s[2], col);
        consider<MODE>(hi, s[3], col + 1);
      }
    }
    if constexpr (MERGE) {
      if ((tile + 1) % (BD / DT) == 0 || tile + 1 == n_tiles) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            merge_lanes(blk[mt][h], 1);
            merge_lanes(blk[mt][h], 2);
            fold_block(run[mt][h], blk[mt][h]);
            blk[mt][h].reset();
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2& s = run[mt][h];
      if constexpr (!MERGE) {   // the four lanes of a row hold other columns
        merge_lanes(s, 1);
        merge_lanes(s, 2);
      }
      if (t == 0) {
        const int row = (mt * WARPS + warp) * 16 + g + 8 * h;
        const long long o = static_cast<long long>(b) * K + q0 + row;
        const float qsq = __int2float_rn(qsq_s[row]);
        if (MODE == MAX) {
          d0_out[o] = s.b0;
          i0_out[o] = 0;
          d1_out[o] = 0.0f;
        } else {
          d0_out[o] = distance(qsq, s.b0);
          i0_out[o] = s.i0;
          d1_out[o] = MODE == TOP2 ? distance(qsq, s.b1) : 0.0f;
        }
      }
    }
  }
}

struct Args {
  const void* table;
  int K;
  const int* counts;
  const int* pi;
  const int* pj;
  int num_pairs;
  float* d0;
  int* i0;
  float* d1;
  cudaStream_t stream;
};

template <int TQ, class D, int MODE, bool MERGE>
int launch(const Args& x) {
  if (x.K <= 0 || x.K % TQ || (MERGE && x.K % BD))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x.num_pairs == 0) return 0;
  const int smem = TQ * Q_ROW + DT * D::DB_ROW + DT * 4 + TQ * 4;
  cudaError_t err = cudaFuncSetAttribute(
      variant_kernel<TQ, D, MODE, MERGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(x.num_pairs) * (x.K / TQ);
  variant_kernel<TQ, D, MODE, MERGE>
      <<<static_cast<unsigned>(blocks), THREADS, smem, x.stream>>>(
      static_cast<const int8_t*>(x.table), x.K, x.counts, x.pi, x.pj, x.d0,
      x.i0, x.d1);
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch_oneblock(const Args& x, int tq) {
  switch (tq) {
    case 128: return launch<128, D, TOP2, false>(x);
    case 256: return launch<256, D, TOP2, false>(x);
    case 512: return launch<512, D, TOP2, false>(x);
    case 1024: return launch<1024, D, TOP2, false>(x);
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

// Exact 2-NN; tq in {128, 256, 512, 1024}, K % tq == 0; bf16 != 0 runs the
// dot in bf16 (m16n8k16), else in int8 (m16n8k32).
int two_nn_oneblock(const void* table, int K, const int* counts,
                    const int* pi, const int* pj, int num_pairs, int tq,
                    int bf16, float* d0, int* i0, float* d1, void* stream) {
  const Args x{table, K, counts, pi, pj, num_pairs, d0, i0, d1,
               static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_oneblock<Bf16Dot>(x, tq) : launch_oneblock<I8Dot>(x, tq);
}

// Exact 2-NN, bf16 dot, 256 query rows, 512-row db blocks; K % 512 == 0.
int two_nn_blockmerge_bf16(const void* table, int K, const int* counts,
                           const int* pi, const int* pj, int num_pairs,
                           float* d0, int* i0, float* d1, void* stream) {
  const Args x{table, K, counts, pi, pj, num_pairs, d0, i0, d1,
               static_cast<cudaStream_t>(stream)};
  return launch<256, Bf16Dot, TOP2, true>(x);
}

// Epilogue ablations, int8 dot, 128 query rows; K % 128 == 0.
// mode 0: "matmul_max", mode 1: "top1".
int two_nn_ablation(const void* table, int K, const int* counts,
                    const int* pi, const int* pj, int num_pairs, int mode,
                    float* d0, int* i0, float* d1, void* stream) {
  const Args x{table, K, counts, pi, pj, num_pairs, d0, i0, d1,
               static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case 0: return launch<128, I8Dot, MAX, false>(x);
    case 1: return launch<128, I8Dot, TOP1, false>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
