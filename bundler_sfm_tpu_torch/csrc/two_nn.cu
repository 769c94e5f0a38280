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
// index; with fewer than two valid rows the missing distance is 3e38 and
// i0 is 0, as in the XLA path (ops/matching.py::two_nn).
//
// Element types:
//   int8  — centered descriptors (u8 - 128).  Distances are computed as
//           |q|^2 + |b|^2 - 2 q.b in int32 and converted to f32 once: every
//           value is an integer below 2^23, so the result is bit-identical
//           to the XLA path.
//   float — operands rounded to bf16 for the tensor cores, f32 accumulate;
//           |q|^2 and |b|^2 from the unrounded f32 values, d = (|q|^2 +
//           |b|^2) - 2 q.b in f32.  Exact for integer-valued descriptors.
//
// Bound on an H100: the distance products are 2*B*Nq*Nd*128 int8
// tensor-core operations (1979 TOP/s dense), and the epilogue does B*Nq*Nd
// compare/selects on the CUDA cores.  At 2048 keys per image the epilogue,
// not the matrix product, bounds this design: each 16x8 int32 tile of an
// m16n8k32 mma.sync costs ~4 mma plus ~30 integer instructions of
// distance assembly and top-2 update.  What the design does about it: the
// [Nq, Nd] distance tile never leaves registers (the point of the TPU
// kernel), db rows stream through shared memory in 64-row tiles with their
// norms computed once per tile, padded rows are poisoned through their norm
// so the inner loop has no validity branch, and the running top-2 is a
// branch-free select chain merged across the four lanes of a row only once
// at the end.  wgmma, TMA and a persistent schedule are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DIM = 128;          // descriptor length
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * 16;    // query rows per block: one m16 tile per warp
constexpr int DT = 64;            // db rows per shared-memory tile
constexpr int POISON_I = 1 << 30; // |b|^2 of a padded int8 row
constexpr int FAR_I = 1 << 29;    // int8 distances at or above this are padding
constexpr float BIG = 3.0e38f;

// Centered int8 rows, int32 distances.
struct I8 {
  using elem = int8_t;
  using dist = int;
  static constexpr int STAGED_BYTES = 1;         // bytes per element in smem
  static constexpr int ROW_BYTES = DIM + 16;     // +16: conflict-free fragment loads
  static constexpr int KSTEPS = DIM / 32;        // m16n8k32
  static constexpr dist INIT = 0x7fffffff;

  // Thread `tid` stages 32 elements (row tid/4, chunk tid%4) of `rows` rows
  // and returns the partial |row|^2 of its chunk.
  __device__ static dist stage_chunk(const elem* src, unsigned char* dst) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4 v0 = s[0], v1 = s[1];
    int4* d = reinterpret_cast<int4*>(dst);
    d[0] = v0;
    d[1] = v1;
    int acc = 0;
    acc = __dp4a(v0.x, v0.x, acc); acc = __dp4a(v0.y, v0.y, acc);
    acc = __dp4a(v0.z, v0.z, acc); acc = __dp4a(v0.w, v0.w, acc);
    acc = __dp4a(v1.x, v1.x, acc); acc = __dp4a(v1.y, v1.y, acc);
    acc = __dp4a(v1.z, v1.z, acc); acc = __dp4a(v1.w, v1.w, acc);
    return acc;
  }
  __device__ static dist poison() { return POISON_I; }

  __device__ static void mma(int c[4], const uint32_t a[4], uint32_t b0,
                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static dist distance(dist qsq, dist bsq, int acc) {
    return qsq + bsq - 2 * acc;
  }
  __device__ static dist dmin(dist a, dist b) { return min(a, b); }
  __device__ static float to_float(dist d) {
    return d >= FAR_I ? BIG : static_cast<float>(d);
  }
};

// f32 rows staged as bf16, f32 distances.
struct F32 {
  using elem = float;
  using dist = float;
  static constexpr int STAGED_BYTES = 2;         // staged as bf16
  static constexpr int ROW_BYTES = DIM * 2 + 16;
  static constexpr int KSTEPS = DIM / 16;        // m16n8k16
  static constexpr float INIT = BIG;

  __device__ static dist stage_chunk(const elem* src, unsigned char* dst) {
    const float4* s = reinterpret_cast<const float4*>(src);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 v = s[i];
      acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
      acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
      acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
      acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
      d[2 * i] = __floats2bfloat162_rn(v.x, v.y);
      d[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
    return acc;
  }
  __device__ static dist poison() { return BIG; }

  __device__ static void mma(float c[4], const uint32_t a[4], uint32_t b0,
                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static dist distance(dist qsq, dist bsq, float acc) {
    // (q_sq + b_sq) - 2*dots, the XLA path's order; no FMA contraction.
    return __fsub_rn(__fadd_rn(qsq, bsq), __fmul_rn(2.0f, acc));
  }
  __device__ static dist dmin(dist a, dist b) { return fminf(a, b); }
  __device__ static float to_float(dist d) { return d; }
};

// Stage `rows` rows of 128 elements into shared memory (row stride
// T::ROW_BYTES) and write their squared norms; rows at or past `valid` get
// the poisoned norm.  Four consecutive threads share a row.
template <class T>
__device__ void stage_rows(const typename T::elem* src, int rows, int valid,
                           unsigned char* dst, typename T::dist* norms) {
  constexpr int CHUNK = DIM / 4;
  for (int r = threadIdx.x / 4; r < rows; r += THREADS / 4) {
    const int c = threadIdx.x % 4;
    typename T::dist s =
        T::stage_chunk(src + static_cast<long long>(r) * DIM + c * CHUNK,
                       dst + r * T::ROW_BYTES + c * CHUNK * T::STAGED_BYTES);
    s = s + __shfl_xor_sync(0xffffffffu, s, 1);
    s = s + __shfl_xor_sync(0xffffffffu, s, 2);
    if (c == 0) norms[r] = r < valid ? s : T::poison();
  }
}

template <class T>
__device__ __forceinline__ void top2_update(typename T::dist d, int col,
                                            typename T::dist& b0, int& i0,
                                            typename T::dist& b1) {
  // Candidates reach a lane in increasing column order, so a strict `<`
  // keeps the lowest index on ties; an equal distance becomes the runner-up.
  const bool lt = d < b0;
  b1 = lt ? b0 : T::dmin(b1, d);
  i0 = lt ? col : i0;
  b0 = lt ? d : b0;
}

template <class T>
__device__ __forceinline__ void top2_merge(typename T::dist& b0, int& i0,
                                           typename T::dist& b1, int lane_mask) {
  const typename T::dist o0 = __shfl_xor_sync(0xffffffffu, b0, lane_mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i0, lane_mask);
  const typename T::dist o1 = __shfl_xor_sync(0xffffffffu, b1, lane_mask);
  const bool other = (o0 < b0) || (o0 == b0 && oi < i0);
  const typename T::dist n1 = other ? T::dmin(b0, o1) : T::dmin(o0, b1);
  b0 = other ? o0 : b0;
  i0 = other ? oi : i0;
  b1 = n1;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
two_nn_kernel(const typename T::elem* __restrict__ qtab, long long q_stride,
              int nq, const typename T::elem* __restrict__ dbtab,
              long long db_stride, const int* __restrict__ db_counts,
              const int* __restrict__ pi, const int* __restrict__ pj,
              float* __restrict__ d0_out, int* __restrict__ i0_out,
              float* __restrict__ d1_out) {
  using dist = typename T::dist;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* db_s = q_s + QT * T::ROW_BYTES;
  dist* qsq_s = reinterpret_cast<dist*>(db_s + DT * T::ROW_BYTES);
  dist* bsq_s = qsq_s + QT;

  const int q_tiles = nq / QT;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const int dj = pj[b];
  const int dbc = db_counts[dj];
  const typename T::elem* qbase =
      qtab + static_cast<long long>(pi[b]) * q_stride +
      static_cast<long long>(q0) * DIM;
  const typename T::elem* dbase = dbtab + static_cast<long long>(dj) * db_stride;

  stage_rows<T>(qbase, QT, QT, q_s, qsq_s);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int r0 = warp * 16 + g;

  // A fragments for this warp's 16 query rows stay in registers.
  uint32_t a[T::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk) {
    const unsigned char* p0 = q_s + r0 * T::ROW_BYTES + kk * 32 + t * 4;
    const unsigned char* p1 = p0 + 8 * T::ROW_BYTES;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
  }
  const dist qs_lo = qsq_s[r0];
  const dist qs_hi = qsq_s[r0 + 8];

  dist lo0 = T::INIT, lo1 = T::INIT, hi0 = T::INIT, hi1 = T::INIT;
  int lo_i = 0, hi_i = 0;

  const int n_tiles = (dbc + DT - 1) / DT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<T>(dbase + static_cast<long long>(tile) * DT * DIM, DT,
                  dbc - tile * DT, db_s, bsq_s);
    __syncthreads();
#pragma unroll 2
    for (int nt = 0; nt < DT / 8; ++nt) {
      dist c[4] = {0, 0, 0, 0};
      const unsigned char* brow = db_s + (nt * 8 + g) * T::ROW_BYTES + t * 4;
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + kk * 32);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(brow + kk * 32 + 16);
        T::mma(c, a[kk], b0, b1);
      }
      const int cl = nt * 8 + t * 2;
      const dist bs0 = bsq_s[cl];
      const dist bs1 = bsq_s[cl + 1];
      const int col = tile * DT + cl;
      top2_update<T>(T::distance(qs_lo, bs0, c[0]), col, lo0, lo_i, lo1);
      top2_update<T>(T::distance(qs_lo, bs1, c[1]), col + 1, lo0, lo_i, lo1);
      top2_update<T>(T::distance(qs_hi, bs0, c[2]), col, hi0, hi_i, hi1);
      top2_update<T>(T::distance(qs_hi, bs1, c[3]), col + 1, hi0, hi_i, hi1);
    }
  }

  // The four lanes of a row group hold interleaved columns: merge them.
  top2_merge<T>(lo0, lo_i, lo1, 1);
  top2_merge<T>(lo0, lo_i, lo1, 2);
  top2_merge<T>(hi0, hi_i, hi1, 1);
  top2_merge<T>(hi0, hi_i, hi1, 2);
  if (t == 0) {
    const long long o = static_cast<long long>(b) * nq + q0 + r0;
    d0_out[o] = T::to_float(lo0);
    i0_out[o] = lo_i;
    d1_out[o] = T::to_float(lo1);
    d0_out[o + 8] = T::to_float(hi0);
    i0_out[o + 8] = hi_i;
    d1_out[o + 8] = T::to_float(hi1);
  }
}

template <class T>
int launch(const void* qtab, long long q_stride, int nq, const void* dbtab,
           long long db_stride, const int* db_counts, const int* pi,
           const int* pj, int num_pairs, float* d0, int* i0, float* d1,
           cudaStream_t stream) {
  if (num_pairs == 0 || nq == 0) return 0;
  const int smem = (QT + DT) * T::ROW_BYTES +
                   (QT + DT) * static_cast<int>(sizeof(typename T::dist));
  cudaError_t err = cudaFuncSetAttribute(
      two_nn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(num_pairs) * (nq / QT);
  two_nn_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const typename T::elem*>(qtab), q_stride, nq,
      static_cast<const typename T::elem*>(dbtab), db_stride, db_counts, pi,
      pj, d0, i0, d1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tables are contiguous [n_img, rows, 128]; q_stride / db_stride are the
// per-image element strides.  nq % 128 == 0, db rows per image % 64 == 0,
// db_counts[j] <= db rows.  Outputs are [num_pairs, nq].  Returns the CUDA
// error code of the launch (0 on success).
int two_nn_pairs_i8(const void* qtab, long long q_stride, int nq,
                    const void* dbtab, long long db_stride,
                    const int* db_counts, const int* pi, const int* pj,
                    int num_pairs, float* d0, int* i0, float* d1,
                    void* stream) {
  return launch<I8>(qtab, q_stride, nq, dbtab, db_stride, db_counts, pi, pj,
                    num_pairs, d0, i0, d1, static_cast<cudaStream_t>(stream));
}

int two_nn_pairs_f32(const void* qtab, long long q_stride, int nq,
                     const void* dbtab, long long db_stride,
                     const int* db_counts, const int* pi, const int* pj,
                     int num_pairs, float* d0, int* i0, float* d1,
                     void* stream) {
  return launch<F32>(qtab, q_stride, nq, dbtab, db_stride, db_counts, pi, pj,
                     num_pairs, d0, i0, d1, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
