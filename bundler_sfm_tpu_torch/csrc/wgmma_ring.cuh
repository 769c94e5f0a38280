// Building blocks of the warp-specialised 2-NN kernels for Hopper (sm_90a),
// shared by two_nn.cu (two_nn_pairs_i8, two_nn_pairs_f32) and
// two_nn_variants.cu (the probe variants): mbarrier and TMA helpers for a
// ring of 128-row tiles in shared memory, the wgmma descriptor of a K-major
// tile with 128-byte swizzle, the m64n128k32 int8 and m64n128k16 bf16
// wgmma (A in registers or shared memory), the packed-key top-2 fold, and
// what makes a call one launch: the first phase that writes a table's
// column constants, a grid-wide barrier, and the cooperative launch.
//
// Packed keys.  With the per-column constant c = |b|^2 * 256 + (row % 128)
// (KEY_POISON for a row at or past the count), key = c - 512 (q.b) =
// (|b|^2 - 2 q.b) * 256 + column: e = |b|^2 - 2 q.b lies in [-2^21, 2^23)
// for centered int8 descriptors, so the key fits int32 and orders by
// (distance - |q|^2, column).  |q|^2 is added back once per row at the end.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <utility>

namespace wsk {

constexpr int NT = 128;                      // db rows per ring stage (wgmma N)
constexpr int WG = 128;                      // threads per warpgroup
constexpr int NORM_BYTES = NT * 4;           // a stage's column constants
constexpr int BOX_BYTES = 128 * NT;          // one 128-byte-wide TMA box of 128 rows
constexpr int KEY_POISON = 0x7fffffff;       // key of a row past the count
constexpr int E_POISON = KEY_POISON >> 8;    // its distance part
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One TMA box of a 2-D tensor map at element (col, row) into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused.  A k-step
// inside the 128-byte row is a byte offset on the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving accumulator registers across async wgmma.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, class T>
__device__ __forceinline__ void wgmma_wait(T (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc(d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

#define WSK_D8(C, i)                                                      \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define WSK_D64(C)                                                          \
  WSK_D8(C, 0), WSK_D8(C, 8), WSK_D8(C, 16), WSK_D8(C, 24), WSK_D8(C, 32), \
      WSK_D8(C, 40), WSK_D8(C, 48), WSK_D8(C, 56)
#define WSK_R(x) "+r"(x)
#define WSK_F(x) "+f"(x)
#define WSK_ACC                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A x B^T for one k32 step: int8 A fragments in registers (the
// m16n8k32 layout, one 16-row slice per warp), B from shared memory.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_k32(int (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WSK_ACC
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : WSK_D64(WSK_R)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// bf16 x bf16 -> f32, A in registers (the m16n8k16 layout per warp).
template <int SCALE_D>
__device__ __forceinline__ void wgmma_k16_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WSK_ACC
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WSK_D64(WSK_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(SCALE_D));
}

// bf16 x bf16 -> f32, A from shared memory.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_k16_ss(float (&d)[64], uint64_t a_desc,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WSK_ACC
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WSK_D64(WSK_F)
      : "l"(a_desc), "l"(b_desc), "r"(SCALE_D));
}

// Byte address of k-step kk in a block of 128-byte-wide boxes: steps 0-3
// read the first box (the whole int8 row), steps 4-7 the second (bf16).
__device__ __forceinline__ uint32_t kstep_addr(uint32_t base, int kk) {
  return base + (kk / 4) * BOX_BYTES + (kk % 4) * 32;
}

// The consumers' loop over an item's n_tiles db tiles with two accumulator
// sets: tile n's product goes to acc0 for even n and acc1 for odd n, and
// tile n+1's product is issued before tile n's epilogue and waited for
// after it, so every wgmma group is retired inside the branch that issued
// it (ptxas serialises groups in flight across a branch or a loop's back
// edge).  issue(acc, n) issues tile n's product; finish(acc, n) runs its
// epilogue, finish_last(acc, n) that of the item's last tile.
template <class Acc, class Issue, class Finish, class FinishLast>
__device__ __forceinline__ void run_tiles(int n_tiles, Acc (&acc0)[64],
                                          Acc (&acc1)[64], Issue&& issue,
                                          Finish&& finish,
                                          FinishLast&& finish_last) {
  if (n_tiles > 0) {
    issue(acc0, 0);
    wgmma_wait<0>(acc0);
  }
  for (int n = 0; n < n_tiles; n += 2) {
    if (n + 1 == n_tiles) {
      finish_last(acc0, n);
      break;
    }
    issue(acc1, n + 1);
    finish(acc0, n);
    wgmma_wait<0>(acc1);
    if (n + 2 == n_tiles) {
      finish_last(acc1, n + 1);
      break;
    }
    issue(acc0, n + 2);
    finish(acc1, n + 1);
    wgmma_wait<0>(acc0);
  }
}

// Fold two keys of distinct columns into a top-2 (b0 <= b1): the second
// smallest of two sorted pairs is min(max(b0, lo), b1, hi).
__device__ __forceinline__ void fold2(int ka, int kb, int& b0, int& b1) {
  const int lo = min(ka, kb);
  const int hi = max(ka, kb);
  b1 = min(min(max(b0, lo), b1), hi);
  b0 = min(b0, lo);
}

// Merge a tile's top-2 keys into the running (e0, i0, e1); the running
// entry has the lower columns, so it wins ties.
__device__ __forceinline__ void merge_tile(int b0, int b1, int col0, int& e0,
                                           int& i0, int& e1) {
  const int t0 = b0 >> 8;
  const int t1 = b1 >> 8;
  const bool lt = t0 < e0;
  e1 = lt ? min(e0, t1) : min(e1, t0);
  i0 = lt ? col0 + (b0 & 255) : i0;
  e0 = lt ? t0 : e0;
}

__device__ __forceinline__ int key(int c, int acc) {
  // c - 512 * acc, wrapping: only a poisoned column of a last tile can leave
  // int32, and its key is replaced.
  return static_cast<int>(static_cast<uint32_t>(c) -
                          512u * static_cast<uint32_t>(acc));
}

// Merge the (e0, i0, e1) of lane ^ lane_mask; ties go to the lower index.
__device__ __forceinline__ void merge_lanes(int& e0, int& i0, int& e1,
                                            int lane_mask) {
  const int o0 = __shfl_xor_sync(0xffffffffu, e0, lane_mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i0, lane_mask);
  const int o1 = __shfl_xor_sync(0xffffffffu, e1, lane_mask);
  const bool other = (o0 < e0) || (o0 == e0 && oi < i0);
  const int n1 = other ? min(e0, o1) : min(o0, e1);
  e0 = other ? o0 : e0;
  i0 = other ? oi : i0;
  e1 = n1;
}

// The integer value of an accumulator: an int32 sum as it is; an f32 sum of
// bf16 products of int8 values (an exact integer, |q.b| <= 2^21) as the low
// bits of acc + 1.5 * 2^23, i.e. acc + 0x4B400000 (exact in [2^23, 2^24)).
// The caller's column constant carries the offset: 512 * 0x4B400000 wraps
// to 0x80000000 (mod 2^32), so with c + 0x80000000 key() gives the same key.
constexpr int F32_MAGIC_BIAS = INT32_MIN;

__device__ __forceinline__ int acc_bits(int a) { return a; }
__device__ __forceinline__ int acc_bits(float a) {
  return __float_as_int(__fadd_rn(a, 12582912.0f));
}

// Tile-local top-2 of this thread's 2 rows x 32 columns, merged into the
// running state.  Thread (warp w, lane 4g+t) holds rows 16w+g (acc[4i],
// acc[4i+1]) and 16w+g+8 (acc[4i+2], acc[4i+3]) at columns 8i+2t, 8i+2t+1.
// With LAST, the keys of poisoned columns (rows past the count, which only
// a pair's last tile holds) are raised to KEY_POISON.
template <bool LAST, class T>
__device__ __forceinline__ void epilogue(const T (&acc)[64], const int* cst,
                                         int t, int col0, int& e0lo, int& i0lo,
                                         int& e1lo, int& e0hi, int& i0hi,
                                         int& e1hi) {
  int b0lo = KEY_POISON, b1lo = KEY_POISON, b0hi = KEY_POISON, b1hi = KEY_POISON;
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    const int2 c = *reinterpret_cast<const int2*>(cst + 8 * i + 2 * t);
    int k0 = key(c.x, acc_bits(acc[4 * i]));
    int k1 = key(c.y, acc_bits(acc[4 * i + 1]));
    int k2 = key(c.x, acc_bits(acc[4 * i + 2]));
    int k3 = key(c.y, acc_bits(acc[4 * i + 3]));
    if (LAST) {
      const int fx = c.x == KEY_POISON ? KEY_POISON : INT32_MIN;
      const int fy = c.y == KEY_POISON ? KEY_POISON : INT32_MIN;
      k0 = max(k0, fx);
      k1 = max(k1, fy);
      k2 = max(k2, fx);
      k3 = max(k3, fy);
    }
    fold2(k0, k1, b0lo, b1lo);
    fold2(k2, k3, b0hi, b1hi);
  }
  merge_tile(b0lo, b1lo, col0, e0lo, i0lo, e1lo);
  merge_tile(b0hi, b1hi, col0, e0hi, i0hi, e1hi);
}

__device__ __forceinline__ float to_dist(int qsq, int e) {
  return e >= E_POISON ? BIG : static_cast<float>(qsq + e);
}

// The column constants of every row of a centered int8 table [n_img, nd,
// 128], written to cst [n_img, kp] (kp >= nd, a multiple of NT): c =
// |b|^2 * 256 + r % NT + bias for rows r < counts[j], KEY_POISON for the
// rest (the padding to kp included); with sq, also |b|^2 into sq [n_img,
// nd].  The pre-phase of a one-launch kernel: every thread of the grid
// takes units of 16 bytes, eight lanes a row (dp4a, then an xor tree over
// the eight, as two_nn_norms_kernel sums), PRE_UNROLL loads in flight
// before any is used, since the grid has far fewer threads than units.
// 32-bit indices: the launcher refuses n_img * kp >= PRE_MAX_ROWS.
constexpr int PRE_UNROLL = 16;
constexpr long long PRE_MAX_ROWS = 1LL << 26;

__device__ __forceinline__ void table_constants(
    const int8_t* __restrict__ tab, int n_img, int nd, int kp,
    const int* __restrict__ counts, int bias, int* __restrict__ cst,
    int* __restrict__ sq) {
  const int units = n_img * kp * 8;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // The same round count on every lane, so the shuffles see whole warps.
  const int rounds = (units + stride * PRE_UNROLL - 1) / (stride * PRE_UNROLL);
  for (int k = 0; k < rounds; ++k) {
    uint4 v[PRE_UNROLL];
#pragma unroll
    for (int i = 0; i < PRE_UNROLL; ++i) {
      const int u = first + (k * PRE_UNROLL + i) * stride;
      const int row = u >> 3;
      const int j = row / kp;
      const int r = row - j * kp;
      v[i] = make_uint4(0, 0, 0, 0);
      if (u < units && r < nd)
        v[i] = *reinterpret_cast<const uint4*>(
            tab + (static_cast<long long>(j) * nd + r) * 128 + (u & 7) * 16);
    }
#pragma unroll
    for (int i = 0; i < PRE_UNROLL; ++i) {
      const int u = first + (k * PRE_UNROLL + i) * stride;
      int s = 0;
      s = __dp4a(static_cast<int>(v[i].x), static_cast<int>(v[i].x), s);
      s = __dp4a(static_cast<int>(v[i].y), static_cast<int>(v[i].y), s);
      s = __dp4a(static_cast<int>(v[i].z), static_cast<int>(v[i].z), s);
      s = __dp4a(static_cast<int>(v[i].w), static_cast<int>(v[i].w), s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (u < units && (u & 7) == 0) {
        const int row = u >> 3;
        const int j = row / kp;
        const int r = row - j * kp;
        cst[row] = r < counts[j]
                       ? static_cast<int>(static_cast<uint32_t>(s * 256 + r % NT) +
                                          static_cast<uint32_t>(bias))
                       : KEY_POISON;
        if (sq != nullptr && r < nd) sq[static_cast<long long>(j) * nd + r] = s;
      }
    }
  }
}

// Make this thread's generic-proxy writes to global memory visible to
// the async proxy (the bulk copies that load them into the ring).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A barrier across the grid of a cooperative launch (every block resident
// at once).  One thread a block adds to `arrived`: block 0 adds 2^31 -
// (gridDim.x - 1), the others 1, so the top bit flips exactly when all
// have arrived and each barrier adds 2^31 in all: the counter needs no
// reset between launches of any grid size.  Launches that use one counter
// must not overlap (they share the stream).
__device__ __forceinline__ void grid_barrier(unsigned int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(arrived, add);
    while (((old ^ *reinterpret_cast<volatile unsigned int*>(arrived)) &
            0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The SM count of the current device, with `kernel`'s dynamic shared
// memory limit raised to `smem` there: queried and set once per device for
// each `cache` (one per kernel instantiation), then read from it.  Returns
// the count, or minus the CUDA error.
constexpr int MAX_DEVICES = 64;

template <class Kernel>
inline int sm_count_for(Kernel kernel, int smem,
                        std::atomic<int> (&cache)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < MAX_DEVICES) {
    const int sms = cache[dev].load(std::memory_order_relaxed);
    if (sms > 0) return sms;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < MAX_DEVICES) cache[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tensor map over `rows` rows of 128 B (128 int8 or 64 bf16 per box
// row), boxes of `box_cols` x 128 rows, 128-byte swizzle.  Returns false if
// cuTensorMapEncodeTiled cannot be found or refuses the map.
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type,
                        const void* base, int cols, long long rows,
                        int row_bytes, int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), NT};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `kernel` on `grid` blocks of `threads` threads with `smem` bytes
// of dynamic shared memory; with `cooperative`, as a cooperative launch
// (every block resident at once, which grid_barrier needs: the runtime
// refuses a grid that cannot be).  Returns the launch's CUDA error.
template <class... Params, class... Args>
inline int launch_kernel(void (*kernel)(Params...), int grid, int threads,
                         int smem, cudaStream_t stream, bool cooperative,
                         Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace wsk
