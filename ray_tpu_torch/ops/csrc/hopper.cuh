// Hopper (sm_90a) machinery shared by the wgmma kernels of K1 (flash_fwd.cu),
// K2 and K3 (flash_bwd.cu): TMA tensor maps and loads/stores, mbarriers, wgmma
// shared-memory descriptors and the wgmma instructions themselves.
//
// Tiles. Every bf16 tile lives in shared memory as TMA writes it with the
// 128-byte swizzle: boxes of 64 head-dim columns (128 bytes) by R rows, row
// r of a box at byte 128 r, the 16-byte chunk c of a row stored at chunk
// c ^ (r % 8). A tile of Dp columns is Dp / 64 such boxes one after the
// other, each box 1024-byte aligned, so the swizzle follows the address
// bits that wgmma's descriptors assume.
//
// wgmma reads such a tile two ways:
// - K-major (the product contracts over the head dim, as in q k^T): one
//   k16 step is 32 bytes of every row, at offset 32 (k % 4) of box k / 4;
//   rows are 128 bytes apart and 8-row groups 1024 (SBO).
// - MN-major (the product contracts over the rows, as in p v, read
//   through the transpose bit): one k16 step is 16 rows, 2048 bytes; the
//   64-column boxes are LBO bytes apart and 8-row groups 1024 (SBO).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBoxCols = 64;         // bf16 columns of a 128-byte swizzle box
constexpr int kBoxRows = 64;         // rows of one TMA box
constexpr int kRowBytes = 128;

__host__ __device__ constexpr int pad64(int d) { return (d + 63) / 64 * 64; }

// -- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetch it through the
// runtime, so the library links nothing beyond cudart.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map (D, heads, S, B) of a contiguous bf16 [B, S, heads, D] tensor,
// boxes of 64 columns x 1 head x 64 rows x 1 batch, 128-byte swizzle.
// Loads past S (and past D, when the box is wider than D) read zeros; a
// store there is dropped. Within one batch the map never runs into the
// next batch's rows, as a 3-D (D, heads, B*S) map would.
static inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B,
                                   int S, int heads, int D) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBoxRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel's allowance of `smem` bytes of dynamic shared memory (needed
// above 48 KB), set once per device, and the device's SM count in *sms
// when asked: both are needed on every launch and change only with the
// device.
template <auto kKernel>
static inline cudaError_t prepare_launch(size_t smem, int* sms = nullptr) {
  static int cached[64] = {};  // SM count per device, 0 until prepared
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < 64 ? cached[dev] : 0;
  if (n == 0) {
    if ((err = cudaFuncSetAttribute(
             kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if (dev < 64) cached[dev] = n;
  }
  if (sms != nullptr) *sms = n;
  return cudaSuccess;
}

// -- device: shared memory, mbarriers, TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned byte from p (a kernel's dynamic shared
// memory, allocated with 1024 bytes of slack): the 128-byte swizzle
// repeats every 1024 bytes, and wgmma's descriptors assume tiles that
// start on that period.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// A consumer warpgroup is done with a slot: one arrival for the whole
// warpgroup, from its first thread. The wgmma that read the slot ran for
// all four warps at once, so once this thread has seen it complete, so
// has every warp; the slot's empty barrier counts warpgroups.
__device__ __forceinline__ void release(uint64_t* bar) {
  if (threadIdx.x % 128 == 0) mbar_arrive(bar);
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a 4-D map at (col, head, row, batch) into dst, which
// completes bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int head, int row, int batch,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(smem_addr(bar))
      : "memory");
}

// rows x Dp columns (Dp / 64 boxes, each of rows / 64 TMA boxes) of head
// `head` from row `row` into a tile of `rows` rows.
template <int Dp>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, int rows,
                                              const CUtensorMap* map, int head,
                                              int row, int batch,
                                              uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < Dp / kBoxCols; ++b)
    for (int r = 0; r < rows; r += kBoxRows)
      tma_load(dst + (b * rows + r) * kRowBytes, map, b * kBoxCols, head,
               row + r, batch, bar);
}

// A contiguous run of bytes (16-byte aligned, a multiple of 16) into dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One 64 x 64 box from src to a 4-D map at (col, head, row, batch); rows
// and columns past the tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int head,
                                          int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy shared stores made visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over one warpgroup's 128 threads (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// This thread's warpgroup, read from lane 0 so the compiler knows it is
// the same across the warp: branches on it are then not divergent, and
// wgmma in code that depends on it is not serialized.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Store a bf16 pair at column c (even) of row r of a swizzled tile of
// `rows` rows (see the header note).
__device__ __forceinline__ void st_swizzled(uint8_t* tile, int rows, int r,
                                            int c, uint32_t pair) {
  const int box = c / kBoxCols;
  const int cc = c % kBoxCols;
  const int chunk = (cc / 8) ^ (r % 8);
  *reinterpret_cast<uint32_t*>(tile + (box * rows + r) * kRowBytes +
                               chunk * 16 + (cc % 8) * 2) = pair;
}

// -- device: wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: the k16 step kk of a tile of `rows` rows, from row r0.
__device__ __forceinline__ uint64_t desc_k_major(const uint8_t* tile, int rows,
                                                 int r0, int kk) {
  return desc_sw128(tile + ((kk / 4) * rows + r0) * kRowBytes + (kk % 4) * 32,
                    16, 8 * kRowBytes);
}

// MN-major operand: the k16 step kk (rows 16kk..16kk+15) of a tile of
// `rows` rows, from column box b0.
__device__ __forceinline__ uint64_t desc_mn_major(const uint8_t* tile, int rows,
                                                  int b0, int kk) {
  return desc_sw128(tile + (b0 * rows + 16 * kk) * kRowBytes,
                    rows * kRowBytes, 8 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (relative error ~2^-22; 0 for x far
// below -126, as the masked logits are).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma instructions, m64nNk16 bf16 x bf16 -> fp32, one overload per
// accumulator size (N / 2 fp32 registers a thread): N = 64 and 128 with
// both operands in shared memory, N = 64, 128 and 256 with A in registers.
// Accumulator fragment: warp w of the warpgroup holds rows 16w + lane / 4
// and 16w + lane / 4 + 8; d[4j + e] is column 8j + 2 (lane % 4) + e of the
// first row, d[4j + 2 + e] of the second (e = 0, 1).

// d = A * B^T (+ d when scale_d), m64n64k16: A and B in shared memory,
// both K-major (descriptors a and b).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A * B (+ d when scale_d), m64n64k16: A (bf16 pairs) in registers in
// the accumulator's fragment layout, B in shared memory read MN-major
// (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = A * B^T (+ d when scale_d), m64n128k16: A and B in shared memory,
// both K-major (descriptors a and b).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A * B (+ d when scale_d), m64n128k16: A (bf16 pairs) in registers in
// the accumulator's fragment layout, B in shared memory read MN-major
// (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = A * B (+ d when scale_d), m64n256k16: A (bf16 pairs) in registers in
// the accumulator's fragment layout, B in shared memory read MN-major
// (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace hopper
