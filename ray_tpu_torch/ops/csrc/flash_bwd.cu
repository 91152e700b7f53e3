// K2 and K3: flash attention backward for Hopper (sm_90a), CUDA C++.
//
// K2 replaces ray_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and K3
// replaces ::_flash_bwd_dkv_kernel, the Pallas TPU kernels. Both recompute
// the probabilities from q, k and K1's lse instead of reading an S x S
// matrix: p = exp(q k^T / sqrt(D) - lse), zeroed where the causal mask
// hides a key; dp = dO v^T; ds = p (dp - delta), with delta = rowsum(dO o)
// computed by the host. K2 writes dq = ds k / sqrt(D) in q's dtype; K3
// writes dv = p^T dO and dk = ds^T q / sqrt(D) in k's dtype.
//
// Layout. q, dO and dq are [B, S, H, D]; k, v, dk and dv are [B, S, KVH, D];
// lse and delta are fp32 [B*H, S]. All contiguous. K2 reads the key/value
// head h / (H / KVH) itself, as K1 does. K3 runs one block per key/value
// head and key tile and loops over the H / KVH query heads that share it,
// so GQA's sum over the repeated heads happens in its fp32 accumulators:
// each dk/dv tile is written once, with no atomics and no host repeat.
//
// Tiles. Key tiles wholly past a query tile's last row are skipped in K2,
// and query tiles wholly before a key tile's first row in K3, as the JAX
// kernels' causal loop bounds do. Tile sizes are these kernels' own; they
// change the order of the fp32 sums, not what is summed.
//
// Two kernels of each, as for K1:
//
// - *_fma_kernel (fp32 inputs): plain fp32 FMA, no TF32. 32-row tiles, so
//   that the four fp32 tiles a block stages fit in shared memory at D=256.
//   Thread t owns 2 rows (t / 8) and, of each 32-wide tile, the 4 columns
//   t % 8 + 8j; the p/ds tile goes through shared memory to the products
//   that contract over it.
// - bf16 inputs: K2 on tensor cores through mma.sync.m16n8k16 (bf16 x bf16
//   -> fp32, flash_bwd_dq_mma_kernel), 64-row tiles, warp w owning rows
//   16w..16w+15, k staged transposed through 16-bit shared stores so each
//   fragment is one 32-bit shared load; K3 on wgmma fed by TMA
//   (flash_bwd_dkv_wgmma_kernel, its design in the note above it). In
//   both, s and dp are exact fp32 sums of bf16 products; p and ds are
//   rounded to bf16 only as the operands of the products that contract
//   over them (the rounding the fp32 reference does not make). The output
//   columns are split over gridDim.z in slices of at most 128 (D=256 runs
//   two blocks per tile, each recomputing s and dp), which keeps the fp32
//   accumulators at <= 64 (K2) or 128 (K3) registers.
//
// Bound on an H100 SXM at the training shape B=12, H=16, S=1024, D=128,
// bf16, causal (524,800 unmasked pairs per head, 192 heads): K2 does 3
// products over the pairs (s, dp, ds k) = 6 D flops per pair, 77.4 GFLOP,
// ~78 us at the 989 TFLOP/s bf16 tensor-core peak; K3 does 4 (s, dp,
// p^T dO, ds^T q) = 8 D flops per pair, 103 GFLOP, ~104 us. Their bytes
// (q, k, v, dO, lse, delta and one output tensor or two: 253 MB and 303
// MB) take ~76 us and ~91 us at 3.35 TB/s, so the operations bound both.
// K2 is far from it for the reasons K1's first design was (mma.sync,
// synchronous tile loads, a transpose through 16-bit shared stores). K3's
// wgmma design runs its four products on wgmma and overlaps the loads
// with them; what it does not yet do is overlap one warpgroup's
// elementwise work with its own next products, nor keep its blocks
// resident from one key tile to the next, as K1 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
using flash::mma_bf16;
using flash::mma_pitch;
using flash::pack_bf16;

constexpr int kThreads = 128;
constexpr int kColLanes = 8;  // FMA kernels: lanes sharing one row group

// -- fp32: FMA kernels -------------------------------------------------------

constexpr int kF32Rows = 32;  // rows of every tile
constexpr int kF32RowsPerThread = kF32Rows * kColLanes / kThreads;  // 2
constexpr int kF32ColsPerLane = kF32Rows / kColLanes;              // 4
// Pitch of the 32x32 p and ds tiles: 36 puts a warp's 4 row groups (rows
// 2 apart) 8 banks apart, so its 32 stores hit 32 banks.
constexpr int kLdT = kF32Rows + 4;

static_assert(kThreads == (kF32Rows / kF32RowsPerThread) * kColLanes,
              "thread layout must cover the tile");

// Four [32, D + 1] fp32 tiles, two [32, kLdT] tiles and two rows of 32.
template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kF32Rows * (D + 1) +
                          2 * (size_t)kF32Rows * kLdT + 2 * kF32Rows);
}

// Copy rows [r0, r0 + 32) of one head (src: row 0 of that head, pitch
// between positions in elements) into a [32, D + 1] tile, times mul.
template <int D>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          size_t pitch, int r0, float* dst,
                                          float mul) {
  for (int i = threadIdx.x; i < kF32Rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] = src[(size_t)(r0 + r) * pitch + c] * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int S, int H, int KVH, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDCols = D / kColLanes;  // dq columns per thread
  static_assert(D % kColLanes == 0, "head dim must be a multiple of 8");

  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;             // q * scale
  float* sG = sQ + kF32Rows * kLd;  // dO
  float* sK = sG + kF32Rows * kLd;
  float* sV = sK + kF32Rows * kLd;
  float* sDS = sV + kF32Rows * kLd;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;  // heaviest first
  const int tid = threadIdx.x;
  const int row0 = (tid / kColLanes) * kF32RowsPerThread;
  const int lane_c = tid % kColLanes;

  const size_t q_pitch = (size_t)H * D;
  const size_t kv_pitch = (size_t)KVH * D;
  const size_t q_off = ((size_t)b * S * H + h) * D;
  const size_t kv_off = ((size_t)b * S * KVH + kvh) * D;
  stage_f32<D>(q + q_off, q_pitch, q0, sQ, scale);
  stage_f32<D>(g + q_off, q_pitch, q0, sG, 1.f);

  float lse_r[kF32RowsPerThread], delta_r[kF32RowsPerThread];
  float acc[kF32RowsPerThread][kDCols];
#pragma unroll
  for (int i = 0; i < kF32RowsPerThread; ++i) {
    lse_r[i] = lse[(size_t)bh * S + q0 + row0 + i];
    delta_r[i] = delta[(size_t)bh * S + q0 + row0 + i];
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = S / kF32Rows;
  if (causal) n_tiles = min(n_tiles, q0 / kF32Rows + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kF32Rows;
    __syncthreads();  // the previous tile's sK, sV and sDS are read
    stage_f32<D>(k + kv_off, kv_pitch, k0, sK, 1.f);
    stage_f32<D>(v + kv_off, kv_pitch, k0, sV, 1.f);
    __syncthreads();

    // s[i][j] = q[row0 + i] . k[lane_c + 8j], dp[i][j] = dO[row0 + i] . v[..]
    float s[kF32RowsPerThread][kF32ColsPerLane];
    float dp[kF32RowsPerThread][kF32ColsPerLane];
#pragma unroll
    for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kF32ColsPerLane; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kF32RowsPerThread], gv[kF32RowsPerThread];
      float kv[kF32ColsPerLane], vv[kF32ColsPerLane];
#pragma unroll
      for (int i = 0; i < kF32RowsPerThread; ++i) {
        qv[i] = sQ[(row0 + i) * kLd + d];
        gv[i] = sG[(row0 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kF32ColsPerLane; ++j) {
        kv[j] = sK[(lane_c + kColLanes * j) * kLd + d];
        vv[j] = sV[(lane_c + kColLanes * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kF32ColsPerLane; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kF32ColsPerLane; ++j) {
        const int col = lane_c + kColLanes * j;
        const bool masked = causal && q0 + row0 + i < k0 + col;
        const float p = masked ? 0.f : expf(s[i][j] - lse_r[i]);
        sDS[(row0 + i) * kLdT + col] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();

    // acc[i][j] += sum_c ds[row0 + i][c] * k[c][lane_c + 8j]
#pragma unroll 4
    for (int c = 0; c < kF32Rows; ++c) {
      float dsv[kF32RowsPerThread];
#pragma unroll
      for (int i = 0; i < kF32RowsPerThread; ++i)
        dsv[i] = sDS[(row0 + i) * kLdT + c];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        const float kk = sK[c * kLd + lane_c + kColLanes * j];
#pragma unroll
        for (int i = 0; i < kF32RowsPerThread; ++i)
          acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kF32RowsPerThread; ++i) {
    float* row = dq + q_off + (size_t)(q0 + row0 + i) * q_pitch;
#pragma unroll
    for (int j = 0; j < kDCols; ++j)
      row[lane_c + kColLanes * j] = acc[i][j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S,
                         int H, int KVH, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDCols = D / kColLanes;
  static_assert(D % kColLanes == 0, "head dim must be a multiple of 8");

  extern __shared__ float smem_f32[];
  float* sK = smem_f32;
  float* sV = sK + kF32Rows * kLd;
  float* sQ = sV + kF32Rows * kLd;  // q * scale
  float* sG = sQ + kF32Rows * kLd;  // dO
  float* sP = sG + kF32Rows * kLd;  // p^T: key rows x query columns
  float* sDS = sP + kF32Rows * kLdT;
  float* sL = sDS + kF32Rows * kLdT;  // lse of the query tile
  float* sDl = sL + kF32Rows;         // delta of the query tile

  const int bkv = blockIdx.x;
  const int b = bkv / KVH;
  const int kvh = bkv - b * KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.y * kF32Rows;  // the first key tiles see most
  const int tid = threadIdx.x;
  const int row0 = (tid / kColLanes) * kF32RowsPerThread;
  const int lane_c = tid % kColLanes;

  const size_t q_pitch = (size_t)H * D;
  const size_t kv_pitch = (size_t)KVH * D;
  const size_t kv_off = ((size_t)b * S * KVH + kvh) * D;
  stage_f32<D>(k + kv_off, kv_pitch, k0, sK, 1.f);
  stage_f32<D>(v + kv_off, kv_pitch, k0, sV, 1.f);

  float acc_k[kF32RowsPerThread][kDCols], acc_v[kF32RowsPerThread][kDCols];
#pragma unroll
  for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int first_tile = causal ? k0 / kF32Rows : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const size_t bh = (size_t)b * H + h;
    const size_t q_off = ((size_t)b * S * H + h) * D;
    for (int qt = first_tile; qt < S / kF32Rows; ++qt) {
      const int q0 = qt * kF32Rows;
      __syncthreads();  // the previous tile's sQ, sG, sP and sDS are read
      stage_f32<D>(q + q_off, q_pitch, q0, sQ, scale);
      stage_f32<D>(g + q_off, q_pitch, q0, sG, 1.f);
      if (tid < kF32Rows) {
        sL[tid] = lse[bh * S + q0 + tid];
        sDl[tid] = delta[bh * S + q0 + tid];
      }
      __syncthreads();

      // s[i][j] = k[row0 + i] . q[lane_c + 8j], dp[i][j] = v[..] . dO[..]
      float s[kF32RowsPerThread][kF32ColsPerLane];
      float dp[kF32RowsPerThread][kF32ColsPerLane];
#pragma unroll
      for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kF32ColsPerLane; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[kF32RowsPerThread], vv[kF32RowsPerThread];
        float qv[kF32ColsPerLane], gv[kF32ColsPerLane];
#pragma unroll
        for (int i = 0; i < kF32RowsPerThread; ++i) {
          kv[i] = sK[(row0 + i) * kLd + d];
          vv[i] = sV[(row0 + i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < kF32ColsPerLane; ++j) {
          qv[j] = sQ[(lane_c + kColLanes * j) * kLd + d];
          gv[j] = sG[(lane_c + kColLanes * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kF32ColsPerLane; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kF32RowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kF32ColsPerLane; ++j) {
          const int col = lane_c + kColLanes * j;
          const bool masked = causal && q0 + col < k0 + row0 + i;
          const float p = masked ? 0.f : expf(s[i][j] - sL[col]);
          sP[(row0 + i) * kLdT + col] = p;
          sDS[(row0 + i) * kLdT + col] = p * (dp[i][j] - sDl[col]);
        }
      __syncthreads();

      // acc_v += p^T dO, acc_k += ds^T (q * scale), over the query tile.
#pragma unroll 4
      for (int c = 0; c < kF32Rows; ++c) {
        float pv[kF32RowsPerThread], dsv[kF32RowsPerThread];
#pragma unroll
        for (int i = 0; i < kF32RowsPerThread; ++i) {
          pv[i] = sP[(row0 + i) * kLdT + c];
          dsv[i] = sDS[(row0 + i) * kLdT + c];
        }
#pragma unroll
        for (int j = 0; j < kDCols; ++j) {
          const float gg = sG[c * kLd + lane_c + kColLanes * j];
          const float qq = sQ[c * kLd + lane_c + kColLanes * j];
#pragma unroll
          for (int i = 0; i < kF32RowsPerThread; ++i) {
            acc_v[i][j] = fmaf(pv[i], gg, acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qq, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kF32RowsPerThread; ++i) {
    const size_t row = kv_off + (size_t)(k0 + row0 + i) * kv_pitch;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      dk[row + lane_c + kColLanes * j] = acc_k[i][j];
      dv[row + lane_c + kColLanes * j] = acc_v[i][j];
    }
  }
}

// -- bf16: tensor-core kernels -------------------------------------------------

constexpr int kTile = 64;               // rows of every tile: 4 warps x 16
constexpr int kTPitch = kTile + 8;      // transposed tiles, bf16 elements
constexpr int kNTiles = kTile / 8;      // 8-column tiles of a score tile

static_assert(kThreads == 4 * 32 && kTile == 4 * 16,
              "4 warps of 16 rows");

// Output columns a block computes: all of D up to 128, else 128-wide slices.
template <int D>
__host__ __device__ constexpr int out_cols() { return D < 128 ? D : 128; }

// K2: sQ, sG, sK, sV row-major [64, D], and k^T for the block's columns.
template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (4 * (size_t)kTile * mma_pitch<D>() +
                                  (size_t)out_cols<D>() * kTPitch);
}

// K2: copy rows [r0, r0 + 64) of one head of a bf16 tensor (src: row 0 of
// that head as 32-bit words, pitch between positions in words) into a
// row-major tile dst (pitch mma_pitch<D>() elements) and, when dst_t is
// given, the columns [c_lo, c_lo + out_cols<D>()) transposed into dst_t
// (kTPitch elements per column).
template <int D>
__device__ __forceinline__ void stage_bf16(const uint32_t* __restrict__ src,
                                           size_t pitch, int r0, uint32_t* dst,
                                           __nv_bfloat16* dst_t, int c_lo) {
  constexpr int kPairs = D / 2;
  constexpr int kPw = mma_pitch<D>() / 2;
  for (int i = threadIdx.x; i < kTile * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = i - r * kPairs;
    const uint32_t w = src[(size_t)(r0 + r) * pitch + c];
    dst[r * kPw + c] = w;
    const int col = 2 * c - c_lo;  // c_lo and out_cols are even
    if (dst_t != nullptr && col >= 0 && col < out_cols<D>()) {
      dst_t[col * kTPitch + r] = __ushort_as_bfloat16((unsigned short)(w & 0xffffu));
      dst_t[(col + 1) * kTPitch + r] = __ushort_as_bfloat16((unsigned short)(w >> 16));
    }
  }
}

// The a-fragment of rows (r, r + 8) of a row-major tile at k-step kk.
template <int D>
__device__ __forceinline__ void load_a(const uint32_t* tile, int r, int kk,
                                       uint32_t (&a)[4]) {
  constexpr int kPw = mma_pitch<D>() / 2;
  const int cw = kk * 8 + threadIdx.x % 4;
  a[0] = tile[r * kPw + cw];
  a[1] = tile[(r + 8) * kPw + cw];
  a[2] = tile[r * kPw + cw + 4];
  a[3] = tile[(r + 8) * kPw + cw + 4];
}

// acc[n] += A x B^T over D, for the 8 column tiles of a 64-row tile B
// (row-major in shared memory): A's rows are r, r + 8 of tile_a.
template <int D>
__device__ __forceinline__ void product_nt(const uint32_t* tile_a, int r,
                                           const uint32_t* tile_b,
                                           float (&acc)[kNTiles][4]) {
  constexpr int kPw = mma_pitch<D>() / 2;
  const int gr = (threadIdx.x % 32) / 4;
  const int tg = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<D>(tile_a, r, kk, a);
    const int cw = kk * 8 + tg;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const uint32_t* brow = tile_b + (n * 8 + gr) * kPw;
      mma_bf16(acc[n], a, brow[cw], brow[cw + 4]);
    }
  }
}

// acc[j] += X x T over the tile's 64 rows, where X is this warp's 16 x 64
// fp32 score-shaped fragments (rounded to bf16 here) and T the transposed
// tile (out_cols<D>() columns of kTPitch elements).
template <int D>
__device__ __forceinline__ void product_xt(const float (&x)[kNTiles][4],
                                           const uint32_t* tile_t,
                                           float (&acc)[out_cols<D>() / 8][4]) {
  constexpr int kTw = kTPitch / 2;
  const int gr = (threadIdx.x % 32) / 4;
  const int tg = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int cw = kk * 8 + tg;
#pragma unroll
    for (int j = 0; j < out_cols<D>() / 8; ++j) {
      const uint32_t* trow = tile_t + (j * 8 + gr) * kTw;
      mma_bf16(acc[j], a, trow[cw], trow[cw + 4]);
    }
  }
}

// Store rows (r, r + 8) of a 16 x out_cols fragment tile, times mul, as bf16
// (dst: row 0 of the head at the block's first column, as 32-bit words).
template <int D>
__device__ __forceinline__ void store_rows(uint32_t* dst, size_t pitch, int r,
                                           const float (&acc)[out_cols<D>() / 8][4],
                                           float mul) {
  const int tg = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t* row = dst + (size_t)(r + 8 * half) * pitch;
#pragma unroll
    for (int j = 0; j < out_cols<D>() / 8; ++j)
      row[j * 4 + tg] = pack_bf16(acc[j][2 * half] * mul,
                                  acc[j][2 * half + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int H, int KVH,
                        int causal, float scale) {
  constexpr int kPw = mma_pitch<D>() / 2;
  constexpr int kPairs = D / 2;
  constexpr int kOut = out_cols<D>() / 8;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ uint32_t smem_u32[];
  uint32_t* sQ = smem_u32;
  uint32_t* sG = sQ + kTile * kPw;
  uint32_t* sK = sG + kTile * kPw;
  uint32_t* sV = sK + kTile * kPw;
  __nv_bfloat16* sKt = reinterpret_cast<__nv_bfloat16*>(sV + kTile * kPw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int c_lo = blockIdx.z * out_cols<D>();
  const int warp = threadIdx.x / 32;
  const int gr = (threadIdx.x % 32) / 4;
  const int tg = threadIdx.x % 4;

  const size_t q_pitch = (size_t)H * kPairs;  // in 32-bit words
  const size_t kv_pitch = (size_t)KVH * kPairs;
  const size_t q_off = ((size_t)b * S * H + h) * kPairs;
  const size_t kv_off = ((size_t)b * S * KVH + kvh) * kPairs;
  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k) + kv_off;
  const uint32_t* v32 = reinterpret_cast<const uint32_t*>(v) + kv_off;
  stage_bf16<D>(reinterpret_cast<const uint32_t*>(q) + q_off, q_pitch, q0, sQ,
                nullptr, 0);
  stage_bf16<D>(reinterpret_cast<const uint32_t*>(g) + q_off, q_pitch, q0, sG,
                nullptr, 0);

  const int r_lo = warp * 16 + gr;  // this thread's rows r_lo and r_lo + 8
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};
  const float lse_r[2] = {lse[(size_t)bh * S + qpos[0]],
                          lse[(size_t)bh * S + qpos[1]]};
  const float delta_r[2] = {delta[(size_t)bh * S + qpos[0]],
                            delta[(size_t)bh * S + qpos[1]]};
  float acc[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_tiles = S / kTile;
  if (causal) n_tiles = min(n_tiles, q0 / kTile + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's sK, sKt and sV are read
    stage_bf16<D>(k32, kv_pitch, k0, sK, sKt, c_lo);
    stage_bf16<D>(v32, kv_pitch, k0, sV, nullptr, 0);
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    product_nt<D>(sQ, r_lo, sK, s);
    product_nt<D>(sG, r_lo, sV, dp);

    // ds = p (dp - delta), in place of s. s[n] holds keys 8n + 2tg + {0, 1}
    // of row r_lo in [0..1], of row r_lo + 8 in [2..3].
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const bool masked = causal && qpos[half] < k0 + n * 8 + 2 * tg + e % 2;
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_r[half]);
        s[n][e] = p * (dp[n][e] - delta_r[half]);
      }
    product_xt<D>(s, reinterpret_cast<const uint32_t*>(sKt), acc);
  }

  store_rows<D>(reinterpret_cast<uint32_t*>(dq) + q_off + c_lo / 2, q_pitch,
                qpos[0], acc, scale);
}

// K3 for bf16: wgmma fed by TMA (hopper.cuh). One block per (b, KV head,
// 128 key rows; 64 at D=256): two consumer warpgroups of 64 keys (one at
// D=256) and one producer warpgroup, of which one thread issues the TMA
// loads. K and V are loaded once; q and dO tiles of 64 query rows, with
// their lse and delta, stream over the H / KVH
// query heads of the KV head and, for each, over the query tiles from the
// diagonal (causal) or from 0, through a ring of up to 4 stages (2 at
// D=256). Transposed scores, so no operand is ever
// transposed by hand: s^T = K q^T and dp^T = V dO^T are wgmmas with both
// operands in shared memory, K-major over the head dim; p^T and ds^T are
// computed on their fp32 fragments in registers and rounded to bf16 there,
// where they are the A operand of dV += p^T dO and dK += ds^T q, whose B
// (dO, q) is read MN-major through the transpose bit. dk and dv sum in
// fp32 registers over every query head and tile and are written once,
// through shared memory and a TMA store: no atomics, deterministic.
template <int D>
struct DkvTiles {
  static constexpr int kDp = hopper::pad64(D);    // head dim in shared memory
  static constexpr int kWG = D > 128 ? 1 : 2;     // consumer warpgroups
  static constexpr int kNK = 64 * kWG;            // key rows per block
  // Output columns per block: the fp32 dk and dv of 128 columns take 128
  // registers a thread, so D=256 splits them over gridDim.z.
  static constexpr int kOut = kDp > 128 ? 128 : kDp;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kKVBytes = kNK * kDp * 2;  // K or V
  static constexpr int kQBytes = 64 * kDp * 2;    // one q or dO tile
  // q/dO tiles in flight: as many as shared memory holds, up to 4 (2 at
  // D=256).
  static constexpr int kFit =
      (227 * 1024 - 2048 - 2 * kKVBytes) / (2 * kQBytes + 2 * 64 * 4);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  kStages * (2 * kQBytes + 2 * 64 * 4) +
                                  8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap g_map,
                           const __grid_constant__ CUtensorMap dk_map,
                           const __grid_constant__ CUtensorMap dv_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int S, int H,
                           int KVH, int causal, float scale) {
  using T = DkvTiles<D>;
  constexpr int kDp = T::kDp, kNK = T::kNK, kOut = T::kOut;
  constexpr int kStages = T::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = hopper::align_1024(smem_raw);
  uint8_t* sV = sK + T::kKVBytes;
  uint8_t* sQ = sV + T::kKVBytes;             // kStages q tiles
  uint8_t* sG = sQ + kStages * T::kQBytes;    // kStages dO tiles
  float* sL = reinterpret_cast<float*>(sG + kStages * T::kQBytes);
  float* sDl = sL + kStages * 64;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDl + kStages * 64);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // The key tiles of one KV head are neighbours in the grid (x), the
  // first key tiles, which see most queries, first.
  const int bkv = blockIdx.y;
  const int b = bkv / KVH;
  const int kvh = bkv - b * KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.x * kNK;
  const int c_lo = blockIdx.z * kOut;
  const int first = causal ? k0 / 64 : 0;
  const int per_head = S / 64 - first;
  const int n_iter = rep * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], T::kWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    // Producer: one thread keeps the TMA loads in flight.
    if constexpr (T::kWG == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * T::kKVBytes);
      hopper::tma_load_tile<kDp>(sK, kNK, &k_map, kvh, k0, b, kv_full);
      hopper::tma_load_tile<kDp>(sV, kNK, &v_map, kvh, k0, b, kv_full);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int h = kvh * rep + it / per_head;
        const int q0 = (first + it % per_head) * 64;
        const size_t row = ((size_t)b * H + h) * S + q0;  // of lse, delta
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * T::kQBytes + 2 * 64 * 4);
        hopper::tma_load_tile<kDp>(sQ + s * T::kQBytes, 64, &q_map, h, q0, b,
                                   &full[s]);
        hopper::tma_load_tile<kDp>(sG + s * T::kQBytes, 64, &g_map, h, q0, b,
                                   &full[s]);
        hopper::bulk_load(sL + s * 64, lse + row, 64 * 4, &full[s]);
        hopper::bulk_load(sDl + s * 64, delta + row, 64 * 4, &full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns key rows key_wg .. key_wg + 63.
  if constexpr (T::kWG == 2) hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int tq = lane % 4;
  const int r_lo = 16 * (tid / 32) + lane / 4;  // key rows r_lo, r_lo + 8
  const int key_wg = k0 + 64 * c;
  const int kpos[2] = {key_wg + r_lo, key_wg + r_lo + 8};
  const float sl2 = scale * kLog2e;
  float dk[kOut / 2], dv[kOut / 2];
#pragma unroll
  for (int i = 0; i < kOut / 2; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = (first + it % per_head) * 64;
    const uint8_t* tQ = sQ + s * T::kQBytes;
    const uint8_t* tG = sG + s * T::kQBytes;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    if (causal && q0 + 63 < key_wg) {  // every query before every key here
      hopper::release(&empty[s]);
      continue;
    }
    // s^T = K q^T and dp^T = V dO^T: rows are this warpgroup's keys,
    // columns the tile's 64 queries.
    float st[32], dpt[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk)
      hopper::wgmma_ss(st, hopper::desc_k_major(sK, kNK, 64 * c, kk),
                       hopper::desc_k_major(tQ, 64, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk)
      hopper::wgmma_ss(dpt, hopper::desc_k_major(sV, kNK, 64 * c, kk),
                       hopper::desc_k_major(tG, 64, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // p^T = exp(s^T scale - lse[query]), zeroed where the query precedes
    // the key (causal); ds^T = p^T (dp^T - delta[query]).
    const bool mask = causal && q0 < key_wg + 63;
    const float* tL = sL + s * 64;
    const float* tDl = sDl + s * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tq + e;
        const float lse2 = tL[col] * kLog2e;
        const float dl = tDl[col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half + e;
          float p = hopper::ex2(fmaf(st[i], sl2, -lse2));
          if (mask && q0 + col < kpos[half]) p = 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl);
        }
      }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
      }

    // dV += p^T dO and dK += ds^T q over the tile's queries, for this
    // block's output columns c_lo .. c_lo + kOut.
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs(dv, pa[kk], hopper::desc_mn_major(tG, 64, c_lo / 64, kk),
                       1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs(dk, da[kk], hopper::desc_mn_major(tQ, 64, c_lo / 64, kk),
                       1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::release(&empty[s]);
  }

  // dk * scale and dv in bf16, through this warpgroup's rows of the K and
  // V tiles (their last reader was the wait above), then TMA stores: rows
  // past S and columns past D are not written.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 64 * c + r_lo + 8 * half;
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      const int i = 4 * j + 2 * half;
      hopper::st_swizzled(sK, kNK, r, 8 * j + 2 * tq,
                          pack_bf16(dk[i] * scale, dk[i + 1] * scale));
      hopper::st_swizzled(sV, kNK, r, 8 * j + 2 * tq,
                          pack_bf16(dv[i], dv[i + 1]));
    }
  }
  hopper::fence_async_shared();
  hopper::warpgroup_sync(1 + c);
  if (tid == 0) {
#pragma unroll
    for (int bx = 0; bx < kOut / 64; ++bx)
      if (c_lo + bx * 64 < D) {
        const int off = (bx * kNK + 64 * c) * hopper::kRowBytes;
        hopper::tma_store(&dk_map, sK + off, c_lo + bx * 64, kvh, key_wg, b);
        hopper::tma_store(&dv_map, sV + off, c_lo + bx * 64, kvh, key_wg, b);
      }
    hopper::tma_store_wait();
  }
}

// -- launch --------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // Above 48 KB a block's dynamic shared memory must be allowed first.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *g, *lse, *delta;
  void *out0, *out1;  // dq (K2) or dk, dv (K3)
  int B, S, H, KVH, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(int dtype, const Args& a) {
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (dtype == 0) {
    constexpr size_t smem = fma_smem_bytes<D>();
    if ((err = allow_smem(flash_bwd_dq_fma_kernel<D>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dq_fma_kernel<D><<<dim3(a.B * a.H, a.S / kF32Rows), kThreads,
                                 smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.g), lse,
        delta, static_cast<float*>(a.out0), a.S, a.H, a.KVH, a.causal, a.scale);
  } else {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    if ((err = allow_smem(flash_bwd_dq_mma_kernel<D>, smem)) != cudaSuccess)
      return err;
    const dim3 grid(a.B * a.H, a.S / kTile, D / out_cols<D>());
    flash_bwd_dq_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.g), lse, delta,
        static_cast<__nv_bfloat16*>(a.out0), a.S, a.H, a.KVH, a.causal,
        a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const Args& a) {
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (dtype == 0) {
    constexpr size_t smem = fma_smem_bytes<D>();
    if ((err = allow_smem(flash_bwd_dkv_fma_kernel<D>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dkv_fma_kernel<D><<<dim3(a.B * a.KVH, a.S / kF32Rows),
                                  kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.g), lse,
        delta, static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.S,
        a.H, a.KVH, a.causal, a.scale);
  } else {
    using T = DkvTiles<D>;
    CUtensorMap q_map, k_map, v_map, g_map, dk_map, dv_map;
    if ((err = hopper::make_map(&q_map, a.q, a.B, a.S, a.H, D)) != cudaSuccess ||
        (err = hopper::make_map(&k_map, a.k, a.B, a.S, a.KVH, D)) != cudaSuccess ||
        (err = hopper::make_map(&v_map, a.v, a.B, a.S, a.KVH, D)) != cudaSuccess ||
        (err = hopper::make_map(&g_map, a.g, a.B, a.S, a.H, D)) != cudaSuccess ||
        (err = hopper::make_map(&dk_map, a.out0, a.B, a.S, a.KVH, D)) !=
            cudaSuccess ||
        (err = hopper::make_map(&dv_map, a.out1, a.B, a.S, a.KVH, D)) !=
            cudaSuccess)
      return err;
    if ((err = hopper::prepare_launch<flash_bwd_dkv_wgmma_kernel<D>>(
             T::kSmem)) != cudaSuccess)
      return err;
    if (a.B * a.KVH > 65535) return cudaErrorInvalidValue;  // gridDim.y
    const dim3 grid((a.S + T::kNK - 1) / T::kNK, a.B * a.KVH,
                    T::kDp / T::kOut);
    flash_bwd_dkv_wgmma_kernel<D><<<grid, T::kThreads, T::kSmem, a.stream>>>(
        q_map, k_map, v_map, g_map, dk_map, dv_map, lse, delta, a.S, a.H,
        a.KVH, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <bool kDq>
cudaError_t dispatch(int D, int dtype, const Args& a) {
  if (a.B < 1 || a.S < kTile || a.S % kTile || a.KVH < 1 || a.H % a.KVH ||
      a.S / kF32Rows > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  switch (D) {
    case 16: return kDq ? launch_dq<16>(dtype, a) : launch_dkv<16>(dtype, a);
    case 32: return kDq ? launch_dq<32>(dtype, a) : launch_dkv<32>(dtype, a);
    case 64: return kDq ? launch_dq<64>(dtype, a) : launch_dkv<64>(dtype, a);
    case 80: return kDq ? launch_dq<80>(dtype, a) : launch_dkv<80>(dtype, a);
    case 128: return kDq ? launch_dq<128>(dtype, a) : launch_dkv<128>(dtype, a);
    case 256: return kDq ? launch_dq<256>(dtype, a) : launch_dkv<256>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (mma kernels). q, dO
// (g) and the outputs as in the header note; lse and delta fp32 [B*H, S].
// Return a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for shapes the kernels do not take (S must be a multiple of 64).
int ray_tpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, int B, int S, int H, int KVH, int D,
                         int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dq, nullptr, B, S, H, KVH, causal,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, dtype, a);
}

int ray_tpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int B, int S, int H, int KVH,
                          int D, int dtype, int causal, float scale,
                          void* stream) {
  const Args a{q, k, v, g, lse, delta, dk, dv, B, S, H, KVH, causal,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, dtype, a);
}

}  // extern "C"
