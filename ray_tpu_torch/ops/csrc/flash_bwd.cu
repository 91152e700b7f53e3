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
// - *_wgmma_kernel (bf16 inputs): Hopper's wgmma fed by TMA (the machinery
//   is in hopper.cuh; each kernel's design is in the note above it). A
//   producer warpgroup streams tiles through mbarrier rings; consumer
//   warpgroups of 64 rows compute s and dp with both operands in shared
//   memory and feed p and ds from their fp32 fragments in registers, as
//   the A operand, to the products that contract over them, whose B is
//   read MN-major through the transpose bit: no operand is transposed by
//   hand. s and dp are exact fp32 sums of bf16 products; p and ds are
//   rounded to bf16 only as those operands (the rounding the fp32
//   reference does not make), and every sum stays fp32. The output columns
//   are split in slices of at most 128 (at D=256 each tile is two pieces of
//   work, each recomputing s and dp), which keeps the fp32 accumulators at
//   <= 64 (K2) or 128 (K3) registers. Each output tile is written once, by
//   a TMA store that drops rows past S and columns past D: no atomics, so
//   both kernels are deterministic.
//
// Bound on an H100 SXM at the training shape B=12, H=16, S=1024, D=128,
// bf16, causal (524,800 unmasked pairs per head, 192 heads): K2 does 3
// products over the pairs (s, dp, ds k) = 6 D flops per pair, 77.4 GFLOP,
// ~78 us at the 989 TFLOP/s bf16 tensor-core peak; K3 does 4 (s, dp,
// p^T dO, ds^T q) = 8 D flops per pair, 103 GFLOP, ~104 us. Their bytes
// (q, k, v, dO, lse, delta and one output tensor or two: 253 MB and 303
// MB) take ~76 us and ~91 us at 3.35 TB/s, so the operations bound both.
// Both kernels overlap the loads with the products. K2 also overlaps each
// warpgroup's elementwise work with its own previous product and keeps its
// blocks resident from one query tile to the next, as K1 does; K3 does
// neither yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
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

// -- bf16: wgmma kernels --------------------------------------------------------

constexpr int kKeys = 64;  // keys per K/V tile of K2; S is a multiple of it

// K2 for bf16: wgmma fed by TMA (hopper.cuh). A persistent kernel, as K1
// is: one block per SM, each walking pairs of query tiles (128 rows; 64 at
// D=256) of one (b, h), the last tile with the first, so that under the
// causal mask every pair is the same work and a static schedule balances
// the SMs; the pairs of one head are neighbours, so the blocks at work
// share a few heads' K and V in L2. A block is two consumer warpgroups of
// 64 query rows each (one at D=256) and one producer warpgroup, of which
// one thread issues the TMA loads: Q and dO of a tile into one of two
// slots (one at D=256), so the next tile's arrive while this one's dq
// leaves, and K and V tiles of 64 keys of KV head h / (H / KVH) through
// two rings, from key 0 up to the tile's diagonal (causal) or to S.
// s = Q K^T and dp = dO V^T are wgmmas with both operands in shared
// memory, K-major over the head dim; p = exp2(s scale log2 e - lse log2 e)
// and ds = p (dp - delta) are computed on their fp32 fragments in
// registers and ds is rounded to bf16 there, where it is the A operand of
// dQ += ds K, whose B (the same K tile) is read MN-major through the
// transpose bit: nothing is transposed by hand. Per warpgroup a pipeline
// of depth one: s and dp of key tile t are issued together with dQ += ds K
// of tile t - 1, and the elementwise work of tile t runs while the latter
// is on the tensor cores. (Committing s and dp apart, to compute p while
// dp runs, made ptxas serialize the wgmma, C7514, and was slower.) V's
// slot is free once dp is computed, K's once ds K is. dq sums in fp32
// registers and is written once, through the warpgroup's rows of the Q
// slot and a TMA store: no atomics, deterministic. setmaxnreg gives the
// consumers 232 registers and leaves the producer 40.
template <int D>
struct DqTiles {
  static constexpr int kDp = hopper::pad64(D);    // head dim in shared memory
  static constexpr int kWG = D > 128 ? 1 : 2;     // consumer warpgroups
  static constexpr int kM = 64 * kWG;             // query rows per tile
  // Output columns per item: D=256 splits them in two items, as K3 splits
  // them over gridDim.z.
  static constexpr int kOut = kDp > 128 ? 128 : kDp;
  static constexpr int kSlices = kDp / kOut;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = kM * kDp * 2;      // Q or dO
  static constexpr int kKVBytes = kKeys * kDp * 2;  // one K or V tile
  static constexpr int kRoom = 227 * 1024 - 2048;   // less alignment, barriers
  // Two Q/dO slots, so the next item's Q and dO load while this one's dq
  // leaves through the other, where they fit beside 2 K/V stages (not at
  // D=256); then as many K/V stages as fit, up to 4 (3 at D=128, 2 at
  // D=256).
  static constexpr int kQSlots =
      4 * kQBytes + 4 * kKVBytes <= kRoom ? 2 : 1;
  static constexpr int kFit = (kRoom - 2 * kQSlots * kQBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = 1024 + 2 * kQSlots * kQBytes +
                                  2 * kStages * kKVBytes +
                                  8 * (2 * kQSlots + 4 * kStages);
};

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int BH, int S,
                          int H, int KVH, int causal, float scale) {
  using T = DqTiles<D>;
  constexpr int kDp = T::kDp, kM = T::kM, kOut = T::kOut;
  constexpr int kStages = T::kStages, kQSlots = T::kQSlots;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align_1024(smem_raw);  // kQSlots Q tiles
  uint8_t* sG = sQ + kQSlots * T::kQBytes;     // kQSlots dO tiles
  uint8_t* sK = sG + kQSlots * T::kQBytes;     // kStages K tiles
  uint8_t* sV = sK + kStages * T::kKVBytes;    // kStages V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * T::kKVBytes);
  uint64_t* q_empty = q_full + kQSlots;
  uint64_t* k_full = q_empty + kQSlots;  // K and V rings: full and empty
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // The block's work: items (b*h, k, column slice) for the query tiles
  // n_qt - 1 - k and k of one head, k < cdiv(n_qt, 2), every gridDim.x-th
  // from blockIdx.x (the middle tile of an odd n_qt is a pair of one), as
  // K1 walks them. Under the causal mask every pair is the same work, so
  // this static schedule balances the blocks; the pairs of one head are
  // neighbours, so the blocks at work share a few heads' K/V in L2.
  const int n_qt = (S + kM - 1) / kM;
  const int n_half = (n_qt + 1) / 2;
  const int n_items = BH * n_half * T::kSlices;
  auto tiles_of = [&](int qt) {  // key tiles a query tile needs
    int n = S / kKeys;
    if (causal) n = min(n, (qt + 1) * kM / kKeys);
    return n;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], T::kWG);
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], T::kWG);
      hopper::mbar_init(&v_empty[s], T::kWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    // Producer: one thread keeps the TMA loads in flight, running ahead
    // into the next item while the consumers finish this one.
    if constexpr (T::kWG == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int n = 0, tt = 0;  // query tiles and K/V tiles so far
      for (int p = blockIdx.x; p < n_items; p += gridDim.x) {
        const int pair = p / T::kSlices;
        const int bh = pair / n_half, k = pair % n_half;
        const int b = bh / H, h = bh % H;
        const int kvh = h / (H / KVH);
        for (int sub = 0; sub < 2; ++sub, ++n) {
          const int qt = sub == 0 ? n_qt - 1 - k : k;
          if (sub == 1 && qt == n_qt - 1 - k) break;
          const int qs = n % kQSlots;
          hopper::mbar_wait(&q_empty[qs], ((n / kQSlots) & 1) ^ 1);
          hopper::mbar_expect_tx(&q_full[qs], 2 * T::kQBytes);
          hopper::tma_load_tile<kDp>(sQ + qs * T::kQBytes, kM, &q_map, h,
                                     qt * kM, b, &q_full[qs]);
          hopper::tma_load_tile<kDp>(sG + qs * T::kQBytes, kM, &g_map, h,
                                     qt * kM, b, &q_full[qs]);
          const int n_tiles = tiles_of(qt);
          for (int t = 0; t < n_tiles; ++t) {
            const int s = (tt + t) % kStages;
            const uint32_t parity = (((tt + t) / kStages) & 1) ^ 1;
            hopper::mbar_wait(&k_empty[s], parity);
            hopper::mbar_expect_tx(&k_full[s], T::kKVBytes);
            hopper::tma_load_tile<kDp>(sK + s * T::kKVBytes, kKeys, &k_map,
                                       kvh, t * kKeys, b, &k_full[s]);
            hopper::mbar_wait(&v_empty[s], parity);
            hopper::mbar_expect_tx(&v_full[s], T::kKVBytes);
            hopper::tma_load_tile<kDp>(sV + s * T::kKVBytes, kKeys, &v_map,
                                       kvh, t * kKeys, b, &v_full[s]);
          }
          tt += n_tiles;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows row_wg .. row_wg + 63 of each
  // query tile and computes its key tiles 0 .. n_mine - 1: up to its
  // diagonal when causal, none when its rows lie wholly past S (S is a
  // multiple of 64). The tile's other key tiles it waits for and frees
  // without computing (warpgroup 0's last, under the causal mask), so
  // every slot is freed by both. Per key tile a pipeline of depth one:
  // s and dp of tile t are issued together with dQ += ds K of tile t - 1,
  // and p and ds of tile t are computed while the latter is still on the
  // tensor cores.
  if constexpr (T::kWG == 2) hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int tq = lane % 4;
  const int r_lo = 16 * (tid / 32) + lane / 4;  // query rows r_lo, r_lo + 8
  const float sl2 = scale * kLog2e;

  int n = 0, tt = 0;
  for (int p = blockIdx.x; p < n_items; p += gridDim.x) {
    const int pair = p / T::kSlices;
    const int c_lo = (p % T::kSlices) * kOut;
    const int bh = pair / n_half, k = pair % n_half;
    const int b = bh / H, h = bh % H;
    for (int sub = 0; sub < 2; ++sub, ++n) {
      const int qt = sub == 0 ? n_qt - 1 - k : k;
      if (sub == 1 && qt == n_qt - 1 - k) break;
      const int qs = n % kQSlots;
      uint8_t* tQ = sQ + qs * T::kQBytes;
      const uint8_t* tG = sG + qs * T::kQBytes;
      const int row_wg = qt * kM + 64 * c;
      const int n_tiles = tiles_of(qt);
      int n_mine = row_wg < S ? n_tiles : 0;
      if (causal && row_wg < S) n_mine = row_wg / kKeys + 1;

      hopper::mbar_wait(&q_full[qs], (n / kQSlots) & 1);
      if (n_mine > 0) {
        const int qpos[2] = {row_wg + r_lo, row_wg + r_lo + 8};
        float lse2[2], dl[2];  // lse in log2 units, and delta, of both rows
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          lse2[half] = lse[(size_t)bh * S + qpos[half]] * kLog2e;
          dl[half] = delta[(size_t)bh * S + qpos[half]];
        }
        float dq[kOut / 2];
#pragma unroll
        for (int i = 0; i < kOut / 2; ++i) dq[i] = 0.f;
        uint32_t da[kKeys / 16][4];  // ds of tile t - 1 in bf16: dQ's A

        for (int t = 0; t < n_mine; ++t) {
          const int s = (tt + t) % kStages;
          const int sp = (tt + t + kStages - 1) % kStages;  // tile t - 1's
          const uint32_t parity = ((tt + t) / kStages) & 1;
          hopper::mbar_wait(&k_full[s], parity);
          hopper::mbar_wait(&v_full[s], parity);
          float sc[kKeys / 2], dp[kKeys / 2];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kDp / 16; ++kk)
            hopper::wgmma_ss(sc, hopper::desc_k_major(tQ, kM, 64 * c, kk),
                             hopper::desc_k_major(sK + s * T::kKVBytes, kKeys,
                                                  0, kk),
                             kk > 0);
#pragma unroll
          for (int kk = 0; kk < kDp / 16; ++kk)
            hopper::wgmma_ss(dp, hopper::desc_k_major(tG, kM, 64 * c, kk),
                             hopper::desc_k_major(sV + s * T::kKVBytes, kKeys,
                                                  0, kk),
                             kk > 0);
          hopper::wgmma_commit();
          if (t > 0) {
            // K read MN-major: the product contracts over the keys.
#pragma unroll
            for (int kk = 0; kk < kKeys / 16; ++kk)
              hopper::wgmma_rs(dq, da[kk],
                               hopper::desc_mn_major(sK + sp * T::kKVBytes,
                                                     kKeys, c_lo / 64, kk),
                               1);
            hopper::wgmma_commit();
            hopper::wgmma_wait<1>();  // s and dp are ready; ds K runs on
          } else {
            hopper::wgmma_wait<0>();
          }
          hopper::fence_regs(sc);
          hopper::fence_regs(dp);
          hopper::release(&v_empty[s]);

          // p = exp(s scale - lse), zeroed where the key follows the
          // query (causal: only on the diagonal tile); ds = p (dp -
          // delta), in sc.
          const bool mask = causal && t == n_mine - 1;
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * half + e;
                float pr = hopper::ex2(fmaf(sc[i], sl2, -lse2[half]));
                if (mask && t * kKeys + 8 * j + 2 * tq + e > qpos[half])
                  pr = 0.f;
                sc[i] = pr * (dp[i] - dl[half]);
              }

          hopper::wgmma_wait<0>();  // dq and da are free again
          hopper::fence_regs(dq);
          if (t > 0) hopper::release(&k_empty[sp]);
          // The accumulator's fragments of ds are the A operand of ds K:
          // key columns 16kk..16kk+15 are column tiles 2kk and 2kk + 1.
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              da[kk][i] = pack_bf16(sc[8 * kk + 2 * i],
                                    sc[8 * kk + 2 * i + 1]);
        }
        {  // dQ += ds K of the last tile
          const int s = (tt + n_mine - 1) % kStages;
          hopper::fence_regs(dq);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk)
            hopper::wgmma_rs(dq, da[kk],
                             hopper::desc_mn_major(sK + s * T::kKVBytes,
                                                   kKeys, c_lo / 64, kk),
                             1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dq);
          hopper::release(&k_empty[s]);
        }

        // dq * scale in bf16, through this warpgroup's rows of its Q slot
        // (their last reader was the S product above), then one TMA store
        // per column box: rows past S and columns past D are not written.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 64 * c + r_lo + 8 * half;
#pragma unroll
          for (int j = 0; j < kOut / 8; ++j)
            hopper::st_swizzled(tQ, kM, r, 8 * j + 2 * tq,
                                pack_bf16(dq[4 * j + 2 * half] * scale,
                                          dq[4 * j + 2 * half + 1] * scale));
        }
        hopper::fence_async_shared();
        hopper::warpgroup_sync(1 + c);
        if (tid == 0) {
#pragma unroll
          for (int bx = 0; bx < kOut / 64; ++bx)
            if (c_lo + bx * 64 < D)
              hopper::tma_store(&dq_map,
                                tQ + (bx * kM + 64 * c) * hopper::kRowBytes,
                                c_lo + bx * 64, h, row_wg, b);
          hopper::tma_store_wait();
        }
      }
      // The key tiles past this warpgroup's diagonal (or all, past S).
      for (int t = n_mine; t < n_tiles; ++t) {
        const int s = (tt + t) % kStages;
        const uint32_t parity = ((tt + t) / kStages) & 1;
        hopper::mbar_wait(&k_full[s], parity);
        hopper::mbar_wait(&v_full[s], parity);
        hopper::release(&k_empty[s]);
        hopper::release(&v_empty[s]);
      }
      // The slot is free for the next Q once the store has read it.
      hopper::release(&q_empty[qs]);
      tt += n_tiles;
    }
  }
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
    using T = DqTiles<D>;
    CUtensorMap q_map, k_map, v_map, g_map, dq_map;
    if ((err = hopper::make_map(&q_map, a.q, a.B, a.S, a.H, D)) != cudaSuccess ||
        (err = hopper::make_map(&k_map, a.k, a.B, a.S, a.KVH, D)) != cudaSuccess ||
        (err = hopper::make_map(&v_map, a.v, a.B, a.S, a.KVH, D)) != cudaSuccess ||
        (err = hopper::make_map(&g_map, a.g, a.B, a.S, a.H, D)) != cudaSuccess ||
        (err = hopper::make_map(&dq_map, a.out0, a.B, a.S, a.H, D)) !=
            cudaSuccess)
      return err;
    // Persistent: one block per SM, or one per item if fewer.
    int sms = 0;
    if ((err = hopper::prepare_launch<flash_bwd_dq_wgmma_kernel<D>>(
             T::kSmem, &sms)) != cudaSuccess)
      return err;
    const long long items = (long long)a.B * a.H *
                            (((a.S + T::kM - 1) / T::kM + 1) / 2) * T::kSlices;
    const int grid = (int)(items < sms ? items : sms);
    flash_bwd_dq_wgmma_kernel<D><<<grid, T::kThreads, T::kSmem, a.stream>>>(
        q_map, k_map, v_map, g_map, dq_map, lse, delta, a.B * a.H, a.S, a.H,
        a.KVH, a.causal, a.scale);
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
  if (a.B < 1 || a.S < kKeys || a.S % kKeys || a.KVH < 1 || a.H % a.KVH ||
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

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (wgmma kernels). q, dO
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
