// K1: flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces ray_tpu/ops/flash_attention.py::_flash_fwd_kernel, the Pallas
// TPU kernel. It computes what that kernel computes: per (batch, head) and
// per query row, an online softmax over the key/value rows in fp32, with q
// scaled by 1/sqrt(D) in fp32, masked logits filled with -1e30 and their
// probabilities zeroed, l floored at 1e-30, out = o / l in the input dtype
// and lse = m + log(l) in fp32. Key tiles wholly past a query tile's last
// row are skipped when causal. Tile sizes are the kernels' own; they change
// only the order of the fp32 sums, not what is summed.
//
// Layout. q is [B, S, H, D], k and v are [B, S, KVH, D], all contiguous;
// out is [B, S, H, D] and lse is [B*H, S]. The kernel reads the key/value
// head h / (H / KVH) itself, so the host neither transposes nor repeats
// heads for GQA.
//
// Two kernels, one per input type:
//
// - flash_fwd_fma_kernel (fp32 inputs): plain fp32 FMA, no TF32, since K1
//   computes in fp32. One block of 128 threads per (b*h, 64 query rows);
//   each 64-row key tile and value tile is staged through shared memory as
//   fp32 (the query tile pre-scaled); thread t owns 4 query rows (t / 8)
//   and, of each 64-wide score tile, the 8 columns t % 8 + 8j, so a row's
//   max and sum reduce over 8 neighbouring lanes with warp shuffles.
// - flash_fwd_wgmma_kernel (bf16 inputs): Hopper's wgmma fed by TMA (the
//   machinery is in hopper.cuh). A persistent kernel: one block per SM,
//   each walking pairs of 128-row query tiles of one (b, h), the last
//   tile with the first, so that under the causal mask every pair is the
//   same work and a static schedule balances the SMs. A block is two
//   consumer warpgroups of 64 query rows each and one producer
//   warpgroup, of which one thread issues the TMA loads: Q into one of
//   two slots (one at D=256), so the next tile's Q arrives while this
//   one's output leaves, and K and V tiles (128 keys; 64 at D=256, where
//   the accumulators and shared memory would not fit) through two rings,
//   each stage with a full barrier and an empty barrier that each
//   consumer warpgroup arrives on once. K's slot is free once S is
//   computed, V's once P V is, and V is loaded a tile behind K, as it is
//   consumed; tiles past the causal cutoff min(cdiv(q_end, kN),
//   cdiv(S, kN)) are never loaded. S = Q K^T is a wgmma with both
//   operands in shared memory, K-major. The online softmax runs on its
//   fp32 fragments in registers (exp2 of log2e-prescaled scores on the
//   special-function unit; the mask only on the tiles that reach the
//   diagonal or the end of the sequence) while the previous tile's
//   O += P V still runs; P is rounded to bf16 in registers, where the
//   accumulator's fragments are the A operand of that product, whose B
//   is the V tile read MN-major through the transpose bit, so nothing is
//   transposed by hand. The bf16 rounding of p is the one rounding the
//   fp32 reference does not make (~2^-9 relative per term); every sum
//   stays fp32. q, k and v are read through 4-D tensor maps (D, heads, S,
//   B) of their own layout, so the host neither transposes nor repeats
//   heads, rows past S read as zeros, and head dims 16, 32 and 80 are
//   padded to a multiple of 64 in shared memory by the same zero fill.
//   out goes back through the Q slot and a TMA store, which drops rows
//   past S and columns past D. setmaxnreg gives the consumers 232
//   registers and leaves the producer 40.
//
// Bound on an H100 SXM at the serving shape B=4, H=16, S=1024, D=128,
// bf16, causal: 4*B*H*D*S*(S+1)/2 = 17.2 GFLOP, ~17 us at the 989 TFLOP/s
// bf16 tensor-core peak; q, k, v and out are 67 MB, ~20 us at 3.35 TB/s.
// So the least time is ~20 us, set by the bytes (at the training shape,
// B=12, ~60 us). Yet the kernel is held by neither: K and V come from L2
// after a head's first tile, and at these short sequences (4.5 key tiles
// per query tile on average) what costs is each tile's fixed work
// (Q's arrival, the pipeline's fill and drain, the epilogue), which the
// persistent blocks overlap only in part, and the softmax's exp2 and
// rescale, which the overlap with P V hides only in part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
using flash::kNegInf;
using flash::pack_bf16;

constexpr int kBlockM = 64;          // query rows per thread block
constexpr int kBlockN = 64;          // key/value rows per tile
constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;    // 16 row groups x 4 rows = kBlockM
constexpr int kColLanes = 8;         // lanes sharing one row group
constexpr int kColsPerLane = kBlockN / kColLanes;
// FMA kernel: row pitch of the probability tile; 66 puts the 4 row groups of a warp 8
// banks apart, so a warp's 32 stores hit 32 banks.
constexpr int kLdP = kBlockN + 2;

static_assert(kThreads == (kBlockM / kRowsPerThread) * kColLanes,
              "thread layout must cover the tile");

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// fp32 words of shared memory for head dim D. A row pitch of D + 1 words
// spreads the rows a warp reads at once over distinct banks.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBlockM + 2 * kBlockN) * (D + 1) +
                          (size_t)kBlockM * kLdP);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int KVH,
                     int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDCols = D / kColLanes;  // output columns per thread
  static_assert(D % kColLanes == 0, "head dim must be a multiple of 8");

  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;
  float* sK = sQ + kBlockM * kLd;
  float* sV = sK + kBlockN * kLd;
  float* sP = sV + kBlockN * kLd;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  // The heaviest causal tiles (last query rows) are scheduled first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int tid = threadIdx.x;
  const int row0 = (tid / kColLanes) * kRowsPerThread;
  const int lane_c = tid % kColLanes;

  const size_t q_pitch = (size_t)H * D;     // between sequence positions
  const size_t kv_pitch = (size_t)KVH * D;
  const float* q_base = q + ((size_t)b * S * H + h) * D;
  const float* k_base = k + ((size_t)b * S * KVH + kvh) * D;
  const float* v_base = v + ((size_t)b * S * KVH + kvh) * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    sQ[r * kLd + c] = q_base[(size_t)(q0 + r) * q_pitch + c] * scale;
  }

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kDCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = S / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM + kBlockN - 1) / kBlockN);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    // Every thread is done with the previous tile's sK/sV/sP (and, on the
    // first pass, has stored its part of sQ).
    __syncthreads();
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const size_t g = (size_t)(k0 + r) * kv_pitch + c;
      sK[r * kLd + c] = k_base[g];
      sV[r * kLd + c] = v_base[g];
    }
    __syncthreads();

    // Scores: s[i][j] = q[row0 + i] . k[lane_c + 8j]
    float s[kRowsPerThread][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kColsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = sQ[(row0 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        kv[j] = sK[(lane_c + kColLanes * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax update, one row at a time.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qpos = q0 + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        if (causal && qpos < k0 + lane_c + kColLanes * j) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const bool masked = causal && qpos < k0 + lane_c + kColLanes * j;
        // A row with every key masked so far keeps m == -1e30, where
        // exp(s - m) would be 1: the mask, not the exponent, zeroes it.
        const float p = masked ? 0.f : expf(s[i][j] - m_new);
        sP[(row0 + i) * kLdP + lane_c + kColLanes * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[i][j] += sum_c p[row0 + i][c] * v[c][lane_c + 8j]
#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = sP[(row0 + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        const float vv = sV[c * kLd + lane_c + kColLanes * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qpos = q0 + row0 + i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* o_row = out + (((size_t)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j)
      o_row[lane_c + kColLanes * j] = acc[i][j] / l_safe;
    if (lane_c == 0) lse[(size_t)bh * S + qpos] = m[i] + logf(l_safe);
  }
}

// -- bf16: wgmma kernel ----------------------------------------------------------

constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdTiles {
  static constexpr int kDp = hopper::pad64(D);  // head dim in shared memory
  static constexpr int kWG = 2;                 // consumer warpgroups
  static constexpr int kM = 64 * kWG;           // query rows per block
  static constexpr int kN = D > 128 ? 64 : 128; // keys per K/V tile
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = kM * kDp * 2;
  static constexpr int kKVBytes = kN * kDp * 2;  // one K or V tile
  static constexpr int kRoom = 227 * 1024 - 2048;  // less alignment, barriers
  // Two Q slots, so the next item's Q loads while this one's output goes
  // out through the other, where they fit beside 2 K/V stages (not at
  // D=256); then as many K/V stages as fit, up to 4 (2 at D=128 and 256).
  static constexpr int kQSlots =
      2 * kQBytes + 4 * kKVBytes <= kRoom ? 2 : 1;
  static constexpr int kFit = (kRoom - kQSlots * kQBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // 1024 bytes of slack to align the tiles, then the barriers.
  static constexpr size_t kSmem = 1024 + kQSlots * kQBytes +
                                  2 * kStages * kKVBytes +
                                  8 * (2 * kQSlots + 4 * kStages);
};

// One K/V tile's online-softmax update of this thread's two rows. sc holds
// the raw scores (keys k0 + 8j + 2tq + e of rows qpos[0] in sc[4j + e],
// qpos[1] in sc[4j + 2 + e]) and leaves with the probabilities; m is the
// running max in log2 units (scores times sl2 = scale * log2 e), l the
// running sum, and corr the factor exp2(m_old - m_new) by which the caller
// rescales o. kMask applies the causal mask and the end of the sequence
// (keys >= S), only on the tiles that reach either.
template <bool kMask, int kN>
__device__ __forceinline__ void online_softmax(float (&sc)[kN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2],
                                               const int (&qpos)[2], int k0,
                                               int S, int causal, float sl2,
                                               int tq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * half + e];
        if (kMask) {
          const int key = k0 + 8 * j + 2 * tq + e;
          if ((causal && key > qpos[half]) || key >= S) x = kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[half], mx * sl2);  // sl2 > 0
    corr[half] = hopper::ex2(m[half] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * half + e];
        float p = hopper::ex2(fmaf(x, sl2, -m_new));
        if (kMask) {
          // A row with every key masked so far has m_new = -1e30 * sl2,
          // where the exponent would give 1: the mask, not the exponent,
          // zeroes it.
          const int key = k0 + 8 * j + 2 * tq + e;
          if ((causal && key > qpos[half]) || key >= S) p = 0.f;
        }
        x = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[half] = l[half] * corr[half] + rs;
    m[half] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap out_map,
                       float* __restrict__ lse, int BH, int S, int H, int KVH,
                       int causal, float scale) {
  using T = FwdTiles<D>;
  constexpr int kDp = T::kDp, kM = T::kM, kN = T::kN, kStages = T::kStages;
  constexpr int kQSlots = T::kQSlots;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align_1024(smem_raw);
  uint8_t* sK = sQ + kQSlots * T::kQBytes;    // kStages tiles of kN rows
  uint8_t* sV = sK + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * T::kKVBytes);
  uint64_t* q_empty = q_full + kQSlots;
  uint64_t* k_full = q_empty + kQSlots;  // K and V rings: full and empty
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // The block's work: pairs (b*h, k) of the query tiles n_qt - 1 - k and
  // k of one head, for k < cdiv(n_qt, 2), every gridDim.x-th pair from
  // blockIdx.x (the middle tile of an odd n_qt is a pair of one). Under
  // the causal mask every pair is the same work, so this static schedule
  // balances the blocks; the pairs of one head are neighbours, so the
  // blocks at work share a few heads' K/V in L2.
  const int n_qt = (S + kM - 1) / kM;
  const int n_half = (n_qt + 1) / 2;
  const int n_pairs = BH * n_half;
  auto tiles_of = [&](int qt) {
    int n = (S + kN - 1) / kN;
    if (causal) n = min(n, ((qt + 1) * kM + kN - 1) / kN);
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
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int n = 0, tt = 0;  // items and K/V tiles so far
      for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
        const int bh = p / n_half, k = p % n_half;
        const int b = bh / H, h = bh % H;
        const int kvh = h / (H / KVH);
        for (int sub = 0; sub < 2; ++sub, ++n) {
          const int qt = sub == 0 ? n_qt - 1 - k : k;
          if (sub == 1 && qt == n_qt - 1 - k) break;
          const int qs = n % kQSlots;
          hopper::mbar_wait(&q_empty[qs], ((n / kQSlots) & 1) ^ 1);
          hopper::mbar_expect_tx(&q_full[qs], T::kQBytes);
          hopper::tma_load_tile<kDp>(sQ + qs * T::kQBytes, kM, &q_map, h,
                                     qt * kM, b, &q_full[qs]);
          // V_t is consumed a step after K_t (see the consumers), so it is
          // loaded a step later: a K load never queues behind a V slot.
          const int n_tiles = tiles_of(qt);
          for (int t = 0; t <= n_tiles; ++t) {
            if (t < n_tiles) {
              const int s = (tt + t) % kStages;
              hopper::mbar_wait(&k_empty[s], (((tt + t) / kStages) & 1) ^ 1);
              hopper::mbar_expect_tx(&k_full[s], T::kKVBytes);
              hopper::tma_load_tile<kDp>(sK + s * T::kKVBytes, kN, &k_map,
                                         kvh, t * kN, b, &k_full[s]);
            }
            if (t > 0) {
              const int s = (tt + t - 1) % kStages;
              hopper::mbar_wait(&v_empty[s],
                                (((tt + t - 1) / kStages) & 1) ^ 1);
              hopper::mbar_expect_tx(&v_full[s], T::kKVBytes);
              hopper::tma_load_tile<kDp>(sV + s * T::kKVBytes, kN, &v_map,
                                         kvh, (t - 1) * kN, b, &v_full[s]);
            }
          }
          tt += n_tiles;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows 64c .. 64c + 63 of each tile.
  // Per item, a pipeline of depth one: S_t = Q K_t^T is issued together
  // with O += P_{t-1} V_{t-1}, and the softmax of S_t runs while the
  // latter is still on the tensor cores. The two warpgroups run
  // independently, each overlapping the other. (Making them take turns
  // to issue, as FlashAttention-3's ping-pong does, measured no faster
  // here.) Both walk every key tile of the item; one wholly past a
  // warpgroup's rows (D=256, causal) is masked to zero.
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int tq = lane % 4;
  const int r_lo = 16 * (tid / 32) + lane / 4;  // rows r_lo, r_lo + 8
  const float sl2 = scale * kLog2e;

  int n = 0, tt = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const int bh = p / n_half, k = p % n_half;
    const int b = bh / H, h = bh % H;
    for (int sub = 0; sub < 2; ++sub, ++n) {
      const int qt = sub == 0 ? n_qt - 1 - k : k;
      if (sub == 1 && qt == n_qt - 1 - k) break;
      const int qs = n % kQSlots;
      uint8_t* tQ = sQ + qs * T::kQBytes;
      const int row_wg = qt * kM + 64 * c;
      const int qpos[2] = {row_wg + r_lo, row_wg + r_lo + 8};
      const int n_tiles = tiles_of(qt);
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};
      float o[kDp / 2];
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
      uint32_t pa[kN / 16][4];  // P_{t-1} in bf16, the A operand of P V

      hopper::mbar_wait(&q_full[qs], (n / kQSlots) & 1);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = (tt + t) % kStages;
        const int sp = (tt + t + kStages - 1) % kStages;  // tile t - 1's
        const int k0 = t * kN;
        hopper::mbar_wait(&k_full[s], ((tt + t) / kStages) & 1);
        if (t > 0)
          hopper::mbar_wait(&v_full[sp], ((tt + t - 1) / kStages) & 1);
        float sc[kN / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDp / 16; ++kk)
          hopper::wgmma_ss(sc, hopper::desc_k_major(tQ, kM, 64 * c, kk),
                           hopper::desc_k_major(sK + s * T::kKVBytes, kN, 0,
                                                kk),
                           kk > 0);
        hopper::wgmma_commit();
        if (t > 0) {
          // V read MN-major: no transpose through registers.
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk)
            hopper::wgmma_rs(o, pa[kk],
                             hopper::desc_mn_major(sV + sp * T::kKVBytes, kN,
                                                   0, kk),
                             1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // S_t is ready; P V may run on
        } else {
          hopper::wgmma_wait<0>();
        }
        hopper::fence_regs(sc);
        hopper::release(&k_empty[s]);

        float corr[2];
        if ((causal && k0 + kN - 1 > row_wg) || k0 + kN > S)
          online_softmax<true, kN>(sc, m, l, corr, qpos, k0, S, causal, sl2,
                                   tq);
        else
          online_softmax<false, kN>(sc, m, l, corr, qpos, k0, S, causal, sl2,
                                    tq);

        hopper::wgmma_wait<0>();  // o and pa are free again
        hopper::fence_regs(o);
        if (t > 0) hopper::release(&v_empty[sp]);
#pragma unroll
        for (int j = 0; j < kDp / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        // The accumulator's fragments of P are the A operand of P V: key
        // columns 16kk..16kk+15 are column tiles 2kk and 2kk + 1.
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      }
      {  // O += P V of the last tile
        const int s = (tt + n_tiles - 1) % kStages;
        hopper::mbar_wait(&v_full[s], ((tt + n_tiles - 1) / kStages) & 1);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          hopper::wgmma_rs(o, pa[kk],
                           hopper::desc_mn_major(sV + s * T::kKVBytes, kN, 0,
                                                 kk),
                           1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::release(&v_empty[s]);
      }
      tt += n_tiles;

      // out = o / l in bf16, through this warpgroup's rows of its Q slot
      // (their last reader was the wait above), then one TMA store per
      // column box: rows past S and columns past D are not written. The
      // slot is free for the next Q once the stores have read it.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // One reciprocal a row: a division per element was a measurable
        // share of the kernel.
        const float l_safe = fmaxf(l[half], 1e-30f);
        const float inv = 1.f / l_safe;
        const int r = 64 * c + r_lo + 8 * half;
#pragma unroll
        for (int j = 0; j < kDp / 8; ++j)
          hopper::st_swizzled(tQ, kM, r, 8 * j + 2 * tq,
                              pack_bf16(o[4 * j + 2 * half] * inv,
                                        o[4 * j + 2 * half + 1] * inv));
        if (tq == 0 && qpos[half] < S)
          lse[(size_t)bh * S + qpos[half]] = m[half] * kLn2 + logf(l_safe);
      }
      hopper::fence_async_shared();
      hopper::warpgroup_sync(1 + c);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < kDp / 64; ++bx)
          if (bx * 64 < D)
            hopper::tma_store(&out_map,
                              tQ + (bx * kM + 64 * c) * hopper::kRowBytes,
                              bx * 64, h, row_wg, b);
        hopper::tma_store_wait();
      }
      hopper::release(&q_empty[qs]);
    }
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int S, int H, int KVH, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB a block's dynamic shared memory must be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / kBlockM);
  flash_fwd_fma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), S, H, KVH, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int S, int H, int KVH,
                         int causal, float scale, cudaStream_t stream) {
  using T = FwdTiles<D>;
  CUtensorMap q_map, k_map, v_map, out_map;
  cudaError_t err;
  if ((err = hopper::make_map(&q_map, q, B, S, H, D)) != cudaSuccess ||
      (err = hopper::make_map(&k_map, k, B, S, KVH, D)) != cudaSuccess ||
      (err = hopper::make_map(&v_map, v, B, S, KVH, D)) != cudaSuccess ||
      (err = hopper::make_map(&out_map, out, B, S, H, D)) != cudaSuccess)
    return err;
  // Persistent: one block per SM, or one per pair of query tiles if fewer.
  int sms = 0;
  err = hopper::prepare_launch<flash_fwd_wgmma_kernel<D>>(T::kSmem, &sms);
  if (err != cudaSuccess) return err;
  const long long pairs =
      (long long)B * H * (((S + T::kM - 1) / T::kM + 1) / 2);
  const int grid = (int)(pairs < sms ? pairs : sms);
  flash_fwd_wgmma_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      q_map, k_map, v_map, out_map, static_cast<float*>(lse), B * H, S, H,
      KVH, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, void* lse, int B, int S, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  return dtype == 0 ? launch_fma<D>(q, k, v, out, lse, B, S, H, KVH, causal,
                                    scale, stream)
                    : launch_wgmma<D>(q, k, v, out, lse, B, S, H, KVH,
                                      causal, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel). Returns a
// cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// shapes the kernels do not take.
int ray_tpu_flash_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int B, int S, int H, int KVH, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (B < 1 || S < kBlockM || S % kBlockM || KVH < 1 || H % KVH ||
      S / kBlockM > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, out, lse, B, S, H, KVH, causal, scale, st);
    case 32: return launch<32>(dtype, q, k, v, out, lse, B, S, H, KVH, causal, scale, st);
    case 64: return launch<64>(dtype, q, k, v, out, lse, B, S, H, KVH, causal, scale, st);
    case 80: return launch<80>(dtype, q, k, v, out, lse, B, S, H, KVH, causal, scale, st);
    case 128: return launch<128>(dtype, q, k, v, out, lse, B, S, H, KVH, causal, scale, st);
    case 256: return launch<256>(dtype, q, k, v, out, lse, B, S, H, KVH, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ray_tpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
