// K1: flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces ray_tpu/ops/flash_attention.py::_flash_fwd_kernel, the Pallas
// TPU kernel. It computes what that kernel computes: per (batch, head) and
// per query row, an online softmax over the key/value rows in fp32, with q
// scaled by 1/sqrt(D) in fp32, masked logits filled with -1e30 and their
// probabilities zeroed, l floored at 1e-30, out = o / l in the input dtype
// and lse = m + log(l) in fp32. Key tiles wholly past a query tile's last
// row are skipped when causal. Tile sizes are this kernel's own (64 x 64);
// they change only the order of the fp32 sums, not what is summed.
//
// Layout. q is [B, S, H, D], k and v are [B, S, KVH, D], all contiguous;
// out is [B, S, H, D] and lse is [B*H, S]. The kernel reads the key/value
// head h / (H / KVH) itself, so the host neither transposes nor repeats
// heads for GQA.
//
// Design. One thread block of 128 threads (4 warps) per (b*h, 64-row query
// tile); each 64-row key tile and value tile is staged through shared
// memory, and tiles past the causal cutoff are never loaded. Running max,
// sum and the output accumulator stay in fp32 registers. Two kernels share
// that skeleton and differ in how they multiply:
//
// - flash_fwd_fma_kernel (fp32 inputs): plain fp32 FMA, no TF32, since K1
//   computes in fp32. Tiles sit in shared memory as fp32 (the query tile
//   pre-scaled); thread t owns 4 query rows (t / 8) and, of each 64-wide
//   score tile, the 8 columns t % 8 + 8j, so a row's max and sum reduce
//   over 8 neighbouring lanes with warp shuffles.
// - flash_fwd_mma_kernel (bf16 inputs): tensor cores through
//   mma.sync.m16n8k16 (bf16 x bf16 -> fp32). Warp w owns query rows
//   16w..16w+15; scores are exact fp32 sums of bf16 products, scaled by
//   1/sqrt(D) in fp32 afterwards. The probabilities are rounded to bf16 to
//   multiply the values (the one rounding the fp32 reference does not
//   make, ~2^-9 relative per term); sums stay fp32. The value tile is
//   stored transposed so each mma operand is one 32-bit shared load.
//
// Bound on an H100 SXM at the serving shape B=4, H=16, S=1024, D=128,
// bf16, causal: 4*B*H*D*S*(S+1)/2 = 17.2 GFLOP, ~17 us at the 989 TFLOP/s
// bf16 tensor-core peak; q, k, v and out are 67 MB, ~20 us at 3.35 TB/s.
// So the least time is ~20 us, set by the bytes. This first design is far
// from it: mma.sync reaches only part of the tensor-core rate that wgmma
// does, every tile load is synchronous (no cp.async/TMA double buffering),
// and each key/value tile is re-read from L2 by every query tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::mma_bf16;
using flash::mma_pitch;
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

// Pitch of the transposed value tile, in bf16 elements (see mma_pitch).
constexpr int kVtPitch = kBlockN + 8;

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBlockM + kBlockN) * mma_pitch<D>() + (size_t)D * kVtPitch);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int S, int H, int KVH, int causal, float scale) {
  constexpr int kP = mma_pitch<D>();
  constexpr int kPw = kP / 2;          // pitch in 32-bit words
  constexpr int kVtw = kVtPitch / 2;
  constexpr int kPairs = D / 2;        // bf16 pairs per row
  constexpr int kNTiles = kBlockN / 8; // 8-key column tiles of a score tile
  constexpr int kDTiles = D / 8;       // 8-wide column tiles of the output
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kThreads == 4 * 32 && kBlockM == 4 * 16,
                "4 warps of 16 query rows");

  extern __shared__ uint32_t smem_u32[];
  uint32_t* sQ = smem_u32;                    // kBlockM x kP bf16
  uint32_t* sK = sQ + kBlockM * kPw;          // kBlockN x kP bf16
  __nv_bfloat16* sVt =                        // D x kVtPitch bf16: v^T
      reinterpret_cast<__nv_bfloat16*>(sK + kBlockN * kPw);
  const uint32_t* sVt32 = reinterpret_cast<const uint32_t*>(sVt);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;  // fragment row within 8
  const int tg = tid % 4;        // fragment column pair

  // One row of q/k/v is D bf16 = kPairs 32-bit words (D is even and the
  // tensors are contiguous, so every row starts 4-byte aligned).
  const size_t q_pitch = (size_t)H * kPairs;
  const size_t kv_pitch = (size_t)KVH * kPairs;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q) +
                        ((size_t)b * S * H + h) * kPairs;
  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k) +
                        ((size_t)b * S * KVH + kvh) * kPairs;
  const uint32_t* v32 = reinterpret_cast<const uint32_t*>(v) +
                        ((size_t)b * S * KVH + kvh) * kPairs;

  for (int i = tid; i < kBlockM * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = i - r * kPairs;
    sQ[r * kPw + c] = q32[(size_t)(q0 + r) * q_pitch + c];
  }

  const int r_lo = warp * 16 + g;  // this thread's two rows in the tile
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int n_tiles = S / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM + kBlockN - 1) / kBlockN);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();
    for (int i = tid; i < kBlockN * kPairs; i += kThreads) {
      const int r = i / kPairs;
      const int c = i - r * kPairs;
      const size_t gi = (size_t)(k0 + r) * kv_pitch + c;
      sK[r * kPw + c] = k32[gi];
      const uint32_t vv = v32[gi];
      sVt[(2 * c) * kVtPitch + r] = __ushort_as_bfloat16((unsigned short)(vv & 0xffffu));
      sVt[(2 * c + 1) * kVtPitch + r] = __ushort_as_bfloat16((unsigned short)(vv >> 16));
    }
    __syncthreads();

    // Scores of rows (r_lo, r_lo + 8) against the tile's 64 keys: s[n] holds
    // keys 8n + 2tg + {0, 1} of row r_lo in [0..1], of row r_lo + 8 in [2..3].
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cw = kk * 8 + tg;  // word column of pairs (16kk + 2tg)
      const uint32_t a[4] = {sQ[r_lo * kPw + cw], sQ[(r_lo + 8) * kPw + cw],
                             sQ[r_lo * kPw + cw + 4],
                             sQ[(r_lo + 8) * kPw + cw + 4]};
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const uint32_t* krow = sK + (n * 8 + g) * kPw;
        mma_bf16(s[n], a, krow[cw], krow[cw + 4]);
      }
    }

    // Online softmax update of this thread's two rows; the 4 lanes of a
    // fragment row group (xor 1, 2) hold the rest of each row.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * half + e] * scale;
          if (causal && qpos[half] < k0 + n * 8 + 2 * tg + e) x = kNegInf;
          s[n][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float corr = expf(m[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool masked = causal && qpos[half] < k0 + n * 8 + 2 * tg + e;
          const float p = masked ? 0.f : expf(s[n][2 * half + e] - m_new);
          s[n][2 * half + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[half] = l[half] * corr + rs;
      m[half] = m_new;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        o[j][2 * half] *= corr;
        o[j][2 * half + 1] *= corr;
      }
    }

    // o += p v: the score fragments of key columns 16kk..16kk+15 are the
    // a-fragment of p for that k-step.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int cw = kk * 8 + tg;  // word column of key pairs (16kk + 2tg)
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const uint32_t* vrow = sVt32 + (j * 8 + g) * kVtw;
        mma_bf16(o[j], a, vrow[cw], vrow[cw + 4]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float l_safe = fmaxf(l[half], 1e-30f);
    uint32_t* o_row = reinterpret_cast<uint32_t*>(out) +
                      (((size_t)b * S + qpos[half]) * H + h) * kPairs;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
      o_row[j * 4 + tg] = pack_bf16(o[j][2 * half] / l_safe,
                                    o[j][2 * half + 1] / l_safe);
    if (tg == 0) lse[(size_t)bh * S + qpos[half]] = m[half] + logf(l_safe);
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
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int S, int H, int KVH, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / kBlockM);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, H, KVH, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, void* lse, int B, int S, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  return dtype == 0 ? launch_fma<D>(q, k, v, out, lse, B, S, H, KVH, causal,
                                    scale, stream)
                    : launch_mma<D>(q, k, v, out, lse, B, S, H, KVH, causal,
                                    scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (mma kernel). Returns a
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
