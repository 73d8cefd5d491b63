// Kernel K2-f32: bidirectional flash attention in float32 for Hopper (sm_90a).
//
// Replaces the TPU kernel behind ser_tpu/models/attention.py::_flash_path
// (jax.experimental.pallas.ops.tpu.flash_attention) when it is handed float32
// operands: the wav2vec2 / XLS-R encoder of the medium profile after a
// non-finite bf16 encode (its float32 retry, and every encode after it), an
// explicit float32 request (SER_TORCH_DTYPE=float32), and any float32 encoder
// on the card. Per (batch, head) it computes
//   out = softmax(q k^T / sqrt(D) + bias) v
// with q, k, v, out float32 in the callers' (B, T, H, D) layout (read through
// strides, so no transposes), D = 64, every product float32-grade (one TF32
// pass errs by about 5e-4 at T = 1500, 25 times the float32 limit).
// `key_mask` is optional: (B, mask_stride) uint8, mask_stride at least T
// rounded up to the kBlockK-key tile and a multiple of 16; a masked key gets
// the einsum path's -1e30 bias, so a query attends to the valid keys (the port
// masks keys only; valid rows agree with the TPU kernel's segment ids). Keys
// at or past T are excluded.
//
// Bound on the H100: at the medium profile's shapes (B = 8, T = 1499, H = 16)
// one call is 4 B H T^2 D = 73.6 GFLOP against 123 MB of q, k, v and out
// (0.037 ms at 3.35 TB/s), so the arithmetic bounds it: 0.45 ms for
// float32-grade products on the tensor cores, three TF32 products each at 495
// TFLOP/s dense (1.10 ms at the 67 TFLOP/s of float32 FMA outside them). Its
// 287 M exponentials take 0.07 ms at the special-function units' rate.
//
// Design: every T x T x D product is three TF32 wgmma products with float32
// accumulation. Each operand x is split as x = hi + lo, hi = x rounded to TF32
// (cvt.rna), lo = (x - hi) rounded to TF32; x y is formed as lo_x hi_y +
// hi_x lo_y + hi_x hi_y, the two small terms first (the dropped lo lo term is
// about 2^-22 of the product). A persistent grid, one block per SM, walks the
// (batch, head, 128-query tile) work items; a block is three warpgroups.
// - Warp 0 of warpgroup 2 issues TMA loads of each 64-key tile of K and V
//   (float32 rows of 256 bytes as two 128-byte-swizzled boxes of 32 floats,
//   zero-filled past T) and of its 64 mask bytes into a "landed" ring.
// - Warps 1-3 of warpgroup 2 turn each landed tile into the operands the
//   tensor cores take, in a "split" ring: K's hi and lo tiles (element by
//   element, in the landed tile's swizzled layout), and V transposed to (D,
//   keys) hi and lo tiles: TF32 wgmma takes only K-major operands (no transpose
//   flag), and P V sums over keys. They also permute the keys inside each group
//   of 8 (k-slot kappa holds key 2 kappa for kappa < 4 and key 2 (kappa - 4) + 1
//   otherwise), so that the S accumulator's registers are the P operand's A
//   fragments as they stand: a thread holds keys 2 t and 2 t + 1 of each group
//   in its accumulator and k-slots t and t + 4 in its fragment. Each 4 x 4 block
//   of V goes through registers; the lanes of each quarter-warp take blocks whose
//   16-byte reads and writes fall on 8 different bank groups of the swizzle.
// - Warpgroups 0 and 1 own 64 queries each. A thread keeps its two query rows'
//   hi and lo A fragments (q prescaled by log2(e) / sqrt(D)) in registers for
//   the whole item, issues S = Q K^T (three batches of 8 m64n64k8 products),
//   runs the online softmax in log2 units on the accumulator, splits P in
//   registers, and issues the tile's P V (three more batches) into an
//   accumulator of its own, which is added to O (in registers) by float32
//   FMAs: the tensor cores' accumulation truncates instead of rounding, and O's
//   sum over 1500 keys left to it would lose about 1e-5 of the output.
//   While one warpgroup runs its softmax, the other's products keep the tensor
//   cores busy.
// setmaxnreg gives warpgroup 2 56 registers and each consumer thread 224.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 4;        // one float32 row of D: two 128-byte swizzle spans
constexpr int kSpan = 32;                      // floats in one 128-byte span: one TMA box row
constexpr int kBlockQ = 128;                   // queries per work item, 64 per consumer warpgroup
constexpr int kBlockK = 64;                    // keys per tile
constexpr int kHalfBytes = kBlockK * 128;      // 8 KB: 64 rows of one 128-byte span
constexpr int kTileBytes = 2 * kHalfBytes;     // 16 KB: 64 x 64 floats
constexpr int kLandStages = 2;
constexpr int kSplitStages = 2;
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSplitWarps = 3;                 // warps 1-3 of warpgroup 2
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;             // 128 * 56 + 256 * 224 = 384 * 168: the block's launch allocation
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedScore = -1e30f;         // the einsum path's bias on a masked key

static_assert(kRowBytes == 2 * kSpan * 4, "a row of D is two swizzle spans");

// Shared memory, from the 1024-byte aligned base.
constexpr int kLandK = 0;                                       // [kLandStages] K tiles as TMA wrote them
constexpr int kLandV = kLandK + kLandStages * kTileBytes;       // [kLandStages] V tiles
constexpr int kKHi = kLandV + kLandStages * kTileBytes;         // [kSplitStages] K hi
constexpr int kKLo = kKHi + kSplitStages * kTileBytes;          // [kSplitStages] K lo
constexpr int kVtHi = kKLo + kSplitStages * kTileBytes;         // [kSplitStages] V^T hi, keys permuted
constexpr int kVtLo = kVtHi + kSplitStages * kTileBytes;        // [kSplitStages] V^T lo
constexpr int kLandMask = kVtLo + kSplitStages * kTileBytes;    // [kLandStages] 64 mask bytes
constexpr int kSplitMask = kLandMask + kLandStages * kBlockK;   // [kSplitStages] 64 mask bytes
constexpr int kBars = kSplitMask + kSplitStages * kBlockK;      // land full/empty, split full/empty
constexpr int kSmem = kBars + 2 * (kLandStages + kSplitStages) * 8 + 1024;

template <int kStages>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The (batch, head, 128-query tile) work item w: tile w % tiles of head (w / tiles) % H of batch w / (tiles H).
struct WorkItem {
  int b, h, row0;
  __device__ __forceinline__ WorkItem(int w, int tiles, int heads)
      : b(w / (tiles * heads)), h((w / tiles) % heads), row0((w % tiles) * kBlockQ) {}
};

// k-step kk (8 TF32 values, 32 bytes) of a 64-deep tile lies in span kk / 4
// (a 64-row half tile, 8 KB on) at byte 32 (kk % 4) of each row.
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kHalfBytes + (kk % 4) * 32);
}

// Every warp of a consumer warpgroup releases a stage once its reads are done.
__device__ __forceinline__ void release(uint32_t empty_bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar);
}

// Warps 1-3 of warpgroup 2: one landed tile into its split operands (thread t of kSplitThreads).
__device__ __forceinline__ void split_tile(const uint8_t* land_k, const uint8_t* land_v, const uint8_t* land_mask,
                                           uint8_t* k_hi, uint8_t* k_lo, uint8_t* vt_hi, uint8_t* vt_lo,
                                           uint8_t* split_mask, int t) {
  // K: element by element, at the same (swizzled) byte offsets.
  for (int i = t; i < kTileBytes / 16; i += kSplitThreads) {
    const float4 x = *reinterpret_cast<const float4*>(land_k + 16 * i);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(k_hi + 16 * i) = hi;
    *reinterpret_cast<uint4*>(k_lo + 16 * i) = lo;
  }
  // V: 4 x 4 blocks, transposed. Block `blk`: lane l = blk % 8 of a quarter-warp
  // takes key-slot chunk c = l (slots 4c..4c+3 of a 32-key half: the even keys of
  // 8-key group c / 2 for even c, the odd keys for odd c) and d chunk (l & 6) ^ x
  // of a 32-wide d half, x = (blk / 8) % 8.
  for (int blk = t; blk < kBlockK * kHeadDim / 16; blk += kSplitThreads) {
    const int l = blk & 7, x = (blk >> 3) & 7, d_half = (blk >> 6) & 1, k_half = blk >> 7;
    const int dc = (l & 6) ^ x;
    const int group = 4 * k_half + (l >> 1);
    float4 rows[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int key = 8 * group + 2 * m + (l & 1);
      rows[m] = *reinterpret_cast<const float4*>(land_v + d_half * kHalfBytes + key * 128 + ((dc ^ (key & 7)) << 4));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 32 * d_half + 4 * dc + i;
      const float* c0 = reinterpret_cast<const float*>(&rows[0]);
      const float* c1 = reinterpret_cast<const float*>(&rows[1]);
      const float* c2 = reinterpret_cast<const float*>(&rows[2]);
      const float* c3 = reinterpret_cast<const float*>(&rows[3]);
      uint4 hi, lo;
      split_tf32(c0[i], hi.x, lo.x);
      split_tf32(c1[i], hi.y, lo.y);
      split_tf32(c2[i], hi.z, lo.z);
      split_tf32(c3[i], hi.w, lo.w);
      const int offset = k_half * kHalfBytes + d * 128 + ((l ^ (d & 7)) << 4);
      *reinterpret_cast<uint4*>(vt_hi + offset) = hi;
      *reinterpret_cast<uint4*>(vt_lo + offset) = lo;
    }
  }
  if (land_mask != nullptr && t < kBlockK / 16) {
    reinterpret_cast<uint4*>(split_mask)[t] = reinterpret_cast<const uint4*>(land_mask)[t];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ q, const uint8_t* __restrict__ key_mask,
                           float* __restrict__ out, int batch, int seq, int heads, int mask_stride,
                           float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t land_full = base + kBars;
  const uint32_t land_empty = land_full + 8 * kLandStages;
  const uint32_t split_full = land_empty + 8 * kLandStages;
  const uint32_t split_empty = split_full + 8 * kSplitStages;
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int n_work = q_tiles * heads * batch;
  const int n_tiles = (seq + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLandStages; ++s) {
      mbar_init(land_full + 8 * s, 1);
      mbar_init(land_empty + 8 * s, kSplitWarps);
    }
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(split_full + 8 * s, kSplitWarps);
      mbar_init(split_empty + 8 * s, kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (warp == 0) {
      // TMA: K, V (and the mask bytes) of every key tile of every work item, into the landed ring.
      if (lane == 0) {
        Ring<kLandStages> ring;
        for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
          const WorkItem item(w, q_tiles, heads);
          const uint8_t* mask_b = key_mask != nullptr ? key_mask + static_cast<size_t>(item.b) * mask_stride : nullptr;
          for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
            const int s = ring.stage;
            const int k0 = tile * kBlockK;
            const uint32_t bar = land_full + 8 * s;
            mbar_wait(land_empty + 8 * s, ring.phase ^ 1u);
            mbar_expect_tx(bar, 2 * kTileBytes + (mask_b != nullptr ? kBlockK : 0));
            for (int half = 0; half < 2; ++half) {
              tma_load_4d(base + kLandK + s * kTileBytes + half * kHalfBytes, k_map, bar, half * kSpan, item.h, k0,
                          item.b);
              tma_load_4d(base + kLandV + s * kTileBytes + half * kHalfBytes, v_map, bar, half * kSpan, item.h, k0,
                          item.b);
            }
            if (mask_b != nullptr) bulk_load(base + kLandMask + s * kBlockK, mask_b + k0, kBlockK, bar);
          }
        }
      }
    } else {
      // Split: each landed tile into K hi/lo and V^T hi/lo.
      const int t = threadIdx.x - kConsumers * 128 - 32;
      Ring<kLandStages> land;
      Ring<kSplitStages> split;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        for (int tile = 0; tile < n_tiles; ++tile, land.next(), split.next()) {
          const int ls = land.stage, ss = split.stage;
          mbar_wait(land_full + 8 * ls, land.phase);
          mbar_wait(split_empty + 8 * ss, split.phase ^ 1u);
          split_tile(smem + kLandK + ls * kTileBytes, smem + kLandV + ls * kTileBytes,
                     key_mask != nullptr ? smem + kLandMask + ls * kBlockK : nullptr, smem + kKHi + ss * kTileBytes,
                     smem + kKLo + ss * kTileBytes, smem + kVtHi + ss * kTileBytes, smem + kVtLo + ss * kTileBytes,
                     smem + kSplitMask + ss * kBlockK, t);
          fence_proxy_async();  // the split tiles are wgmma operands
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(land_empty + 8 * ls);
            mbar_arrive(split_full + 8 * ss);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows row0 + 64 wg .. row0 + 64 wg + 63 of each work item.
    regs_alloc<kConsumerRegs>();
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int t4 = lane & 3;  // thread of the four that share a row
    uint32_t q_hi[8][4], q_lo[8][4];
    float s[32];   // scores, then probabilities, of the current key tile
    float pv[32];  // the current key tile's P V
    float o[32];   // the output so far, unnormalised
    Ring<kSplitStages> ring;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const WorkItem item(w, q_tiles, heads);
      const int r0 = item.row0 + wg * 64 + warp * 16 + g;
      const int r1 = r0 + 8;
      const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
      const float* q_bh = q + static_cast<size_t>(item.b) * seq * row_stride + static_cast<size_t>(item.h) * kHeadDim;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (e & 1) ? r1 : r0;
          const int col = 8 * kk + t4 + ((e & 2) ? 4 : 0);
          const float x = row < seq ? q_bh[row * row_stride + col] * scale_log2 : 0.f;
          split_tf32(x, q_hi[kk][e], q_lo[kk][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row maxima (log2 units)
      float l0 = 0.f, l1 = 0.f;                      // this thread's share of the running row sums

      for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
        const int st = ring.stage;
        const uint32_t k_hi = base + kKHi + st * kTileBytes, k_lo = base + kKLo + st * kTileBytes;
        const uint32_t vt_hi = base + kVtHi + st * kTileBytes, vt_lo = base + kVtLo + st * kTileBytes;
        mbar_wait(split_full + 8 * st, ring.phase);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_tf32(s, q_lo[kk], tile_desc(k_hi, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_tf32(s, q_hi[kk], tile_desc(k_lo, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_tf32(s, q_hi[kk], tile_desc(k_hi, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // The thread's keys are 8j + 2 t4 + e (j < 8, e < 2) in both of its rows.
        const int k0 = tile * kBlockK;
        const uint8_t* mask_s = key_mask != nullptr ? smem + kSplitMask + st * kBlockK : nullptr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * j + 2 * t4 + e;
            float bias = 0.f;
            bool replace = false;
            if (mask_s != nullptr && mask_s[key] == 0) {
              bias = kMaskedScore;
              replace = true;
            }
            if (k0 + key >= seq) {
              bias = -CUDART_INF_F;  // past T: no weight at all
              replace = true;
            }
            if (replace) {
              s[4 * j + e] = bias;
              s[4 * j + 2 + e] = bias;
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // Key k0 < T is in every tile (a score or -1e30), so mx0 and mx1 are finite.
        const float alpha0 = exp2_approx(m0 - mx0), alpha1 = exp2_approx(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[4 * j] = exp2_approx(s[4 * j] - mx0);
          s[4 * j + 1] = exp2_approx(s[4 * j + 1] - mx0);
          s[4 * j + 2] = exp2_approx(s[4 * j + 2] - mx1);
          s[4 * j + 3] = exp2_approx(s[4 * j + 3] - mx1);
          sum0 += s[4 * j] + s[4 * j + 1];
          sum1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
        // P's A fragments for k-step j (keys 8j..8j+7, permuted): slots t4 and t4 + 4 of
        // rows g and g + 8 are keys 8j + 2 t4 and 8j + 2 t4 + 1.
        uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          split_tf32(s[4 * j], p_hi[j][0], p_lo[j][0]);
          split_tf32(s[4 * j + 2], p_hi[j][1], p_lo[j][1]);
          split_tf32(s[4 * j + 1], p_hi[j][2], p_lo[j][2]);
          split_tf32(s[4 * j + 3], p_hi[j][3], p_lo[j][3]);
        }
        // This tile's P V in an accumulator of its own, added to O in float32 below: the
        // tensor cores' accumulation truncates, so O's sum over the tiles is not left to it.
#pragma unroll
        for (int i = 0; i < 32; ++i) pv[i] = 0.f;
        fence_regs(pv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) wgmma_tf32(pv, p_lo[j], tile_desc(vt_hi, j), 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) wgmma_tf32(pv, p_hi[j], tile_desc(vt_lo, j), 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) wgmma_tf32(pv, p_hi[j], tile_desc(vt_hi, j), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        release(split_empty + 8 * st);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] = fmaf(o[4 * j], alpha0, pv[4 * j]);
          o[4 * j + 1] = fmaf(o[4 * j + 1], alpha0, pv[4 * j + 1]);
          o[4 * j + 2] = fmaf(o[4 * j + 2], alpha1, pv[4 * j + 2]);
          o[4 * j + 3] = fmaf(o[4 * j + 3], alpha1, pv[4 * j + 3]);
        }
      }

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      float* out_bh =
          out + static_cast<size_t>(item.b) * seq * row_stride + static_cast<size_t>(item.h) * kHeadDim;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t4;
        if (r0 < seq) {
          *reinterpret_cast<float2*>(out_bh + r0 * row_stride + c) = make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        }
        if (r1 < seq) {
          *reinterpret_cast<float2*>(out_bh + r1 * row_stride + c) =
              make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
    }
  }
}

// A (D, H, T, B) map over a contiguous (B, T, H, 64) float32 tensor: boxes of
// 32 floats x 64 rows of one (batch, head), 128-byte swizzle, rows past T read as zeros.
bool head_map(CUtensorMap* map, const void* tensor, int batch, int seq, int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kHeadDim, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {kRowBytes, static_cast<cuuint64_t>(heads) * kRowBytes,
                                 static_cast<cuuint64_t>(seq) * heads * kRowBytes};
  const cuuint32_t box[4] = {kSpan, 1, kBlockK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(tensor), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// K2-f32 on `stream`. q, k, v, out: (B, T, H, 64) float32, contiguous, 16-byte
// aligned. `key_mask` (B, mask_stride) uint8 or null; `mask_stride` is read
// only with a mask: at least T rounded up to kBlockK, a multiple of 16.
extern "C" int ser_flash_attention_f32(const void* q, const void* k, const void* v, const void* key_mask,
                                       void* out, int batch, int seq, int heads, int head_dim, int mask_stride,
                                       float scale, void* stream) {
  if (head_dim != kHeadDim || seq <= 0 || batch <= 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int padded = (seq + kBlockK - 1) / kBlockK * kBlockK;
  if (key_mask != nullptr && (mask_stride < padded || mask_stride % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap k_map, v_map;
  if (!head_map(&k_map, k, batch, seq, heads) || !head_map(&v_map, v, batch, seq, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int grid = persistent_grid(q_tiles * heads * batch, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_f32_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, static_cast<const float*>(q), static_cast<const uint8_t*>(key_mask), static_cast<float*>(out),
      batch, seq, heads, mask_stride, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
