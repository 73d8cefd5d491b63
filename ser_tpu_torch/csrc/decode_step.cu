// Kernels K3, K4 and K5: the Whisper decode step's attention groups, for Hopper (sm_90a).
//
// Replace the three TPU kernels of ser_tpu/ops/decode_step_kernels.py:
//   K3  ln_qkv_project       (:94, _ln_qkv_kernel :86)        float32 LayerNorm -> x . W_qkv + b
//   K4  self_attend_and_out  (:175, _self_attend_kernel :138) one query per (row, head) over the
//       self-attention cache, keys <= position, out-projection + bias + residual
//   K5  cross_attention_step (:269, _cross_step_kernel :224)  LayerNorm -> per-head Q -> one
//       query over the encoder K/V -> out-projection + bias + residual, and the float32
//       attention weights (H, R, S) for the alignment heads
//
// Rounding points are the TPU kernels' (and the unfused decode's): LayerNorm in float32,
// rounded to bf16 before the product; every product accumulates in float32 and rounds
// to bf16 at its output; bias and residual adds round to bf16; scores are rounded to
// bf16, divided by bf16(sqrt(Dh)) in bf16, and the softmax runs in float32; P is
// normalised in float32 and then rounded to bf16 before P . V. The out-projection sums
// per-head float32 partials in head order, as the TPU kernels do, and rounds once.
//
// Bound on the H100: at decode batch (R = 1-20 rows) all three are bound by bytes. At
// large-v3 and R = 2: K3 reads W_qkv, 9.8 MB (2.9 us at 3.35 TB/s); K5 moves 22.2 MB per
// call (W_q and W_out 6.6 MB, the encoder K/V 15.4 MB, its float32 weights 0.24 MB), so
// 6.6 us; K4 moves 7.9 MB at position 447 (W_out 3.3 MB and the cache up to position),
// so 2.4 us.
//
// K3 is one GEMV kernel whose weight stream is a single round trip: a block owns 32
// output columns (3840 / 32 = 120 blocks at large-v3), and at entry one thread puts the
// block's whole weight slice in flight into shared memory (TMA boxes of 256 rows x 64
// bytes, 80 KB at d = 1280, each on its own barrier) before anything else. The block
// computes the LayerNorm of its rows (cheaper to recompute than a second launch; every
// load it needs issued at once) while those bytes arrive, then reduces each box as soon
// as it lands, on the tensor cores (mma.sync, bf16 in, float32 accumulation: the rounded
// LayerNorm output is exact in bf16), so that little work is left once the last byte is
// in. The warps' partial sums meet in a fixed order: a call gives the same bits on every
// run. Given the self-attention caches, K3 writes the K and V columns of its output into
// them at `position` and only q to its output, so the decode step needs no scatter.
//
// K4 and K5 are one cluster kernel, one launch each. At R = 2 a block per (row, head)
// leaves most of the 132 SMs idle and each block latency-bound, so the work of one head
// is split over a thread-block cluster of up to kMaxCluster CTAs (the portable limit):
// 20 heads x 8 CTAs = 160 CTAs, two resident per SM, one wave (the wrapper checks with
// cudaOccupancyMaxActiveClusters and takes a smaller cluster where that does not fit).
// One cluster per head, for all R rows, reads every byte of W_q[h], W_out[h] and each
// row's K/V once per call. The key range [0, n_keys) is cut into one contiguous chunk per
// CTA, chunk_keys() keys long (n_keys = position + 1 for K4, S for K5); a CTA whose chunk
// lies past n_keys has no keys. Inside one launch, each CTA:
//   1. (K5) computes the LayerNorm statistics of the R rows (5 KB: cheaper to recompute
//      than to exchange), projects its slice of d (rows of W_q[h], contiguous) onto the 64
//      dims of the head for all rows, and sums the (R, 64) float32 partials of all CTAs
//      through distributed shared memory (DSMEM) in rank order; rounds, adds b_q, rounds;
//   2. scores its chunk's keys and keeps each row's chunk max and sum of exp; every CTA
//      combines the (max, sum) pairs of the cluster in rank order into the row's max M and
//      sum L (a CTA without keys has max -inf and sum 0 and is skipped, so exp(-inf - M)
//      is never formed);
//   3. normalises p = exp(s - M) / L in float32 (K5 writes it as its weights), then rounds
//      p to bf16: the TPU kernel's order, which is why M and L are global before P . V;
//   4. forms its float32 P . V partial; the partials meet over DSMEM in rank order and
//      round once to the head's (R, 64) output;
//   5. multiplies that output by its d / cluster columns of W_out[h] and writes a float32
//      per-head partial to an (H, R, d) scratch;
//   6. counts itself done on its column slice with an integer atomic; the last of the H
//      CTAs of a slice sums the H partials in head order, rounds, adds the bias and the
//      residual, writes the slice and resets the counter for the next call.
// No float atomics: every sum has a fixed order, and the output is the same bits on
// every run. The kernel is a chain of dependent steps, so each step's operands are asked
// for before the chain starts: one cp.async group brings the small vectors (b_q, the
// LayerNorm affines, b_out, the residual, K4's q), the next W_out's slice, and the K/V
// chunks stream through a ring of kStages shared-memory tiles issued behind them, so the
// loads run under the LayerNorm, the projection and the exchanges.
// K is (R, H, Dh, S): at S = 1500 its dimension rows are 3000 bytes apart, which TMA's
// 16-byte stride rule refuses, so K's chunk arrives by 8-byte cp.async, aligned because
// S % kKeyAlign == 0 and every chunk starts at a multiple of kKeyAlign keys (the wrapper
// checks S). K4 never reads a cache slot past position: the last partial group of 4
// keys is read key by key. V's chunk (keys x 128 bytes) is contiguous: 16-byte cp.async.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroup = 4;                             // input rows per pass over W_q (K5)

// The GEMV kernel (K3).
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kTileCols = 32;                            // output columns per block: 4 n8 tiles of mma
constexpr int kBoxRows = 256;                            // weight rows per TMA box (the box limit)
constexpr int kBoxBytes = kBoxRows * kTileCols * 2;      // 16 KB: rows of 64 bytes, 64-byte swizzled
constexpr int kStepsPerWarp = kBoxRows / 16 / kGemvWarps;  // k16 steps of a box per warp
constexpr int kLnQkvSmem = 200 * 1024;                   // dynamic shared memory at most (d up to 2304)
constexpr int kMaxBoxes = 16;                            // d up to 4096 rows of W (shared memory allows 2304)
constexpr int kLnChunks = 2;                             // 16-byte chunks of a row per thread (d up to 4096)
constexpr int kLnRows = 4;                               // input rows per pass over the weights
constexpr int kHeadDim = 64;

// The attention cluster kernel (K4, K5).
constexpr int kMaxCluster = 8;   // CTAs per head at most: the portable cluster size
constexpr int kKeyAlign = 4;     // chunks start at multiples of 4 keys: 8-byte loads of K
constexpr int kTileKeys = 64;    // keys per ring tile
constexpr int kKPad = 72;        // bf16 per K-tile dim row (64 keys + 8: no bank conflicts)
constexpr int kStages = 6;       // ring tiles in flight
constexpr int kTileElems = kHeadDim * kKPad;  // bf16 per ring slot (K tile; a V tile is smaller)
constexpr int kColPad = 8;       // bf16 added to each W_out slice row in shared memory
constexpr int kHeadBatch = 24;   // head partials in flight per thread in the head sum
constexpr int kQUnroll = 8;      // W_q loads in flight per thread in K5's Q projection
constexpr int kMaxSmem = 226 * 1024;  // dynamic: the 227 KB opt-in less room for the static bytes

// Keys per CTA: n_keys split over the cluster, rounded up to kKeyAlign.
__host__ __device__ constexpr int chunk_keys(int n_keys, int cluster) {
  return (n_keys + cluster * kKeyAlign - 1) / (cluster * kKeyAlign) * kKeyAlign;
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ void unpack8(const uint4& packed, float* out) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(pairs[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

struct LnQkvParams {
  const bf16* x;         // (R, K)
  const bf16* ln_scale;  // (K)
  const bf16* ln_bias;   // (K)
  const bf16* bias;      // (N)
  bf16* out;             // (R, N); with the caches, q only: (R, N / 3)
  bf16* k_cache;         // (R, H, 64, s_max) or null: column `position` gets the K part
  bf16* v_cache;         // (R, H, s_max, 64) or null: row `position` gets the V part
  int rows, K, N, position, s_max;
  float eps;
};

// A thread's share of the LayerNorm's inputs for rows r0 .. r0 + kRows - 1 of x (zeros
// past p.rows): its 16-byte chunks of each row, of the scale and of the bias.
struct LnInputs {
  static constexpr int kRows = kLnRows;
  uint4 x[kRows][kLnChunks], scale[kLnChunks], bias[kLnChunks];

  // Issues every load at once (one round trip); nothing waits for them here.
  __device__ __forceinline__ void load(const LnQkvParams& p, int r0) {
    const int chunks = p.K / 8;
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      const int idx = threadIdx.x + c * kGemvThreads;
      const bool live = idx < chunks;
      scale[c] = live ? reinterpret_cast<const uint4*>(p.ln_scale)[idx] : make_uint4(0u, 0u, 0u, 0u);
      bias[c] = live ? reinterpret_cast<const uint4*>(p.ln_bias)[idx] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x[r][c] = live && r0 + r < p.rows
                      ? reinterpret_cast<const uint4*>(p.x + static_cast<int64_t>(r0 + r) * p.K)[idx]
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
};

// The LayerNorm of rows r0 .. r0 + kLnRows - 1 of x (those < p.rows; the others are zeros)
// into a_s (kLnRows x K, rounded to bf16), from the loaded inputs; all rows' sums meet in
// one block reduction.
__device__ __forceinline__ void layer_norm_rows(const LnQkvParams& p, int r0, const LnInputs& in, bf16* a_s,
                                                float* red_s) {
  constexpr int kRows = kLnRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int K = p.K, chunks = K / 8;
  const auto& xv = in.x;
  const auto& scale = in.scale;
  const auto& bias = in.bias;
  float sums[2 * kRows];  // sum and sum of squares of each row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      float v[8];
      unpack8(xv[r][c], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += v[j];
        sq += v[j] * v[j];
      }
    }
    sums[2 * r] = s;
    sums[2 * r + 1] = sq;
  }
#pragma unroll
  for (int i = 0; i < 2 * kRows; ++i) {
    for (int offset = 16; offset > 0; offset >>= 1) sums[i] += __shfl_xor_sync(0xffffffffu, sums[i], offset);
  }
  __syncthreads();  // the previous row group's readers are done with red_s and a_s
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2 * kRows; ++i) red_s[warp * 2 * kRows + i] = sums[i];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = red_s[2 * r], sq = red_s[2 * r + 1];
    for (int w = 1; w < kGemvWarps; ++w) {
      s += red_s[w * 2 * kRows + 2 * r];
      sq += red_s[w * 2 * kRows + 2 * r + 1];
    }
    const float mean = s / K;
    const float inv = rsqrtf(fmaxf(0.f, sq / K - mean * mean) + p.eps);
    const bool live_row = r0 + r < p.rows;
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      const int idx = tid + c * kGemvThreads;
      if (idx >= chunks) continue;
      float v[8], sc[8], bi[8];
      unpack8(xv[r][c], v);
      unpack8(scale[c], sc);
      unpack8(bias[c], bi);
      uint4 packed;
      uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = live_row ? (v[2 * j] - mean) * inv * sc[2 * j] + bi[2 * j] : 0.f;
        const float hi = live_row ? (v[2 * j + 1] - mean) * inv * sc[2 * j + 1] + bi[2 * j + 1] : 0.f;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
        words[j] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(a_s + r * K + idx * 8) = packed;
    }
  }
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the address of row
// l % 8 of matrix l / 8; register i gets the pair that mma's B fragment wants of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, float32) += A (16 x 16, bf16, rows 0-7 only: a0 = (g, 2t..2t+1), a2 = (g, 2t+8..2t+9))
// * B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// K3. out[r, n] = bf16(bf16(sum_k ln(x)[r, k] W[k, n]) + bias[n]), with ln(x) the float32
// LayerNorm of x (fast variance E[x^2] - E[x]^2, as flax) rounded to bf16. W is (K, N)
// row-major, read through `w_map` (boxes of 32 columns x 256 rows, 64-byte swizzled), each
// box on a barrier of its own so that the reduction starts on the first box to land. The
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulation): the
// rounded LayerNorm rows are exact in bf16, and the CUDA cores' share of the work after
// the last byte lands is then a few instructions. Warp w takes the k16 steps w, w + 8, ...;
// its float32 partials meet the other warps' in warp order. kLnRows input rows per pass
// over the weights (the A operand's other rows are zeros). Grid: N / 32 blocks.
__global__ void __launch_bounds__(kGemvThreads)
ln_qkv_kernel(const __grid_constant__ CUtensorMap w_map, const LnQkvParams p) {
  constexpr int kRows = kLnRows;
  extern __shared__ uint8_t smem_raw[];  // W slice (n_boxes * 256 rows x 32 columns), then kRows x K bf16
  __shared__ uint64_t bars_s[kMaxBoxes];
  __shared__ float part_s[kGemvWarps][kRows][kTileCols];
  __shared__ float red_s[kGemvWarps * 2 * kRows];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int K = p.K;
  const int n_boxes = (K + kBoxRows - 1) / kBoxRows;
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw + (base - raw) + n_boxes * kBoxBytes);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kTileCols;

  // The LayerNorm's inputs and the bias of this thread's output column are asked for
  // first, then the whole weight slice goes in flight: one round trip to device memory,
  // with the small loads queued ahead of the 80 KB.
  LnInputs ln_in;
  ln_in.load(p, 0);
  const float bias_c = to_float(p.bias[n0 + tid % kTileCols]);
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < n_boxes; ++i) mbar_init(smem_addr(&bars_s[i]), 1);
    fence_barrier_init();
    for (int i = 0; i < n_boxes; ++i) {
      const uint32_t bar = smem_addr(&bars_s[i]);
      mbar_expect_tx(bar, kBoxBytes);
      tma_load_2d(base + i * kBoxBytes, w_map, bar, n0, i * kBoxRows);
    }
  }

  // This lane's ldmatrix row: matrix m = lane / 8 is k rows 8 (m % 2) .. + 7 of a k16 step
  // and n8 tile m / 2 of a pair of tiles. In the 64-byte swizzle, 16-byte chunk c of row k
  // lies at chunk c ^ ((k / 2) % 4).
  const int lm_row = (lane >> 3 & 1) * 8 + (lane & 7);
  const int lm_tile = lane >> 4;

  for (int r0 = 0; r0 < p.rows; r0 += kRows) {
    const int group = min(kRows, p.rows - r0);
    if (r0 > 0) ln_in.load(p, r0);
    layer_norm_rows(p, r0, ln_in, a_s, red_s);  // the first group's runs while the weights arrive
    __syncthreads();

    float acc[kTileCols / 8][4];
#pragma unroll
    for (int j = 0; j < kTileCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* a_row = a_s + (g < kRows ? g : 0) * K;
    for (int box = 0; box < n_boxes; ++box) {
      if (r0 == 0) mbar_wait(smem_addr(&bars_s[box]), 0);
#pragma unroll
      for (int i = 0; i < kStepsPerWarp; ++i) {
        const int k_box = (warp + i * kGemvWarps) * 16;  // the step's first row inside the box
        const int k0 = box * kBoxRows + k_box;
        if (k0 >= K) break;
        uint32_t a0 = 0u, a2 = 0u;
        if (g < kRows) {
          a0 = *reinterpret_cast<const uint32_t*>(a_row + k0 + 2 * t4);
          a2 = *reinterpret_cast<const uint32_t*>(a_row + k0 + 8 + 2 * t4);
        }
        const int k = k_box + lm_row;
        const uint32_t row_addr = base + box * kBoxBytes + k * (kTileCols * 2);
        uint32_t b01[4], b23[4];
        ldmatrix_x4_trans(row_addr + (((0 + lm_tile) ^ ((k >> 1) & 3)) << 4), b01);
        ldmatrix_x4_trans(row_addr + (((2 + lm_tile) ^ ((k >> 1) & 3)) << 4), b23);
        mma_bf16_16816(acc[0], a0, a2, b01[0], b01[1]);
        mma_bf16_16816(acc[1], a0, a2, b01[2], b01[3]);
        mma_bf16_16816(acc[2], a0, a2, b23[0], b23[1]);
        mma_bf16_16816(acc[3], a0, a2, b23[2], b23[3]);
      }
    }
    // Rows g < kRows of this warp's partial: columns 8j + 2 t4 and 8j + 2 t4 + 1.
    if (g < kRows) {
#pragma unroll
      for (int j = 0; j < kTileCols / 8; ++j) {
        part_s[warp][g][8 * j + 2 * t4] = acc[j][0];
        part_s[warp][g][8 * j + 2 * t4 + 1] = acc[j][1];
      }
    }
    __syncthreads();
    if (tid < group * kTileCols) {
      const int r = tid / kTileCols, c = tid % kTileCols, n = n0 + c;
      const int64_t row = r0 + r;
      float sum = 0.f;
      for (int w_i = 0; w_i < kGemvWarps; ++w_i) sum += part_s[w_i][r][c];
      const bf16 y = __float2bfloat16(round_bf16(round_bf16(sum) + bias_c));
      if (p.k_cache == nullptr) {
        p.out[row * p.N + n] = y;
      } else {
        const int d = p.N / 3, heads = d / kHeadDim;
        if (n < d) {
          p.out[row * d + n] = y;
        } else if (n < 2 * d) {
          const int h = (n - d) / kHeadDim, e = (n - d) % kHeadDim;
          p.k_cache[((row * heads + h) * kHeadDim + e) * p.s_max + p.position] = y;
        } else {
          const int h = (n - 2 * d) / kHeadDim, e = (n - 2 * d) % kHeadDim;
          p.v_cache[((row * heads + h) * p.s_max + p.position) * kHeadDim + e] = y;
        }
      }
    }
    // The next row group's LayerNorm starts with a __syncthreads(): part_s is read by then.
  }
}

// ----------------------------------------------------------------------------------------
// K4 and K5: the attention cluster kernel
// ----------------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}
__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_address(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_address(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// sum over the cluster's CTAs, in rank order, of value[i] in each CTA's shared memory;
// the remote loads are all issued before the first add.
__device__ __forceinline__ float cluster_sum(const cg::cluster_group& cluster, float* value, int i, int csize) {
  float part[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) part[c] = c < csize ? cluster.map_shared_rank(value, c)[i] : 0.f;
  float sum = part[0];
#pragma unroll
  for (int c = 1; c < kMaxCluster; ++c) {
    if (c < csize) sum += part[c];
  }
  return sum;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct AttendParams {
  const bf16* x;         // (R, d): K5's input and residual; K4's residual
  const bf16* ln_scale;  // (d) K5
  const bf16* ln_bias;   // (d) K5
  const bf16* w_q;       // (H, d, Dh) K5
  const bf16* b_q;       // (H * Dh) K5
  const bf16* q;         // (R, H, Dh) with row stride q_row_stride, K4
  const bf16* k;         // (R, H, Dh, s_stride)
  const bf16* v;         // (R, H, s_stride, Dh)
  const bf16* w_out;     // (H * Dh, d)
  const bf16* b_out;     // (d)
  float* weights;        // (H, R, n_keys) K5
  float* partials;       // (H, R, d) scratch
  int* counters;         // (cluster) zero between calls
  bf16* out;             // (R, d)
  int q_row_stride, rows, heads, s_stride, n_keys, chunk, d_model;
  float eps, root_d;
};

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory regions. "small" holds the bf16 vectors
// copied in first: the residual's and b_out's slices, and K5's LayerNorm affine slices
// and b_q[h], or K4's q[:, h]. "work" holds K5's LayerNorm slice, then the scores and P;
// "vec" (read by the cluster) the Q partial, then the P . V partial; "rowvec" q, then
// the head output; "stats" (read by the cluster) each row's chunk (max, sum); "rowml"
// K5's LayerNorm (mean, inv), then each row's (M, L).
struct SmemLayout {
  int w_out, small, work, vec, rowvec, stats, rowml, red, total;
  __host__ __device__ SmemLayout(int rows, int chunk, int ncols) {
    const int ring = align16(kStages * kTileElems * 2);
    w_out = ring;
    small = w_out + align16(kHeadDim * (ncols + kColPad) * 2);
    work = small + align16(((rows + 3) * ncols + (rows + 1) * kHeadDim) * 2);
    const int work_floats = rows * (ncols > chunk ? ncols : chunk);
    vec = work + align16(work_floats * 4);
    rowvec = vec + align16(rows * kHeadDim * 4);
    stats = rowvec + align16(rows * kHeadDim * 4);
    rowml = stats + align16(rows * 2 * 4);
    red = rowml + align16(rows * 2 * 4);
    total = red + kWarps * kRowGroup * kHeadDim * 4;
  }
};

// Grid: heads * cluster CTAs in clusters of `cluster` (one cluster per head).
template <bool kCross>
__global__ void __launch_bounds__(kThreads, 2) attend_cluster_kernel(const AttendParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / csize;
  const int R = p.rows, d = p.d_model, ncols = d / csize, wcols = ncols + kColPad;
  const SmemLayout layout(R, p.chunk, ncols);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* w_out_s = reinterpret_cast<bf16*>(smem + layout.w_out);
  bf16* res_s = reinterpret_cast<bf16*>(smem + layout.small);  // (R, ncols)
  bf16* b_out_s = res_s + R * ncols;                             // (ncols)
  bf16* ln_scale_s = b_out_s + ncols;                            // (ncols) K5
  bf16* ln_bias_s = ln_scale_s + ncols;                          // (ncols) K5
  bf16* b_q_s = ln_bias_s + ncols;                               // (64) K5
  bf16* q_s = b_q_s + kHeadDim;                                  // (R, 64) K4
  float* work = reinterpret_cast<float*>(smem + layout.work);
  float* vec = reinterpret_cast<float*>(smem + layout.vec);
  float* rowvec = reinterpret_cast<float*>(smem + layout.rowvec);
  float* stats = reinterpret_cast<float*>(smem + layout.stats);
  float* rowml = reinterpret_cast<float*>(smem + layout.rowml);
  float* red = reinterpret_cast<float*>(smem + layout.red);

  const int c0 = rank * p.chunk;
  const int len = max(0, min(p.chunk, p.n_keys - c0));
  const int tiles_per_row = (len + kTileKeys - 1) / kTileKeys;
  const int k_tiles = R * tiles_per_row, n_tiles = 2 * k_tiles;

  // The small vectors first, one cp.async group; then W_out[h]'s slice of columns (64
  // rows of ncols), another.
  {
    const int pieces = ncols / 8, k0 = rank * ncols;
    for (int i = tid; i < R * pieces; i += kThreads) {
      const int r = i / pieces, c8 = i % pieces * 8;
      cp_async_16(res_s + r * ncols + c8, p.x + static_cast<int64_t>(r) * d + k0 + c8);
    }
    for (int i = tid; i < pieces; i += kThreads) {
      cp_async_16(b_out_s + i * 8, p.b_out + k0 + i * 8);
      if constexpr (kCross) {
        cp_async_16(ln_scale_s + i * 8, p.ln_scale + k0 + i * 8);
        cp_async_16(ln_bias_s + i * 8, p.ln_bias + k0 + i * 8);
      }
    }
    if constexpr (kCross) {
      if (tid < kHeadDim / 8) cp_async_16(b_q_s + tid * 8, p.b_q + head * kHeadDim + tid * 8);
    } else {
      for (int i = tid; i < R * kHeadDim / 8; i += kThreads) {
        cp_async_16(q_s + i * 8, p.q + static_cast<int64_t>(i / 8) * p.q_row_stride + head * kHeadDim + i % 8 * 8);
      }
    }
    cp_async_commit();
  }
  {
    const bf16* src = p.w_out + static_cast<int64_t>(head) * kHeadDim * d + rank * ncols;
    const int pieces = ncols / 8;
    for (int i = tid; i < kHeadDim * pieces; i += kThreads) {
      const int e = i / pieces, c8 = i % pieces * 8;
      cp_async_16(w_out_s + e * wcols + c8, src + static_cast<int64_t>(e) * d + c8);
    }
    cp_async_commit();
  }
  // Ring tile t: K tiles (r, key tile) first, then V tiles in the same order. One group per
  // call, empty past the last tile, so that "all but the newest kStages - 1 groups" always
  // means "up to tile t".
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const bool is_v = t >= k_tiles;
      const int rem = is_v ? t - k_tiles : t;
      const int r = rem / tiles_per_row, off = rem % tiles_per_row * kTileKeys;
      const int ks = c0 + off, tk = min(kTileKeys, len - off);
      bf16* slot = ring + (t % kStages) * kTileElems;
      const int64_t cache = (static_cast<int64_t>(r) * p.heads + head) * kHeadDim * p.s_stride;
      if (!is_v) {
        const bf16* src = p.k + cache + ks;
        const int quads = (tk + kKeyAlign - 1) / kKeyAlign;
        for (int i = tid; i < kHeadDim * quads; i += kThreads) {
          const int j = i / quads, key = i % quads * kKeyAlign;
          bf16* dst = slot + j * kKPad + key;
          const bf16* from = src + static_cast<int64_t>(j) * p.s_stride + key;
          if (key + kKeyAlign <= tk) {
            cp_async_8(dst, from);
          } else {  // the last keys up to n_keys, one by one: never a slot past it
            for (int u = 0; u < kKeyAlign; ++u) dst[u] = key + u < tk ? from[u] : __float2bfloat16(0.f);
          }
        }
      } else {
        const bf16* src = p.v + cache + static_cast<int64_t>(ks) * kHeadDim;
        for (int i = tid; i < tk * kHeadDim / 8; i += kThreads) cp_async_16(slot + i * 8, src + i * 8);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages; ++t) issue(t);

  // 1. The query of each row for this head: (R, 64) floats in rowvec.
  if constexpr (kCross) {
    for (int r = warp; r < R; r += kWarps) {
      const bf16* x_row = p.x + static_cast<int64_t>(r) * d;
      float sum = 0.f, sum_sq = 0.f;
      for (int k = lane * 8; k < d; k += 32 * 8) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(x_row + k), v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sum += v[j];
          sum_sq += v[j] * v[j];
        }
      }
      for (int offset = 16; offset > 0; offset >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, offset);
        sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, offset);
      }
      if (lane == 0) {
        const float mean = sum / d;
        rowml[2 * r] = mean;
        rowml[2 * r + 1] = rsqrtf(fmaxf(0.f, sum_sq / d - mean * mean) + p.eps);
      }
    }
    cp_async_wait<kStages + 1>();  // the small vectors
    __syncthreads();
    const int k0 = rank * ncols;  // this CTA's slice of d
    for (int i = tid; i < R * ncols; i += kThreads) {
      const int r = i / ncols, k = i % ncols;
      const float normed = (to_float(res_s[i]) - rowml[2 * r]) * rowml[2 * r + 1];
      work[i] = round_bf16(normed * to_float(ln_scale_s[k]) + to_float(ln_bias_s[k]));
    }
    __syncthreads();
    // Partial of LN(x)[:, slice] . W_q[h, slice, :]: lane % 8 owns 8 dims, the 32
    // (warp, lane / 8) pairs split the slice's rows.
    const int colg = lane % 8, kslice = warp * 4 + lane / 8;
    const bf16* w_q = p.w_q + (static_cast<int64_t>(head) * d + k0) * kHeadDim + colg * 8;
    for (int r0 = 0; r0 < R; r0 += kRowGroup) {
      const int group = min(kRowGroup, R - r0);
      float acc[kRowGroup][8];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
      }
      for (int k_base = kslice; k_base < ncols; k_base += 32 * kQUnroll) {
        uint4 packed[kQUnroll];
#pragma unroll
        for (int u = 0; u < kQUnroll; ++u) {
          const int k = k_base + u * 32;
          packed[u] = k < ncols ? *reinterpret_cast<const uint4*>(w_q + static_cast<int64_t>(k) * kHeadDim)
                                : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kQUnroll; ++u) {
          const int k = k_base + u * 32;
          if (k >= ncols) break;
          float wv[8];
          unpack8(packed[u], wv);
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r) {
            const float a = r < group ? work[(r0 + r) * ncols + k] : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a, wv[j], acc[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = acc[r][j];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          acc[r][j] = v;
        }
      }
      if (lane < 8) {
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
          for (int j = 0; j < 8; ++j) red[(warp * kRowGroup + r) * kHeadDim + colg * 8 + j] = acc[r][j];
        }
      }
      __syncthreads();
      for (int i = tid; i < group * kHeadDim; i += kThreads) {
        const int r = i / kHeadDim, e = i % kHeadDim;
        float sum = 0.f;
        for (int w_i = 0; w_i < kWarps; ++w_i) sum += red[(w_i * kRowGroup + r) * kHeadDim + e];
        vec[(r0 + r) * kHeadDim + e] = sum;
      }
      __syncthreads();
    }
    cluster.sync();  // every CTA's Q partial is written
    for (int i = tid; i < R * kHeadDim; i += kThreads) {
      const float sum = cluster_sum(cluster, vec, i, csize);
      rowvec[i] = round_bf16(round_bf16(sum) + to_float(b_q_s[i % kHeadDim]));
    }
  } else {
    cp_async_wait<kStages + 1>();  // the small vectors
    __syncthreads();
    for (int i = tid; i < R * kHeadDim; i += kThreads) rowvec[i] = to_float(q_s[i]);
  }
  __syncthreads();

  // 2. Scores of the chunk: thread (key = tid / 4, dims tid % 4 + 4 i), two shuffles.
  float* scores = work;  // (R, chunk)
  for (int t = 0; t < k_tiles; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* tile = ring + (t % kStages) * kTileElems;
    const int r = t / tiles_per_row, off = t % tiles_per_row * kTileKeys;
    const int tk = min(kTileKeys, len - off);
    const int key = tid / 4, dg = tid % 4;
    float dot = 0.f;
    if (key < tk) {
      const float* q_row = rowvec + r * kHeadDim;
#pragma unroll
      for (int i = 0; i < kHeadDim / 4; ++i) {
        const int j = dg + 4 * i;
        dot = fmaf(q_row[j], to_float(tile[j * kKPad + key]), dot);
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (dg == 0 && key < tk) scores[r * p.chunk + off + key] = round_bf16(round_bf16(dot) / p.root_d);
    __syncthreads();
    issue(t + kStages);
  }
  for (int r = warp; r < R; r += kWarps) {
    const float* row = scores + r * p.chunk;
    float m = -INFINITY;
    for (int s = lane; s < len; s += 32) m = fmaxf(m, row[s]);
    for (int offset = 16; offset > 0; offset >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
    float l = 0.f;
    for (int s = lane; s < len; s += 32) l += expf(row[s] - m);
    for (int offset = 16; offset > 0; offset >>= 1) l += __shfl_xor_sync(0xffffffffu, l, offset);
    if (lane == 0) {
      stats[2 * r] = m;
      stats[2 * r + 1] = l;
    }
  }
  cluster.sync();  // every CTA's (max, sum) is written; every Q partial has been read
  for (int r = tid; r < R; r += kThreads) {
    float2 pair[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      pair[c] = c < csize ? reinterpret_cast<const float2*>(cluster.map_shared_rank(stats, c))[r]
                          : make_float2(-INFINITY, 0.f);
    }
    float m = pair[0].x;
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c) m = fmaxf(m, pair[c].x);
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (pair[c].y > 0.f) l += pair[c].y * expf(pair[c].x - m);
    }
    rowml[2 * r] = m;
    rowml[2 * r + 1] = l;
  }
  __syncthreads();

  // 3. p = exp(s - M) / L in float32 (K5's weights), then rounded to bf16 in place.
  for (int i = tid; i < R * len; i += kThreads) {
    const int r = i / len, s = i % len;
    const float prob = expf(scores[r * p.chunk + s] - rowml[2 * r]) / rowml[2 * r + 1];
    if constexpr (kCross) p.weights[(static_cast<int64_t>(head) * R + r) * p.n_keys + c0 + s] = prob;
    scores[r * p.chunk + s] = round_bf16(prob);
  }
  if (len == 0) {
    for (int i = tid; i < R * kHeadDim; i += kThreads) vec[i] = 0.f;
  }
  __syncthreads();

  // 4. P . V over the chunk: warp w takes keys w, w + 8, ...; lane takes dims 2 lane, 2 lane + 1.
  float acc0 = 0.f, acc1 = 0.f;
  for (int t = k_tiles; t < n_tiles; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* tile = ring + (t % kStages) * kTileElems;
    const int rem = t - k_tiles, r = rem / tiles_per_row, off = rem % tiles_per_row * kTileKeys;
    const int tk = min(kTileKeys, len - off);
    const float* prob = scores + r * p.chunk + off;
    for (int s = warp; s < tk; s += kWarps) {
      const float pr = prob[s];
      const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + s * kHeadDim + 2 * lane));
      acc0 = fmaf(pr, vv.x, acc0);
      acc1 = fmaf(pr, vv.y, acc1);
    }
    const bool row_end = rem % tiles_per_row == tiles_per_row - 1;
    if (row_end) {
      red[warp * kHeadDim + 2 * lane] = acc0;
      red[warp * kHeadDim + 2 * lane + 1] = acc1;
      acc0 = acc1 = 0.f;
    }
    __syncthreads();
    if (row_end && tid < kHeadDim) {
      float sum = 0.f;
      for (int w_i = 0; w_i < kWarps; ++w_i) sum += red[w_i * kHeadDim + tid];
      vec[r * kHeadDim + tid] = sum;
    }
    issue(t + kStages);
  }
  cluster.sync();  // every CTA's P . V partial is written
  for (int i = tid; i < R * kHeadDim; i += kThreads) rowvec[i] = round_bf16(cluster_sum(cluster, vec, i, csize));
  // No CTA may leave while another can still read its shared memory: arrive now, wait
  // before leaving, so that the barrier runs under the out-projection.
  cluster_arrive();

  // 5. This head's float32 partial of the out-projection on this CTA's columns: lane % 8
  // takes dims lane % 8 + 8 i, lane / 8 one group of 8 columns.
  cp_async_wait<0>();
  __syncthreads();
  const int es = lane % 8, groups = ncols / 8;
  float* partial = p.partials + static_cast<int64_t>(head) * R * d + rank * ncols;
  for (int g0 = warp * 4; g0 < groups; g0 += kWarps * 4) {
    const int g = g0 + lane / 8;
    const bool valid = g < groups;
    for (int r0 = 0; r0 < R; r0 += kRowGroup) {
      float acc[kRowGroup][8];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
      }
      if (valid) {
#pragma unroll
        for (int i = 0; i < kHeadDim / 8; ++i) {
          const int e = es + 8 * i;
          float wv[8];
          unpack8(*reinterpret_cast<const uint4*>(w_out_s + e * wcols + g * 8), wv);
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r) {
            const float h = r0 + r < R ? rowvec[(r0 + r) * kHeadDim + e] : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(h, wv[j], acc[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = acc[r][j];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          acc[r][j] = v;
        }
      }
      if (valid && es == 0) {
        for (int r = 0; r < kRowGroup && r0 + r < R; ++r) {
          float4* dst = reinterpret_cast<float4*>(partial + static_cast<int64_t>(r0 + r) * d + g * 8);
          dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
    }
  }

  // 6. The last CTA to finish this column slice sums the heads in head order. The barrier
  // orders every thread's partial before thread 0's release; its acquire, and the
  // barrier after it, order the other CTAs' partials before this CTA's reads.
  cluster_wait();
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> done(p.counters[rank]);
    last_s = done.fetch_add(1, cuda::memory_order_acq_rel) == p.heads - 1;
  }
  __syncthreads();
  if (!last_s) return;
  // Two neighbouring columns per thread, the heads' partials loaded kHeadBatch at a time.
  for (int i = tid; i < R * ncols / 2; i += kThreads) {
    const int r = i / (ncols / 2), c = i % (ncols / 2) * 2;
    const float2* column = reinterpret_cast<const float2*>(p.partials + static_cast<int64_t>(r) * d + rank * ncols + c);
    const int64_t head_stride = static_cast<int64_t>(R) * d / 2;
    float2 sum = make_float2(0.f, 0.f);
    for (int h0 = 0; h0 < p.heads; h0 += kHeadBatch) {
      float2 part[kHeadBatch];
#pragma unroll
      for (int j = 0; j < kHeadBatch; ++j) {
        part[j] = h0 + j < p.heads ? __ldcg(column + (h0 + j) * head_stride) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kHeadBatch; ++j) {
        if (h0 + j < p.heads) {
          sum.x += part[j].x;
          sum.y += part[j].y;
        }
      }
    }
    const float y0 = round_bf16(round_bf16(sum.x) + to_float(b_out_s[c]));
    const float y1 = round_bf16(round_bf16(sum.y) + to_float(b_out_s[c + 1]));
    const float2 residual = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res_s + r * ncols + c));
    *reinterpret_cast<__nv_bfloat162*>(p.out + static_cast<int64_t>(r) * d + rank * ncols + c) =
        __floats2bfloat162_rn(round_bf16(residual.x + y0), round_bf16(residual.y + y1));
  }
  if (tid == 0) cuda::atomic_ref<int, cuda::thread_scope_device>(p.counters[rank]).store(0, cuda::memory_order_relaxed);
}

template <bool kCross>
cudaError_t allow_smem() {
  static std::once_flag once;
  static cudaError_t status = cudaSuccess;
  std::call_once(once, [] {
    status = cudaFuncSetAttribute(attend_cluster_kernel<kCross>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem);
  });
  return status;
}

cudaLaunchConfig_t cluster_config(int heads, int cluster, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attribute) {
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = cluster;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(heads * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

bool valid_split(int rows, int heads, int n_keys, int d_model, int cluster, int chunk) {
  return rows > 0 && heads > 0 && n_keys > 0 && cluster >= 1 && cluster <= kMaxCluster &&
         d_model % (8 * cluster) == 0 && chunk == chunk_keys(n_keys, cluster);
}

template <bool kCross>
cudaError_t launch_attend(const AttendParams& params, int cluster, cudaStream_t stream) {
  if (!valid_split(params.rows, params.heads, params.n_keys, params.d_model, cluster, params.chunk)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = SmemLayout(params.rows, params.chunk, params.d_model / cluster).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kCross>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = cluster_config(params.heads, cluster, smem, stream, &attribute);
  err = cudaLaunchKernelEx(&config, attend_cluster_kernel<kCross>, params);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The TMA map of a (K, N) row-major bf16 weight: boxes of 32 columns x 256 rows, 64-byte
// swizzled (ldmatrix then reads 8 rows without bank conflicts).
bool weight_map(CUtensorMap* map, const void* w, int K, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {kTileCols, kBoxRows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// K3. x (R, d), ln_scale/ln_bias (d), w (d, n_out), b (n_out) bf16 -> out (R, n_out) bf16.
// With k_cache (R, H, 64, s_max) and v_cache (R, H, s_max, 64) (both or neither; n_out = 3d,
// d = 64 H), out is q (R, d) and the K and V parts go into the caches at `position`.
extern "C" int ser_ln_qkv_project(const void* x, const void* ln_scale, const void* ln_bias, const void* w,
                                  const void* b, void* out, void* k_cache, void* v_cache, int rows, int d,
                                  int n_out, int position, int s_max, float eps, void* stream) {
  const bool cached = k_cache != nullptr;
  if (rows <= 0 || d <= 0 || n_out <= 0 || n_out % kTileCols != 0 || cached != (v_cache != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cached && (n_out != 3 * d || d % kHeadDim != 0 || position < 0 || position >= s_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 1024 + static_cast<size_t>((d + kBoxRows - 1) / kBoxRows) * kBoxBytes +
                      sizeof(bf16) * kLnRows * static_cast<size_t>(d);
  if (d % 16 != 0 || smem > static_cast<size_t>(kLnQkvSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t allowed =
      cudaFuncSetAttribute(ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLnQkvSmem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  CUtensorMap w_map;
  if (!weight_map(&w_map, w, d, n_out)) return static_cast<int>(cudaErrorInvalidValue);
  LnQkvParams params = {};
  params.x = static_cast<const bf16*>(x);
  params.ln_scale = static_cast<const bf16*>(ln_scale);
  params.ln_bias = static_cast<const bf16*>(ln_bias);
  params.bias = static_cast<const bf16*>(b);
  params.out = static_cast<bf16*>(out);
  params.k_cache = static_cast<bf16*>(k_cache);
  params.v_cache = static_cast<bf16*>(v_cache);
  params.rows = rows;
  params.K = d;
  params.N = n_out;
  params.position = position;
  params.s_max = s_max;
  params.eps = eps;
  ln_qkv_kernel<<<n_out / kTileCols, kGemvThreads, smem, static_cast<cudaStream_t>(stream)>>>(w_map, params);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the K4 (cross = 0) or K5 (cross = 1) kernel can be resident at
// once for `cluster` CTAs per head, R rows and `chunk` keys per CTA; 0 where its shared
// memory does not fit. Written to *max_clusters (a host int).
extern "C" int ser_decode_step_clusters(int cross, int cluster, int rows, int heads, int chunk,
                                        int d_model, void* max_clusters) {
  int* count = static_cast<int*>(max_clusters);
  *count = 0;
  if (cluster < 1 || cluster > kMaxCluster || d_model % (8 * cluster) != 0 || chunk % kKeyAlign != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = SmemLayout(rows, chunk, d_model / cluster).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaSuccess);
  cudaError_t err = cross ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = cluster_config(heads, cluster, smem, nullptr, &attribute);
  err = cross ? cudaOccupancyMaxActiveClusters(count, attend_cluster_kernel<true>, &config)
              : cudaOccupancyMaxActiveClusters(count, attend_cluster_kernel<false>, &config);
  return static_cast<int>(err);
}

// K4. q (R, H, 64) with row stride q_row_stride; k_cache (R, H, 64, s_max); v_cache
// (R, H, s_max, 64); w_out (H * 64, d); b_out (d); x_res (R, d) bf16 -> out (R, d) bf16.
// Every pointer and q's rows are 16-byte aligned. Keys 0..position are visible. partials: (H, R, d) float32 scratch; counters: `cluster`
// ints, zero, left zero. chunk = chunk_keys(position + 1, cluster); s_max % 4 == 0.
extern "C" int ser_self_attend_and_out(const void* q, int q_row_stride, const void* k_cache,
                                       const void* v_cache, const void* w_out, const void* b_out,
                                       const void* x_res, void* partials, void* counters, void* out,
                                       int rows, int heads, int s_max, int position, int d_model,
                                       int cluster, int chunk, float root_d, void* stream) {
  AttendParams params = {};
  params.x = static_cast<const bf16*>(x_res);
  params.q = static_cast<const bf16*>(q);
  params.k = static_cast<const bf16*>(k_cache);
  params.v = static_cast<const bf16*>(v_cache);
  params.w_out = static_cast<const bf16*>(w_out);
  params.b_out = static_cast<const bf16*>(b_out);
  params.partials = static_cast<float*>(partials);
  params.counters = static_cast<int*>(counters);
  params.out = static_cast<bf16*>(out);
  params.q_row_stride = q_row_stride;
  params.rows = rows;
  params.heads = heads;
  params.s_stride = s_max;
  params.n_keys = position + 1;
  params.chunk = chunk;
  params.d_model = d_model;
  params.root_d = root_d;
  if (s_max % kKeyAlign != 0 || position < 0 || position >= s_max) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attend<false>(params, cluster, static_cast<cudaStream_t>(stream)));
}

// K5. x (R, d); ln_scale/ln_bias (d); w_q (H, d, 64); b_q (H * 64); k (R, H, 64, S);
// v (R, H, S, 64); w_out (H * 64, d); b_out (d) bf16 -> out (R, d) bf16 and weights
// (H, R, S) float32. partials: (H, R, d) float32 scratch; counters: `cluster` ints, zero,
// left zero. chunk = chunk_keys(S, cluster); S % 4 == 0.
extern "C" int ser_cross_attention_step(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w_q, const void* b_q, const void* k,
                                        const void* v, const void* w_out, const void* b_out,
                                        void* partials, void* counters, void* out, void* weights,
                                        int rows, int heads, int s_len, int d_model, int cluster,
                                        int chunk, float eps, float root_d, void* stream) {
  AttendParams params = {};
  params.x = static_cast<const bf16*>(x);
  params.ln_scale = static_cast<const bf16*>(ln_scale);
  params.ln_bias = static_cast<const bf16*>(ln_bias);
  params.w_q = static_cast<const bf16*>(w_q);
  params.b_q = static_cast<const bf16*>(b_q);
  params.k = static_cast<const bf16*>(k);
  params.v = static_cast<const bf16*>(v);
  params.w_out = static_cast<const bf16*>(w_out);
  params.b_out = static_cast<const bf16*>(b_out);
  params.weights = static_cast<float*>(weights);
  params.partials = static_cast<float*>(partials);
  params.counters = static_cast<int*>(counters);
  params.out = static_cast<bf16*>(out);
  params.rows = rows;
  params.heads = heads;
  params.s_stride = s_len;
  params.n_keys = s_len;
  params.chunk = chunk;
  params.d_model = d_model;
  params.eps = eps;
  params.root_d = root_d;
  if (s_len % kKeyAlign != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attend<true>(params, cluster, static_cast<cudaStream_t>(stream)));
}
