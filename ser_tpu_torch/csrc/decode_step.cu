// Kernels K3, K4 and K5: the Whisper decode step's attention groups, for Hopper (sm_90a).
//
// Replace the three TPU kernels of ser_tpu/ops/decode_step_kernels.py:
//   K3  ln_qkv_project       (_ln_qkv_kernel)      float32 LayerNorm -> x . W_qkv + b
//   K4  self_attend_and_out  (_self_attend_kernel) one query per (row, head) over the
//       self-attention cache, keys <= position, out-projection + bias + residual
//   K5  cross_attention_step (_cross_step_kernel)  LayerNorm -> per-head Q -> one query
//       over the encoder K/V -> out-projection + bias + residual, and the float32
//       attention weights (H, R, S) for the alignment heads
//
// Rounding points are the TPU kernels' (and the unfused decode's): LayerNorm in float32,
// rounded to bf16 before the product; every product accumulates in float32 and rounds
// to bf16 at its output; bias and residual adds round to bf16; scores are rounded to
// bf16, divided by bf16(sqrt(Dh)) in bf16, and the softmax runs in float32; P is rounded
// to bf16 before P . V. The out-projection sums all heads in float32 before its one
// rounding (the TPU kernel sums per-head float32 partials: the same sum in another order).
//
// Bound on the H100: at decode batch (R = 1-20 rows) all three are bound by bytes: each
// weight matrix is read once per call for a handful of rows (K3 9.8 MB, K4 3.3 MB of
// W_out plus the cache up to `position`, K5 6.6 MB of W_q and W_out plus 3.8 MB of K/V
// per row at large-v3). The designs stream each byte once, coalesced:
// - the projections are one GEMV kernel: a block owns 32 output columns, its 256 threads
//   split the reduction dimension 64 ways and each reads 16 bytes of a weight row per
//   step, four steps in flight; the 64 partial sums meet through warp shuffles and shared
//   memory in a fixed order (no atomics). Each block recomputes the LayerNorm of its rows
//   into shared memory, which is cheaper than a second launch. Rows go through in groups
//   of 4, so the weights are read from device memory once and from L2 after that.
// - attention is one block per (row, head), reading K (Dh, S) two keys per thread and V
//   (S, Dh) one key row per warp step. K4 reads only the position + 1 visible keys:
//   masked keys take exactly zero weight in float32 either way, and poisoned future
//   slots are never read.
// K4 and K5 are two and three launches on one stream: attention writes each head's bf16
// output to a scratch (R, H * Dh) buffer, which the out-projection GEMV then reads, so the
// head sum has a fixed order. Splitting S over several blocks per (row, head), flash-
// decoding style, and fusing the launches are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;                            // output columns per GEMV block
constexpr int kColsPerThread = 8;                        // one 16-byte load of bf16
constexpr int kColThreads = kTileCols / kColsPerThread;  // 4 threads span a tile row
constexpr int kSlices = kThreads / kColThreads;          // 64 slices of the reduction dim
constexpr int kRowGroup = 4;                             // input rows per pass over W
constexpr int kUnroll = 4;                               // weight loads in flight per thread
constexpr int kHeadDim = 64;

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// Sum (or max) of one float per thread over the block; every thread gets the same value.
template <bool kMax>
__device__ float block_reduce(float value, float* scratch) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, value, offset);
    value = kMax ? fmaxf(value, other) : value + other;
  }
  __syncthreads();  // the previous reduction's readers are done with scratch
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = value;
  __syncthreads();
  float total = scratch[0];
  for (int w = 1; w < kWarps; ++w) total = kMax ? fmaxf(total, scratch[w]) : total + scratch[w];
  return total;
}

// out[r, n] = bf16(bf16(sum_k a[r, k] W(k, n)) + bias[n]), then + residual[r, n] rounded
// again when kResidual. a is x (bf16), or with kLayerNorm the float32 LayerNorm of x
// (fast variance E[x^2] - E[x]^2, as flax) rounded to bf16.
// W(k, n) = w[(n / hc) * K * hc + k * hc + n % hc]: hc = N reads a row-major (K, N)
// matrix, hc = Dh reads per-head (H, K, Dh) blocks. Grid: N / 32 blocks.
template <bool kLayerNorm, bool kResidual>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const bf16* __restrict__ x, int x_row_stride, const bf16* __restrict__ ln_scale,
            const bf16* __restrict__ ln_bias, const bf16* __restrict__ w,
            const bf16* __restrict__ bias, const bf16* __restrict__ residual,
            bf16* __restrict__ out, int rows, int K, int N, int hc, float eps) {
  extern __shared__ float a_s[];  // kRowGroup * K
  __shared__ float part_s[kWarps][kRowGroup][kTileCols];
  __shared__ float red_s[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col_thread = lane % kColThreads;
  const int slice = warp * (32 / kColThreads) + lane / kColThreads;
  const int n0 = blockIdx.x * kTileCols;
  const int col = n0 + col_thread * kColsPerThread;
  const bf16* w_col = w + static_cast<int64_t>(col / hc) * K * hc + col % hc;

  for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
    const int group = min(kRowGroup, rows - r0);
    for (int r = 0; r < kRowGroup; ++r) {
      float* a_row = a_s + r * K;
      if (r >= group) {
        for (int k = tid; k < K; k += kThreads) a_row[k] = 0.f;
        continue;
      }
      const bf16* x_row = x + static_cast<int64_t>(r0 + r) * x_row_stride;
      if (kLayerNorm) {
        float sum = 0.f, sum_sq = 0.f;
        for (int k = tid; k < K; k += kThreads) {
          const float v = to_float(x_row[k]);
          sum += v;
          sum_sq += v * v;
        }
        const float mean = block_reduce<false>(sum, red_s) / K;
        const float mean_sq = block_reduce<false>(sum_sq, red_s) / K;
        const float inv = rsqrtf(fmaxf(0.f, mean_sq - mean * mean) + eps);
        for (int k = tid; k < K; k += kThreads) {
          const float normed = (to_float(x_row[k]) - mean) * inv;
          a_row[k] = round_bf16(normed * to_float(ln_scale[k]) + to_float(ln_bias[k]));
        }
      } else {
        for (int k = tid; k < K; k += kThreads) a_row[k] = to_float(x_row[k]);
      }
    }
    __syncthreads();

    float acc[kRowGroup][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;
    }
    for (int k_base = slice; k_base < K; k_base += kSlices * kUnroll) {
      uint4 packed[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k_base + u * kSlices;
        packed[u] = k < K ? *reinterpret_cast<const uint4*>(w_col + static_cast<int64_t>(k) * hc)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k_base + u * kSlices;
        if (k >= K) break;
        const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&packed[u]);
        float wv[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread / 2; ++j) {
          const float2 f = __bfloat1622float2(pairs[j]);
          wv[2 * j] = f.x;
          wv[2 * j + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) {
          const float a = a_s[r * K + k];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = fmaf(a, wv[j], acc[r][j]);
        }
      }
    }
    // The 8 slices of a warp differ in lane / kColThreads: fold them by shuffles.
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        float v = acc[r][j];
        for (int offset = kColThreads; offset < 32; offset <<= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, offset);
        }
        acc[r][j] = v;
      }
    }
    if (lane < kColThreads) {
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          part_s[warp][r][col_thread * kColsPerThread + j] = acc[r][j];
        }
      }
    }
    __syncthreads();
    if (tid < group * kTileCols) {
      const int r = tid / kTileCols, c = tid % kTileCols, n = n0 + c;
      float sum = 0.f;
      for (int w_i = 0; w_i < kWarps; ++w_i) sum += part_s[w_i][r][c];
      float y = round_bf16(round_bf16(sum) + to_float(bias[n]));
      const int64_t at = static_cast<int64_t>(r0 + r) * N + n;
      if (kResidual) y = round_bf16(to_float(residual[at]) + y);
      out[at] = __float2bfloat16(y);
    }
    __syncthreads();  // a_s and part_s are rewritten by the next row group
  }
}

// One block per (row, head). q: (R, H, Dh) with row stride q_row_stride; k: (R, H, Dh,
// s_max); v: (R, H, s_max, Dh). Attends over keys [0, n_keys). out: (R, H, Dh) bf16;
// weights (kWeights): (H, R, s_max) float32, the softmax before its bf16 rounding.
template <bool kWeights>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const bf16* __restrict__ q, int q_row_stride, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ weights,
              int rows, int heads, int s_max, int n_keys, float root_d) {
  extern __shared__ float p_s[];  // s_max
  __shared__ float q_s[kHeadDim];
  __shared__ float red_s[kWarps];
  __shared__ float pv_s[kWarps][kHeadDim];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x / heads, head = blockIdx.x % heads;
  const int64_t cache = (static_cast<int64_t>(row) * heads + head) * kHeadDim * s_max;
  const bf16* k_head = k + cache;  // (Dh, s_max)
  const bf16* v_head = v + cache;  // (s_max, Dh)
  if (tid < kHeadDim) q_s[tid] = to_float(q[static_cast<int64_t>(row) * q_row_stride + head * kHeadDim + tid]);
  __syncthreads();

  // Scores, two neighbouring keys per thread (4-byte loads along s; s_max is even).
  float local_max = -INFINITY;
  for (int s = 2 * tid; s < n_keys; s += 2 * kThreads) {
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll 8
    for (int j = 0; j < kHeadDim; ++j) {
      const float2 kk =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k_head + static_cast<int64_t>(j) * s_max + s));
      dot0 = fmaf(q_s[j], kk.x, dot0);
      dot1 = fmaf(q_s[j], kk.y, dot1);
    }
    const float score0 = round_bf16(round_bf16(dot0) / root_d);
    p_s[s] = score0;
    local_max = fmaxf(local_max, score0);
    if (s + 1 < n_keys) {
      const float score1 = round_bf16(round_bf16(dot1) / root_d);
      p_s[s + 1] = score1;
      local_max = fmaxf(local_max, score1);
    }
  }
  const float max_score = block_reduce<true>(local_max, red_s);
  float local_sum = 0.f;
  for (int s = tid; s < n_keys; s += kThreads) {
    const float e = expf(p_s[s] - max_score);
    p_s[s] = e;
    local_sum += e;
  }
  const float total = block_reduce<false>(local_sum, red_s);
  float* weights_row = kWeights ? weights + (static_cast<int64_t>(head) * rows + row) * s_max : nullptr;
  for (int s = tid; s < n_keys; s += kThreads) {
    const float p = p_s[s] / total;
    if (kWeights) weights_row[s] = p;
    p_s[s] = round_bf16(p);
  }
  __syncthreads();

  // P . V: warp w takes keys w, w + 8, ...; lane takes dims 2 lane and 2 lane + 1.
  float acc0 = 0.f, acc1 = 0.f;
  for (int s = warp; s < n_keys; s += kWarps) {
    const float p = p_s[s];
    const float2 vv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(v_head + static_cast<int64_t>(s) * kHeadDim + 2 * lane));
    acc0 = fmaf(p, vv.x, acc0);
    acc1 = fmaf(p, vv.y, acc1);
  }
  pv_s[warp][2 * lane] = acc0;
  pv_s[warp][2 * lane + 1] = acc1;
  __syncthreads();
  if (tid < kHeadDim) {
    float sum = 0.f;
    for (int w_i = 0; w_i < kWarps; ++w_i) sum += pv_s[w_i][tid];
    out[(static_cast<int64_t>(row) * heads + head) * kHeadDim + tid] = __float2bfloat16(sum);
  }
}

size_t gemv_smem(int K) { return sizeof(float) * kRowGroup * static_cast<size_t>(K); }
size_t attend_smem(int s_max) { return sizeof(float) * static_cast<size_t>(s_max); }

template <bool kLayerNorm, bool kResidual>
cudaError_t launch_gemv(const bf16* x, int x_row_stride, const bf16* ln_scale, const bf16* ln_bias,
                        const bf16* w, const bf16* bias, const bf16* residual, bf16* out, int rows,
                        int K, int N, int hc, float eps, cudaStream_t stream) {
  gemv_kernel<kLayerNorm, kResidual><<<N / kTileCols, kThreads, gemv_smem(K), stream>>>(
      x, x_row_stride, ln_scale, ln_bias, w, bias, residual, out, rows, K, N, hc, eps);
  return cudaGetLastError();
}

template <bool kWeights>
cudaError_t launch_attend(const bf16* q, int q_row_stride, const bf16* k, const bf16* v, bf16* out,
                          float* weights, int rows, int heads, int s_max, int n_keys, float root_d,
                          cudaStream_t stream) {
  attend_kernel<kWeights><<<rows * heads, kThreads, attend_smem(s_max), stream>>>(
      q, q_row_stride, k, v, out, weights, rows, heads, s_max, n_keys, root_d);
  return cudaGetLastError();
}

}  // namespace

// K3. x (R, d), ln_scale/ln_bias (d), w (d, n_out), b (n_out) bf16 -> out (R, n_out) bf16.
extern "C" int ser_ln_qkv_project(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w, const void* b, void* out, int rows, int d,
                                  int n_out, float eps, void* stream) {
  return static_cast<int>(launch_gemv<true, false>(
      static_cast<const bf16*>(x), d, static_cast<const bf16*>(ln_scale),
      static_cast<const bf16*>(ln_bias), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      nullptr, static_cast<bf16*>(out), rows, d, n_out, n_out, eps, static_cast<cudaStream_t>(stream)));
}

// K4. q (R, H, 64) with row stride q_row_stride; k_cache (R, H, 64, s_max); v_cache
// (R, H, s_max, 64); w_out (H * 64, d); b_out (d); x_res (R, d) bf16; heads (R, H * 64)
// bf16 scratch -> out (R, d) bf16. Keys 0..position are visible.
extern "C" int ser_self_attend_and_out(const void* q, int q_row_stride, const void* k_cache,
                                       const void* v_cache, const void* w_out, const void* b_out,
                                       const void* x_res, void* heads_out, void* out, int rows,
                                       int heads, int s_max, int position, int d_model,
                                       float root_d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = heads * kHeadDim;
  cudaError_t err = launch_attend<false>(
      static_cast<const bf16*>(q), q_row_stride, static_cast<const bf16*>(k_cache),
      static_cast<const bf16*>(v_cache), static_cast<bf16*>(heads_out), nullptr, rows, heads, s_max,
      position + 1, root_d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gemv<false, true>(
      static_cast<const bf16*>(heads_out), width, nullptr, nullptr, static_cast<const bf16*>(w_out),
      static_cast<const bf16*>(b_out), static_cast<const bf16*>(x_res), static_cast<bf16*>(out), rows,
      width, d_model, d_model, 0.f, s));
}

// K5. x (R, d); ln_scale/ln_bias (d); w_q (H, d, 64); b_q (H * 64); k (R, H, 64, S);
// v (R, H, S, 64); w_out (H * 64, d); b_out (d) bf16; q_out and heads_out (R, H * 64) bf16
// scratch -> out (R, d) bf16 and weights (H, R, S) float32.
extern "C" int ser_cross_attention_step(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* w_q, const void* b_q, const void* k,
                                        const void* v, const void* w_out, const void* b_out,
                                        void* q_out, void* heads_out, void* out, void* weights,
                                        int rows, int heads, int s_len, int d_model, float eps,
                                        float root_d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = heads * kHeadDim;
  cudaError_t err = launch_gemv<true, false>(
      static_cast<const bf16*>(x), d_model, static_cast<const bf16*>(ln_scale),
      static_cast<const bf16*>(ln_bias), static_cast<const bf16*>(w_q), static_cast<const bf16*>(b_q),
      nullptr, static_cast<bf16*>(q_out), rows, d_model, width, kHeadDim, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attend<true>(static_cast<const bf16*>(q_out), width, static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(heads_out),
                            static_cast<float*>(weights), rows, heads, s_len, s_len, root_d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gemv<false, true>(
      static_cast<const bf16*>(heads_out), width, nullptr, nullptr, static_cast<const bf16*>(w_out),
      static_cast<const bf16*>(b_out), static_cast<const bf16*>(x), static_cast<bf16*>(out), rows,
      width, d_model, d_model, 0.f, s));
}
