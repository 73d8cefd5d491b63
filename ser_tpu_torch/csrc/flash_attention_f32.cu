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
// strides, so no transposes), D = 64, every product and sum in float32 (no
// TF32: one TF32 pass errs by about 1e-4 at T = 1500, five times the float32
// limit). `key_mask` is optional: (B, mask_stride) uint8, mask_stride at
// least T rounded up to the 64-key tile and a multiple of 16; a masked key gets
// the einsum path's -1e30 bias, so a query attends to the valid keys (the
// port masks keys only; valid rows agree with the TPU kernel's segment ids).
// Keys at or past T are excluded.
//
// Bound on the H100: at the medium profile's shapes (B = 8, T = 1499, H = 16)
// one call is 4 B H T^2 D = 73.6 GFLOP against 123 MB of q, k, v and out
// (0.037 ms at 3.35 TB/s), so the arithmetic bounds it: 1.10 ms at the 67
// TFLOP/s of float32 FMA outside the tensor cores, which is this design's own
// bound, or 0.45 ms for float32-grade products on the tensor cores (three TF32
// products each, at 495 TFLOP/s dense). Its 287 M exponentials take 0.07 ms at
// the special-function units' rate.
//
// Design: plain FFMA, right before fast. A block is 128 threads and owns 128
// queries of one (batch, head), one query row per thread: q (64 floats) and
// the output accumulator (64 floats) live in that thread's registers. K and V
// stream through shared memory in 64-key tiles by cp.async, double-buffered
// (the next tile's copy runs under this tile's arithmetic), with zeros past T.
// Every thread of a warp reads the same key row at once (a broadcast, no bank
// conflicts), so shared memory serves one 16-byte load per four FMAs. The
// online softmax runs over chunks of 16 keys: 16 dot products (1024 FMAs),
// one rescale of the accumulator, 16 exponentials (exp2 of scores prescaled
// by log2(e) / sqrt(D)), then 1024 FMAs of P V. Nothing is rounded below
// float32; only the order of the sums differs from the plain version's.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 128;  // queries per block, one per thread
constexpr int kThreads = kBlockQ;
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax step
constexpr int kStages = 2;
constexpr int kRowChunks = kHeadDim * 4 / 16;  // 16-byte pieces of one key row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedScore = -1e30f;  // the einsum path's bias on a masked key

static_assert(kBlockK % kChunk == 0, "a tile holds whole chunks");

struct Tiles {
  float k[kStages][kBlockK][kHeadDim];
  float v[kStages][kBlockK][kHeadDim];
  uint8_t mask[kStages][kBlockK];
};

// 16 bytes from global to shared memory; zeros when `valid` is false (no read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copy of the key tile at k0 (K, V and the mask bytes) into `stage`.
__device__ __forceinline__ void load_tile(Tiles& tiles, int stage, const float* k, const float* v,
                                          const uint8_t* key_mask, int b, int h, int k0, int seq, int heads,
                                          int mask_stride) {
  for (int i = threadIdx.x; i < kBlockK * kRowChunks; i += kThreads) {
    const int row = i / kRowChunks;
    const int col = (i % kRowChunks) * 4;
    const int key = k0 + row;
    const bool valid = key < seq;
    const size_t offset = ((static_cast<size_t>(b) * seq + (valid ? key : 0)) * heads + h) * kHeadDim + col;
    cp_async16(&tiles.k[stage][row][col], k + offset, valid);
    cp_async16(&tiles.v[stage][row][col], v + offset, valid);
  }
  if (key_mask != nullptr && threadIdx.x < kBlockK / 16) {
    cp_async16(&tiles.mask[stage][threadIdx.x * 16],
               key_mask + static_cast<size_t>(b) * mask_stride + k0 + threadIdx.x * 16, true);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
                               float* __restrict__ out, int seq, int heads, int mask_stride, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles& tiles = *reinterpret_cast<Tiles*>(smem_raw);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool row_valid = row < seq;
  const size_t row_offset = ((static_cast<size_t>(b) * seq + (row_valid ? row : 0)) * heads + h) * kHeadDim;
  const int n_tiles = (seq + kBlockK - 1) / kBlockK;

  load_tile(tiles, 0, k, v, key_mask, b, h, 0, seq, heads, mask_stride);

  float qr[kHeadDim];
  const float4* q4 = reinterpret_cast<const float4*>(q + row_offset);
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4) {
    const float4 x = q4[d / 4];
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
  }
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float row_max = -CUDART_INF_F;  // running max of the scaled scores (log2 units)
  float row_sum = 0.f;            // running sum of exp2(score - row_max)

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tiles, stage ^ 1, k, v, key_mask, b, h, (tile + 1) * kBlockK, seq, heads, mask_stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_keys = min(kBlockK, seq - tile * kBlockK);
    const float(*kt)[kHeadDim] = tiles.k[stage];
    const float(*vt)[kHeadDim] = tiles.v[stage];
    // The first key of every chunk is below T, so each chunk's max is finite.
    for (int c = 0; c < n_keys; c += kChunk) {
      float score[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) score[j] = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 4) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(&kt[c + j][d]);
          score[j] = fmaf(qr[d], kv.x, score[j]);
          score[j] = fmaf(qr[d + 1], kv.y, score[j]);
          score[j] = fmaf(qr[d + 2], kv.z, score[j]);
          score[j] = fmaf(qr[d + 3], kv.w, score[j]);
        }
      }
      float chunk_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int key = c + j;
        float x = score[j] * scale_log2;
        if (key_mask != nullptr && !tiles.mask[stage][key]) x = kMaskedScore;
        if (key >= n_keys) x = -CUDART_INF_F;  // past T: no weight at all
        score[j] = x;
        chunk_max = fmaxf(chunk_max, x);
      }
      const float new_max = fmaxf(row_max, chunk_max);
      const float rescale = exp2f(row_max - new_max);
      row_max = new_max;
      row_sum *= rescale;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] *= rescale;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(score[j] - new_max);
        row_sum += p;
#pragma unroll
        for (int d = 0; d < kHeadDim; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vt[c + j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
    }
    __syncthreads();  // every thread is done with `stage` before the next copy into it
  }

  if (row_valid) {
    const float inv = 1.f / row_sum;
    float4* o4 = reinterpret_cast<float4*>(out + row_offset);
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      o4[d / 4] = make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
  }
}

}  // namespace

// K2-f32 on `stream`. q, k, v, out: (B, T, H, 64) float32, contiguous, 16-byte
// aligned. `key_mask` (B, mask_stride) uint8 or null; `mask_stride` is read
// only with a mask: at least T rounded up to 64, a multiple of 16.
extern "C" int ser_flash_attention_f32(const void* q, const void* k, const void* v, const void* key_mask,
                                       void* out, int batch, int seq, int heads, int head_dim, int mask_stride,
                                       float scale, void* stream) {
  if (head_dim != kHeadDim || seq <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int padded = (seq + kBlockK - 1) / kBlockK * kBlockK;
  if (key_mask != nullptr && (mask_stride < padded || mask_stride % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(Tiles));
  cudaError_t err =
      cudaFuncSetAttribute(flash_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_attention_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<float*>(out), seq, heads, mask_stride, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
