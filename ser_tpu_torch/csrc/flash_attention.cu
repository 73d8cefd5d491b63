// Kernel K2: bidirectional flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel behind ser_tpu/models/attention.py::_flash_path
// (jax.experimental.pallas.ops.tpu.flash_attention), which the Whisper
// encoder calls once per layer. It computes, per (batch, head),
//   out = softmax(q k^T / sqrt(D) + bias) v
// with q, k, v, out bf16 in the (B, T, H, D) layout of the callers (read
// through strides, so no transposes), D = 64, float32 scores, softmax and
// accumulation. `key_mask` (B, T) is optional; a masked key gets the einsum
// path's -1e30 bias, so every query row attends to the valid keys. The TPU
// kernel cuts the mask as segment ids, which differs only on masked *query*
// rows; nobody reads those. Keys at or past T in the last tile are excluded,
// so T needs no padding (T = 1500 for Whisper).
//
// Bound on the H100: at the encoder's shapes (B = 8, H = 20, T = 1500) one
// call is about 92 GFLOP of bf16 matrix products (93 us at 989 TFLOP/s dense,
// data sheet) against about 123 MB of q, k, v and out (37 us at 3.35 TB/s),
// so the tensor cores bound it.
// Design: one block of 4 warps per (batch, head, 64-query tile); each warp
// owns 16 query rows, keeps its Q fragments and its float32 output in
// registers, and walks the keys in tiles of 64 with a running max and running
// sum (online softmax), so the (T, T) score matrix never reaches device
// memory. K and V tiles are staged row-major in shared memory, two tiles deep:
// cp.async fetches tile i+1 while the tensor cores work on tile i. Q K^T and
// P V run as mma.sync m16n8k16 (bf16 in, float32 accumulate), with K's
// fragments read by ldmatrix and V's by ldmatrix.trans. It does not use wgmma
// or TMA; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;
constexpr int kBlockK = 64;
constexpr int kLd = kHeadDim + 8;  // padded smem row (bf16): conflict-free fragment loads and ldmatrix

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies 16 bytes global -> shared without the registers; `full` false writes 16 zero bytes.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most one committed group of this thread is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i] (as mma fragments: row = lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, each matrix transposed (column = lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// D += A (16x16, row-major) * B (16x8, column-major); bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const uint8_t* __restrict__ key_mask, __nv_bfloat16* __restrict__ out,
                           int seq, int heads, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBlockK * kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row (and B column) group of the mma fragments
  const int t4 = lane & 3;  // thread within the group

  const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * seq * row_stride + static_cast<size_t>(h) * kHeadDim;
  const __nv_bfloat16* q_bh = q + head_base;
  const __nv_bfloat16* k_bh = k + head_base;
  const __nv_bfloat16* v_bh = v + head_base;
  __nv_bfloat16* out_bh = out + head_base;
  const uint8_t* mask_b = key_mask ? key_mask + static_cast<size_t>(b) * seq : nullptr;

  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as A fragments: 4 steps of 16 along D.
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = r0 < seq ? load_pair(q_bh + r0 * row_stride + c) : 0u;
    qf[kk][1] = r1 < seq ? load_pair(q_bh + r1 * row_stride + c) : 0u;
    qf[kk][2] = r0 < seq ? load_pair(q_bh + r0 * row_stride + c + 8) : 0u;
    qf[kk][3] = r1 < seq ? load_pair(q_bh + r1 * row_stride + c + 8) : 0u;
  }

  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 domain) of rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums

  // Stages key tile `tile` (K and V rows, row-major) into buffer `buf`; keys at
  // or past `seq` are zero-filled.
  auto load_tile = [&](int tile, int buf) {
    for (int i = threadIdx.x; i < kBlockK * (kHeadDim / 8); i += kThreads) {
      const int r = i >> 3;
      const int c8 = (i & 7) * 8;
      const int key = tile * kBlockK + r;
      const bool valid = key < seq;
      const size_t offset = static_cast<size_t>(valid ? key : 0) * row_stride + c8;
      cp_async_16(&k_s[buf][r * kLd + c8], k_bh + offset, valid);
      cp_async_16(&v_s[buf][r * kLd + c8], v_bh + offset, valid);
    }
  };

  const int n_tiles = (seq + kBlockK - 1) / kBlockK;
  load_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    // Buffer buf ^ 1 was last read in the previous iteration, which ended in a barrier.
    if (tile + 1 < n_tiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_one();  // this thread's copies of `tile` have landed
    __syncthreads();              // and every other thread's too
    const int k0 = tile * kBlockK;
    const __nv_bfloat16* ks = k_s[buf];
    const __nv_bfloat16* vs = v_s[buf];

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys; one ldmatrix
    // gives the B fragments of 8 keys over 32 of the 64 dimensions.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (nt * 8 + (lane & 7)) * kLd + half * 32 + (lane >> 3) * 8);
        mma_16816(s[nt], qf[2 * half], kb[0], kb[1]);
        mma_16816(s[nt], qf[2 * half + 1], kb[2], kb[3]);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale_log2;
        if (key >= seq) {
          x = -CUDART_INF_F;
        } else if (mask_b != nullptr && mask_b[key] == 0) {
          x = -1e30f;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // Key k0 < seq is in every tile, so mx0 and mx1 are finite here.
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    // O += P V: the score accumulators are already laid out as A fragments;
    // one ldmatrix.trans gives the B fragments of two 8-column output tiles.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {pack_pair(s[2 * j][0], s[2 * j][1]), pack_pair(s[2 * j][2], s[2 * j][3]),
                             pack_pair(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_pair(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (j * 16 + (lane & 15)) * kLd + dp * 16 + (lane >> 4) * 8);
        mma_16816(o[2 * dp], a, b[0], b[1]);
        mma_16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < seq) {
      *reinterpret_cast<uint32_t*>(out_bh + r0 * row_stride + c) = pack_pair(o[dt][0] * inv0, o[dt][1] * inv0);
    }
    if (r1 < seq) {
      *reinterpret_cast<uint32_t*>(out_bh + r1 * row_stride + c) = pack_pair(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
}

}  // namespace

extern "C" int ser_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* key_mask, void* out, int batch, int seq,
                                       int heads, int head_dim, float scale, void* stream) {
  if (head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), seq, heads, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
