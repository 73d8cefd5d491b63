// Kernel K2: bidirectional flash attention for Hopper (sm_90a), forward and
// backward (K2-bwd).
//
// Replaces the TPU kernel behind ser_tpu/models/attention.py::_flash_path
// (jax.experimental.pallas.ops.tpu.flash_attention), which the Whisper
// encoder calls once per layer, and its backward (the Pallas dkv and dq
// kernels, block sizes at ser_tpu/models/attention.py:96-113), which encoder
// training runs. The forward computes, per (batch, head),
//   out = softmax(q k^T / sqrt(D) + bias) v
// with q, k, v, out bf16 in the (B, T, H, D) layout of the callers (read
// through strides, so no transposes), D = 64, float32 scores, softmax and
// accumulation. `key_mask` (B, T) is optional; a masked key gets the einsum
// path's -1e30 bias, so every query row attends to the valid keys. The TPU
// kernel cuts the mask as segment ids, which differs only on masked *query*
// rows; nobody reads those. Keys at or past T in the last tile are excluded,
// so T needs no padding (T = 1500 for Whisper). Given a pointer, the forward
// also writes the float32 (B, H, T_pad) log-sum-exp of the scaled scores in
// natural-log units (0 past T), which the backward reads.
//
// Bound on the H100: at the encoder's shapes (B = 8, H = 20, T = 1500) one
// forward is about 92 GFLOP of bf16 matrix products (93 us at 989 TFLOP/s
// dense, data sheet) against about 123 MB of q, k, v and out (37 us at
// 3.35 TB/s), so the tensor cores bound it. The backward at the training
// step's (4, 1500, 20, 64) does five such T x T x D products (115 GFLOP,
// 0.117 ms) against about 123 MB of q, k, v, out, dout, dq, dk, dv: also
// bound by the tensor cores.
// Design, forward: one block of 4 warps per (batch, head, 64-query tile);
// each warp owns 16 query rows, keeps its Q fragments and its float32 output
// in registers, and walks the keys in tiles of 64 with a running max and
// running sum (online softmax), so the (T, T) score matrix never reaches
// device memory. K and V tiles are staged row-major in shared memory, two
// tiles deep: cp.async fetches tile i+1 while the tensor cores work on tile i.
// Q K^T and P V run as mma.sync m16n8k16 (bf16 in, float32 accumulate), with
// K's fragments read by ldmatrix and V's by ldmatrix.trans.
// Design, backward: the Pallas kernel's split. A small pass computes
// Delta = rowsum(dO * O) in float32; a dK/dV kernel (one block per 64-key
// tile) walks the query tiles and a dQ kernel (one block per 64-query tile)
// walks the key tiles, each recomputing P from the saved log-sum-exp, so no
// (T, T) matrix reaches device memory and no sum needs atomics (dQ is the
// same bit for bit on every run). The same mma.sync fragments and cp.async
// double buffering as the forward. Neither direction uses wgmma or TMA yet.

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
                           float* __restrict__ lse, int seq, int heads, int lse_stride, float scale_log2) {
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
  if (lse != nullptr && t4 == 0) {
    // Natural-log log-sum-exp of the scaled scores; rows past T (up to the
    // last query tile's end) get 0, so the backward can read whole tiles.
    float* lse_bh = lse + (static_cast<size_t>(b) * heads + h) * lse_stride;
    lse_bh[r0] = r0 < seq ? (m0 + log2f(l0)) * kLn2 : 0.f;
    lse_bh[r1] = r1 < seq ? (m1 + log2f(l1)) * kLn2 : 0.f;
  }
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


// --------------------------------------------------------------------------- //
// K2-bwd: dQ, dK, dV of the unmasked attention, from q, k, v, out, dout and the
// forward's log-sum-exp. With S = q k^T * scale, P = exp(S - lse),
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(dO * O),  dS = P * (dP - Delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// --------------------------------------------------------------------------- //

// Delta, float32 (B, H, T_pad): eight threads per (b, h, t) row, 16 bytes of
// out and of dout each; rows t in [T, T_pad) get 0.
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                                 float* __restrict__ delta, int batch, int seq, int heads, int lse_stride) {
  const int part = threadIdx.x & 7;
  const size_t row = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const size_t rows = static_cast<size_t>(batch) * heads * lse_stride;
  const bool in_range = row < rows;
  const int t = static_cast<int>(row % lse_stride);
  const size_t bh = row / lse_stride;
  float acc = 0.f;
  if (in_range && t < seq) {
    const size_t b = bh / heads;
    const size_t h = bh % heads;
    const size_t offset = ((b * seq + t) * heads + h) * kHeadDim + part * 8;
    const uint4 o4 = *reinterpret_cast<const uint4*>(out + offset);
    const uint4 d4 = *reinterpret_cast<const uint4*>(dout + offset);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 c = __bfloat1622float2(d2[i]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (in_range && part == 0) delta[row] = acc;
}

// A operand (16 rows x 64 of D) of one warp, rows `r0` and `r0 + 8`, from a
// (T, H, D) head slice with `row_stride` elements per row; rows past `seq` are 0.
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[4][4], const __nv_bfloat16* base, size_t row_stride,
                                            int r0, int seq, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t4 * 2;
    f[kk][0] = r0 < seq ? load_pair(base + r0 * row_stride + c) : 0u;
    f[kk][1] = r1 < seq ? load_pair(base + r1 * row_stride + c) : 0u;
    f[kk][2] = r0 < seq ? load_pair(base + r0 * row_stride + c + 8) : 0u;
    f[kk][3] = r1 < seq ? load_pair(base + r1 * row_stride + c + 8) : 0u;
  }
}

// acc (16 x 64) = A (16 x 64, fragments `a`) times the transpose of the
// row-major 64 x 64 tile `tile` (B[k][n] = tile[n][k]).
__device__ __forceinline__ void mma_a_tile_t(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                             const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t bfrag[4];
      ldmatrix_x4(bfrag, tile + (nt * 8 + (lane & 7)) * kLd + half * 32 + (lane >> 3) * 8);
      mma_16816(acc[nt], a[2 * half], bfrag[0], bfrag[1]);
      mma_16816(acc[nt], a[2 * half + 1], bfrag[2], bfrag[3]);
    }
  }
}

// acc (16 x 64) += X (16 x 64, float32 accumulators rounded to bf16) times the
// row-major 64 x 64 tile `tile` (B[k][n] = tile[k][n]).
__device__ __forceinline__ void mma_acc_tile(float (&acc)[8][4], const float (&x)[8][4],
                                             const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_pair(x[2 * j][0], x[2 * j][1]), pack_pair(x[2 * j][2], x[2 * j][3]),
                           pack_pair(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_pair(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t bfrag[4];
      ldmatrix_x4_trans(bfrag, tile + (j * 16 + (lane & 15)) * kLd + dp * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * dp], a, bfrag[0], bfrag[1]);
      mma_16816(acc[2 * dp + 1], a, bfrag[2], bfrag[3]);
    }
  }
}

// Writes a warp's 16 x 64 float32 result, times `scale`, as bf16 rows r0, r0 + 8 (< seq).
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t row_stride, const float (&acc)[8][4],
                                           float scale, int r0, int seq, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < seq) {
      *reinterpret_cast<uint32_t*>(base + r0 * row_stride + c) = pack_pair(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (r1 < seq) {
      *reinterpret_cast<uint32_t*>(base + r1 * row_stride + c) = pack_pair(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

// dK and dV: one block of 4 warps per (batch, head, 64-key tile); each warp
// owns 16 keys, keeps their K and V fragments and its float32 dK and dV in
// registers, and walks the query tiles (Q, dO, lse and Delta staged by
// cp.async, two tiles deep). Per tile it recomputes S^T = K Q^T and
// P^T = exp(S^T - lse), then dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - Delta) and dK += dS^T Q. Queries and keys at or past T
// get P = 0; rows of dK/dV past T are not written.
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq, int heads,
                               int lse_stride, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_s[2][kBlockQ * kLd];
  __shared__ __align__(16) __nv_bfloat16 do_s[2][kBlockQ * kLd];
  __shared__ __align__(16) float lse_s[2][kBlockQ];
  __shared__ __align__(16) float delta_s[2][kBlockQ];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * seq * row_stride + static_cast<size_t>(h) * kHeadDim;
  const __nv_bfloat16* q_bh = q + head_base;
  const __nv_bfloat16* do_bh = dout + head_base;
  const size_t stat_base = (static_cast<size_t>(b) * heads + h) * lse_stride;
  const float* lse_bh = lse + stat_base;
  const float* delta_bh = delta + stat_base;

  const int key0 = blockIdx.x * kBlockK + warp * 16 + g;
  const int key1 = key0 + 8;
  uint32_t kf[4][4], vf[4][4];
  load_a_rows(kf, k + head_base, row_stride, key0, seq, t4);
  load_a_rows(vf, v + head_base, row_stride, key0, seq, t4);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  // Stages query tile `tile` (Q and dO rows, lse and Delta) into buffer `buf`;
  // queries past `seq` are zero-filled (lse and Delta are 0 there already).
  auto load_tile = [&](int tile, int buf) {
    for (int i = threadIdx.x; i < kBlockQ * (kHeadDim / 8); i += kThreads) {
      const int r = i >> 3;
      const int c8 = (i & 7) * 8;
      const int query = tile * kBlockQ + r;
      const bool valid = query < seq;
      const size_t offset = static_cast<size_t>(valid ? query : 0) * row_stride + c8;
      cp_async_16(&q_s[buf][r * kLd + c8], q_bh + offset, valid);
      cp_async_16(&do_s[buf][r * kLd + c8], do_bh + offset, valid);
    }
    if (threadIdx.x < kBlockQ / 4) {
      cp_async_16(&lse_s[buf][threadIdx.x * 4], lse_bh + tile * kBlockQ + threadIdx.x * 4, true);
    } else if (threadIdx.x < kBlockQ / 2) {
      const int i = threadIdx.x - kBlockQ / 4;
      cp_async_16(&delta_s[buf][i * 4], delta_bh + tile * kBlockQ + i * 4, true);
    }
  };

  const int n_tiles = (seq + kBlockQ - 1) / kBlockQ;
  load_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    const int q0 = tile * kBlockQ;
    const __nv_bfloat16* qs = q_s[buf];
    const __nv_bfloat16* dos = do_s[buf];
    const float* ls = lse_s[buf];
    const float* ds = delta_s[buf];

    float p[8][4];
    mma_a_tile_t(p, kf, qs, lane);  // S^T for this warp's 16 keys and the tile's 64 queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const bool live = q0 + col < seq && (e < 2 ? key0 : key1) < seq;
        p[nt][e] = live ? exp2f(p[nt][e] * scale_log2 - ls[col] * kLog2e) : 0.f;
      }
    }
    float dp[8][4];
    mma_a_tile_t(dp, vf, dos, lane);  // dP^T = V dO^T
    mma_acc_tile(dv_acc, p, dos, lane);  // dV += P^T dO
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - ds[nt * 8 + t4 * 2 + (e & 1)]);
    }
    mma_acc_tile(dk_acc, dp, qs, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

  store_rows(dk + head_base, row_stride, dk_acc, scale, key0, seq, t4);
  store_rows(dv + head_base, row_stride, dv_acc, 1.f, key0, seq, t4);
}

// dQ: one block of 4 warps per (batch, head, 64-query tile); each warp owns 16
// queries, keeps their Q and dO fragments, lse and Delta in registers, and
// walks the key tiles (K and V staged as in the forward). Per tile it
// recomputes S = Q K^T and P = exp(S - lse), then dP = dO V^T,
// dS = P (dP - Delta) and dQ += dS K. Keys at or past T get P = 0. Each dQ
// element is summed in one fixed order: no atomics, the same bits every run.
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int seq, int heads, int lse_stride, float scale,
                              float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBlockK * kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * seq * row_stride + static_cast<size_t>(h) * kHeadDim;
  const __nv_bfloat16* k_bh = k + head_base;
  const __nv_bfloat16* v_bh = v + head_base;
  const size_t stat_base = (static_cast<size_t>(b) * heads + h) * lse_stride;

  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[4][4], dof[4][4];
  load_a_rows(qf, q + head_base, row_stride, r0, seq, t4);
  load_a_rows(dof, dout + head_base, row_stride, r0, seq, t4);
  // Rows r0, r1 < T_pad = lse_stride: lse and Delta are 0 past T.
  const float lse0 = lse[stat_base + r0] * kLog2e;
  const float lse1 = lse[stat_base + r1] * kLog2e;
  const float delta0 = delta[stat_base + r0];
  const float delta1 = delta[stat_base + r1];

  float dq_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

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
    if (tile + 1 < n_tiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    const int k0 = tile * kBlockK;
    const __nv_bfloat16* ks = k_s[buf];
    const __nv_bfloat16* vs = v_s[buf];

    float p[8][4];
    mma_a_tile_t(p, qf, ks, lane);  // S = Q K^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = k0 + nt * 8 + t4 * 2 + (e & 1) < seq && (e < 2 ? r0 : r1) < seq;
        p[nt][e] = live ? exp2f(p[nt][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
      }
    }
    float dp[8][4];
    mma_a_tile_t(dp, dof, vs, lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      dp[nt][0] = p[nt][0] * (dp[nt][0] - delta0);
      dp[nt][1] = p[nt][1] * (dp[nt][1] - delta0);
      dp[nt][2] = p[nt][2] * (dp[nt][2] - delta1);
      dp[nt][3] = p[nt][3] * (dp[nt][3] - delta1);
    }
    mma_acc_tile(dq_acc, dp, ks, lane);  // dQ += dS K
    __syncthreads();
  }

  store_rows(dq + head_base, row_stride, dq_acc, scale, r0, seq, t4);
}

}  // namespace

extern "C" int ser_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* key_mask, void* out, void* lse, int batch, int seq,
                                       int heads, int head_dim, int lse_stride, float scale, void* stream) {
  if (head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  if (lse != nullptr && lse_stride < static_cast<int>(grid.x) * kBlockQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), seq, heads, lse_stride, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// K2-bwd: three launches on `stream`, in order: Delta into the float32
// scratch `delta` (B, H, lse_stride), then dK/dV, then dQ. `lse` is the
// forward's (B, H, lse_stride) output; lse_stride is T rounded up to 64.
extern "C" int ser_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                       void* dv, int batch, int seq, int heads, int head_dim, int lse_stride,
                                       float scale, void* stream) {
  const int tiles = (seq + kBlockQ - 1) / kBlockQ;
  if (head_dim != kHeadDim || lse_stride != tiles * kBlockQ) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  auto* delta_ = static_cast<float*>(delta);

  const size_t delta_threads = static_cast<size_t>(batch) * heads * lse_stride * 8;
  flash_attention_bwd_delta_kernel<<<static_cast<unsigned>((delta_threads + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), do_, delta_, batch, seq, heads, lse_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(tiles, heads, batch);
  flash_attention_bwd_dkv_kernel<<<grid, kThreads, 0, s>>>(q_, k_, v_, do_, lse_, delta_,
                                                           static_cast<__nv_bfloat16*>(dk),
                                                           static_cast<__nv_bfloat16*>(dv), seq, heads,
                                                           lse_stride, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  flash_attention_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(q_, k_, v_, do_, lse_, delta_,
                                                          static_cast<__nv_bfloat16*>(dq), seq, heads,
                                                          lse_stride, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
