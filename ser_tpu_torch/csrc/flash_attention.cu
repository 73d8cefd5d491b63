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
// accumulation. `key_mask` is optional: (B, T_pad) uint8, T_pad = T rounded up
// to the 128-key tile, the rows' tails ignored; a masked key gets the einsum
// path's -1e30 bias, so every query row attends to the valid keys. The TPU
// kernel cuts the mask as segment ids, which differs only on masked *query*
// rows; nobody reads those. Keys at or past T are excluded, so T needs no
// padding (T = 1500 for Whisper). Given a pointer, the forward also writes the
// float32 (B, H, T_pad) log-sum-exp of the scaled scores in natural-log units
// (0 past T), which the backward reads.
//
// Bound on the H100: at the encoder's shapes (B = 8, H = 20, T = 1500) one
// forward is 92 GFLOP of bf16 matrix products (0.093 ms at 989 TFLOP/s dense,
// data sheet) against 123 MB of q, k, v and out (0.037 ms at 3.35 TB/s), so
// the tensor cores bound it. At D = 64 the softmax's exponentials come close:
// 8 * 20 * 1500^2 = 360 M exp2 at the special-function units' ~3.9 T/s is
// about 0.09 ms too, so the kernel reaches its bound only if the softmax of
// one tile runs while the tensor cores work on another. The backward at the
// training step's (4, 1500, 20, 64) is five T x T x D products at the least
// (115 GFLOP, 0.117 ms) against 123 MB of q, k, v, out, dout, dq, dk, dv:
// also bound by the tensor cores. Its two passes below recompute S and dP in
// each, 7 products, so this design's own floor is about 0.16 ms.
//
// Design, shared by the three attention kernels: a persistent grid, one block
// per SM, each walking (batch, head, 128-row tile) work items; one block is
// three warpgroups. Warpgroup 2 is the producer: one thread issues TMA loads
// (cp.async.bulk.tensor over a 4-D map of (D, H, T, B), 64-row boxes with
// 128-byte swizzle, zero-filled past T) of each item's resident tiles, and of
// the streamed tiles into a ring of kStages buffers, each guarded by a full
// and an empty mbarrier; it loads the next item's tiles while the consumers
// finish the current one. Warpgroups 0 and 1 are consumers of 64 rows each:
// every T x T x D product is wgmma.mma_async (bf16 in, float32 accumulate),
// with both operands in shared memory, or with the A operand in registers
// where it is a probability or dS tile that the warpgroup just computed (the
// float32 accumulator rounded to bf16 in place: its layout is already wgmma's
// A fragment). setmaxnreg gives the producer 40 registers and each consumer
// thread 232. The two consumers take turns issuing their products (named
// barriers 1 and 2): while one runs its softmax on the CUDA cores, the tensor
// cores work on the other's products. Each consumer also keeps its last
// product of a tile in flight while it starts the next tile.
// Forward: items are 128-query tiles, streaming 128-key tiles of K, V (and the
// key mask). Per tile a consumer issues S = Q K^T (m64n128k16, 4 k-steps)
// together with the previous tile's O += P V (m64n64k16, 8 k-steps, V
// MN-major), then runs the online softmax of S (in log2 units, the scale
// folded into one FMA, row max and sum across the 4 lanes that share a row)
// while P V is still on the tensor cores.
// Backward: the Pallas kernel's split, three launches. Delta = rowsum(dO * O)
// in float32; a dK/dV kernel (items: 128-key tiles, K and V resident) streams
// 64-query tiles of Q, dO, lse and Delta and runs S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO and dK += dS^T Q; a dQ kernel (items: 128-query tiles, Q and dO
// resident) streams 128-key tiles of K and V and runs S = Q K^T, dP = dO V^T
// and dQ += dS K. Each recomputes P from the saved log-sum-exp, so no (T, T)
// matrix reaches device memory, and no sum needs atomics: dQ is the same bit
// for bit on every run. The dQ grid needs only Delta, so it is launched as a
// programmatic dependent of the dK/dV grid and fills the SMs that the dK/dV
// grid's last items leave idle.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;        // one row of D in bf16: exactly one 128-byte swizzle span
constexpr int kBox = 64;                       // rows of one TMA box, and of one consumer warpgroup
constexpr int kBoxBytes = kBox * kRowBytes;    // 8 KB
constexpr int kBlockQ = 128;                   // query tile of the forward and dQ blocks; lse rows are padded to it
constexpr int kBlockK = 128;                   // key tile of the forward, dQ and dK/dV blocks
constexpr int kBwdBlockQ = 64;                 // query tile that the dK/dV kernel streams
constexpr int kTileBytes = kBlockK * kRowBytes;  // 16 KB
constexpr int kStages = 3;
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSwizzleAtom = 8 * kRowBytes;    // 1024 bytes: 8 rows of the 128-byte swizzle
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockQ == kBlockK, "the key mask and the lse share one padded row length");

// ---- shared memory, barriers, TMA ------------------------------------------ //

// One 64-row box of a (D, H, T, B) map: rows row..row+63 of head h, batch b;
// rows at or past T arrive as zeros. Completion is counted on `bar`.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap& map, uint32_t bar, int h, int row,
                                             int b) {
  tma_load_4d(dst, map, bar, 0, h, row, b);
}

// Position in the ring of kStages buffers, and the parity of its current round.
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

// Every warp of a consumer warpgroup releases a stage once its reads are done.
__device__ __forceinline__ void release(uint32_t empty_bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar);
}

constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 = 384 * 168: the block's launch allocation

// The two consumer warpgroups take turns issuing their wgmma batches: warpgroup
// 0 waits on named barrier 1 and passes to 2, warpgroup 1 the other way round.
// Each bar.sync of 128 threads meets one bar.arrive of the other 128.
struct Turns {
  int wg;
  __device__ __forceinline__ void start() const {
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // warpgroup 0 goes first
  }
  __device__ __forceinline__ void wait() const { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); }
  // Warpgroup 1's last pass would have no one to meet, so it is left out.
  __device__ __forceinline__ void pass(bool last) const {
    if (!(last && wg == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  }
};

// ---- wgmma ----------------------------------------------------------------- //

// Shared-memory matrix descriptor of a tile in rows of 128 bytes, 128-byte
// swizzled (as TMA wrote it), 1024-byte aligned at its swizzle atom. The
// stride between 8-row groups is 1024 bytes; so is the leading offset, which
// only an MN-major operand wider than 64 would use. A K-major k-step of 16
// adds 32 bytes to the start; an MN-major one adds 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kOffset = kSwizzleAtom >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kOffset << 16) | (kOffset << 32) | (1ull << 62);
}

// D (64 x 128, float32) (+)= A (64 x 16, K-major in shared memory) * B (16 x 128, K-major).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, float32) (+)= A (64 x 16, bf16 fragments in registers) * B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A float32 m64nN accumulator (N = 16 * kSteps), rounded to bf16, as the A
// operand of a product over N: k-step kk takes its columns 16kk..16kk+15.
// Thread (warp w, lane 4g + t) holds rows 16w + g and 16w + g + 8 of both, at
// the same columns, so no value moves between threads.
template <int kSteps>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[kSteps][4], const float (&d)[kSteps * 8]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    a[kk][0] = pack_pair(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_pair(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_pair(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_pair(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Writes a thread's share of a 64 x 64 float32 accumulator as bf16: rows r0
// (times s0) and r0 + 8 (times s1), those < seq only.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t row_stride, const float (&acc)[32], float s0,
                                           float s1, int r0, int seq, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + t4 * 2;
    if (r0 < seq) {
      *reinterpret_cast<uint32_t*>(base + r0 * row_stride + c) = pack_pair(acc[4 * j] * s0, acc[4 * j + 1] * s0);
    }
    if (r1 < seq) {
      *reinterpret_cast<uint32_t*>(base + r1 * row_stride + c) = pack_pair(acc[4 * j + 2] * s1, acc[4 * j + 3] * s1);
    }
  }
}

// The block's dynamic shared memory, rounded up to the 1024-byte swizzle atom.
__device__ __forceinline__ uint32_t aligned_smem_base(uint8_t* raw, uint8_t** aligned) {
  const uint32_t addr = smem_addr(raw);
  const uint32_t base = (addr + kSwizzleAtom - 1) & ~static_cast<uint32_t>(kSwizzleAtom - 1);
  *aligned = raw + (base - addr);
  return base;
}

// ---- K2: forward ----------------------------------------------------------- //

// The (batch, head, 128-row tile) work item w of a persistent grid: tile
// w % tiles of head (w / tiles) % H of batch w / (tiles H).
struct WorkItem {
  int b, h, row0;
  __device__ __forceinline__ WorkItem(int w, int tiles, int heads)
      : b(w / (tiles * heads)), h((w / tiles) % heads), row0((w % tiles) * kBlockQ) {}
};


// Keys past T get -inf (TMA gave them zero rows, which would score 0); keys
// that `mask_s` (this tile's 128 mask bytes, or null) marks 0 get the -1e30
// bias. The thread's columns are 8j + 2 t4 and 8j + 2 t4 + 1, j < 16, in both
// of its rows. Scores are raw here: the scale is folded in later.
__device__ __forceinline__ void mask_scores(float (&s)[64], int k0, int seq, const uint8_t* mask_s, int t4) {
  if (mask_s != nullptr) {
    uint32_t pairs[16];
    uint32_t all = 0x0101u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pairs[j] = *reinterpret_cast<const uint16_t*>(mask_s + j * 8 + t4 * 2);
      all &= pairs[j];
    }
    if (all != 0x0101u) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (((pairs[j] >> (8 * e)) & 0xffu) == 0) {
            s[4 * j + e] = -1e30f;
            s[4 * j + 2 + e] = -1e30f;
          }
        }
      }
    }
  }
  if (k0 + kBlockK > seq) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + j * 8 + t4 * 2 + e >= seq) {
          s[4 * j + e] = -CUDART_INF_F;
          s[4 * j + 2 + e] = -CUDART_INF_F;
        }
      }
    }
  }
}

// Running max (raw scores) and this thread's share of the running sums of a
// thread's two rows, g and g + 8, in log2 units with the scale folded into one
// FMA per score. The max is taken across the 4 lanes that share a row.
struct OnlineSoftmax {
  float m0, m1, l0, l1;

  __device__ __forceinline__ OnlineSoftmax()
      : m0(-__builtin_huge_valf()), m1(-__builtin_huge_valf()), l0(0.f), l1(0.f) {}

  // Turns the scores of one key tile into probabilities; returns the factors
  // (rows g, g + 8) by which the output accumulated so far must be rescaled.
  __device__ __forceinline__ float2 update(float (&s)[64], float scale_log2) {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Key k0 < T is in every tile, so mx0 and mx1 are finite.
    const float2 alpha = make_float2(exp2_approx((m0 - mx0) * scale_log2), exp2_approx((m1 - mx1) * scale_log2));
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = exp2_approx(fmaf(s[4 * j], scale_log2, -mc0));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -mc0));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -mc1));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -mc1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha.x + sum0;
    l1 = l1 * alpha.y + sum1;
    return alpha;
  }

  // A row's whole sum, from the shares of its 4 lanes.
  __device__ __forceinline__ static float row_sum(float share) {
    share += __shfl_xor_sync(0xffffffffu, share, 1);
    return share + __shfl_xor_sync(0xffffffffu, share, 2);
  }
};

constexpr int kFwdQ = 0;                                 // 128 query rows
constexpr int kFwdK = kFwdQ + kTileBytes;                // kStages x 128 key rows
constexpr int kFwdV = kFwdK + kStages * kTileBytes;      // kStages x 128 value rows
constexpr int kFwdMask = kFwdV + kStages * kTileBytes;   // kStages x 128 bytes of key mask
constexpr int kFwdBars = kFwdMask + kStages * kBlockK;   // q_full, q_empty, full[kStages], empty[kStages]
constexpr int kFwdSmem = kFwdBars + (2 + 2 * kStages) * 8 + kSwizzleAtom;

// Persistent: one block per SM walks the (batch, head, 128-query tile) work
// items w = blockIdx.x, blockIdx.x + gridDim.x, ... (query tile w % q_tiles,
// head (w / q_tiles) % H, batch w / (q_tiles H)), so that the producer loads
// the next item's Q and first K/V tiles while the consumers finish the last
// P V and write the output of the current one.
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ key_mask,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int batch, int seq, int heads,
                           int padded, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_smem_base(smem_raw, &smem);
  const uint32_t q_full = base + kFwdBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;           // full[s] = full + 8 s
  const uint32_t empty = full + 8 * kStages;   // empty[s] = empty + 8 s
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int n_work = q_tiles * heads * batch;
  const int n_tiles = (seq + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: per work item, Q once, then K, V (and the mask) of each key tile into the ring.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;
      uint32_t q_phase = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, q_phase ^= 1u) {
        const WorkItem item(w, q_tiles, heads);
        const int h = item.h, b = item.b;
        mbar_wait(q_empty, q_phase ^ 1u);
        mbar_expect_tx(q_full, kTileBytes);
        tma_load_box(base + kFwdQ, q_map, q_full, h, item.row0, b);
        tma_load_box(base + kFwdQ + kBoxBytes, q_map, q_full, h, item.row0 + kBox, b);
        const uint8_t* mask_b = key_mask != nullptr ? key_mask + static_cast<size_t>(b) * padded : nullptr;
        for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
          const int s = ring.stage;
          const int k0 = tile * kBlockK;
          const uint32_t bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ring.phase ^ 1u);
          mbar_expect_tx(bar, 2 * kTileBytes + (mask_b != nullptr ? kBlockK : 0));
          for (int half = 0; half < 2; ++half) {
            tma_load_box(base + kFwdK + s * kTileBytes + half * kBoxBytes, k_map, bar, h, k0 + half * kBox, b);
            tma_load_box(base + kFwdV + s * kTileBytes + half * kBoxBytes, v_map, bar, h, k0 + half * kBox, b);
          }
          if (mask_b != nullptr) bulk_load(base + kFwdMask + s * kBlockK, mask_b + k0, kBlockK, bar);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63 of each work item.
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int t4 = lane & 3;  // thread of the four that share a row
    const Turns turns{wg};
    const uint32_t q_tile = base + kFwdQ + wg * kBoxBytes;

    float o[32];
    float s[64];       // scores, then probabilities, of the current key tile
    uint32_t p[8][4];  // the previous tile's probabilities in bf16, as A fragments

    // S = Q K^T of the tile in stage st, issued as one wgmma group.
    auto issue_scores = [&](int st) {
      const uint32_t k_tile = base + kFwdK + st * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_ss(s, smem_desc(q_tile + kk * 32), smem_desc(k_tile + kk * 32), kk);
      }
      wgmma_commit();
    };
    // O += P V with the V tile in stage st, one wgmma group.
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = base + kFwdV + st * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs(o, p[kk], smem_desc(v_tile + kk * 2 * kSwizzleAtom), 1);
      wgmma_commit();
    };
    auto mask = [&](int tile, int st) {
      mask_scores(s, tile * kBlockK, seq, key_mask != nullptr ? smem + kFwdMask + st * kBlockK : nullptr, t4);
    };

    turns.start();
    Ring ring;
    uint32_t q_phase = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, q_phase ^= 1u) {
      const WorkItem item(w, q_tiles, heads);
      const bool last_work = w + static_cast<int>(gridDim.x) >= n_work;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      OnlineSoftmax softmax;

      // The first key tile: scores and softmax only.
      mbar_wait(q_full, q_phase);
      mbar_wait(full + 8 * ring.stage, ring.phase);
      turns.wait();
      fence_regs(s);
      wgmma_fence();
      issue_scores(ring.stage);
      turns.pass(last_work && n_tiles == 1);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1) release(q_empty);
      mask(0, ring.stage);
      softmax.update(s, scale_log2);
      acc_to_a(p, s);
      int prev = ring.stage;  // stage of the previous key tile, whose V the pending P V reads
      ring.next();
      for (int tile = 1; tile < n_tiles; ++tile) {
        const int st = ring.stage;
        mbar_wait(full + 8 * st, ring.phase);
        turns.wait();
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();
        issue_scores(st);
        issue_pv(prev);
        turns.pass(last_work && tile == n_tiles - 1);
        wgmma_wait<1>();  // S is ready; the previous tile's P V may still run
        fence_regs(s);
        if (tile == n_tiles - 1) release(q_empty);  // the next item's Q may load
        mask(tile, st);
        const float2 alpha = softmax.update(s, scale_log2);
        wgmma_wait<0>();  // P V is done: its P and V are free
        fence_regs(o);
        release(empty + 8 * prev);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= alpha.x;
          o[4 * j + 1] *= alpha.x;
          o[4 * j + 2] *= alpha.y;
          o[4 * j + 3] *= alpha.y;
        }
        acc_to_a(p, s);
        prev = st;
        ring.next();
      }
      // The last tile's P V.
      fence_regs(o);
      wgmma_fence();
      issue_pv(prev);
      wgmma_wait<0>();
      fence_regs(o);
      release(empty + 8 * prev);

      const float l0 = softmax.row_sum(softmax.l0), l1 = softmax.row_sum(softmax.l1);
      const int r0 = item.row0 + wg * kBox + warp * 16 + g;
      const int r1 = r0 + 8;
      if (lse != nullptr && t4 == 0) {
        // Natural-log log-sum-exp of the scaled scores; rows past T (up to the
        // last query tile's end) get 0, so the backward can read whole tiles.
        float* lse_bh = lse + (static_cast<size_t>(item.b) * heads + item.h) * padded;
        lse_bh[r0] = r0 < seq ? (softmax.m0 * scale_log2 + log2f(l0)) * kLn2 : 0.f;
        lse_bh[r1] = r1 < seq ? (softmax.m1 * scale_log2 + log2f(l1)) * kLn2 : 0.f;
      }
      const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
      __nv_bfloat16* out_bh =
          out + static_cast<size_t>(item.b) * seq * row_stride + static_cast<size_t>(item.h) * kHeadDim;
      store_rows(out_bh, row_stride, o, 1.f / l0, 1.f / l1, r0, seq, t4);
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

constexpr int kQTileBytes = kBwdBlockQ * kRowBytes;       // 8 KB: one 64-query tile
constexpr int kDkvK = 0;                                  // 128 key rows
constexpr int kDkvV = kDkvK + kTileBytes;                 // 128 value rows
constexpr int kDkvQ = kDkvV + kTileBytes;                 // kStages x 64 query rows
constexpr int kDkvDo = kDkvQ + kStages * kQTileBytes;     // kStages x 64 dout rows
constexpr int kDkvLse = kDkvDo + kStages * kQTileBytes;   // kStages x 64 floats
constexpr int kDkvDelta = kDkvLse + kStages * kBwdBlockQ * 4;
constexpr int kDkvBars = kDkvDelta + kStages * kBwdBlockQ * 4;  // kv_full, kv_empty, full[kStages], empty[kStages]
constexpr int kDkvSmem = kDkvBars + (2 + 2 * kStages) * 8 + kSwizzleAtom;

// dK and dV, persistent: one block per SM walks the (batch, head, 128-key
// tile) work items; consumer warpgroup wg owns keys 64 wg .. 64 wg + 63 of the
// tile and keeps their float32 dK and dV in registers while it walks the
// 64-query tiles. Queries past T get P = 0; rows of dK and dV past T are not
// written.
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int batch,
                               int seq, int heads, int padded, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_smem_base(smem_raw, &smem);
  const uint32_t kv_full = base + kDkvBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8;
  const uint32_t empty = full + 8 * kStages;
  const int k_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_work = k_tiles * heads * batch;
  const int n_tiles = (seq + kBwdBlockQ - 1) / kBwdBlockQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // The dQ grid reads nothing this one writes: its blocks may take the SMs
  // that this grid's last wave leaves idle (programmatic dependent launch).
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;
      uint32_t kv_phase = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, kv_phase ^= 1u) {
        const WorkItem item(w, k_tiles, heads);
        const size_t stat_base = (static_cast<size_t>(item.b) * heads + item.h) * padded;
        mbar_wait(kv_empty, kv_phase ^ 1u);
        mbar_expect_tx(kv_full, 2 * kTileBytes);
        for (int half = 0; half < 2; ++half) {
          const int row = item.row0 + half * kBox;
          tma_load_box(base + kDkvK + half * kBoxBytes, k_map, kv_full, item.h, row, item.b);
          tma_load_box(base + kDkvV + half * kBoxBytes, v_map, kv_full, item.h, row, item.b);
        }
        for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
          const int s = ring.stage;
          const int q0 = tile * kBwdBlockQ;
          const uint32_t bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ring.phase ^ 1u);
          mbar_expect_tx(bar, 2 * kQTileBytes + 2 * kBwdBlockQ * 4);
          tma_load_box(base + kDkvQ + s * kQTileBytes, q_map, bar, item.h, q0, item.b);
          tma_load_box(base + kDkvDo + s * kQTileBytes, do_map, bar, item.h, q0, item.b);
          bulk_load(base + kDkvLse + s * kBwdBlockQ * 4, lse + stat_base + q0, kBwdBlockQ * 4, bar);
          bulk_load(base + kDkvDelta + s * kBwdBlockQ * 4, delta + stat_base + q0, kBwdBlockQ * 4, bar);
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const Turns turns{wg};
    const uint32_t k_tile = base + kDkvK + wg * kBoxBytes;
    const uint32_t v_tile = base + kDkvV + wg * kBoxBytes;

    float dk_acc[32], dv_acc[32];
    float p[32];   // S^T, then P^T: this warpgroup's 64 keys x the tile's 64 queries
    float ds[32];  // dP^T, then dS^T
    uint32_t pa[4][4], dsa[4][4];

    turns.start();
    Ring ring;
    uint32_t kv_phase = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, kv_phase ^= 1u) {
      const WorkItem item(w, k_tiles, heads);
      const bool last_work = w + static_cast<int>(gridDim.x) >= n_work;
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      mbar_wait(kv_full, kv_phase);
      int prev = 0;  // stage of the previous query tile, whose Q and dO the pending products read
      for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
        const int st = ring.stage;
        mbar_wait(full + 8 * st, ring.phase);
        const uint32_t q_tile = base + kDkvQ + st * kQTileBytes;
        const uint32_t do_tile = base + kDkvDo + st * kQTileBytes;
        turns.wait();
        fence_regs(p);
        fence_regs(ds);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(p, smem_desc(k_tile + kk * 32), smem_desc(q_tile + kk * 32), kk);  // S^T = K Q^T
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(ds, smem_desc(v_tile + kk * 32), smem_desc(do_tile + kk * 32), kk);  // dP^T = V dO^T
        }
        wgmma_commit();
        turns.pass(last_work && tile == n_tiles - 1);
        wgmma_wait<1>();  // the previous tile's dV and dK products and this S^T are done; dP^T may still run
        fence_regs(p);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        if (tile > 0) release(empty + 8 * prev);

        const int q0 = tile * kBwdBlockQ;
        const bool ragged = q0 + kBwdBlockQ > seq;
        const float* lse_s = reinterpret_cast<const float*>(smem + kDkvLse + st * kBwdBlockQ * 4);
        const float* delta_s = reinterpret_cast<const float*>(smem + kDkvDelta + st * kBwdBlockQ * 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j * 8 + t4 * 2;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lq = (e == 0 ? l2.x : l2.y) * kLog2e;
            const bool live = !ragged || q0 + col + e < seq;
            p[4 * j + e] = live ? exp2_approx(fmaf(p[4 * j + e], scale_log2, -lq)) : 0.f;
            p[4 * j + 2 + e] = live ? exp2_approx(fmaf(p[4 * j + 2 + e], scale_log2, -lq)) : 0.f;
          }
        }
        acc_to_a(pa, p);
        wgmma_wait<0>();
        fence_regs(ds);
        if (tile == n_tiles - 1) release(kv_empty);  // K and V are read: the next item's may load
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_rs(dv_acc, pa[kk], smem_desc(do_tile + kk * 2 * kSwizzleAtom), 1);  // dV += P^T dO
        }
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + j * 8 + t4 * 2);
          ds[4 * j] = p[4 * j] * (ds[4 * j] - d2.x);
          ds[4 * j + 1] = p[4 * j + 1] * (ds[4 * j + 1] - d2.y);
          ds[4 * j + 2] = p[4 * j + 2] * (ds[4 * j + 2] - d2.x);
          ds[4 * j + 3] = p[4 * j + 3] * (ds[4 * j + 3] - d2.y);
        }
        acc_to_a(dsa, ds);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_rs(dk_acc, dsa[kk], smem_desc(q_tile + kk * 2 * kSwizzleAtom), 1);  // dK += dS^T Q
        }
        wgmma_commit();  // both still in flight when the next tile's S^T and dP^T are issued
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      release(empty + 8 * prev);

      const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
      const size_t head_base =
          static_cast<size_t>(item.b) * seq * row_stride + static_cast<size_t>(item.h) * kHeadDim;
      const int key0 = item.row0 + wg * kBox + warp * 16 + g;
      store_rows(dk + head_base, row_stride, dk_acc, scale, scale, key0, seq, t4);
      store_rows(dv + head_base, row_stride, dv_acc, 1.f, 1.f, key0, seq, t4);
    }
  }
}

constexpr int kDqQ = 0;                                // 128 query rows
constexpr int kDqDo = kDqQ + kTileBytes;               // 128 dout rows
constexpr int kDqK = kDqDo + kTileBytes;               // kStages x 128 key rows
constexpr int kDqV = kDqK + kStages * kTileBytes;      // kStages x 128 value rows
constexpr int kDqBars = kDqV + kStages * kTileBytes;   // qdo_full, qdo_empty, full[kStages], empty[kStages]
constexpr int kDqSmem = kDqBars + (2 + 2 * kStages) * 8 + kSwizzleAtom;

// dQ: one block per (batch, head, 128-query tile); consumer warpgroup wg owns
// queries 64 wg .. 64 wg + 63 of the tile, keeps their lse and Delta in
// registers and their float32 dQ while it walks the 128-key tiles. Keys past T
// get P = 0. Each dQ element is summed in one fixed order: no atomics.
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int batch, int seq, int heads, int padded,
                              float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_smem_base(smem_raw, &smem);
  const uint32_t qdo_full = base + kDqBars;
  const uint32_t qdo_empty = qdo_full + 8;
  const uint32_t full = qdo_empty + 8;
  const uint32_t empty = full + 8 * kStages;
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int n_work = q_tiles * heads * batch;
  const int n_tiles = (seq + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    mbar_init(qdo_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;
      uint32_t qdo_phase = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, qdo_phase ^= 1u) {
        const WorkItem item(w, q_tiles, heads);
        mbar_wait(qdo_empty, qdo_phase ^ 1u);
        mbar_expect_tx(qdo_full, 2 * kTileBytes);
        for (int half = 0; half < 2; ++half) {
          const int row = item.row0 + half * kBox;
          tma_load_box(base + kDqQ + half * kBoxBytes, q_map, qdo_full, item.h, row, item.b);
          tma_load_box(base + kDqDo + half * kBoxBytes, do_map, qdo_full, item.h, row, item.b);
        }
        for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
          const int s = ring.stage;
          const int k0 = tile * kBlockK;
          const uint32_t bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ring.phase ^ 1u);
          mbar_expect_tx(bar, 2 * kTileBytes);
          for (int half = 0; half < 2; ++half) {
            const int row = k0 + half * kBox;
            tma_load_box(base + kDqK + s * kTileBytes + half * kBoxBytes, k_map, bar, item.h, row, item.b);
            tma_load_box(base + kDqV + s * kTileBytes + half * kBoxBytes, v_map, bar, item.h, row, item.b);
          }
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const Turns turns{wg};
    const uint32_t q_tile = base + kDqQ + wg * kBoxBytes;
    const uint32_t do_tile = base + kDqDo + wg * kBoxBytes;
    float dq_acc[32];
    float p[64];   // S, then P, then dS: this warpgroup's 64 queries x the tile's 128 keys
    float dp[64];  // dP
    uint32_t dsa[8][4];

    turns.start();
    Ring ring;
    uint32_t qdo_phase = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, qdo_phase ^= 1u) {
      const WorkItem item(w, q_tiles, heads);
      const bool last_work = w + static_cast<int>(gridDim.x) >= n_work;
      const int r0 = item.row0 + wg * kBox + warp * 16 + g;
      const int r1 = r0 + 8;
      // Rows r0, r1 < T_pad: lse and Delta are 0 past T.
      const size_t stat_base = (static_cast<size_t>(item.b) * heads + item.h) * padded;
      const float lse0 = lse[stat_base + r0] * kLog2e;
      const float lse1 = lse[stat_base + r1] * kLog2e;
      const float delta0 = delta[stat_base + r0];
      const float delta1 = delta[stat_base + r1];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
      mbar_wait(qdo_full, qdo_phase);
      int prev = 0;  // stage of the previous key tile, whose K the pending dQ product reads
      for (int tile = 0; tile < n_tiles; ++tile, ring.next()) {
        const int st = ring.stage;
        mbar_wait(full + 8 * st, ring.phase);
        const uint32_t k_tile = base + kDqK + st * kTileBytes;
        const uint32_t v_tile = base + kDqV + st * kTileBytes;
        turns.wait();
        fence_regs(p);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k16_ss(p, smem_desc(q_tile + kk * 32), smem_desc(k_tile + kk * 32), kk);  // S = Q K^T
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k16_ss(dp, smem_desc(do_tile + kk * 32), smem_desc(v_tile + kk * 32), kk);  // dP = dO V^T
        }
        wgmma_commit();
        turns.pass(last_work && tile == n_tiles - 1);
        wgmma_wait<1>();  // the previous tile's dQ += dS K and this S are done; dP may still run
        fence_regs(p);
        fence_regs(dq_acc);
        if (tile > 0) release(empty + 8 * prev);

        const int k0 = tile * kBlockK;
        const bool ragged = k0 + kBlockK > seq;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = !ragged || k0 + j * 8 + t4 * 2 + e < seq;
            p[4 * j + e] = live ? exp2_approx(fmaf(p[4 * j + e], scale_log2, -lse0)) : 0.f;
            p[4 * j + 2 + e] = live ? exp2_approx(fmaf(p[4 * j + 2 + e], scale_log2, -lse1)) : 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        if (tile == n_tiles - 1) release(qdo_empty);  // Q and dO are read: the next item's may load
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          p[4 * j] *= dp[4 * j] - delta0;
          p[4 * j + 1] *= dp[4 * j + 1] - delta0;
          p[4 * j + 2] *= dp[4 * j + 2] - delta1;
          p[4 * j + 3] *= dp[4 * j + 3] - delta1;
        }
        acc_to_a(dsa, p);
        fence_regs(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_rs(dq_acc, dsa[kk], smem_desc(k_tile + kk * 2 * kSwizzleAtom), 1);  // dQ += dS K
        }
        wgmma_commit();  // still in flight when the next tile's S and dP are issued
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(dq_acc);
      release(empty + 8 * prev);

      const size_t row_stride = static_cast<size_t>(heads) * kHeadDim;
      const size_t head_base =
          static_cast<size_t>(item.b) * seq * row_stride + static_cast<size_t>(item.h) * kHeadDim;
      store_rows(dq + head_base, row_stride, dq_acc, scale, scale, r0, seq, t4);
    }
    // This grid may have started before the dK/dV grid ended: it ends after it,
    // so that whatever follows on the stream sees dK and dV written.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
}

// ---- host ------------------------------------------------------------------ //

// A (D, H, T, B) map over a contiguous (B, T, H, 64) bf16 tensor: 64-row boxes
// of one (batch, head), 128-byte swizzle, rows past T read as zeros.
bool head_map(CUtensorMap* map, const void* tensor, int batch, int seq, int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kHeadDim, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {kRowBytes, static_cast<cuuint64_t>(heads) * kRowBytes,
                                 static_cast<cuuint64_t>(seq) * heads * kRowBytes};
  const cuuint32_t box[4] = {kHeadDim, 1, kBox, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(tensor), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// K2. `padded` is T rounded up to the 128-row tile: the row length of `lse`
// (B, H, padded) and of `key_mask` (B, padded), required when either is given.
extern "C" int ser_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* key_mask, void* out, void* lse, int batch, int seq,
                                       int heads, int head_dim, int padded, float scale, void* stream) {
  const int tiles = (seq + kBlockQ - 1) / kBlockQ;
  if (head_dim != kHeadDim || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((lse != nullptr || key_mask != nullptr) && padded != tiles * kBlockQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, k_map, v_map;
  if (!head_map(&q_map, q, batch, seq, heads) || !head_map(&k_map, k, batch, seq, heads) ||
      !head_map(&v_map, v, batch, seq, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  const int grid = persistent_grid(tiles * heads * batch, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<const uint8_t*>(key_mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), batch, seq, heads, padded, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// K2-bwd: three launches on `stream`, in order: Delta into the float32
// scratch `delta` (B, H, lse_stride), then dK/dV, then dQ. `lse` is the
// forward's (B, H, lse_stride) output; lse_stride is T rounded up to 128.
extern "C" int ser_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                       void* dv, int batch, int seq, int heads, int head_dim, int lse_stride,
                                       float scale, void* stream) {
  const int tiles = (seq + kBlockQ - 1) / kBlockQ;
  if (head_dim != kHeadDim || seq <= 0 || lse_stride != tiles * kBlockQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!head_map(&q_map, q, batch, seq, heads) || !head_map(&k_map, k, batch, seq, heads) ||
      !head_map(&v_map, v, batch, seq, heads) || !head_map(&do_map, dout, batch, seq, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lse_ = static_cast<const float*>(lse);
  auto* delta_ = static_cast<float*>(delta);

  const size_t delta_threads = static_cast<size_t>(batch) * heads * lse_stride * 8;
  flash_attention_bwd_delta_kernel<<<static_cast<unsigned>((delta_threads + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), delta_, batch, seq, heads,
      lse_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int grid = persistent_grid(tiles * heads * batch, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, s>>>(
      q_map, k_map, v_map, do_map, lse_, delta_, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      batch, seq, heads, lse_stride, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ overlaps the tail of dK/dV (it needs only Delta, which ended before dK/dV began).
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kDqSmem;
  config.stream = s;
  config.attrs = &overlap;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, flash_attention_bwd_dq_kernel, q_map, k_map, v_map, do_map, lse_, delta_,
                           static_cast<__nv_bfloat16*>(dq), batch, seq, heads, lse_stride, scale, scale * kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
