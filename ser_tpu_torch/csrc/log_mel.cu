// Kernel K1 for Hopper (sm_90a), in two forms.
//
// Both replace the TPU kernel ser_tpu/ops/pallas_kernels.py::_power_mel_log_kernel_3d
// (launched by _power_mel_log_call) together with the STFT in front of it
// (conv_stft there, a float32 matmul in the port's plain version). Each writes
// the raw log-mel (no max-8 floor, no affine: those reduce over a window):
//   out (B, T_out, n_mels) f32 = log10(max(sum_k (re_k^2 + im_k^2) fb[k, m], 1e-10)),
//   fb (n_bins, n_mels) f32 the Slaney filterbank, transposed.
//
// 1. The spectrum form, ser_power_mel_log: the TPU kernel's own boundary. The
//    [re | im] STFT comes in, spec (B, T, 2 * n_bins) f32, and the first
//    T_out <= T frames go out. Bound on the H100 at the main path's shapes
//    (B = 8 windows, T = 3001, n_bins = 201, n_mels = 128): about 51 MB
//    (spectrum in, log-mel out) against about 0.03 GFLOP over the
//    filterbank's 394 non-zero weights of 25,728, so memory bounds it. One
//    block per SM stages the filterbank in shared memory and finds each mel
//    filter's non-zero span once, then walks (window, tile of 64 frames)
//    pairs: it computes a tile's power into shared memory, with four loads
//    in flight per thread, and each thread then sums one mel filter over its
//    span for 8 frames. Unlike the TPU kernel it takes the spectrum unpadded.
//
// 2. The fused form, ser_stft_power_mel_log: the waveform comes in, (B, S)
//    f32, one 30 s window per row, and no spectrum reaches device memory.
//    Whisper's framing only (n_fft = 400, hop = 160, n_bins = 201): frame t
//    is padded samples 160 t .. 160 t + 399 of the window reflect-padded by
//    200 on both sides (F.pad(mode="reflect")), T = 1 + S / 160 frames, and
//    re/im are its products with the Hann-windowed DFT basis. Bound on the
//    H100 at (8, 480000) -> (8, 3000, 128): 2 B T_out 402 400 = 7.7 GFLOP of
//    float32-grade products, as three TF32 products each (23.2 GFLOP at
//    494.7 TFLOP/s: 0.047 ms; the padding below makes 26.8 GFLOP issued,
//    0.054 ms), against about 29 MB (waveform 15.4, pre-split basis 1.5,
//    filterbank 0.1, log-mel 12.3; 0.009 ms at 3.35 TB/s): the products
//    bound it.
//    Design. A persistent grid, one block per SM; a block is three warpgroups,
//    and a work item is 64 frames of one window, owned by one of the two
//    consumer warpgroups. A round gives each block two items (one per
//    consumer) while two per block are left; the last round gives every block
//    one before any a second, so the tail (376 items over 132 SMs: 2.85 a
//    block) runs one consumer alone on most SMs instead of two on fewer. A
//    consumer without an item in a round only passes the round's basis
//    stages on.
//    - The DFT runs on the tensor cores, float32-grade: each product is
//      lo_a hi_b + hi_a lo_b + hi_a hi_b, three m64n64k8 TF32 wgmma products
//      with x = hi + lo (both TF32, rounded to nearest). The basis is a
//      constant: the wrapper splits it once per device into hi and lo,
//      interleaves its columns as (re_k, im_k) pairs, pads it to 448 columns
//      (7 N tiles of 64) and 416 taps (13 K chunks of 32, the last 16 zero),
//      orders each chunk's taps so that a thread's eight A values of a chunk
//      are contiguous (slot t of k-step kk is tap 8 t + 2 kk, slot t + 4 tap
//      8 t + 2 kk + 1), and lays each (N tile, K chunk) out as the
//      128-byte-swizzled K-major tile that wgmma reads (8 KB hi, then 8 KB
//      lo). Warp 0 of warpgroup 2 streams those 16 KB stages by bulk copy
//      into an mbarrier ring; they stay in L2 (1.5 MB), and both consumers
//      read each stage.
//    - The framing never materialises. Warp 1 of warpgroup 2 copies the
//      10,496 consecutive samples that an item's frames cover into that
//      consumer's span in shared memory, one bulk copy per row of 160
//      samples, and reflects the rows at the window's two ends with plain
//      loads. The A fragment of frame r, tap k is then read straight from the
//      span at 160 r + k: rows overlap (a Hankel operand), which a wgmma
//      shared-memory descriptor cannot describe, so A goes through registers
//      (two 16-byte loads per row and chunk) and is split there, in integer
//      instructions. 160 = 0 (mod 32) would put the rows of a load on the
//      same banks, so sample i is stored at word i + 4 floor(i / 160): rows
//      start 164 words apart, and the 8 lanes of each quarter-warp fall on
//      8 different 16-byte bank groups.
//    - Each K chunk's products go to an accumulator of their own, added to
//      the running sum by float32 adds: the tensor cores' accumulation
//      truncates, and all 156 products of an N tile in one accumulator err
//      several times more than the plain float32 route.
//    - Power in registers: a thread's two adjacent accumulator columns are one
//      bin's re and im, so power = re^2 + im^2 needs no shuffle. A consumer
//      writes an N tile's 32 bins of power for its 64 frames to shared memory
//      only (double-buffered, rows 36 words apart), and thread m then adds
//      mel filter m's weights times the bins of that tile inside its span into
//      64 registers, one per frame. After the last N tile it writes
//      log10(max(mel, 1e-10)) for its 64 frames.
//    setmaxnreg gives warpgroup 2 56 registers and each consumer thread 224.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper_common.cuh"

namespace {

constexpr int kTileFrames = 64;
constexpr int kFramesPerThread = 8;
constexpr int kThreads = 1024;
constexpr int kLoadsInFlight = 4;

size_t shared_bytes(int n_bins, int n_mels) {
  return sizeof(float) * (static_cast<size_t>(n_bins) * n_mels + static_cast<size_t>(kTileFrames) * n_bins) +
         sizeof(int) * 2 * static_cast<size_t>(n_mels);
}

__global__ void __launch_bounds__(kThreads)
power_mel_log_kernel(const float* __restrict__ spec, const float* __restrict__ fb,
                     float* __restrict__ out, int batch, int frames, int out_frames, int n_bins,
                     int n_mels) {
  extern __shared__ float smem[];
  float* fb_s = smem;                                      // n_bins * n_mels
  float* power_s = fb_s + n_bins * n_mels;                 // kTileFrames * n_bins
  int* lo_s = reinterpret_cast<int*>(power_s + kTileFrames * n_bins);  // n_mels
  int* hi_s = lo_s + n_mels;                               // n_mels
  const int tid = threadIdx.x;

  for (int i = tid; i < n_bins * n_mels; i += kThreads) fb_s[i] = fb[i];
  __syncthreads();
  // A Slaney filter is non-zero on a few neighbouring bins only: each tile
  // sums over that span instead of all n_bins.
  for (int mel = tid; mel < n_mels; mel += kThreads) {
    int lo = n_bins, hi = 0;
    for (int k = 0; k < n_bins; ++k) {
      if (fb_s[k * n_mels + mel] != 0.f) {
        lo = min(lo, k);
        hi = k + 1;
      }
    }
    lo_s[mel] = lo;
    hi_s[mel] = hi;
  }

  const int tiles_per_window = (out_frames + kTileFrames - 1) / kTileFrames;
  const int tile_items = kTileFrames * n_bins;
  constexpr int kGroups = kTileFrames / kFramesPerThread;
  for (int tile = blockIdx.x; tile < batch * tiles_per_window; tile += gridDim.x) {
    const int b = tile / tiles_per_window;
    const int t0 = (tile - b * tiles_per_window) * kTileFrames;
    const float* spec_b = spec + static_cast<size_t>(b) * frames * (2 * n_bins);
    __syncthreads();  // the spans are written, and every thread is done with the previous tile

    for (int base = tid; base < tile_items; base += kLoadsInFlight * kThreads) {
      float re[kLoadsInFlight], im[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int i = base + u * kThreads;
        const int f = i / n_bins;
        const int k = i - f * n_bins;
        re[u] = im[u] = 0.f;
        if (i < tile_items && t0 + f < out_frames) {
          const float* row = spec_b + static_cast<size_t>(t0 + f) * (2 * n_bins);
          re[u] = row[k];
          im[u] = row[n_bins + k];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int i = base + u * kThreads;
        if (i < tile_items) power_s[i] = re[u] * re[u] + im[u] * im[u];
      }
    }
    __syncthreads();

    for (int item = tid; item < kGroups * n_mels; item += kThreads) {
      const int group = item / n_mels;
      const int mel = item - group * n_mels;
      const float* p = power_s + group * kFramesPerThread * n_bins;
      float acc[kFramesPerThread];
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) acc[f] = 0.f;
      for (int k = lo_s[mel]; k < hi_s[mel]; ++k) {
        const float w = fb_s[k * n_mels + mel];
#pragma unroll
        for (int f = 0; f < kFramesPerThread; ++f) acc[f] = fmaf(p[f * n_bins + k], w, acc[f]);
      }
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) {
        const int t = t0 + group * kFramesPerThread + f;
        if (t < out_frames) {
          out[(static_cast<size_t>(b) * out_frames + t) * n_mels + mel] = log10f(fmaxf(acc[f], 1e-10f));
        }
      }
    }
  }
}

// The shared-memory attribute and the number of resident blocks depend only on
// the device and the shared-memory size, so they are set and queried once per
// (device, size) and kept here.
struct LaunchConfig {
  size_t smem = 0;
  int resident_blocks = 0;
};
constexpr int kMaxDevices = 64;
LaunchConfig g_config[kMaxDevices];
std::mutex g_config_mutex;

cudaError_t launch_config(int device, size_t smem, int* resident_blocks) {
  std::lock_guard<std::mutex> lock(g_config_mutex);
  LaunchConfig& config = g_config[device];
  if (config.smem != smem) {
    cudaError_t err = cudaFuncSetAttribute(power_mel_log_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
      return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, power_mel_log_kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    config.smem = smem;
    config.resident_blocks = sms * per_sm;
  }
  *resident_blocks = config.resident_blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int ser_power_mel_log(const float* spec, const float* fb, float* out, int batch,
                                 int frames, int out_frames, int n_bins, int n_mels,
                                 void* stream) {
  const size_t smem = shared_bytes(n_bins, n_mels);
  int device = 0, resident_blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if ((err = launch_config(device, smem, &resident_blocks)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // One resident block per SM slot, each walking several (window, tile) pairs,
  // so the filterbank is staged once per block.
  const int tiles = batch * ((out_frames + kTileFrames - 1) / kTileFrames);
  const int grid = tiles < resident_blocks ? tiles : resident_blocks;
  power_mel_log_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      spec, fb, out, batch, frames, out_frames, n_bins, n_mels);
  return static_cast<int>(cudaGetLastError());
}

// ---- the fused form --------------------------------------------------------- //

namespace {

constexpr int kFft = 400;
constexpr int kHop = 160;
constexpr int kBins = kFft / 2 + 1;                 // 201
constexpr int kPad = kFft / 2;                      // reflect-centred framing
constexpr int kItemFrames = 64;                     // frames per work item, owned by one consumer warpgroup
constexpr int kNTile = 64;                          // basis columns per N tile: 32 bins as (re, im) pairs
constexpr int kNTiles = 7;                          // 448 columns >= 2 * 201
constexpr int kKChunk = 32;                         // taps per K chunk: one 128-byte row
constexpr int kKChunks = 13;                        // 416 taps >= 400; the basis is zero past 400
constexpr int kChunkBytes = kNTile * kKChunk * 4;   // 8 KB: one hi or lo tile
constexpr int kStageBytes = 2 * kChunkBytes;        // hi, then lo
constexpr int kStages = 6;
constexpr int kSkew = 4;                            // sample i at word i + kSkew * (i / kHop)
constexpr int kSpanSamples = (kItemFrames - 1) * kHop + kKChunks * kKChunk;  // 10,496
constexpr int kSpanRows = (kSpanSamples + kHop - 1) / kHop;                   // rows of kHop samples
constexpr int kSpanWords = kSpanRows * (kHop + kSkew);
constexpr int kPowerStride = 36;                    // words between frames of a power tile
constexpr int kPowerWords = kItemFrames * kPowerStride;  // one N tile's power for an item
constexpr int kFusedConsumers = 2;
constexpr int kFusedThreads = (kFusedConsumers + 1) * 128;
constexpr int kMaxMels = 128;                       // one mel filter per consumer thread
constexpr int kFusedProducerRegs = 56;
constexpr int kFusedConsumerRegs = 224;             // 128 * 56 + 256 * 224 = 384 * 168

static_assert(kNTiles * kNTile >= 2 * kBins && kKChunks * kKChunk >= kFft, "the padded basis covers the DFT");
static_assert(kHop % kKChunk == 0, "a K chunk never straddles a multiple of kHop, so its skew is one value");
static_assert(kItemFrames == 64, "one wgmma row tile per work item");

// Shared memory, from the 1024-byte aligned base.
constexpr int kFusedStage = 0;                                         // [kStages] basis stages
constexpr int kFusedSpan = kFusedStage + kStages * kStageBytes;        // [consumer] the item's samples, skewed
constexpr int kFusedPower = kFusedSpan + kFusedConsumers * kSpanWords * 4;         // [consumer][2] power tiles
constexpr int kFusedMelSpan = kFusedPower + kFusedConsumers * 2 * kPowerWords * 4;  // lo[kMaxMels], hi[kMaxMels]
constexpr int kFusedBars = kFusedMelSpan + 2 * kMaxMels * 4;  // full, empty [kStages]; span full, empty [consumer]
constexpr int kFusedSmem = kFusedBars + (2 * kStages + 2 * kFusedConsumers) * 8 + 1024;

// Sample s of a window of n samples, reflected at both ends as F.pad(mode="reflect")
// does for |s| < n; clamped, so that frames past T (never written) read finite samples.
__device__ __forceinline__ int reflect(int s, int n) {
  if (s < 0) s = -s;
  if (s >= n) s = 2 * (n - 1) - s;
  return min(max(s, 0), n - 1);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The work item of consumer warpgroup `wg` in round `round`, or -1. A round gives each
// block two items while at least two per block are left; the last round gives every block
// one item before any block a second, so that its blocks run one consumer where they can.
__device__ __forceinline__ int round_item(int round, int wg, int n_items) {
  const int per_round = kFusedConsumers * gridDim.x;
  const int first = round * per_round;
  const int left = n_items - first;
  if (left <= 0) return -1;
  const int i = left >= per_round ? kFusedConsumers * blockIdx.x + wg : wg * gridDim.x + blockIdx.x;
  return i < left ? first + i : -1;
}

__global__ void __launch_bounds__(kFusedThreads, 1)
stft_power_mel_log_kernel(const float* __restrict__ wave, const uint8_t* __restrict__ basis,
                          const float* __restrict__ fb, float* __restrict__ out, int batch, int samples,
                          int out_frames, int n_mels, int vector_loads) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* mel_lo = reinterpret_cast<int*>(smem + kFusedMelSpan);
  int* mel_hi = mel_lo + kMaxMels;
  const uint32_t full = base + kFusedBars;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t span_full = empty + 8 * kStages;                 // [consumer]
  const uint32_t span_empty = span_full + 8 * kFusedConsumers;    // [consumer]
  const int item_tiles = (out_frames + kItemFrames - 1) / kItemFrames;
  const int n_items = batch * item_tiles;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kFusedConsumers * 4);
    }
    for (int c = 0; c < kFusedConsumers; ++c) {
      mbar_init(span_full + 8 * c, 2);  // the fill warp's expect_tx and its arrival after the plain loads
      mbar_init(span_empty + 8 * c, 4);
    }
    fence_barrier_init();
  }
  // A Slaney filter is non-zero on a few neighbouring bins only: each thread sums its
  // filter over that span.
  for (int mel = threadIdx.x; mel < n_mels; mel += kFusedThreads) {
    int lo = kBins, hi = 0;
    for (int k = 0; k < kBins; ++k) {
      if (fb[k * n_mels + mel] != 0.f) {
        lo = min(lo, k);
        hi = k + 1;
      }
    }
    mel_lo[mel] = lo;
    mel_hi[mel] = hi;
  }
  __syncthreads();

  if (wg == kFusedConsumers) {
    regs_dealloc<kFusedProducerRegs>();
    if (warp == 0) {
      // The basis stages of every (N tile, K chunk), once per round, in the consumers' order.
      if (lane == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int round = 0; round_item(round, 0, n_items) >= 0; ++round) {
          for (int chunk = 0; chunk < kNTiles * kKChunks; ++chunk) {
            mbar_wait(empty + 8 * stage, phase ^ 1u);
            mbar_expect_tx(full + 8 * stage, kStageBytes);
            bulk_load(base + kFusedStage + stage * kStageBytes, basis + static_cast<size_t>(chunk) * kStageBytes,
                      kStageBytes, full + 8 * stage);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
    } else if (warp == 1) {
      // The samples that each item's frames cover, skewed: a bulk copy per row of kHop
      // samples that lies inside the window, plain loads (reflected at its ends) elsewhere.
      uint32_t phases = 0;  // bit c: the parity of consumer c's span barriers
      for (int round = 0; round_item(round, 0, n_items) >= 0; ++round) {
        for (int c = 0; c < kFusedConsumers; ++c) {
          const int item = round_item(round, c, n_items);
          if (item < 0) continue;
          const int b = item / item_tiles;
          const int first = (item - b * item_tiles) * kItemFrames * kHop - kPad;  // window sample of span sample 0
          const float* wave_b = wave + static_cast<size_t>(b) * samples;
          const uint32_t span_addr = base + kFusedSpan + c * kSpanWords * 4;
          float* span = reinterpret_cast<float*>(smem + kFusedSpan) + c * kSpanWords;
          mbar_wait(span_empty + 8 * c, ((phases >> c) & 1u) ^ 1u);
          uint32_t bytes = 0;
          for (int row = lane; row < kSpanRows; row += 32) {
            const int s = first + row * kHop, len = min(kHop, kSpanSamples - row * kHop);
            if (vector_loads && s >= 0 && s + len <= samples) bytes += 4 * len;
          }
          bytes = __reduce_add_sync(0xffffffffu, bytes);
          if (lane == 0) mbar_expect_tx(span_full + 8 * c, bytes);
          __syncwarp();
          for (int row = lane; row < kSpanRows; row += 32) {
            const int s = first + row * kHop, len = min(kHop, kSpanSamples - row * kHop);
            if (vector_loads && s >= 0 && s + len <= samples) {
              bulk_load(span_addr + 4 * row * (kHop + kSkew), wave_b + s, 4 * len, span_full + 8 * c);
            }
          }
          for (int row = 0; row < kSpanRows; ++row) {
            const int s = first + row * kHop, len = min(kHop, kSpanSamples - row * kHop);
            if (!(vector_loads && s >= 0 && s + len <= samples)) {
              for (int e = lane; e < len; e += 32) span[row * (kHop + kSkew) + e] = wave_b[reflect(s + e, samples)];
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(span_full + 8 * c);  // the plain loads' arrival; the copies complete the bytes
          phases ^= 1u << c;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: one item of 64 frames a round, or, without one, it only
    // passes the round's basis stages on.
    regs_alloc<kFusedConsumerRegs>();
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int t4 = lane & 3;  // thread of the four that share a row
    const int row0 = 16 * warp + g;  // this thread's frames in the item: row0, row0 + 8
    const int word0 = row0 * (kHop + kSkew);
    const int word1 = word0 + 8 * (kHop + kSkew);
    const int mel = threadIdx.x % 128;
    const int lo = mel < n_mels ? mel_lo[mel] : 0;
    const int hi = mel < n_mels ? mel_hi[mel] : 0;
    const float* span = reinterpret_cast<const float*>(smem + kFusedSpan) + wg * kSpanWords;
    float* power = reinterpret_cast<float*>(smem + kFusedPower) + wg * 2 * kPowerWords;
    int stage = 0, tiles_done = 0;  // the power buffers alternate over every N tile of every item
    uint32_t phase = 0, span_phase = 0;
    for (int round = 0; round_item(round, 0, n_items) >= 0; ++round) {
      const int item = round_item(round, wg, n_items);
      if (item < 0) {
        for (int chunk = 0; chunk < kNTiles * kKChunks; ++chunk) {
          mbar_wait(full + 8 * stage, phase);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
        continue;
      }
      const int b = item / item_tiles;
      const int t0 = (item - b * item_tiles) * kItemFrames;
      float mel_sum[64];
#pragma unroll
      for (int f = 0; f < 64; ++f) mel_sum[f] = 0.f;
      mbar_wait(span_full + 8 * wg, span_phase);
      span_phase ^= 1u;

      for (int n_tile = 0; n_tile < kNTiles; ++n_tile, ++tiles_done) {
        float sum[32], part[32];
        for (int chunk = 0; chunk < kKChunks; ++chunk) {
          // A fragments of the chunk's 32 taps, in the basis's tap order: slot t4 of k-step kk is
          // tap 8 t4 + 2 kk, slot t4 + 4 tap 8 t4 + 2 kk + 1, so that each row's 8 taps are
          // contiguous (two 16-byte loads); rows row0 and row0 + 8; split into hi and lo.
          const int k0 = chunk * kKChunk;
          const int offset = k0 + kSkew * (k0 / kHop) + 8 * t4;
          uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float* taps = span + (r ? word1 : word0) + offset;
            const float4 v0 = *reinterpret_cast<const float4*>(taps);
            const float4 v1 = *reinterpret_cast<const float4*>(taps + 4);
            const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              split_tf32_int(v[2 * kk], a_hi[kk][r], a_lo[kk][r]);
              split_tf32_int(v[2 * kk + 1], a_hi[kk][2 + r], a_lo[kk][2 + r]);
            }
          }
          const uint32_t tile_hi = base + kFusedStage + stage * kStageBytes;
          const uint32_t tile_lo = tile_hi + kChunkBytes;
          mbar_wait(full + 8 * stage, phase);
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_lo[kk], sw128_desc(tile_hi + 32 * kk), kk);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_hi[kk], sw128_desc(tile_lo + 32 * kk), 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_hi[kk], sw128_desc(tile_hi + 32 * kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
          // The chunk's sum in an accumulator of its own, added here in float32.
          if (chunk == 0) {
#pragma unroll
            for (int i = 0; i < 32; ++i) sum[i] = part[i];
          } else {
#pragma unroll
            for (int i = 0; i < 32; ++i) sum[i] += part[i];
          }
        }
        if (n_tile == kNTiles - 1) {  // the span is read for the last time
          __syncwarp();
          if (lane == 0) mbar_arrive(span_empty + 8 * wg);
        }
        // Columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of the tile are bin 4 j + t4's re and im.
        float* tile_power = power + (tiles_done & 1) * kPowerWords;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tile_power[row0 * kPowerStride + 4 * j + t4] = fmaf(sum[4 * j], sum[4 * j], sum[4 * j + 1] * sum[4 * j + 1]);
          tile_power[(row0 + 8) * kPowerStride + 4 * j + t4] =
              fmaf(sum[4 * j + 2], sum[4 * j + 2], sum[4 * j + 3] * sum[4 * j + 3]);
        }
        named_barrier(1 + wg, 128);
        // Filter `mel` over the bins of this tile inside its span.
        const int bin0 = 32 * n_tile;
        const int k_end = min(hi, bin0 + 32);
        for (int k = max(lo, bin0); k < k_end; ++k) {
          const float weight = __ldg(fb + k * n_mels + mel);
          const float* column = tile_power + (k - bin0);
#pragma unroll
          for (int f = 0; f < 64; ++f) mel_sum[f] = fmaf(column[f * kPowerStride], weight, mel_sum[f]);
        }
        __syncwarp();
      }
      if (mel < n_mels) {
#pragma unroll
        for (int f = 0; f < 64; ++f) {
          if (t0 + f < out_frames) {
            out[(static_cast<size_t>(b) * out_frames + t0 + f) * n_mels + mel] = log10f(fmaxf(mel_sum[f], 1e-10f));
          }
        }
      }
    }
  }
}

}  // namespace

// The fused form on `stream`. wave (B, S) f32 contiguous; basis the wrapper's
// pre-split, interleaved, padded and swizzled DFT basis (kNTiles * kKChunks
// stages of kStageBytes, 16-byte aligned); fb (201, n_mels) f32, n_mels <= 128;
// out (B, T_out, n_mels) f32, T_out <= 1 + S / 160.
extern "C" int ser_stft_power_mel_log(const void* wave, const void* basis, const void* fb, void* out, int batch,
                                      int samples, int out_frames, int n_mels, void* stream) {
  if (batch <= 0 || samples <= kPad || n_mels <= 0 || n_mels > kMaxMels || out_frames <= 0 ||
      out_frames > 1 + samples / kHop || (reinterpret_cast<uintptr_t>(basis) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vector_loads = (reinterpret_cast<uintptr_t>(wave) & 15) == 0 && samples % 4 == 0;
  cudaError_t err = cudaSuccess;
  const int items = batch * ((out_frames + kItemFrames - 1) / kItemFrames);
  const int grid = persistent_grid((items + kFusedConsumers - 1) / kFusedConsumers, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(stft_power_mel_log_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFusedSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stft_power_mel_log_kernel<<<grid, kFusedThreads, kFusedSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const uint8_t*>(basis), static_cast<const float*>(fb),
      static_cast<float*>(out), batch, samples, out_frames, n_mels, vector_loads);
  return static_cast<int>(cudaGetLastError());
}
