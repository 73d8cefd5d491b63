// Kernel K1: Whisper's power -> mel -> log10 stage, for Hopper (sm_90a).
//
// Replaces the TPU kernel ser_tpu/ops/pallas_kernels.py::_power_mel_log_kernel_3d
// (launched by _power_mel_log_call). Same boundary: the [re | im] STFT comes in,
// the raw log-mel (no max-8 floor, no affine) goes out.
//
//   in : spec (B, T, 2 * n_bins) f32, [re_0..re_{n_bins-1} | im_0..im_{n_bins-1}]
//        fb   (n_bins, n_mels)    f32, the Slaney filterbank, transposed
//   out: (B, T_out, n_mels) f32 = log10(max(sum_k (re_k^2 + im_k^2) fb[k, m], 1e-10))
//        for the first T_out <= T frames
//
// Bound on the H100: at the main path's shapes (B = 8 windows, T = 3001,
// n_bins = 201, n_mels = 128) the kernel must move about 51 MB (spectrum in,
// log-mel out), while the Slaney filterbank has 394 non-zero weights of
// 25,728, so the projection it needs is about 0.03 GFLOP: memory bounds it.
// The design reads the spectrum once, coalesced, and never writes the power
// to device memory. One block per SM stages the filterbank in shared memory
// and finds each mel filter's non-zero span once, then walks (window, tile of
// 64 frames) pairs: it computes a tile's power into shared memory, with four
// loads in flight per thread, and each thread then sums one mel filter over
// its span for 8 frames. Unlike the TPU kernel it takes the spectrum unpadded
// (no 256/128 lane padding). Folding the framing and the DFT in, so that the
// spectrum never reaches device memory, is later work.

#include <cuda_runtime.h>

#include <mutex>

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
