// Polyphase resampling to the encoders' rate, written into their padded rows (sm_90a).
//
// It replaces no TPU kernel: the JAX package resamples on the host
// (ser_tpu/_internal/utils/audio_io.py::resample_audio, scipy's resample_poly
// in float64), and so did the port until this kernel. On the host that pass
// took about 1.3 ms per audio-second, one core, while the card waited for
// its result; here the samples are copied to the card once and one launch
// writes the encoder's input rows.
//
// What it computes: scipy.signal.resample_poly(clip, up, down) with its
// defaults, up/down reduced by their gcd. With half = 10 max(up, down) and
// h = firwin(2 half + 1, 1 / max(up, down), window=("kaiser", 5.0)) * up,
// output i of a clip of n samples (0 <= i < ceil(n up / down)) is
//   y[i] = sum_s x[s] h[half + i down - up s],  x zero outside [0, n),
// which is resample_poly's upfirdn with its n_pre_pad / n_pre_remove
// alignment. With base = i down + half, s_hi = base / up and r = base % up,
// y[i] = sum_k P[r][k] x[s_hi - k], P[r][k] = h[r + up k] (zero past h's end):
// phase r's taps, kt = ceil((2 half + 1) / up) of them. The wrapper hands the
// table in float32, a row of kt taps a phase, in the order the kernel reads
// them: by class rho = k % down, then j = k / down.
//
// A row descriptor (int64 x 4: offset of the clip in the flat source, its
// length at the source rate, the first output of the row within the clip, the
// outputs the row holds) makes row b of out (rows, row_samples):
//   out[b, c] = y_clip[start + c] for c < valid, 0 for valid <= c < row_samples,
// so a row that starts inside a clip reads the source on both sides of its
// first output, as filtering the whole clip and then cutting it does.
//
// Bound on the H100: bytes. At 48 kHz (1/3, kt = 61) a 16 kHz output reads
// three source samples and writes one: a 600 s file into 20 rows of 480000 is
// 115 MB read and 38 MB written (46 us at 3.35 TB/s) against 0.59 GMAC
// (61 a sample; 18 us of float32 FMA). Design. A block takes a tile of
// kPerThread * items outputs of one row. It stages the tile's source span
// (its outputs' reach, zero-extended at the clip's ends) in shared memory,
// by 16-byte asynchronous copies (cp.async) where the span lies inside the
// clip, all in flight before the block waits for them. An item is
// kPerThread outputs of one phase, up apart (at up = 1, consecutive), so one
// tap feeds kPerThread products: the thread walks each tap class rho and
// keeps the kPerThread source samples it needs in a register ring, loading
// one new sample a tap (the outputs of a class are a plain convolution of the
// every-down-th samples). A small table (up * kt <= kSharedTaps: 61 taps at
// 48 kHz) is copied into shared memory by each block, and read there as a
// broadcast at up = 1; a larger one is read through the read-only cache.
// Outputs go to shared memory and then out with coalesced stores, the
// padding written as zeros by the same pass; a tile wholly in the padding
// only writes zeros. kPerThread is odd, so the threads' source reads,
// kPerThread * down apart, fall in distinct banks whenever down is odd. A
// ratio whose tile does not fit shared memory (up or down in the thousands)
// reads the source and writes the rows straight from device memory instead.
// Measured on an H100 (700 W) at the 600 s file: 0.084 ms, 55 % of the byte
// bound; the products and their loads, not the bytes, hold it there (without
// the products the same launch takes 0.055 ms). At 44.1 kHz (160/441, one
// tap a class, so no sample is reused from the ring) 0.47 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 7;
// A table of at most this many taps (up * kt; 61 at 48 kHz) is copied into shared memory by each block.
constexpr int kSharedTaps = 1024;

struct Row {
  long long offset, length, start, valid;
};

// The tile's source samples: staged in shared memory, or read from device memory.
struct SharedSpan {
  const float* xs;
  __device__ __forceinline__ float operator()(int m) const { return xs[m]; }
};

struct DeviceSpan {
  const float* clip;
  long long first, length;
  __device__ __forceinline__ float operator()(int m) const {
    const long long s = first + m;
    return (s >= 0 && s < length) ? __ldg(clip + s) : 0.0f;
  }
};

// Starts a 16-byte copy from device to shared memory (cp.async; waited for by cp.async.wait_all).
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address), "l"(src) : "memory");
}

// kPerThread outputs of one phase (its kt taps from taps[0]), the latest source sample at span
// index hi (the next output's up later, down samples on).
template <typename Span>
__device__ __forceinline__ void item_outputs(const Span& x, const float* __restrict__ taps, int hi, int down,
                                             int kt, float (&acc)[kPerThread]) {
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) acc[t] = 0.0f;
  const int classes = kt < down ? kt : down;
  int tap = 0;
  for (int rho = 0; rho < classes; ++rho) {
    // Class rho: z[u] = x[hi - rho + u down], acc[t] += sum_j taps[tap + j] z[t - j].
    const int count = (kt - 1 - rho) / down + 1;
    const int z0 = hi - rho;
    float ring[kPerThread];  // z[u] in slot u mod kPerThread
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) ring[t] = x(z0 + t * down);
    for (int jb = 0; jb < count; jb += kPerThread) {
#pragma unroll
      for (int jj = 0; jj < kPerThread; ++jj) {
        const int j = jb + jj;
        if (j < count) {
          if (j > 0) ring[(kPerThread - jj) % kPerThread] = x(z0 - j * down);
          const float h = taps[tap + j];
#pragma unroll
          for (int t = 0; t < kPerThread; ++t) {
            acc[t] = fmaf(h, ring[(t - jj + kPerThread) % kPerThread], acc[t]);
          }
        }
      }
    }
    tap += count;
  }
}

template <bool kStaged, bool kTapsShared>
__global__ void __launch_bounds__(kThreads) resample_rows_kernel(
    const float* __restrict__ source, const long long* __restrict__ rows, const float* __restrict__ table,
    float* __restrict__ out, int row_samples, int tiles_per_row, int items, int up, int down, int half, int kt,
    int span_capacity) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float shared_taps[kTapsShared ? kSharedTaps : 1];
  const int row = blockIdx.x / tiles_per_row;
  const int tile = items * kPerThread;
  const int c0 = (blockIdx.x % tiles_per_row) * tile;
  const int columns = min(tile, row_samples - c0);
  const Row d = reinterpret_cast<const Row*>(rows)[row];
  float* out_row = out + static_cast<long long>(row) * row_samples + c0;
  if (c0 >= d.valid) {
    for (int m = threadIdx.x; m < columns; m += blockDim.x) out_row[m] = 0.0f;
    return;
  }
  const long long o0 = d.start + c0;
  const long long first = (o0 * down + half) / up - (kt - 1);  // the tile's first source sample
  const float* clip = source + d.offset;

  if (kTapsShared) {
    for (int i = threadIdx.x; i < up * kt; i += blockDim.x) shared_taps[i] = __ldg(table + i);
  }
  float* xs = smem;
  float* ys = smem + span_capacity;
  int lead = 0;
  if (kStaged) {
    // Samples first .. last of the clip, from a 16-byte boundary of the flat source. Every copy is
    // started before any is waited for: a block's span is in flight at once.
    const long long last = ((o0 + tile - 1) * down + half) / up;
    const long long a0 = (d.offset + first) & ~3LL;
    lead = static_cast<int>(d.offset + first - a0);
    const int vectors = static_cast<int>((d.offset + last - a0) / 4 + 1);
    for (int v = threadIdx.x; v < vectors; v += blockDim.x) {
      const long long a = a0 + 4LL * v;
      if (a >= d.offset && a + 3 < d.offset + d.length) {
        copy16_async(xs + 4 * v, source + a);
      } else {
        const long long s = a - d.offset;
        float4 q;
        q.x = (s >= 0 && s < d.length) ? __ldg(source + a) : 0.0f;
        q.y = (s + 1 >= 0 && s + 1 < d.length) ? __ldg(source + a + 1) : 0.0f;
        q.z = (s + 2 >= 0 && s + 2 < d.length) ? __ldg(source + a + 2) : 0.0f;
        q.w = (s + 3 >= 0 && s + 3 < d.length) ? __ldg(source + a + 3) : 0.0f;
        reinterpret_cast<float4*>(xs)[v] = q;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (kStaged || kTapsShared) __syncthreads();

  const int group = up * kPerThread;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int q = (item / up) * group + item % up;  // the item's first output in the tile
    const long long base = (o0 + q) * down + half;
    const int hi = static_cast<int>(base / up - first);
    const float* taps = (kTapsShared ? shared_taps : table) + static_cast<long long>(base % up) * kt;
    float acc[kPerThread];
    if (kStaged) {
      item_outputs(SharedSpan{xs + lead}, taps, hi, down, kt, acc);
    } else {
      item_outputs(DeviceSpan{clip, first, d.length}, taps, hi, down, kt, acc);
    }
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int m = q + t * up;
      const float y = c0 + m < d.valid ? acc[t] : 0.0f;
      if (kStaged) {
        ys[m] = y;
      } else if (m < columns) {
        out_row[m] = y;
      }
    }
  }
  if (kStaged) {
    __syncthreads();
    for (int m = threadIdx.x; m < columns; m += blockDim.x) out_row[m] = ys[m];
  }
}

}  // namespace

extern "C" int ser_resample_rows(const void* source, const void* rows, const void* table, void* out, int n_rows,
                                 int row_samples, int up, int down, int half, int kt, void* stream) {
  if (n_rows <= 0 || row_samples <= 0 || up <= 0 || down <= 0 || half < 0 || kt <= 0 ||
      (reinterpret_cast<uintptr_t>(source) & 15) != 0 || (reinterpret_cast<uintptr_t>(rows) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // An item is kPerThread outputs of one phase; a tile, whole groups of up * kPerThread outputs and
  // at least kThreads items.
  const long long items = static_cast<long long>(up) * ((kThreads + up - 1) / up);
  const long long tile = items * kPerThread;
  if (tile > (1LL << 24)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_per_row = (row_samples + tile - 1) / tile;
  const long long blocks = tiles_per_row * n_rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // The tile's span: (tile - 1) down / up + 1 latest samples and kt - 1 before them, the lead to a
  // 16-byte boundary and the last vector's tail; then the output tile.
  const long long span = ((tile - 1) * down) / up + 1 + kt + 7;
  const long long span_capacity = (span + 3) & ~3LL;
  const long long smem = (span_capacity + tile) * static_cast<long long>(sizeof(float));
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* src = static_cast<const float*>(source);
  const auto* desc = static_cast<const long long*>(rows);
  const auto* taps = static_cast<const float*>(table);
  auto* dst = static_cast<float*>(out);
  const auto cuda_stream = static_cast<cudaStream_t>(stream);
  const bool small_table = static_cast<long long>(up) * kt <= kSharedTaps;
  const auto launch = [&](auto kernel, long long bytes) {
    if (bytes > 48 * 1024) {
      const cudaError_t set =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (set != cudaSuccess) return set;
    }
    kernel<<<static_cast<int>(blocks), kThreads, static_cast<size_t>(bytes), cuda_stream>>>(
        src, desc, taps, dst, row_samples, static_cast<int>(tiles_per_row), static_cast<int>(items), up, down, half,
        kt, static_cast<int>(span_capacity));
    return cudaGetLastError();
  };
  if (smem + kSharedTaps * static_cast<long long>(sizeof(float)) > optin) {
    err = launch(resample_rows_kernel<false, false>, 0);
  } else if (small_table) {
    err = launch(resample_rows_kernel<true, true>, smem);
  } else {
    err = launch(resample_rows_kernel<true, false>, smem);
  }
  return static_cast<int>(err);
}
