// AdaIN statistics pass: masked instance moments and the AdaIN fold, Hopper
// (sm_90a).
//
// Replaces the XLA reduction the JAX package runs outside its Pallas conv
// kernels, illufly_tts_tpu/ops/pallas/fused_conv.py::instance_moments and
// fold_adain (the "cheap XLA reduction that runs before the transposed-layout
// kernel"), and the same reduction inside illufly_tts_tpu/model/layers.py::
// AdaIN1d. For x [B, C, L] (channels first, f32 or bf16), mask [B, L] f32 or
// none (all ones), gamma and beta [B, C] f32 (rows at any stride):
//   count = max(sum m, 1), mean = sum x m / count,
//   var = sum (x - mean)^2 m / count,
//   scale = (1 + gamma) / sqrt(var + eps), shift = beta - mean * scale,
// written as out [2, B, C] f32 (scale, then shift). With gamma and beta null
// the fold is left out and out holds (mean, 1 / sqrt(var + eps)): the moments
// that AdaIN1d normalizes with, as the JAX layer does. A bf16 x is widened to
// f32 on load; all arithmetic is f32.
//
// Bound: memory. The function must read x once (and the mask once); its
// arithmetic is a few operations an element. [32, 128, 61440] bf16 is
// 503 MB of x and 7.9 MB of mask, 0.153 ms at 3.35 TB/s.
//
// Design (two launches on one stream):
// - chunk_moments: one block of THREADS threads a (row, chunk) pair, a
//   chunk being CHUNK = THREADS * PER_THREAD consecutive elements of one
//   (b, c) row. Rows reach 491520 elements and a stage may have only 128
//   rows for 132 SMs, so rows are split across blocks. Each thread loads
//   its PER_THREAD elements (coalesced: neighbouring threads on
//   neighbouring elements) and their mask values into registers once; the
//   block sums x m and m, takes the chunk's mean, then sums the centered
//   squares (x - mean_chunk)^2 m from the same registers: the two-pass
//   arithmetic, with x read from device memory once. It writes the chunk's
//   (count, mean, M2) to a scratch of three planes [chunks][rows].
//   With row extents (extent[b], one past the last nonzero mask column of
//   batch row b; the Generator passes them), a block whose chunk starts at
//   or past its row's extent reads neither x nor the mask: every weight
//   there is 0, so the full pass would write count 0, mean 0 and M2 0
//   (+0 each, for finite x), which the block writes as they are.
// - finish_rows: one thread a row combines its chunks' triples left to
//   right by Chan's formula (each triple centered within its chunk, so the
//   combine stays centered), then applies the count clamp and the fold. A
//   zero-count triple leaves n and M2 as they were (+0 added) and the mean
//   too (delta * 0 added; a -0 mean becomes +0), whether the block computed
//   it or skipped it: the two give the same bits.
// Sums are block trees in a fixed order and the combine runs in a fixed
// order: no atomics, so two launches on the same inputs give the same
// bits, inside CUDA graphs too (the wrapper allocates out and the scratch).
//
// Plain C interface, loaded with ctypes: each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;
constexpr int WARPS = THREADS / 32;
constexpr int FINISH_THREADS = 128;
constexpr int FINISH_BATCH = 8;  // chunks whose loads a thread issues at once

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum each of v[0..N) over the block; every thread gets the totals. Warps
// reduce by xor shuffles (every lane ends with the same bits: each step adds
// the same two values in either order), then every thread adds the warps'
// sums in warp order.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[warp * N + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * N + j];
    v[j] = s;
  }
  __syncthreads();  // red is written again by the next sum
}

// EXTENTS (with MASKED): the rows' extents decide which chunks are read;
// a launch without them runs the form without the test.
template <typename T, bool MASKED, bool EXTENTS>
__global__ void __launch_bounds__(THREADS)
    chunk_moments(const T* __restrict__ x, const float* __restrict__ mask,
                  const int* __restrict__ extent, int channels, int length,
                  int chunks, int rows, float* __restrict__ part) {
  __shared__ float red[WARPS * 2];
  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  if (EXTENTS && chunk * CHUNK >= extent[row / channels]) {
    if (threadIdx.x == 0) {  // all weights 0: what the pass would write
      const int64_t plane = (int64_t)chunks * rows;
      const int64_t at = (int64_t)chunk * rows + row;
      part[at] = 0.f;
      part[plane + at] = 0.f;
      part[2 * plane + at] = 0.f;
    }
    return;
  }
  const T* xr = x + (int64_t)row * length;
  const float* mr = MASKED ? mask + (int64_t)(row / channels) * length
                           : nullptr;
  const int l0 = chunk * CHUNK + threadIdx.x;
  float v[PER_THREAD], w[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int l = l0 + i * THREADS;
    const bool in = l < length;
    v[i] = in ? widen(xr[l]) : 0.f;
    w[i] = in ? (MASKED ? mr[l] : 1.f) : 0.f;
  }
  float sums[2] = {0.f, 0.f};  // sum x m, sum m
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    sums[0] += v[i] * w[i];
    sums[1] += w[i];
  }
  block_sum<2>(sums, red);
  const float n = sums[1];
  const float mean = n > 0.f ? sums[0] / n : 0.f;
  float m2[1] = {0.f};
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const float d = v[i] - mean;
    m2[0] += d * d * w[i];
  }
  block_sum<1>(m2, red);
  if (threadIdx.x == 0) {
    const int64_t plane = (int64_t)chunks * rows;
    const int64_t at = (int64_t)chunk * rows + row;
    part[at] = n;
    part[plane + at] = mean;
    part[2 * plane + at] = m2[0];
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
    finish_rows(const float* __restrict__ part, int rows, int chunks,
                int channels, const float* __restrict__ gamma,
                int64_t gamma_stride, const float* __restrict__ beta,
                int64_t beta_stride, float eps, float* __restrict__ out) {
  const int row = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (row >= rows) return;
  const int64_t plane = (int64_t)chunks * rows;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k0 = 0; k0 < chunks; k0 += FINISH_BATCH) {
    float cn[FINISH_BATCH], cm[FINISH_BATCH], cq[FINISH_BATCH];
#pragma unroll
    for (int j = 0; j < FINISH_BATCH; ++j) {
      const bool in = k0 + j < chunks;
      const int64_t at = (int64_t)(k0 + j) * rows + row;
      cn[j] = in ? part[at] : 0.f;
      cm[j] = in ? part[plane + at] : 0.f;
      cq[j] = in ? part[2 * plane + at] : 0.f;
    }
    // Chan: n = na + nb, mean += delta nb / n, M2 += M2b + delta^2 na nb / n
#pragma unroll
    for (int j = 0; j < FINISH_BATCH; ++j) {
      if (k0 + j >= chunks) break;
      const float total = n + cn[j];
      const float share = total > 0.f ? cn[j] / total : 0.f;
      const float delta = cm[j] - mean;
      mean += delta * share;
      m2 += cq[j] + delta * delta * n * share;
      n = total;
    }
  }
  // count = max(n, 1): below 1 (an all-zero mask row) the mean is sum x m
  // and the variance sum (x - mean)^2 m = M2 + n (mean_n - mean)^2
  float mean_out = mean, var;
  if (n >= 1.f) {
    var = m2 / n;
  } else {
    mean_out = n * mean;
    const float d = mean - mean_out;
    var = m2 + n * d * d;
  }
  const float rstd = 1.f / sqrtf(var + eps);
  if (gamma == nullptr) {  // the moments alone
    out[row] = mean_out;
    out[rows + row] = rstd;
    return;
  }
  const int b = row / channels;
  const int c = row - b * channels;
  const float scale = (1.f + gamma[b * gamma_stride + c]) * rstd;
  out[row] = scale;
  out[rows + row] = beta[b * beta_stride + c] - mean_out * scale;
}

template <typename T>
int launch(const T* x, const float* mask, const int* extent,
           const float* gamma, int64_t gamma_stride, const float* beta,
           int64_t beta_stride, float* out, float* part, int batch,
           int channels, int length, float eps, void* stream) {
  if (batch <= 0 || channels <= 0 || length <= 0 || (extent && !mask)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = (int64_t)batch * channels;
  const int64_t chunks = (length + CHUNK - 1) / CHUNK;
  if (rows * chunks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(rows * chunks);
  if (extent) {
    chunk_moments<T, true, true><<<blocks, THREADS, 0, s>>>(
        x, mask, extent, channels, length, (int)chunks, (int)rows, part);
  } else if (mask) {
    chunk_moments<T, true, false><<<blocks, THREADS, 0, s>>>(
        x, mask, nullptr, channels, length, (int)chunks, (int)rows, part);
  } else {
    chunk_moments<T, false, false><<<blocks, THREADS, 0, s>>>(
        x, mask, nullptr, channels, length, (int)chunks, (int)rows, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_rows<<<(unsigned)((rows + FINISH_THREADS - 1) / FINISH_THREADS),
                FINISH_THREADS, 0, s>>>(part, (int)rows, (int)chunks,
                                        channels, gamma, gamma_stride, beta,
                                        beta_stride, eps, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, C, L] f32, mask [B, L] f32 or null, extent [B] (row extents of the
// mask) or null, gamma/beta rows of C floats at the given row strides, or
// both null (out: the moments); out [2, B, C]; part: 3 * B * C * chunks
// floats (adain_fold_part_floats).
extern "C" int adain_fold_f32(const float* x, const float* mask,
                              const int* extent,
                              const float* gamma, long long gamma_stride,
                              const float* beta, long long beta_stride,
                              float* out, float* part, int batch,
                              int channels, int length, float eps,
                              void* stream) {
  return launch(x, mask, extent, gamma, gamma_stride, beta, beta_stride, out,
                part, batch, channels, length, eps, stream);
}

// The same for a bfloat16 x.
extern "C" int adain_fold_bf16(const void* x, const float* mask,
                               const int* extent,
                               const float* gamma, long long gamma_stride,
                               const float* beta, long long beta_stride,
                               float* out, float* part, int batch,
                               int channels, int length, float eps,
                               void* stream) {
  return launch((const __nv_bfloat16*)x, mask, extent, gamma, gamma_stride,
                beta, beta_stride, out, part, batch, channels, length, eps,
                stream);
}

// The scratch a launch needs, in floats.
extern "C" long long adain_fold_part_floats(int batch, int channels,
                                            int length) {
  return 3LL * batch * channels * ((length + CHUNK - 1) / CHUNK);
}

// {THREADS, PER_THREAD}: the wrapper mirrors the chunk length.
extern "C" void adain_fold_geometry(int* out) {
  out[0] = THREADS;
  out[1] = PER_THREAD;
}
