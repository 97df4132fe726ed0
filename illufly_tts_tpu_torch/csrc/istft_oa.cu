// Fused iSTFT for the iSTFTNet head (n_fft = 20, hop = 5), Hopper (sm_90a).
//
// Replaces the TPU kernel illufly_tts_tpu/ops/pallas/istft_oa.py::istft_pallas
// and, on the Generator's path, the eager head in front of it. Two entries
// share one overlap-add core and differ in their loader:
//   istft_head_f32: conv_post's raw output x [B, 22, L] f32, channels first,
//     as cuDNN leaves it; mag = exp(clip(x[:, :11], -12, 8)) and
//     phase = pi * sin(x[:, 11:]) are computed on the fly (the Generator's
//     path: nothing between conv_post and the audio reaches device memory);
//   istft_oa_f32: (mag, phase) [B, F, 11] f32, the TPU kernel's interface;
//   istft_head_bf16: the head from a bfloat16 x [B, 22, L] (a bfloat16
//     model's conv_post output). The loader widens each value to f32 and
//     everything after it is the f32 head's code, so the audio is bitwise
//     istft_head_f32 of x.float(); it reads half the bytes.
// Both compute, for frames f (F = L) -> audio [B, F * 5] f32:
//   re = mag cos(phase), im = mag sin(phase)
//   frame_f[n] = sum_k re[f, k] Cw[k, n] + im[f, k] Sw[k, n]   (n = 0..19)
//   audio[5f + r] = env_inv[5f + r] * sum_{c=0..3} frame_{f-c}[5c + r]
// where Cw/Sw are the inverse real-DFT bases with the periodic Hann window
// folded in and env_inv is 1 / (summed squared window): torch.istft
// semantics truncated to F * hop samples (frames before 0 count as zero).
//
// Bound: memory. Per output sample the kernel reads 22 / 5 floats and
// writes one; its arithmetic (~40 FMAs and ~9 transcendental operations a
// sample) is far below the card's operations-per-byte balance. For
// [8, 22, 61440] (or [8, 61440, 11] x 2) that is 43.3 MB read + 9.8 MB
// written, about 16 us at 3.35 TB/s; from bfloat16, 21.6 MB read, ~9.4 us.
//
// Design (one thread per frame, T = 256 threads a block):
// - A block takes one tile: T frames of one batch row, the T - 4 output
//   frames and the 4 frames before them (the 3-frame overlap-add halo, 4
//   so that every tile starts on a 16-byte boundary of the audio). Halo
//   frames are recomputed, never carried between blocks.
// - Loader: each thread issues its frame's 22 loads back to back before
//   any use (head: one coalesced 4-byte load per channel row; polar: the
//   frame's 44 contiguous bytes of each input, served from L1 across the
//   11 loads). The bytes in flight come from occupancy: launch bounds of
//   1024 threads an SM hold the kernel to 64 registers, four blocks an SM,
//   ~90 KB of loads in flight per SM. Walking runs of tiles with the next
//   tile's loads in registers (a double buffer) measured slower than one
//   tile a block at this occupancy, and the 116 registers it took at two
//   blocks an SM slower still.
// - Core: the bases' even/odd symmetry about n = 10 (Cw[k, 20-n] =
//   Cw[k, n], Sw[k, 20-n] = -Sw[k, n]) gives frame[n] = A[n] + S[n] and
//   frame[20-n] = A[n] - S[n], with A over k = 0..10 and S over k = 1..9:
//   191 FMAs a frame instead of 440. Sw[k, 10] and Sw[10, n] are zero up
//   to float rounding of sin(pi k) (|x| < 1e-16) and are dropped. frame[0]
//   = 0 * A[1]: exactly zero (the window is 0 there), NaN where the frame
//   holds NaN, as in the plain version, so audio sample 0 is exactly 0.
//   The bases and envelope travel as a by-value kernel parameter: with
//   every loop unrolled their indices are compile-time constants, read
//   from the constant bank as FMA operands.
// - Overlap-add: each thread parks frame[5..19] in shared memory (stride
//   15, conflict-free), reads its 3 predecessors' chunks, scales by
//   1/envelope and stages its 5 samples; the tile's 5 (T - 4) contiguous
//   samples leave as 16-byte stores (scalar where the tile's first sample
//   is not 16-byte aligned, in rows b > 0 when F % 4 != 0, and for the
//   ragged tail).
// Numerics: the transcendentals go to the SFU, because with precise
// sinf/sincosf/sincospif the kernel was bound by instruction issue, not
// bytes. The head's clip is written with comparisons, so a NaN passes
// through as in torch.clamp (fminf/fmaxf would drop it); exp is __expf
// (ex2.approx: relative error ~1e-6 for |x| <= 12); sin(x) is __sinf after
// one Cody-Waite step to [-pi, pi] (reduce_2pi: absolute error ~5e-7 for
// |x| < 1e6, where the plain version's torch.sin is exact for any x); the
// polar pair is __sincosf(pi * sin(x)), |pi * sin(x)| <= pi needing no
// reduction. The polar entry reduces the phase the same way. Against the
// plain version that is a relative error of a few 1e-6 in re and im,
// inside 1e-4 * (1 + max|audio|) (head) and 1e-4 absolute at |randn|
// magnitudes (polar).
//
// Plain C interface, loaded with ctypes: each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int K = 11;        // n_fft / 2 + 1
constexpr int NFFT = 20;
constexpr int HOP = 5;
constexpr int CHUNKS = NFFT / HOP;  // frames overlapping each sample
constexpr int LEAD = 4;      // frames before the tile's outputs: halo 3 + 1
constexpr int PARK = NFFT - HOP;    // frame[5..19] parked for the next 3
constexpr int RAW = 2 * K;   // floats a thread loads per frame
constexpr int T = 256;       // frames a block holds = threads a block
constexpr int OUT_FRAMES = T - LEAD;

struct Tables {
  float cw[K][NFFT];         // inverse cos basis * window
  float sw[K][NFFT];         // inverse sin basis * window
  float env_head[(CHUNKS - 1) * HOP];  // 1/envelope for samples 0 .. 14
  float env_steady[HOP];     // 1/envelope for every later sample, by r
};


__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The raw floats of frame g of row b (zeros outside 0 <= g < F).
template <bool HEAD, typename In>
__device__ __forceinline__ void load_frame(const In* __restrict__ a,
                                           const float* __restrict__ p,
                                           int64_t b, int g, int frames,
                                           float raw[RAW]) {
  if (g < 0 || g >= frames) {
#pragma unroll
    for (int i = 0; i < RAW; ++i) raw[i] = 0.f;
    return;
  }
  if (HEAD) {
    const In* col = a + b * RAW * frames + g;
#pragma unroll
    for (int c = 0; c < RAW; ++c) raw[c] = widen(col[(int64_t)c * frames]);
  } else {
    const int64_t at = (b * frames + g) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      raw[k] = widen(a[at + k]);
      raw[K + k] = p[at + k];
    }
  }
}

// v - 2 pi round(v / 2 pi), in [-pi, pi]: one Cody-Waite step with 2 pi
// split in two floats (hi + lo within 2e-14), good to ~1e-7 for |v| < 1e6.
// NaN stays NaN.
__device__ __forceinline__ float reduce_2pi(float v) {
  const float n = rintf(v * 0.159154943f);
  return fmaf(-n, -1.74845553e-7f, fmaf(-n, 6.28318548f, v));
}

template <bool HEAD>
__device__ __forceinline__ void polar(const float raw[RAW], bool inside,
                                      float re[K], float im[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float m, s, c;
    if (HEAD) {
      float v = raw[k];
      v = v < -12.f ? -12.f : v;  // NaN fails both tests and stays NaN
      v = v > 8.f ? 8.f : v;
      m = __expf(v);
      __sincosf(3.14159265f * __sinf(reduce_2pi(raw[K + k])), &s, &c);
    } else {
      m = raw[k];
      __sincosf(reduce_2pi(raw[K + k]), &s, &c);
    }
    // a frame outside the row contributes zero (exp(0) would give 1)
    re[k] = inside ? m * c : 0.f;
    im[k] = inside ? m * s : 0.f;
  }
}

template <bool HEAD, typename In>
__global__ void __launch_bounds__(T, 1024 / T)
istft_oa_kernel(const In* __restrict__ a, const float* __restrict__ p,
                float* __restrict__ out, int frames, int tiles_per_row,
                const Tables t) {
  __shared__ float s_park[T * PARK];
  __shared__ __align__(16) float s_out[OUT_FRAMES * HOP];

  const int lf = threadIdx.x;
  const int b = blockIdx.x / tiles_per_row;
  const int f0 = (blockIdx.x - b * tiles_per_row) * OUT_FRAMES;
  const int g = f0 - LEAD + lf;  // this thread's frame

  float re[K], im[K];
  {
    float raw[RAW];
    load_frame<HEAD, In>(a, p, b, g, frames, raw);
    polar<HEAD>(raw, g >= 0 && g < frames, re, im);
  }

  float fr[NFFT];
  {
    float sym[NFFT / 2 + 1], asym[NFFT / 2];
#pragma unroll
    for (int n = 1; n <= NFFT / 2; ++n) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc = fmaf(re[k], t.cw[k][n], acc);
      sym[n] = acc;
    }
#pragma unroll
    for (int n = 1; n < NFFT / 2; ++n) {
      float acc = 0.f;
#pragma unroll
      for (int k = 1; k < K - 1; ++k) acc = fmaf(im[k], t.sw[k][n], acc);
      asym[n] = acc;
    }
    fr[0] = 0.f * sym[1];
#pragma unroll
    for (int n = 1; n < NFFT / 2; ++n) {
      fr[n] = sym[n] + asym[n];
      fr[NFFT - n] = sym[n] - asym[n];
    }
    fr[NFFT / 2] = sym[NFFT / 2];
  }
#pragma unroll
  for (int j = 0; j < PARK; ++j) s_park[lf * PARK + j] = fr[HOP + j];
  __syncthreads();

  if (lf >= LEAD && g < frames) {
#pragma unroll
    for (int r = 0; r < HOP; ++r) {
      float y = fr[r];
#pragma unroll
      for (int c = 1; c < CHUNKS; ++c) {
        y += s_park[(lf - c) * PARK + (c - 1) * HOP + r];
      }
      float env = t.env_steady[r];
      if (g == 0) env = t.env_head[r];
      else if (g == 1) env = t.env_head[HOP + r];
      else if (g == 2) env = t.env_head[2 * HOP + r];
      s_out[(lf - LEAD) * HOP + r] = y * env;
    }
  }
  __syncthreads();

  const int valid = min(OUT_FRAMES, frames - f0) * HOP;
  float* dst = out + ((int64_t)b * frames + f0) * HOP;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vecs = valid / 4;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4* src4 = reinterpret_cast<const float4*>(s_out);
    for (int i = lf; i < vecs; i += T) dst4[i] = src4[i];
    done = vecs * 4;
  }
  for (int i = done + lf; i < valid; i += T) dst[i] = s_out[i];
}

template <bool HEAD, typename In>
int launch(const In* a, const float* p, float* out, int batch,
           int frames, const float* tables, void* stream) {
  if (batch <= 0 || frames <= 0) return (int)cudaErrorInvalidValue;
  const int tiles_per_row = (frames + OUT_FRAMES - 1) / OUT_FRAMES;
  const int64_t tiles = (int64_t)batch * tiles_per_row;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Tables t;
  memcpy(&t, tables, sizeof(Tables));
  istft_oa_kernel<HEAD, In>
      <<<(unsigned)tiles, T, 0, (cudaStream_t)stream>>>(a, p, out, frames,
                                                        tiles_per_row, t);
  return (int)cudaGetLastError();
}

}  // namespace

// tables: host pointer to 460 floats laid out as struct Tables.
extern "C" int istft_head_f32(const float* x, float* out, int batch,
                              int frames, const float* tables, void* stream) {
  return launch<true, float>(x, nullptr, out, batch, frames, tables, stream);
}

extern "C" int istft_head_bf16(const __nv_bfloat16* x, float* out, int batch,
                               int frames, const float* tables,
                               void* stream) {
  return launch<true, __nv_bfloat16>(x, nullptr, out, batch, frames, tables,
                                     stream);
}

extern "C" int istft_oa_f32(const float* mag, const float* phase, float* out,
                            int batch, int frames, const float* tables,
                            void* stream) {
  return launch<false, float>(mag, phase, out, batch, frames, tables,
                              stream);
}

extern "C" int istft_oa_table_floats() { return (int)(sizeof(Tables) / 4); }
