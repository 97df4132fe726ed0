// Fused iSTFT for the iSTFTNet head (n_fft = 20, hop = 5), Hopper (sm_90a).
//
// Replaces the TPU kernel illufly_tts_tpu/ops/pallas/istft_oa.py::istft_pallas.
// Computes, for mag/phase [B, F, 11] f32 -> audio [B, F * 5] f32:
//   re = mag cos(phase), im = mag sin(phase)
//   audio[f*5 + r] = env_inv[f*5 + r] * sum_{c=0..3} sum_k
//                      re[f-c, k] Cw[k, 5c+r] + im[f-c, k] Sw[k, 5c+r]
// where Cw/Sw are the inverse real-DFT bases with the periodic Hann window
// folded in and env_inv is 1 / (summed squared window), i.e. torch.istft
// semantics truncated to F * hop samples (frames before 0 count as zero).
//
// Bound: memory. Per output sample the kernel reads 2 * 11 / 5 inputs and
// does ~88 FMAs, far below the card's operations-per-byte balance, so the
// least time is the bytes moved: each input read once and each output
// written once (for [8, 61440, 11]: 43.3 MB read + 9.8 MB written, about
// 16 us at 3.35 TB/s).
//
// Design: one block per (batch row, tile of TF frames), one thread per
// frame. The block loads its tile plus a 3-frame left halo of mag/phase
// with coalesced reads, turns them into re/im in shared memory with precise
// sincosf, and each thread emits its frame's 5 samples. The windowed bases
// and the envelope travel as a by-value kernel parameter: with every loop
// unrolled their indices are compile-time constants, so they are read from
// the constant bank as FMA operands. The 5 samples per thread are staged in
// shared memory and stored with coalesced writes. No sum crosses blocks.
//
// Plain C interface, loaded with ctypes: the entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int K = 11;        // n_fft / 2 + 1
constexpr int NFFT = 20;
constexpr int HOP = 5;
constexpr int CHUNKS = NFFT / HOP;  // frames overlapping each sample
constexpr int HALO = CHUNKS - 1;
constexpr int TF = 128;      // frames per block = threads per block

struct Tables {
  float cw[K][NFFT];         // inverse cos basis * window
  float sw[K][NFFT];         // inverse sin basis * window
  float env_head[HALO * HOP];  // 1/envelope for samples 0 .. 14
  float env_steady[HOP];     // 1/envelope for every later sample, by r
};

__global__ void __launch_bounds__(TF)
istft_oa_kernel(const float* __restrict__ mag,
                const float* __restrict__ phase,
                float* __restrict__ out, int num_frames, const Tables t) {
  __shared__ float s_re[(TF + HALO) * K];
  __shared__ float s_im[(TF + HALO) * K];
  __shared__ float s_out[TF * HOP];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const int first = f0 - HALO;  // first frame held in shared memory
  const int64_t row = (int64_t)b * num_frames * K;

  for (int i = threadIdx.x; i < (TF + HALO) * K; i += TF) {
    const int f = first + i / K;
    float re = 0.f, im = 0.f;
    if (f >= 0 && f < num_frames) {
      const int64_t idx = row + (int64_t)first * K + i;
      const float m = mag[idx];
      float s, c;
      sincosf(phase[idx], &s, &c);
      re = m * c;
      im = m * s;
    }
    s_re[i] = re;
    s_im[i] = im;
  }
  __syncthreads();

  const int lf = threadIdx.x;
  const int f = f0 + lf;
  if (f < num_frames) {
    float acc[HOP];
#pragma unroll
    for (int r = 0; r < HOP; ++r) acc[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int base = (lf + HALO - c) * K;  // frame f - c
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float re = s_re[base + k];
        const float im = s_im[base + k];
#pragma unroll
        for (int r = 0; r < HOP; ++r) {
          acc[r] = fmaf(re, t.cw[k][c * HOP + r], acc[r]);
          acc[r] = fmaf(im, t.sw[k][c * HOP + r], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < HOP; ++r) {
      float env = t.env_steady[r];
      if (f == 0) env = t.env_head[r];
      else if (f == 1) env = t.env_head[HOP + r];
      else if (f == 2) env = t.env_head[2 * HOP + r];
      s_out[lf * HOP + r] = acc[r] * env;
    }
  }
  __syncthreads();

  const int valid = min(TF, num_frames - f0) * HOP;
  float* dst = out + (int64_t)b * num_frames * HOP + (int64_t)f0 * HOP;
  for (int i = threadIdx.x; i < valid; i += TF) dst[i] = s_out[i];
}

}  // namespace

// tables: host pointer to 460 floats laid out as struct Tables.
extern "C" int istft_oa_f32(const float* mag, const float* phase, float* out,
                            int batch, int num_frames, const float* tables,
                            void* stream) {
  if (batch <= 0 || num_frames <= 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Tables t;
  memcpy(&t, tables, sizeof(Tables));
  const dim3 grid((num_frames + TF - 1) / TF, batch);
  istft_oa_kernel<<<grid, TF, 0, (cudaStream_t)stream>>>(mag, phase, out,
                                                         num_frames, t);
  return (int)cudaGetLastError();
}

extern "C" int istft_oa_table_floats() { return (int)(sizeof(Tables) / 4); }
