// Fused AdaIN affine + Snake + mask + dilated 1-D conv, Hopper (sm_90a).
//
// Replaces two TPU kernels that compute the same function:
//   illufly_tts_tpu/ops/pallas/fused_conv.py::adain_snake_conv
//       (halo tile: adain_snake_conv_tile_kernel below)
//   illufly_tts_tpu/ops/pallas/carry_conv.py::adain_snake_conv_carry
//       (walking carry: adain_snake_conv_carry_kernel below)
// For x [B, C_in, L], mask [B, L], scale/shift [B, C_in], alpha [C_in],
// w [k, C_in, C_out], bias [C_out], all f32, channels-first as in Pallas:
//   z = x * scale + shift
//   h = mask * (z + sin^2(alpha z) / alpha),   h = 0 outside [0, L)
//   y[b, o, l] = bias[o] + sum_t sum_c w[t, c, o] * h[b, c, l + t d - pad]
// with pad = (k - 1) d / 2 (centered zero padding) and f32 accumulation.
// The zero padding lies outside [0, L), not outside the mask: a masked
// column inside [0, L) contributes 0 only because the prologue multiplies
// by the mask.
//
// Bound: operations. Per output the kernel does C_in * k FMAs (1408 at
// C = 128, k = 11) against ~8 bytes of input and output, far above the
// card's f32 operations-per-byte balance (67e12 / 3.35e12 = 20), so the
// least time is 2 B L C_in C_out k / 67e12 (2.64 ms at B=8, C=128,
// L=61440, k=11). The design keeps the activated tensor h out of device
// memory, feeds the FMAs from registers with few shared-memory wavefronts
// per FMA, and hides the loads behind the FMAs.
//
// Common design. A CTA (128 threads, 4 warps) owns a 64-channel by
// 128-column tile of y and keeps it in registers: the 32 lanes of a warp
// take neighbouring columns (lane + 32 j, j < 4) and each warp 16 of the
// 64 output channels, so each thread holds 16 x 4 sums. The CTA walks C_in
// in stages of 8 channels through a two-buffer pipeline in dynamic shared
// memory: while stage q is activated and multiplied, cp.async brings stage
// q + 1 (the k weight taps [k, 8, 64], raw x over the tile's window
// [l0 - pad, l0 + 128 + pad), the mask window, and the channels' scale,
// shift and alpha; zero-filled outside [0, L) and past C_in / C_out). A
// stage is activated in place (the prologue: scale, shift, alpha, precise
// sinf, mask), then every thread runs the k taps as a register-tiled outer
// product: per tap and input channel, 16 weights (four 16-byte loads that
// every lane of the warp shares) times 4 window values (four loads of 32
// neighbouring words, free of bank conflicts), 64 FMAs. Stores are
// 128-byte rows per warp.
//
// Halo tile (counterpart of fused_conv.py). One CTA per (output tile of 128
// columns, output-channel tile, batch row). The Pallas kernel reads each
// block and, through a second BlockSpec, its successor, so the halo is in
// VMEM; here each CTA loads its own window including both halos (L2 serves
// the neighbours' overlap). Halo columns are activated by both
// neighbouring CTAs.
//
// Walking carry (counterpart of carry_conv.py). One CTA per (chunk of
// consecutive tiles, output-channel tile, batch row); it walks its chunk
// left to right, the pipeline running on across tile boundaries. At the
// chunk's first tile the whole window is loaded and activated: zeros at
// l < 0, otherwise the real preceding columns (carry_conv.py's
// _reset_carry at i == 0, generalised to chunks that start inside the
// sequence). At every later tile only the 128 new columns
// [l0 + pad, l0 + 128 + pad) are loaded and activated; the 2 pad columns
// [l0 - pad, l0 + pad) come from a carry buffer in shared memory that holds
// them for every input channel (the role of tail_ref / hprev_ref, which
// carry h across the sequential TPU grid in VMEM). After a stage is
// activated, its window columns [128, 128 + 2 pad) are saved as the next
// tile's carry (the rotation at the end of _kernel). Columns past L are
// zero, as the conv's right padding (_zero_right_halo on the flush step);
// no flush step is needed because a CTA emits a tile as soon as its window
// is complete (the TPU kernel emits block i - 1 at step i). So no input
// column is loaded or activated twice inside a chunk. The carry buffer
// costs occupancy (C_in * 2 pad floats per CTA), so the wrapper keeps
// chunks short while the grid still covers every SM.
//
// Plain C interface, loaded with ctypes: each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL = 128;               // output columns per tile
constexpr int TCO = 64;               // output channels per tile
constexpr int CK = 8;                 // input channels per stage
constexpr int THREADS = 128;          // 4 warps: 32 column lanes each
constexpr int LPT = TL / 32;          // columns per thread
constexpr int CPT = TCO / 4;          // output channels per thread (warp)
constexpr int KMAX = 11;
constexpr int PADMAX = 32;
constexpr int HW = TL + 2 * PADMAX;   // window row stride in shared memory
constexpr int MAX_SMEM = 232448;      // per block on sm_90

struct Args {
  const float* x;
  const float* mask;
  const float* scale;
  const float* shift;
  const float* alpha;
  const float* w;
  const float* bias;
  float* y;
  int c_in, c_out, length, k, dilation, pad;
};

// One pipeline stage in shared memory, in floats: the weight taps
// [k][CK][TCO], the window [CK][HW] (raw x as loaded, then h in place), the
// mask window [HW], and scale, shift, alpha for the stage's CK channels.
__host__ __device__ constexpr int stage_floats(int k) {
  return k * CK * TCO + CK * HW + HW + 4 * CK;
}

// Asynchronous copies to shared memory; with valid false the destination
// is filled with zeros and nothing is read.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Start loading input channels [ci0, ci0 + CK) of the window whose column
// 0 is global column l_first: weights, x and mask at window columns
// [col_lo, TL + 2 pad), and the channels' scale, shift and alpha. Zeros
// outside [0, L) and past C_in / C_out.
__device__ __forceinline__ void start_stage(const Args& a, int b, int ci0,
                                            int co0, int l_first, int col_lo,
                                            float* st) {
  float* w_s = st;
  float* x_s = st + a.k * CK * TCO;
  float* m_s = x_s + CK * HW;
  float* p_s = m_s + HW;
  {  // a tap's [CK, TCO] block is one 16-byte vector per thread
    const int c = threadIdx.x / (TCO / 4);
    const int o = 4 * (threadIdx.x % (TCO / 4));
    const int ci = ci0 + c;
    const int co = co0 + o;
    const bool vec = ci < a.c_in && co + 3 < a.c_out && a.c_out % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
    for (int t = 0; t < a.k; ++t) {
      const float* src = a.w + ((int64_t)t * a.c_in + ci) * a.c_out + co;
      float* dst = w_s + (t * CK + c) * TCO + o;
      if (vec) {
        copy16(dst, src, true);
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool ok = ci < a.c_in && co + e < a.c_out;
          copy4(dst + e, ok ? src + e : a.w, ok);
        }
      }
    }
  }
  const int width = TL + 2 * a.pad;
  const int ncol = width - col_lo;
  for (int i = threadIdx.x; i < CK * ncol; i += THREADS) {
    const int c = i / ncol;
    const int col = col_lo + i - c * ncol;
    const int ci = ci0 + c;
    const int l = l_first + col;
    const bool ok = ci < a.c_in && l >= 0 && l < a.length;
    copy4(x_s + c * HW + col,
          ok ? a.x + ((int64_t)b * a.c_in + ci) * a.length + l : a.x, ok);
  }
  for (int col = col_lo + threadIdx.x; col < width; col += THREADS) {
    const int l = l_first + col;
    const bool ok = l >= 0 && l < a.length;
    copy4(m_s + col, ok ? a.mask + (int64_t)b * a.length + l : a.mask, ok);
  }
  if (threadIdx.x < 3 * CK) {
    const int c = threadIdx.x % CK;
    const int which = threadIdx.x / CK;  // scale, shift, alpha
    const int ci = ci0 + c;
    const bool ok = ci < a.c_in;
    const float* src = which == 2 ? a.alpha + ci
                                  : (which == 0 ? a.scale : a.shift) +
                                        (int64_t)b * a.c_in + ci;
    copy4(p_s + which * CK + c, ok ? src : a.alpha, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// In place over window columns [col_lo, TL + 2 pad): raw x -> h =
// mask * (z + sin^2(alpha z) / alpha), z = x * scale + shift. The mask
// window is zero outside [0, L), so h is zero there; channels past C_in
// stay zero.
__device__ __forceinline__ void activate(const Args& a, int ci0, int col_lo,
                                         float* st) {
  float* x_s = st + a.k * CK * TCO;
  const float* m_s = x_s + CK * HW;
  const float* p_s = m_s + HW;
  const int ncol = TL + 2 * a.pad - col_lo;
  for (int i = threadIdx.x; i < CK * ncol; i += THREADS) {
    const int c = i / ncol;
    const int col = col_lo + i - c * ncol;
    float h = 0.f;
    if (ci0 + c < a.c_in) {
      const float z = x_s[c * HW + col] * p_s[c] + p_s[CK + c];
      const float al = p_s[2 * CK + c];
      const float s = sinf(al * z);
      h = (z + (1.0f / al) * (s * s)) * m_s[col];
    }
    x_s[c * HW + col] = h;
  }
}

__device__ __forceinline__ void accumulate(const Args& a, const float* st,
                                           float (&acc)[CPT][LPT]) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float* h_s = st + a.k * CK * TCO;
  for (int t = 0; t < a.k; ++t) {
    const float* hrow = h_s + lane + t * a.dilation;
    const float* wrow = st + t * CK * TCO + warp * CPT;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      float wv[CPT];  // one warp-wide broadcast per 4 weights
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wrow + c * TCO + 4 * q);
        wv[4 * q] = w4.x;
        wv[4 * q + 1] = w4.y;
        wv[4 * q + 2] = w4.z;
        wv[4 * q + 3] = w4.w;
      }
      float hv[LPT];  // 32 neighbouring words per load: no bank conflicts
#pragma unroll
      for (int j = 0; j < LPT; ++j) hv[j] = hrow[c * HW + 32 * j];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[i][j] = fmaf(wv[i], hv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void store(const Args& a, int b, int co0, int l0,
                                      float (&acc)[CPT][LPT]) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int co = co0 + warp * CPT + i;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = l0 + lane + 32 * j;
      if (co < a.c_out && l < a.length) {
        a.y[((int64_t)b * a.c_out + co) * a.length + l] = acc[i][j] + a.bias[co];
      }
      acc[i][j] = 0.f;
    }
  }
}

// Tiles [tile0, tile_end) of one (output-channel tile, batch row), walked
// left to right through a two-stage pipeline over (tile, input-channel
// stage): stage q + 1 loads while stage q is activated and multiplied.
// With ``carry`` (the walking-carry kernel) every tile after the first
// takes its left 2 pad columns of h from the carry buffer and loads only
// its new columns; without it (the halo-tile kernel, one tile) the whole
// window is loaded.
__device__ __forceinline__ void run(const Args& a, int tile0, int tile_end,
                                    float* carry) {
  extern __shared__ __align__(16) float smem[];
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const int halo = 2 * a.pad;
  const int stages = (a.c_in + CK - 1) / CK;  // per tile
  const int n = (tile_end - tile0) * stages;
  const int per_stage = stage_floats(a.k);
  float acc[CPT][LPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[i][j] = 0.f;

  start_stage(a, b, 0, co0, tile0 * TL - a.pad, 0, smem);
  for (int q = 0; q < n; ++q) {
    const int tile = tile0 + q / stages;
    const int ci0 = (q % stages) * CK;
    const int col_lo = tile == tile0 ? 0 : halo;
    float* st = smem + (q & 1) * per_stage;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // stage q landed; stage q - 1 is done with its buffer
    if (q + 1 < n) {
      const int tile1 = tile0 + (q + 1) / stages;
      start_stage(a, b, ((q + 1) % stages) * CK, co0, tile1 * TL - a.pad,
                  tile1 == tile0 ? 0 : halo, smem + ((q + 1) & 1) * per_stage);
    }
    float* x_s = st + a.k * CK * TCO;
    if (col_lo > 0) {  // the carried, already activated left columns
      for (int i = threadIdx.x; i < CK * halo; i += THREADS) {
        const int c = i / halo;
        const int j = i - c * halo;
        x_s[c * HW + j] = ci0 + c < a.c_in ? carry[(ci0 + c) * halo + j] : 0.f;
      }
    }
    activate(a, ci0, col_lo, st);
    __syncthreads();
    if (carry != nullptr && tile + 1 < tile_end) {
      // window columns [TL, TL + 2 pad) are the next tile's left halo
      for (int i = threadIdx.x; i < CK * halo; i += THREADS) {
        const int c = i / halo;
        const int j = i - c * halo;
        if (ci0 + c < a.c_in) carry[(ci0 + c) * halo + j] = x_s[c * HW + TL + j];
      }
    }
    accumulate(a, st, acc);
    if (q % stages == stages - 1) store(a, b, co0, tile * TL, acc);
  }
}

__global__ void __launch_bounds__(THREADS, 4)
adain_snake_conv_tile_kernel(const Args a) {
  run(a, blockIdx.x, blockIdx.x + 1, nullptr);
}

__global__ void __launch_bounds__(THREADS, 4)
adain_snake_conv_carry_kernel(const Args a, int tiles_per_chunk) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (a.length + TL - 1) / TL;
  const int tile0 = blockIdx.x * tiles_per_chunk;
  const int tile_end = min(n_tiles, tile0 + tiles_per_chunk);
  // [C_in][2 pad] after the two stage buffers, when chunks walk
  float* carry = tiles_per_chunk > 1 ? smem + 2 * stage_floats(a.k) : nullptr;
  run(a, tile0, tile_end, carry);
}

bool valid(int batch, int c_in, int c_out, int length, int k, int dilation) {
  if (batch <= 0 || batch > 65535 || c_in <= 0 || c_out <= 0 || length <= 0)
    return false;
  if (k <= 0 || k > KMAX || dilation <= 0 || ((k - 1) * dilation) % 2)
    return false;
  return (c_out + TCO - 1) / TCO <= 65535 && (k - 1) * dilation / 2 <= PADMAX;
}

Args make_args(const float* x, const float* mask, const float* scale,
               const float* shift, const float* alpha, const float* w,
               const float* bias, float* y, int c_in, int c_out, int length,
               int k, int dilation) {
  return Args{x, mask, scale, shift, alpha, w, bias, y, c_in, c_out, length,
              k, dilation, (k - 1) * dilation / 2};
}

// Dynamic shared memory of a launch; raises the kernel's limit past the
// default 48 KB when it needs more. 0 when it does not fit.
template <typename Kernel>
int prepare_smem(Kernel kernel, int bytes) {
  if (bytes > MAX_SMEM) return 0;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace

extern "C" int adain_snake_conv_f32(const float* x, const float* mask,
                                    const float* scale, const float* shift,
                                    const float* alpha, const float* w,
                                    const float* bias, float* y, int batch,
                                    int c_in, int c_out, int length, int k,
                                    int dilation, void* stream) {
  if (!valid(batch, c_in, c_out, length, k, dilation))
    return (int)cudaErrorInvalidValue;
  const int smem =
      prepare_smem(adain_snake_conv_tile_kernel, 2 * stage_floats(k) * 4);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((length + TL - 1) / TL, (c_out + TCO - 1) / TCO, batch);
  adain_snake_conv_tile_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      make_args(x, mask, scale, shift, alpha, w, bias, y, c_in, c_out, length,
                k, dilation));
  return (int)cudaGetLastError();
}

extern "C" int adain_snake_conv_carry_f32(
    const float* x, const float* mask, const float* scale, const float* shift,
    const float* alpha, const float* w, const float* bias, float* y,
    int batch, int c_in, int c_out, int length, int k, int dilation,
    int tiles_per_chunk, void* stream) {
  if (!valid(batch, c_in, c_out, length, k, dilation) || tiles_per_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (length + TL - 1) / TL;
  const int chunks = (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const int carry_floats = tiles_per_chunk > 1 ? c_in * (k - 1) * dilation : 0;
  const int smem = prepare_smem(adain_snake_conv_carry_kernel,
                                (2 * stage_floats(k) + carry_floats) * 4);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, (c_out + TCO - 1) / TCO, batch);
  adain_snake_conv_carry_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      make_args(x, mask, scale, shift, alpha, w, bias, y, c_in, c_out, length,
                k, dilation),
      tiles_per_chunk);
  return (int)cudaGetLastError();
}

// {output columns per tile, output channels per tile, largest k, largest
// pad}: the wrapper checks its own constants against these.
extern "C" void adain_snake_conv_geometry(int* out) {
  out[0] = TL;
  out[1] = TCO;
  out[2] = KMAX;
  out[3] = PADMAX;
}
