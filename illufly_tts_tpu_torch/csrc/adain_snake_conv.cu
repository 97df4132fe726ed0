// Fused AdaIN affine + Snake + mask + dilated 1-D conv on Hopper's tensor
// cores (sm_90a): an implicit GEMM in 3xTF32 with warpgroup MMAs (wgmma).
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
// with pad = (k - 1) d / 2 (centered zero padding). The zero padding lies
// outside [0, L), not outside the mask: a masked column inside [0, L)
// contributes 0 only because the prologue multiplies by the mask.
//
// Numerics: 3xTF32. Every operand v (h and w) is split in two TF32 values,
//   hi = tf32(v)        (cvt.rna.tf32.f32: round to nearest, ties away)
//   lo = tf32(v - hi)   (v - hi is exact in f32)
// and the tensor cores accumulate lo*hi + hi*lo + hi*hi in f32 (the lo*lo
// term, ~2^-22 of the product, is dropped). Each product is then good to
// ~2^-21 relative, against ~2^-10 for one TF32 pass: a single pass misses
// the f32 tolerance 1e-4 (1 + max|y|) over C_in k = 2816 terms, the split
// meets it. The tensor cores' f32 sums round less finely than f32 FMAs,
// which the kernel's error against the f32 version shows. The sum order per
// output is fixed (input-channel stage, tap, lo*hi, hi*lo, hi*hi) and
// nothing is atomic: runs are bitwise repeatable, whatever tiling the
// wrapper picks.
//
// Bound: operations. Per output the function does C_in k multiply-adds
// against ~8 bytes of input and output; 3xTF32 triples them on the tensor
// cores: the least time is 3 * 2 B L C_in C_out k / 495e12 (1.073 ms at
// B=8, C=128, L=61440, k=11), against 2 B L C_in C_out k / 67e12 (2.644
// ms) for f32 FMAs on the CUDA cores.
//
// The GEMM: M = output columns of a tile, N = output channels, K = (tap t,
// input channel c). A[l][c] = h[c][l + t d] is the activated window shifted
// by t d rows, B[c][o] = w[t][c][o]. A CTA owns TL columns by 128 output
// channels, so each window column is activated once for 128 output
// channels (twice at C_out = 256, by two CTAs). It walks C_in in stages of
// CK = 8 channels, one k8 step of m64nNk8.f32.tf32.tf32 per tap, with both
// operands in shared memory in wgmma's K-major layout without swizzle:
// 16-byte rows of 4 channels, rows contiguous, the two k4 halves LBO apart.
// A tap's A is the window t d rows on, a 16-byte step of the descriptor's
// start address: the shift costs nothing.
//
// Warp specialization (512 threads, one CTA per SM, ~215 KB of shared
// memory at k = 11). Two consumer warpgroups only issue the MMAs (33 per
// stage at k = 11) on stage buffer q % 2, keeping one stage in flight, and
// hold the f32 sums in registers: warpgroup g takes rows 64 g of a
// 128-column tile (n128), or output channels 64 g of a 64-column tile
// (n64). Two producer warpgroups fill the other buffer with stage q + 1:
// B by cp.async from the split weights (split_weights_kernel, one pass per
// launch over w, writes hi and lo already in the stage layout), and A by
// activating the raw window (scale, shift, alpha, precise sinf, mask) that
// cp.async brought one stage earlier, split as hi and lo. Named barriers
// hand each buffer over (FULL) and back (EMPTY). With the producers' code
// between the MMAs' commit and wait in one warpgroup, ptxas serialized every
// MMA; with the roles apart it issues them back to back.
//
// Halo tile (counterpart of fused_conv.py). The Pallas kernel reads each
// block and, through a second BlockSpec, its successor, so the halo is in
// VMEM; here every column tile loads and activates its own window
// including both halos. A CTA takes a run of consecutive tiles of one
// (128-channel output tile, batch row), about one wave of CTAs, so the
// pipeline fills and drains once per run rather than once per tile.
//
// Walking carry (counterpart of carry_conv.py). One CTA per (chunk of
// consecutive tiles, output-channel tile, batch row); it walks its chunk
// left to right, the pipeline running on across tile boundaries. At the
// chunk's first tile the whole window is loaded and activated: zeros at
// l < 0, otherwise the real preceding columns (carry_conv.py's _reset_carry
// at i == 0, generalised to chunks that start inside the sequence). At
// every later tile only the TL new columns [l0 + pad, l0 + TL + pad) are
// loaded and activated; the 2 pad columns [l0 - pad, l0 + pad) come, as hi
// and lo, from a carry buffer in shared memory that holds them for every
// input channel (the role of tail_ref / hprev_ref, which carry h across the
// sequential TPU grid in VMEM). After a stage is activated, its window rows
// [TL, TL + 2 pad) are saved as the next tile's carry. Columns past L are
// zero, as the conv's right padding (_zero_right_halo on the flush step);
// no flush step is needed because a CTA emits a tile as soon as its window
// is complete. The carry buffer (2 C_in 2 pad words) must fit beside the
// two stages: the wrapper walks chunks of about one wave where it does
// (k <= 7 on the main path; 4-7% faster than one-tile chunks on an H100,
// PERF.md) and launches one-tile chunks, which carry nothing, where it
// does not (k = 11 at C = 128).
//
// bf16 forms (adain_snake_conv_bf16, adain_snake_conv_carry_bf16, after
// the f32 kernels): the Pallas kernels' own bf16 semantics, one bf16 MMA per
// tap in place of the three TF32 ones, in a design of their own (the GEMM's
// M and N swapped, weights by the copy engine); their notes are with their
// code.
//
// Plain C interface, loaded with ctypes: each entry point launches its conv
// kernel (the f32 ones after the weight split) on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;          // output channels per CTA (GEMM N)
constexpr int CK = 8;            // input channels per stage (one k8 step)
constexpr int CONSUMERS = 256;   // two warpgroups issue the MMAs
constexpr int PRODUCERS = 256;   // two warpgroups prepare the operands
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int KMAX = 11;
constexpr int PADMAX = 32;
constexpr int TLMAX = 128;       // largest column tile
constexpr int MAX_SMEM = 232448; // per block on sm_90

// Operands in shared memory, in the K-major layout without swizzle that
// wgmma reads: 16-byte rows of 4 channels (one half of the k8 step), rows
// contiguous (8-row core matrices 128 bytes apart), the two halves LBO
// apart. B, per tap: [2 halves][TN rows][4] words; A: [2 halves][window
// rows][4], so the tap t's A starts t d rows on.
constexpr int B_HALF = TN * 4;   // words
constexpr int B_TAP = 2 * B_HALF;
__host__ __device__ constexpr int a_half(int tl) {
  return (tl + 2 * PADMAX) * 4;  // words
}

// A stage's operands in words: B as hi and lo for k taps, then A as hi
// and lo.
__host__ __device__ constexpr int stage_words(int tl, int k) {
  return 2 * k * B_TAP + 4 * a_half(tl);
}

// A stage's raw inputs in words: x [CK][HWX] (row stride 8 mod 32), the
// mask window [HWX], and scale, shift, alpha for its CK channels (4 CK keeps
// 16-byte alignment).
constexpr int HWX = TLMAX + 2 * PADMAX + 8;
constexpr int RAW_WORDS = CK * HWX + HWX + 4 * CK;

// Dynamic shared memory: two stages of operands, two of raw inputs, then
// the carry ([C_in][2 pad] hi and lo words).
__host__ __device__ constexpr int carry_offset(int tl, int k) {
  return 2 * stage_words(tl, k) + 2 * RAW_WORDS;
}

int smem_bytes(int tl, int k, int carry_words) {
  return (carry_offset(tl, k) + carry_words) * 4;
}

struct Args {
  const float* x;
  const float* mask;
  const float* scale;
  const float* shift;
  const float* alpha;
  const float* w;
  const float* bias;
  float* y;
  uint32_t* w_split;  // B, split and laid out by split_weights_kernel
  int c_in, c_out, length, k, dilation, pad;
};

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// wgmma matrix descriptor of a K-major operand without swizzle starting at
// p: leading byte offset (between the two k4 halves) lbo, stride byte
// offset (between 8-row core matrices) 128.
__device__ __forceinline__ uint64_t smem_desc(const uint32_t* p, int lbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D += A B on the tensor cores, one warpgroup: m64 nN k8, TF32 in, f32
// accumulation, both operands from shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n64(d, da, db);
  }
}

// Asynchronous 4-byte copy to shared memory; with valid false the
// destination is filled with zero and nothing is read.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Named barriers (0 is __syncthreads): FULL + s, stage buffer s holds its
// operands; EMPTY + s, the MMAs are done with buffer s (producers and
// consumers, THREADS); RAW, among producers.
constexpr int FULL = 1, EMPTY = 3, RAW = 5;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// B for every (output-channel tile, stage) as the stages hold it: w[t][c]
// [o] split as hi and lo, [co tile][stage][hi, lo][t][half][TN rows][4]
// words, zeros past C_in / C_out. One pass before the conv kernel, so its
// producers copy each stage's B as one contiguous block.
__global__ void split_weights_kernel(const Args a, int stages) {
  const int64_t block = 2 * (int64_t)a.k * B_TAP;  // words per stage
  const int64_t total = (int64_t)((a.c_out + TN - 1) / TN) * stages * block;
  uint32_t* out = a.w_split;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total / 2; i += (int64_t)gridDim.x * blockDim.x) {
    // i runs over [co tile][stage][t][half][row][4]; hi and lo written
    const int64_t tile_stage = i / (block / 2);
    const int within = (int)(i % (block / 2));
    const int t = within / B_TAP;
    const int half = (within / B_HALF) % 2;
    const int n = (within / 4) % TN;
    const int ci = (int)(tile_stage % stages) * CK + half * 4 + within % 4;
    const int co = (int)(tile_stage / stages) * TN + n;
    const float v = ci < a.c_in && co < a.c_out
                        ? a.w[((int64_t)t * a.c_in + ci) * a.c_out + co]
                        : 0.f;
    const uint32_t h = to_tf32(v);
    out[tile_stage * block + within] = h;
    out[tile_stage * block + block / 2 + within] =
        to_tf32(v - __uint_as_float(h));
  }
}

// Start copying stage (co tile, ci0 / CK)'s B, hi then lo, into b_hi.
__device__ __forceinline__ void start_weights(const Args& a, int co_tile,
                                              int ci0, int p,
                                              uint32_t* b_hi) {
  const int stages = (a.c_in + CK - 1) / CK;
  const int chunks = 2 * a.k * B_TAP / 4;  // 16-byte chunks
  const uint32_t* src =
      a.w_split + ((int64_t)co_tile * stages + ci0 / CK) * (4 * chunks);
  for (int i = p; i < chunks; i += PRODUCERS) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(b_hi + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + 4 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Start loading the raw inputs of input channels [ci0, ci0 + CK) for
// window rows [row_lo, width), row 0 at global column l_first: x, mask,
// and the channels' scale, shift and alpha. Producer p takes channel p / 32
// and every 32nd row from p % 32. Zeros outside [0, L) and past C_in.
__device__ __forceinline__ void start_raw(const Args& a, int b, int ci0,
                                          int l_first, int row_lo, int width,
                                          int p, float* raw) {
  float* m_s = raw + CK * HWX;
  float* p_s = m_s + HWX;
  const int c = p / 32;
  const int ci = ci0 + c;
  const float* x_row = a.x + ((int64_t)b * a.c_in + ci) * a.length;
  for (int row = row_lo + p % 32; row < width; row += 32) {
    const int l = l_first + row;
    const bool ok = ci < a.c_in && l >= 0 && l < a.length;
    copy4(raw + c * HWX + row, ok ? x_row + l : a.x, ok);
  }
  for (int row = row_lo + p; row < width; row += PRODUCERS) {
    const int l = l_first + row;
    const bool ok = l >= 0 && l < a.length;
    copy4(m_s + row, ok ? a.mask + (int64_t)b * a.length + l : a.mask, ok);
  }
  if (p < 3 * CK) {
    const int cp = p % CK;
    const int which = p / CK;  // scale, shift, alpha
    const bool ok = ci0 + cp < a.c_in;
    const float* src = which == 2 ? a.alpha + ci0 + cp
                                  : (which == 0 ? a.scale : a.shift) +
                                        (int64_t)b * a.c_in + ci0 + cp;
    copy4(p_s + which * CK + cp, ok ? src : a.alpha, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A rows [row_lo, width) from the raw inputs: h = mask * (z + sin^2(alpha
// z) / alpha), z = x * scale + shift, split as hi and lo. The mask window
// is zero outside [0, L), so h is zero there; channels past C_in are zero.
// Producer p = 64 r + 32 half + 4 j + cc takes channel 4 half + cc and rows
// 8 r + j + 32 i: a warp covers 8 rows by 4 channels, so both its raw-x
// reads (row stride 8 mod 32) and its A stores hit 32 banks.
__device__ __forceinline__ void activate(const Args& a, int ci0, int row_lo,
                                         int width, int half_words, int p,
                                         const float* raw, uint32_t* a_hi,
                                         uint32_t* a_lo) {
  const float* m_s = raw + CK * HWX;
  const float* p_s = m_s + HWX;
  const int cc = p % 4;
  const int half = (p / 32) % 2;
  const int c = 4 * half + cc;
  const bool valid = ci0 + c < a.c_in;
  const float sc = p_s[c];
  const float sh = p_s[CK + c];
  const float al = p_s[2 * CK + c];
  const float inv = 1.0f / al;
  uint32_t* hi = a_hi + half * half_words + cc;
  uint32_t* lo = a_lo + half * half_words + cc;
  for (int row = row_lo + 8 * (p / 64) + (p / 4) % 8; row < width;
       row += 32) {
    float h = 0.f;
    if (valid) {
      const float z = raw[c * HWX + row] * sc + sh;
      const float s = sinf(al * z);
      h = (z + inv * (s * s)) * m_s[row];
    }
    const uint32_t h_hi = to_tf32(h);
    hi[row * 4] = h_hi;
    lo[row * 4] = to_tf32(h - __uint_as_float(h_hi));
  }
}

// Moves A rows between the window and the carry buffer ([C_in][2 pad]
// words, hi then lo): in, rows [0, 2 pad) from the carry; out, rows [TL,
// TL + 2 pad) to it. Producer p takes channel p / 32.
__device__ __forceinline__ void carry_rows(const Args& a, int ci0, int row0,
                                           bool in, int half_words, int p,
                                           uint32_t* a_hi, uint32_t* a_lo,
                                           uint32_t* carry) {
  const int halo = 2 * a.pad;
  const int c = p / 32;
  const int ci = ci0 + c;
  uint32_t* c_hi = carry + ci * halo;
  uint32_t* c_lo = carry + (a.c_in + ci) * halo;
  const int word = (c / 4) * half_words + row0 * 4 + c % 4;
  for (int j = p % 32; j < halo; j += 32) {
    if (in) {
      a_hi[word + 4 * j] = ci < a.c_in ? c_hi[j] : 0u;
      a_lo[word + 4 * j] = ci < a.c_in ? c_lo[j] : 0u;
    } else if (ci < a.c_in) {
      c_hi[j] = a_hi[word + 4 * j];
      c_lo[j] = a_lo[word + 4 * j];
    }
  }
}

// Tiles [tile0, tile_end) of one (output-channel tile, batch row), walked
// left to right, C_in in stages of CK channels, through two operand
// buffers. The producer warpgroups fill buffer q % 2 with stage q's
// operands while the consumer warpgroups multiply stage q - 1 from the
// other; raw inputs run one stage further ahead by cp.async. Consumer
// warpgroup g takes rows 64 g of a 128-column tile (WM = 2, n128), or output
// channels 64 g of a 64-column tile (WM = 1, n64). With ``carry`` every tile
// after the first takes its left 2 pad rows from the carry buffer.
template <int WM>
__device__ __forceinline__ void run(const Args& a, int tile0, int tile_end,
                                    uint32_t* carry) {
  constexpr int TL = 64 * WM;
  constexpr int N = 64 * WM;       // output channels per warpgroup
  constexpr int R = N / 2;         // accumulators per thread
  extern __shared__ __align__(128) uint32_t smem[];
  const int co0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int halo = 2 * a.pad;
  const int half_words = a_half(TL);
  const int stages = (a.c_in + CK - 1) / CK;  // per tile
  const int n = (tile_end - tile0) * stages;
  const int words = stage_words(TL, a.k);

  if (threadIdx.x >= CONSUMERS) {  // ---- producers
    const int p = threadIdx.x - CONSUMERS;
    float* raw0 = reinterpret_cast<float*>(smem + 2 * words);
    auto start = [&](int q) {
      const int tile = tile0 + q / stages;
      start_raw(a, b, (q % stages) * CK, tile * TL - a.pad,
                tile == tile0 || carry == nullptr ? 0 : halo, TL + halo, p,
                raw0 + (q & 1) * RAW_WORDS);
    };
    start(0);
    for (int q = 0; q < n; ++q) {
      const int s = q & 1;
      const int tile = tile0 + q / stages;
      const int ci0 = (q % stages) * CK;
      const int row_lo = tile == tile0 || carry == nullptr ? 0 : halo;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      bar_sync(RAW, PRODUCERS);  // raw q landed; raw q + 1's buffer is free
      if (q >= 2) bar_sync(EMPTY + s, THREADS);  // stage q - 2's MMAs done
      uint32_t* b_hi = smem + s * words;
      uint32_t* a_hi = b_hi + 2 * a.k * B_TAP;
      uint32_t* a_lo = a_hi + 2 * half_words;
      start_weights(a, blockIdx.y, ci0, p, b_hi);
      if (q + 1 < n) start(q + 1);
      if (row_lo > 0)
        carry_rows(a, ci0, 0, true, half_words, p, a_hi, a_lo, carry);
      activate(a, ci0, row_lo, TL + halo, half_words, p,
               raw0 + s * RAW_WORDS, a_hi, a_lo);
      if (carry != nullptr && tile + 1 < tile_end) {
        // rows [TL, TL + 2 pad) are the next tile's left halo
        bar_sync(RAW, PRODUCERS);
        carry_rows(a, ci0, TL, false, half_words, p, a_hi, a_lo, carry);
      }
      // this thread's B copies have landed (raw q + 1 may still fly)
      if (q + 1 < n) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      // generic-proxy writes, visible to the tensor cores' async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(FULL + s, THREADS);
    }
    return;
  }

  // ---- consumers: the warpgroup index as a warp-uniform value keeps the
  // descriptors in uniform registers
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row0 = WM == 2 ? 64 * g : 0;
  const int n0 = WM == 2 ? 0 : 64 * g;
  float acc[R];
  for (int tile = tile0; tile < tile_end; ++tile) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int ci0 = 0; ci0 < a.c_in; ci0 += CK) {
      const int q = (tile - tile0) * stages + ci0 / CK;
      const int s = q & 1;
      const uint32_t* b_hi = smem + s * words;
      const uint32_t* b_lo = b_hi + a.k * B_TAP;
      const uint32_t* a_hi = b_hi + 2 * a.k * B_TAP;
      const uint32_t* a_lo = a_hi + 2 * half_words;
      // tap t: A starts t d rows (16 bytes each) on, B one tap (B_TAP
      // words) on; the descriptors' address field counts 16 bytes
      uint64_t ah = smem_desc(a_hi + row0 * 4, half_words * 4);
      uint64_t al = smem_desc(a_lo + row0 * 4, half_words * 4);
      uint64_t bh = smem_desc(b_hi + n0 * 4, B_HALF * 4);
      uint64_t bl = smem_desc(b_lo + n0 * 4, B_HALF * 4);
      bar_sync(FULL + s, THREADS);  // stage q's operands are in buffer s
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int t = 0; t < a.k; ++t) {
        wgmma<N>(acc, al, bh);
        wgmma<N>(acc, ah, bl);
        wgmma<N>(acc, ah, bh);
        ah += a.dilation;
        al += a.dilation;
        bh += B_TAP / 4;
        bl += B_TAP / 4;
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (ci0 > 0) {  // stage q - 1's MMAs are done: release its buffer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (q + 1 < n) bar_arrive(EMPTY + (s ^ 1), THREADS);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    {  // the tile's last stage
      const int q = (tile - tile0 + 1) * stages - 1;
      if (q + 2 < n) bar_arrive(EMPTY + (q & 1), THREADS);
    }
    // accumulator layout of m64nN: warp w of the warpgroup holds rows 16 w
    // + lane / 4 (+ 8 for e >= 2), columns 8 j + 2 (lane % 4) + e % 2
    const int lane = threadIdx.x % 32;
    const int col0 =
        tile * TL + row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    const int o0 = co0 + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = col0 + 8 * (e / 2);
        const int o = o0 + 8 * j + e % 2;
        if (o < a.c_out && l < a.length)
          a.y[((int64_t)b * a.c_out + o) * a.length + l] =
              acc[4 * j + e] + a.bias[o];
      }
    }
  }
}

template <int WM>
__global__ void __launch_bounds__(THREADS, 1)
adain_snake_conv_tile_kernel(const Args a, int tiles_per_cta) {
  constexpr int TL = 64 * WM;
  const int n_tiles = (a.length + TL - 1) / TL;
  const int tile0 = blockIdx.x * tiles_per_cta;
  run<WM>(a, tile0, min(n_tiles, tile0 + tiles_per_cta), nullptr);
}

template <int WM>
__global__ void __launch_bounds__(THREADS, 1)
adain_snake_conv_carry_kernel(const Args a, int tiles_per_chunk) {
  constexpr int TL = 64 * WM;
  extern __shared__ __align__(128) uint32_t smem[];
  const int n_tiles = (a.length + TL - 1) / TL;
  const int tile0 = blockIdx.x * tiles_per_chunk;
  const int tile_end = min(n_tiles, tile0 + tiles_per_chunk);
  // after the stages and the raw buffers, when chunks walk
  uint32_t* carry =
      tiles_per_chunk > 1 ? smem + carry_offset(TL, a.k) : nullptr;
  run<WM>(a, tile0, tile_end, carry);
}

bool valid(int batch, int c_in, int c_out, int length, int k, int dilation) {
  if (batch <= 0 || batch > 65535 || c_in <= 0 || c_out <= 0 || length <= 0)
    return false;
  if (k <= 0 || k > KMAX || dilation <= 0 || ((k - 1) * dilation) % 2)
    return false;
  return (c_out + TN - 1) / TN <= 65535 && (k - 1) * dilation / 2 <= PADMAX;
}

Args make_args(const float* x, const float* mask, const float* scale,
               const float* shift, const float* alpha, const float* w,
               const float* bias, float* y, uint32_t* w_split, int c_in,
               int c_out, int length, int k, int dilation) {
  return Args{x,     mask,  scale,  shift, alpha, w,        bias,
              y,     w_split, c_in, c_out, length, k, dilation,
              (k - 1) * dilation / 2};
}

// Words of the split weights a launch needs (the wrapper allocates them).
int64_t split_words(int c_in, int c_out, int k) {
  return (int64_t)((c_out + TN - 1) / TN) * ((c_in + CK - 1) / CK) * 2 * k *
         B_TAP;
}

int split_weights(const Args& a, cudaStream_t stream) {
  const int stages = (a.c_in + CK - 1) / CK;
  const int64_t items = split_words(a.c_in, a.c_out, a.k) / 2;
  const int64_t want = (items + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  split_weights_kernel<<<blocks, 256, 0, stream>>>(a, stages);
  return (int)cudaGetLastError();
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

template <int WM>
int launch_tile(const Args& a, int batch, int tiles_per_cta,
                cudaStream_t stream) {
  constexpr int TL = 64 * WM;
  const int n_tiles = (a.length + TL - 1) / TL;
  const int smem = prepare_smem(adain_snake_conv_tile_kernel<WM>,
                                smem_bytes(TL, a.k, 0));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_tiles + tiles_per_cta - 1) / tiles_per_cta,
                  (a.c_out + TN - 1) / TN, batch);
  adain_snake_conv_tile_kernel<WM><<<grid, THREADS, smem, stream>>>(
      a, tiles_per_cta);
  return (int)cudaGetLastError();
}

template <int WM>
int launch_carry(const Args& a, int batch, int tiles_per_chunk,
                 cudaStream_t stream) {
  constexpr int TL = 64 * WM;
  const int n_tiles = (a.length + TL - 1) / TL;
  const int chunks = (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const int carry_words = tiles_per_chunk > 1 ? 2 * a.c_in * 2 * a.pad : 0;
  const int smem = prepare_smem(adain_snake_conv_carry_kernel<WM>,
                                smem_bytes(TL, a.k, carry_words));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, (a.c_out + TN - 1) / TN, batch);
  adain_snake_conv_carry_kernel<WM><<<grid, THREADS, smem, stream>>>(
      a, tiles_per_chunk);
  return (int)cudaGetLastError();
}

// ---- bf16 forms ------------------------------------------------------------
//
// The Pallas kernels with x in bfloat16 (fused_conv.py:59-87 and :118-153,
// carry_conv.py:137-175): x [B, C_in, L] and y bfloat16; mask, scale,
// shift, alpha and bias f32; w bfloat16, held stage-packed (below; the
// model packs it once per weight). The activation is computed in f32 as
// above and rounded to bfloat16 (cvt.rn.bf16x2.f32: to nearest even, as
// torch's .bfloat16()), one wgmma m64nNk16.f32.bf16.bf16 per (tap, stage of
// CKB = 16 input channels) sums the products of h and w in f32, and the
// epilogue adds the f32 bias and rounds to bfloat16. The sum order per
// output is fixed (stage, then tap) and nothing is atomic, so runs are
// bitwise repeatable.
//
// Bound: operations. 2 B L C_in C_out k / 989e12 (the dense bf16 tensor-core
// rate): 0.179 ms at B=8, C=128, L=61440, k=11, against 0.076 ms for its
// bytes (x and y in bfloat16, the f32 mask, w).
//
// The GEMM, with M and N swapped against the f32 kernels: A = the weights
// (M = 128 output channels, 64 for each of two consumer warpgroups), B =
// the activated window (N = TL columns, up to 256: one m64n256k16 per tap
// and stage), K = (tap t, input channel c). A stage's weights (45 KB at
// k = 11) thus feed TL = 256 columns, twice the f32 kernels' longest tile,
// which halves the weights every CTA re-reads from L2 (every CTA streams
// the layer's whole weights once per column tile). Both operands are
// K-major without swizzle: 16-byte rows of 8 channels, rows contiguous (8-row
// core matrices 128 bytes apart), the two 8-channel halves of the k16 step
// LBO apart. Tap t's B starts t d rows (16 bytes each) into the window: a
// step of the descriptor's start address.
//
// Stage-packed weights: the wrapper holds w as [C_out / 128][C_in / 16][k]
// [2 halves][128 rows][8 channels] bfloat16, zero-padded past C_in and C_out
// (ops/adain_snake_conv.py::pack_weights), so one stage's A for one
// output-channel tile is one contiguous span of k * 4 KB in exactly the
// layout wgmma reads. One producer thread moves it with k bulk copies
// (cp.async.bulk, the copy engine), completed on the stage's full mbarrier
// by its transaction count: no thread copies weights word by word.
//
// Warp specialization (384 threads, one CTA per SM): one producer warpgroup
// (128 threads) and two consumer warpgroups. Consumers hold TL / 2 f32
// sums a thread (128 at TL = 256: ptxas reports 154 registers a thread and
// no spills for the 256-column kernels, within the 168 that 384 threads
// leave; a second producer warpgroup does not compile: at 512 threads
// ptxas holds every thread to the launch bound's 128 registers, whatever
// setmaxnreg gives the consumers later) and only issue the MMAs, keeping one
// stage in flight; each warp releases a stage buffer on its empty mbarrier
// once its MMAs on it are done. The producers fill SB = 3 stage buffers:
// the weights one stage ahead (bulk copies), the raw inputs RB - 1 = 2
// stages ahead (16-byte cp.async into RB raw buffers), and the activation
// of the stage itself (scale, shift, alpha, SFU sine, mask, rounded to
// bfloat16), then arrive on the stage's full mbarrier. A producer thread
// activates 4 rows at once for one pair of channels (activate_bf16: one
// warp per scheduler hides no latency otherwise). The epilogue adds the
// bias and stores whole tiles in 16-byte stores after a transpose within
// each quad (store_tile_bf16), ragged tiles column by column.
//
// Raw inputs in 16-byte chunks: a window's first column need not start a
// chunk. Each channel row's columns inside [0, L) are copied as the
// aligned chunks covering them, placed so that column l sits at raw
// position l - l_first + s_c (s_c, 0 to 7, the row's flat index at l_first
// modulo 8; the f32 mask likewise modulo 4); a last chunk reads only up to
// the row's end (zero fill), so nothing past the tensor is read. The
// activation reads only columns inside [0, L) and writes 0 elsewhere,
// without touching the raw value there (stale; never multiplied by 0).
//
// Walking carry: as the f32 kernels, one bfloat16 per (input channel, halo
// column) in shared memory after the raw buffers; it fits beside the stages
// at every shape with k <= 11 and d <= 5, so the carry kernel walks chunks
// of tiles at C = 256 too.
//
// Row extents (the Generator's masks, ragged in a batch): with extent[b],
// one past the last nonzero mask column of row b, the MMAs run only over
// the column tiles that start before extent[b] + pad, clipped to L (none
// for an empty row). Every input at or past the extent is masked to zero,
// so an output column l >= extent + pad sums products of zero activations:
// its f32 sum is +0 and its value bf16(0 + bias[o]), which the launch stores
// for the tiles it skips, bit for bit what computing them gives (+0 is
// added first, so a -0 bias stores +0, as the MMAs' sum gives). Those
// columns are written, not left: the residual, the transposed conv and the
// head after the blocks read them. Each (batch row, output-channel tile) is
// a segment; segments in the order (b, co tile) list their computed tiles,
// and again their bias tiles. The grid is the one without extents, about
// one wave and fixed by shape (CUDA graphs capture it). Where a row's
// extent leaves tiles out, CTA i of the G takes the contiguous share [i W
// / G, (i + 1) W / G) of the W computed tiles (shares differ by at most one
// tile) and likewise of the bias tiles, whose stores its consumers issue
// between its computed tiles. A share may span segments: the pipeline runs
// on across them, the walking carry restarts at each segment's first tile,
// and each tile's arithmetic and column tiling are those of the split
// without extents, so the output is bitwise that launch's. Without extents,
// or where every row reaches its end, a CTA takes tiles_per_cta
// consecutive tiles of one segment, placed by its index, as ever.
//
// A tally (conv_tally_bf16, device memory of this module) counts the column
// tiles computed and the tiles of the launches' whole grids (B x C_out
// tiles x L / TL), one atomic add a CTA (the first CTA adds the grid), so
// CUDA-graph replays count too; adain_snake_conv_tally reads it on demand.

constexpr int CKB = 16;           // input channels per bf16 stage (one k16 step)
constexpr int TLB_MAX = 256;      // longest bf16 column tile (wgmma n256)
constexpr int PRODUCERS_B = 128;  // one warpgroup: weights, raw inputs, activation
constexpr int CONSUMERS_B = 256;  // two warpgroups: 64 output channels each
constexpr int THREADS_B = PRODUCERS_B + CONSUMERS_B;
constexpr int SB = 3;             // operand stage buffers
constexpr int RB = 3;             // raw buffers: raw inputs load RB - 1 stages ahead
constexpr int W_TAP_WORDS = 2 * TN * 4;  // a tap of a stage's weights, 4 KB
constexpr int BAR_WORDS = 32;     // the mbarriers, ahead of the stage buffers
constexpr int RAW_B = 1;          // named barrier among the producers
constexpr int TILES_S = 8;        // the producers' tiles in flight, a ring

// Rows of a stage's window: the tile and both halos at the largest pad,
// rounded so that the two k halves sit 16 banks apart (4 rows_b = 16 mod 32
// words).
__host__ __device__ constexpr int rows_b(int tl) { return tl + 2 * PADMAX + 4; }

// A raw x row in bfloat16: the window, its shift to 16-byte alignment (up
// to 7) and a last chunk's spill (up to 7), rounded to whole 16-byte chunks
// with rows 12 banks apart (raw_row_bf16 / 2 = 12 mod 32 words), so that a
// warp's reads of 4 channels by 8 rows hit distinct banks.
__host__ __device__ constexpr int raw_row_bf16(int tl) {
  return tl + 2 * PADMAX + 24;
}

// The raw mask window in f32: the window, its shift (up to 3) and a last
// chunk's spill (up to 3), in whole 16-byte chunks.
__host__ __device__ constexpr int raw_mask_bf16(int tl) {
  return tl + 2 * PADMAX + 8;
}

// A stage in words: the weights [k][2][TN][4], then the window [2][rows][4].
__host__ __device__ constexpr int stage_words_bf16(int tl, int k) {
  return k * W_TAP_WORDS + 8 * rows_b(tl);
}

// A raw buffer in words: x [CKB][raw_row] bfloat16, the mask window
// [raw_mask] and scale, shift, alpha [3][CKB] f32; 16-byte aligned parts.
__host__ __device__ constexpr int raw_words_bf16(int tl) {
  return CKB * raw_row_bf16(tl) / 2 + raw_mask_bf16(tl) + 3 * CKB;
}

// Dynamic shared memory: the mbarriers, SB stages, RB raw buffers, then the
// carry ([ceil(C_in / 2)][2 pad] words, each two channels' bfloat16).
__host__ __device__ constexpr int carry_offset_bf16(int tl, int k) {
  return BAR_WORDS + SB * stage_words_bf16(tl, k) + RB * raw_words_bf16(tl);
}

int smem_bytes_bf16(int tl, int k, int carry_words) {
  return (carry_offset_bf16(tl, k) + carry_words) * 4;
}

struct ArgsB {
  const __nv_bfloat16* x;
  const float* mask;
  const float* scale;
  const float* shift;
  const float* alpha;
  const __nv_bfloat16* w;  // stage-packed [C_out/128][C_in/16][k][2][128][8]
  const float* bias;
  __nv_bfloat16* y;
  const int* extent;  // [B] row extents, or null: full rows
  int batch, c_in, c_out, length, k, dilation, pad, stages;
};

// Column tiles computed (0) and of the launches' whole grids (1).
__device__ unsigned long long conv_tally_bf16[2];

// A position in one of a launch's two tile lists (computed, bias): the
// segment (b * co_tiles + co tile), the list index of its first tile, and
// how many of its tiles the list holds.
struct Cursor {
  int seg, base, count;
};

// What the split reads of a launch: the row extents (or null), the row
// length, the conv's reach and the output-channel tiles.
struct Rows {
  const int* extent;
  int length, pad, co_tiles;
};

__device__ __forceinline__ Rows rows_of(const ArgsB& a) {
  return Rows{a.extent, a.length, a.pad, (a.c_out + TN - 1) / TN};
}

// Tiles of segment `seg` that the MMAs compute: those starting before the
// row's extent + pad, clipped to the row; none for an empty row; all
// without extents.
template <int TL>
__device__ __forceinline__ int work_tiles(const Rows& r, int seg) {
  const int n_tiles = (r.length + TL - 1) / TL;
  if (r.extent == nullptr) return n_tiles;
  const int e = r.extent[seg / r.co_tiles];
  return e <= 0 ? 0 : min(n_tiles, (e + r.pad + TL - 1) / TL);
}

// Moves c forward to the segment holding list index g (the bias list with
// BIAS: each segment's tiles past its computed ones).
template <int TL, bool BIAS>
__device__ __forceinline__ void seek(const Rows& r, Cursor& c, int g) {
  while (g >= c.base + c.count) {
    c.base += c.count;
    ++c.seg;
    const int w = work_tiles<TL>(r, c.seg);
    c.count = BIAS ? (r.length + TL - 1) / TL - w : w;
  }
}

// A CTA's share: list indices [w0, w1) of the computed tiles and [b0, b1)
// of the bias tiles, with cursors at the segments holding w0 and b0;
// ragged when some row computes fewer than all its tiles.
struct Share {
  int w0, w1, b0, b1;
  Cursor work, bias;
  bool ragged;
};

// The cursor at index g of a list (BIAS: the bias tiles), found by one
// warp, 32 batch rows a step: each row's tiles in the list, their
// inclusive prefix by shuffles, and the first row whose prefix passes g.
template <int TL, bool BIAS>
__device__ __forceinline__ Cursor locate(const ArgsB& a, int co_tiles, int g) {
  const int lane = threadIdx.x % 32;
  const int n_tiles = (a.length + TL - 1) / TL;
  int before = 0;  // list index of this step's first row
  for (int r0 = 0; r0 < a.batch; r0 += 32) {
    const int r = r0 + lane;
    const int w = r < a.batch ? work_tiles<TL>(rows_of(a), r * co_tiles) : 0;
    const int each = r < a.batch ? (BIAS ? n_tiles - w : w) : 0;  // a segment
    int upto = co_tiles * each;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, off);
      if (lane >= off) upto += v;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, before + upto > g);
    if (hit != 0) {
      const int src = __ffs(hit) - 1;
      const int row_base =
          before + __shfl_sync(0xffffffffu, upto - co_tiles * each, src);
      const int per = __shfl_sync(0xffffffffu, each, src);
      const int k = (g - row_base) / per;
      return Cursor{(r0 + src) * co_tiles + k, row_base + k * per, per};
    }
    before += __shfl_sync(0xffffffffu, upto, 31);
  }
  return Cursor{0, 0, 0};  // g past the list: not asked
}

// The CTA's share, by warp 0 (every lane gets it). Without extents, or
// where every row computes all its tiles, a run of tiles_per_cta tiles of
// segment (blockIdx.z, blockIdx.y); else the i-th of G balanced parts of
// each list, i the CTA's index in the grid and G its size.
template <int TL>
__device__ __forceinline__ Share share_of(const ArgsB& a, int tiles_per_cta) {
  const int co_tiles = (a.c_out + TN - 1) / TN;
  const int n_tiles = (a.length + TL - 1) / TL;
  Share s;
  const int seg = blockIdx.z * co_tiles + blockIdx.y;
  const int t0 = blockIdx.x * tiles_per_cta;
  s.work = Cursor{seg, seg * n_tiles, n_tiles};
  s.w0 = seg * n_tiles + t0;
  s.w1 = seg * n_tiles + min(n_tiles, t0 + tiles_per_cta);
  s.b0 = s.b1 = 0;
  s.bias = Cursor{0, 0, 0};
  s.ragged = false;
  if (a.extent == nullptr) return s;
  int total = 0;  // computed tiles of the launch
  for (int r0 = 0; r0 < a.batch; r0 += 32) {
    const int r = r0 + (int)threadIdx.x % 32;
    int w = r < a.batch ? co_tiles * work_tiles<TL>(rows_of(a), r * co_tiles)
                        : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w += __shfl_xor_sync(0xffffffffu, w, off);
    total += w;
  }
  const int64_t bias_total = (int64_t)a.batch * co_tiles * n_tiles - total;
  if (bias_total == 0) return s;  // every row whole
  const int64_t i =
      blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int64_t g = (int64_t)gridDim.x * gridDim.y * gridDim.z;
  s.ragged = true;
  s.w0 = (int)(i * total / g);
  s.w1 = (int)((i + 1) * total / g);
  s.b0 = (int)(i * bias_total / g);
  s.b1 = (int)((i + 1) * bias_total / g);
  s.work = Cursor{0, 0, 0};
  s.bias = Cursor{0, 0, 0};
  if (s.w0 < s.w1) s.work = locate<TL, false>(a, co_tiles, s.w0);
  if (s.b0 < s.b1) s.bias = locate<TL, true>(a, co_tiles, s.b0);
  return s;
}

// D += A B on the tensor cores, one warpgroup: m64 nN k16, bfloat16 in, f32
// accumulation, both operands K-major from shared memory.
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 256) {
    wgmma_bf16_n256(d, da, db);
  } else if constexpr (N == 128) {
    wgmma_bf16_n128(d, da, db);
  } else {
    wgmma_bf16_n64(d, da, db);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers: full[s] completes when the producers' activation of stage
// buffer s has arrived (PRODUCERS_B arrivals) and its weights have landed
// (the bulk copies' transaction bytes); empty[s] when every consumer warp is
// done with its MMAs on buffer s (CONSUMERS_B / 32 arrivals).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The copy engine: `bytes` (a multiple of 16) from global memory to shared
// memory, counted against the mbarrier's transaction bytes.
__device__ __forceinline__ void bulk_copy(uint32_t* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Asynchronous copy of one 16-byte chunk, of which the first `bytes` are
// read and the rest zero-filled.
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying stage `st`'s weights for output-channel tile `co_tile` into
// the stage buffer at `dst` (one thread): k taps of 4 KB by the copy engine,
// onto `bar`'s transaction count.
__device__ __forceinline__ void start_weights_bf16(const ArgsB& a,
                                                   int co_tile, int st,
                                                   uint32_t* dst,
                                                   uint64_t* bar) {
  constexpr int TAP_BYTES = W_TAP_WORDS * 4;
  const char* src = reinterpret_cast<const char*>(a.w) +
                    ((int64_t)co_tile * a.stages + st) * a.k * TAP_BYTES;
  mbar_expect_tx(bar, a.k * TAP_BYTES);
  for (int t = 0; t < a.k; ++t)
    bulk_copy(dst + t * W_TAP_WORDS, src + t * TAP_BYTES, TAP_BYTES, bar);
}

// Start loading the raw inputs of input channels [ci0, ci0 + CKB) for
// window rows [row_lo, width), row 0 at global column l_first, in 16-byte
// chunks: x (the chunks covering each channel's columns inside [0, L), 8
// producers a channel), the mask (likewise) and the channels' scale, shift
// and alpha. A row's first column need not start a chunk: column l goes to
// raw position l - l_first + s, s the row's flat index at l_first modulo 8
// (modulo 4 for the f32 mask), so chunks land 16-byte aligned; a last
// chunk reads only up to the row's end and zero-fills the rest.
template <int TL>
__device__ __forceinline__ void start_raw_bf16(const ArgsB& a, int b,
                                               int ci0, int l_first,
                                               int row_lo, int width, int p,
                                               uint32_t* raw) {
  constexpr int HX = raw_row_bf16(TL);
  constexpr int PER_CHANNEL = PRODUCERS_B / CKB;
  float* m_s = reinterpret_cast<float*>(raw + CKB * HX / 2);
  float* p_s = m_s + raw_mask_bf16(TL);
  const int lo = max(l_first + row_lo, 0);
  const int hi = min(l_first + width, a.length);
  if (lo < hi) {
    const int c = p / PER_CHANNEL;
    const int ci = ci0 + c;
    if (ci < a.c_in) {
      const int64_t base = ((int64_t)b * a.c_in + ci) * a.length;
      const int64_t first = (base + lo) & ~(int64_t)7;  // flat, aligned
      const int64_t end = base + hi;
      // raw position of flat element `first`: a multiple of 8
      const int pos = (int)(first - base - l_first) +
                      (int)((base + l_first) & 7);
      __nv_bfloat16* row =
          reinterpret_cast<__nv_bfloat16*>(raw) + c * HX + pos;
      const int chunks = (int)((end - first + 7) / 8);
      for (int i = p % PER_CHANNEL; i < chunks; i += PER_CHANNEL) {
        const int64_t e = first + 8 * i;
        copy_chunk(row + 8 * i, a.x + e,
                   2 * (int)(end - e < 8 ? end - e : 8));
      }
    }
    const int64_t base = (int64_t)b * a.length;
    const int64_t first = (base + lo) & ~(int64_t)3;
    const int64_t end = base + hi;
    const int pos = (int)(first - base - l_first) +
                    (int)((base + l_first) & 3);
    const int chunks = (int)((end - first + 3) / 4);
    for (int i = p; i < chunks; i += PRODUCERS_B) {
      const int64_t e = first + 4 * i;
      copy_chunk(m_s + pos + 4 * i, a.mask + e,
                 4 * (int)(end - e < 4 ? end - e : 4));
    }
  }
  if (p < 3 * CKB) {
    const int cp = p % CKB;
    const int which = p / CKB;  // scale, shift, alpha
    const bool ok = ci0 + cp < a.c_in;
    const float* src = which == 2 ? a.alpha + ci0 + cp
                                  : (which == 0 ? a.scale : a.shift) +
                                        (int64_t)b * a.c_in + ci0 + cp;
    copy4(p_s + which * CKB + cp, ok ? src : a.alpha, ok);
  }
  commit_group();
}

// sin(v) on the SFU after one Cody-Waite step to [-pi, pi] (2 pi split in
// two floats, as the iSTFT head's reduce_2pi): ~4e-7 absolute error for
// |v| < 1e6, far below the bfloat16 rounding of h; NaN stays NaN.
__device__ __forceinline__ float sin_sfu(float v) {
  const float n = rintf(v * 0.159154943f);
  return __sinf(fmaf(-n, -1.74845553e-7f, fmaf(-n, 6.28318548f, v)));
}

// Window rows [row_lo, width) from the raw inputs: h = mask * (z +
// sin^2(alpha z) / alpha), z = x * scale + shift, in f32, rounded to
// bfloat16; zero outside [0, L) and past C_in. Warp w takes the half w % 2
// (8 channels) and rows 8 (w / 2) + 16 i + lane / 4; lane % 4 picks one
// channel pair (one packed word of the 16-byte row). A row's mask is read
// once for both channels; a warp's x reads hit distinct banks and its
// stores cover 8 whole rows. With one producer warp per scheduler nothing
// hides a row's latency (shared loads, the SFU), so a thread works R rows
// at once: loads first, then R independent chains. Outside [0, L) the raw
// value is stale: h is selected to 0, never multiplied by the mask there.
template <int TL>
__device__ __forceinline__ void activate_bf16(const ArgsB& a, int b, int ci0,
                                              int l_first, int row_lo,
                                              int width, int p,
                                              const uint32_t* raw,
                                              uint32_t* win) {
  constexpr int HW = rows_b(TL);
  constexpr int HX = raw_row_bf16(TL);
  constexpr int HM = raw_mask_bf16(TL);
  constexpr int R = 4;
  const __nv_bfloat16* x_s = reinterpret_cast<const __nv_bfloat16*>(raw);
  const float* m_s = reinterpret_cast<const float*>(raw + CKB * HX / 2);
  const float* p_s = m_s + HM;
  const int warp = p / 32;
  const int lane = p % 32;
  const int pair = 4 * (warp % 2) + lane % 4;
  float sc[2], sh[2], al[2], inv[2];
  bool valid[2];
  const __nv_bfloat16* xr[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = 2 * pair + u;
    const int ci = ci0 + c;
    valid[u] = ci < a.c_in;
    sc[u] = p_s[c];
    sh[u] = p_s[CKB + c];
    al[u] = p_s[2 * CKB + c];
    inv[u] = 1.0f / al[u];
    const int64_t at = ((int64_t)b * a.c_in + ci) * a.length + l_first;
    xr[u] = x_s + c * HX + (int)(at & 7);
  }
  const float* mr = m_s + (int)(((int64_t)b * a.length + l_first) & 3);
  uint32_t* dst = win + (warp % 2) * (4 * HW) + lane % 4;
  // columns [lo, hi) of the window lie inside [0, L)
  const int lo = max(row_lo, -l_first);
  const int hi = min(width, a.length - l_first);
  for (int row0 = row_lo + 8 * (warp / 2) + lane / 4; row0 < width;
       row0 += 16 * R) {
    float xv[R][2], mv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = min(row0 + 16 * r, HM - 4);  // in the buffers
#pragma unroll
      for (int u = 0; u < 2; ++u) xv[r][u] = __bfloat162float(xr[u][row]);
      mv[r] = mr[row];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + 16 * r;
      float h[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float z = xv[r][u] * sc[u] + sh[u];
        const float s = sin_sfu(al[u] * z);
        h[u] = valid[u] && row >= lo && row < hi
                   ? (z + inv[u] * (s * s)) * mv[r]
                   : 0.f;
      }
      uint32_t packed;  // channel 2 pair in the low half, as memory orders
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
          : "=r"(packed)
          : "f"(h[1]), "f"(h[0]));
      if (row < width) dst[row * 4] = packed;
    }
  }
}

// Moves window rows between the window and the carry buffer
// ([ceil(C_in / 2)][2 pad] words of two channels): in, rows [0, 2 pad) from
// the carry; out, rows [TL, TL + 2 pad) to it. Producer p takes the stage's
// channel pair p / 16 and every 16th row.
template <int TL>
__device__ __forceinline__ void carry_rows_bf16(const ArgsB& a, int ci0,
                                                int row0, bool in, int p,
                                                uint32_t* win,
                                                uint32_t* carry) {
  constexpr int HW = rows_b(TL);
  const int halo = 2 * a.pad;
  const int pair = p / 16;
  const int ci = ci0 + 2 * pair;
  uint32_t* c_row = carry + (ci / 2) * halo;
  const int word = (pair / 4) * (4 * HW) + row0 * 4 + pair % 4;
  for (int j = p % 16; j < halo; j += 16) {
    if (in) {
      win[word + 4 * j] = ci < a.c_in ? c_row[j] : 0u;
    } else if (ci < a.c_in) {
      c_row[j] = win[word + 4 * j];
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t packed;  // lo in the low half, as memory orders them
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(packed) : "f"(hi), "f"(lo));
  return packed;
}

// The epilogue of a whole tile with L a multiple of 8: y = acc + bias in
// bfloat16, in 16-byte stores. For each group of 4 column blocks (j = 4 m
// .. 4 m + 3, 8 columns each), the 4 lanes of a quad (one output channel)
// each hold one packed word of every block; a transpose within the quad
// (three shuffles) gives lane q the whole block 4 m + q, so a warp's store
// covers 64 contiguous bytes of each of its 8 rows, whole 32-byte sectors,
// where word stores would write half sectors with 4 times the instructions.
template <int TL>
__device__ __forceinline__ void store_tile_bf16(const ArgsB& a,
                                                const float (&acc)[TL / 2],
                                                int b, int o0, int l0,
                                                int q) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int o = o0 + 8 * e;
    const float bias = o < a.c_out ? a.bias[o] : 0.f;
    __nv_bfloat16* y_row =
        a.y + ((int64_t)b * a.c_out + min(o, a.c_out - 1)) * a.length + l0;
#pragma unroll
    for (int m = 0; m < TL / 32; ++m) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = pack_bf16x2(acc[4 * (4 * m + i) + 2 * e] + bias,
                           acc[4 * (4 * m + i) + 2 * e + 1] + bias);
      // out[i]: lane i's word of block 4 m + q; selects, not a runtime
      // index, keep everything in registers
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = i == q ? v[i] : 0u;
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        const int partner = q ^ r;
        uint32_t send = v[0];
#pragma unroll
        for (int i = 1; i < 4; ++i) send = i == partner ? v[i] : send;
        const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i] = i == partner ? got : out[i];
      }
      if (o < a.c_out)
        *reinterpret_cast<uint4*>(y_row + 8 * (4 * m + q)) =
            make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// A bias tile, by the consumer threads (t of CONSUMERS_B): columns [tile
// TL, min(L, (tile + 1) TL)) of output channels co_tile * 128 .. + 127 of
// row b set to bf16(0 + bias[o]), what the MMAs' +0 sum gives there. Thread
// t takes one 16-byte chunk of a row (one column where L is not a multiple
// of 8) and walks the rows, one bias load a row.
template <int TL>
__device__ __forceinline__ void store_bias_bf16(__nv_bfloat16* y,
                                                const float* bias, int c_out,
                                                int length, int b,
                                                int co_tile, int tile,
                                                int t) {
  const int l0 = tile * TL;
  const int cols = min(TL, length - l0);
  const bool wide = length % 8 == 0;  // the tile starts and ends on a chunk
  const int per_row = wide ? cols / 8 : cols;
  static_assert(TL <= CONSUMERS_B, "a row's chunks fit the threads");
  const int rows_at_once = CONSUMERS_B / per_row;
  const int c = t % per_row;
  if (t / per_row >= rows_at_once) return;
  for (int o = co_tile * TN + t / per_row;
       o < min(c_out, (co_tile + 1) * TN); o += rows_at_once) {
    const float v = __fadd_rn(0.f, bias[o]);
    __nv_bfloat16* y_row = y + ((int64_t)b * c_out + o) * length + l0;
    if (wide) {
      const uint32_t w = pack_bf16x2(v, v);
      *reinterpret_cast<uint4*>(y_row + 8 * c) = make_uint4(w, w, w, w);
    } else {
      y_row[c] = __float2bfloat16_rn(v);
    }
  }
}

// Where the share's tile i lies, for the producers, in tiles[i % TILES_S]:
// its row, output-channel tile and first window column, and the first
// window row to load and activate (a window's first tile in the share or
// its segment loads it whole) with bit 16 set where the share's next tile
// continues the row (walk: the carry kernel walks). Found afresh from the
// share's start, out of line and from scalars (no stack): the producers,
// which set the pace, keep no cursor in registers, and their loop stays as
// lean as without extents.
template <int TL>
__device__ __noinline__ void describe_tile(const int* extent, int length,
                                           int pad, int co_tiles,
                                           const Share* sh, bool walk, int i,
                                           int4* tiles) {
  const Rows r{extent, length, pad, co_tiles};
  const int g = sh->w0 + i;
  Cursor c = sh->work;
  seek<TL, false>(r, c, g);
  const int tile = g - c.base;
  const bool fresh = i == 0 || tile == 0 || !walk;
  const bool cont = walk && g + 1 < sh->w1 && g + 1 < c.base + c.count;
  tiles[i % TILES_S] =
      make_int4(c.seg / co_tiles, c.seg % co_tiles, tile * TL - pad,
                (fresh ? 0 : 2 * pad) | (cont ? 1 << 16 : 0));
}

// Consumer t's part of part i of `parts` of the share's bias tiles (all of
// them for parts = 1), found afresh from the share's start; out of line.
template <int TL>
__device__ __noinline__ void store_bias_share(__nv_bfloat16* y,
                                              const float* bias,
                                              const int* extent, int c_out,
                                              int length, int pad,
                                              const Share* sh, int i,
                                              int parts, int t) {
  const int co_tiles = (c_out + TN - 1) / TN;
  const Rows r{extent, length, pad, co_tiles};
  const int64_t biases = sh->b1 - sh->b0;
  const int from = sh->b0 + (int)(i * biases / parts);
  const int to = sh->b0 + (int)((i + 1) * biases / parts);
  Cursor c = sh->bias;
  for (int gb = from; gb < to; ++gb) {
    seek<TL, true>(r, c, gb);
    store_bias_bf16<TL>(y, bias, c_out, length, c.seg / co_tiles,
                        c.seg % co_tiles,
                        (length + TL - 1) / TL - c.count + gb - c.base, t);
  }
}

// The CTA's share of computed tiles (list indices [w0, w1), each a column
// tile of a segment), C_in in stages of CKB channels through SB stage
// buffers. Producer iteration q activates stage q into buffer q % SB while
// the copy engine brings stage q + 1's weights into the next buffer and
// cp.async the raw inputs RB - 1 stages ahead; the consumers multiply stage
// q - 1 meanwhile. Consumer warpgroup g takes output channels 64 g of the
// tile's 128, all TL columns. With ``carry`` every tile after the first of
// its segment in the share takes its left 2 pad rows from the carry
// buffer. RAGGED: the share may span segments, and each tile's place comes
// from the share's cursors; the consumers also store the share's bias
// tiles, a part after each computed tile's epilogue (all first in a share
// without any), while they would wait for the producers. Else one
// segment's run of tiles, placed by the CTA's index as without extents.
// The consumers hold no cursor across the MMAs, whose n256 sums take all
// but a few of their registers, and the producers, which set the pace,
// hold none at all.
template <int TL, bool RAGGED>
__device__ __forceinline__ void pipeline_bf16(const ArgsB& a, const Share& sh,
                                              int tiles, uint32_t* carry,
                                              int4* tiles_s) {
  constexpr int HW = rows_b(TL);
  extern __shared__ __align__(128) uint32_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + SB;
  uint32_t* stage0 = smem + BAR_WORDS;
  const int co_tiles = (a.c_out + TN - 1) / TN;
  const int halo = 2 * a.pad;
  const int stages = a.stages;  // per tile
  const int words = stage_words_bf16(TL, a.k);
  const int n = (sh.w1 - sh.w0) * stages;

  if (threadIdx.x >= CONSUMERS_B) {  // ---- producers
    const int p = threadIdx.x - CONSUMERS_B;
    uint32_t* raw0 = stage0 + SB * words;
    // each start commits one cp.async group, an empty one past the last
    // stage, so every wait is a constant
    auto start_raw = [&](int q, int4 t) {
      if (q >= n) return commit_group();
      start_raw_bf16<TL>(a, t.x, (q % stages) * CKB, t.z, t.w & 0xFFFF,
                         TL + halo, p, raw0 + (q % RB) * raw_words_bf16(TL));
    };
    auto start_weights = [&](int q, int co_tile) {
      if (p == 0)
        start_weights_bf16(a, co_tile, q % stages, stage0 + (q % SB) * words,
                           &full[q % SB]);
    };
    // the tile of stage q: RAGGED, from tiles_s, where producer 0 places
    // each tile of the share one barrier before any producer reads it (the
    // tile of stage q + RB at stage q, whose raw inputs the next stage
    // starts; a stage's tile is read before the wait, so no shared-memory
    // load lies between a barrier and the copies it lets go); else by the
    // CTA's index, a run of tiles from blockIdx.x * tiles, as without
    // extents
    const int tile0 = blockIdx.x * tiles, tile_end = tile0 + sh.w1 - sh.w0;
    auto tile_of = [&](int q) {
      if constexpr (RAGGED) return tiles_s[(q / stages) % TILES_S];
      const int tile = tile0 + q / stages;
      return make_int4(
          blockIdx.z, blockIdx.y, tile * TL - a.pad,
          (tile == tile0 || carry == nullptr ? 0 : halo) |
              (carry != nullptr && tile + 1 < tile_end ? 1 << 16 : 0));
    };
    if (RAGGED) {
      if (p == 0)
        for (int j = 0; j < RB && j < n; ++j)
          if (j % stages == 0)
            describe_tile<TL>(a.extent, a.length, a.pad, co_tiles, &sh,
                              carry != nullptr, j / stages, tiles_s);
      bar_sync(RAW_B, PRODUCERS_B);
    }
    for (int j = 0; j < RB - 1; ++j) start_raw(j, tile_of(j));
    if (n > 0) start_weights(0, tile_of(0).y);
    for (int q = 0; q < n; ++q) {
      const int s = q % SB;
      const int st = q % stages;
      const int ci0 = st * CKB;
      // the tiles of stages q, q + 1 (weights) and q + RB - 1 (raw inputs)
      const int4 t = tile_of(q), t_raw = tile_of(q + RB - 1);
      const int w_co = tile_of(q + 1).y;
      if (RAGGED && p == 0 && q + RB < n && (q + RB) % stages == 0)
        describe_tile<TL>(a.extent, a.length, a.pad, co_tiles, &sh,
                          carry != nullptr, (q + RB) / stages, tiles_s);
      wait_groups<RB - 2>();  // raw q landed (RB - 2 groups since)
      bar_sync(RAW_B, PRODUCERS_B);  // and raw q - 1's buffer is free
      start_raw(q + RB - 1, t_raw);
      if (q + 1 < n) {
        // stage q + 1 goes to buffer (q + 1) % SB once every consumer warp
        // is done with that buffer's stage, q + 1 - SB
        if (q + 1 >= SB) mbar_wait(&empty[(q + 1) % SB], ((q + 1) / SB - 1) & 1);
        start_weights(q + 1, w_co);
      }
      uint32_t* win = stage0 + s * words + a.k * W_TAP_WORDS;
      const int row_lo = t.w & 0xFFFF;
      if (row_lo > 0) carry_rows_bf16<TL>(a, ci0, 0, true, p, win, carry);
      activate_bf16<TL>(a, t.x, ci0, t.z, row_lo, TL + halo, p,
                        raw0 + (q % RB) * raw_words_bf16(TL), win);
      if (t.w >> 16) {
        // rows [TL, TL + 2 pad) are the next tile's left halo
        bar_sync(RAW_B, PRODUCERS_B);
        carry_rows_bf16<TL>(a, ci0, TL, false, p, win, carry);
      }
      // generic-proxy writes, visible to the tensor cores' async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[s]);
    }
    wait_groups<0>();
    if (p == 0) {
      atomicAdd(&conv_tally_bf16[0], (unsigned long long)(sh.w1 - sh.w0));
      if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
        atomicAdd(&conv_tally_bf16[1], (unsigned long long)a.batch *
                                           co_tiles * ((a.length + TL - 1) /
                                                       TL));
    }
    return;
  }

  // ---- consumers: the warpgroup index as a warp-uniform value keeps the
  // descriptors in uniform registers
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;
  float acc[TL / 2];
  int q = 0;
  // RAGGED: the share's bias tiles, a part after each computed tile's
  // epilogue (all at once in a share without any), while the producers
  // prepare the next tile
  if (RAGGED && sh.w0 == sh.w1 && sh.b0 < sh.b1)
    store_bias_share<TL>(a.y, a.bias, a.extent, a.c_out, a.length, a.pad, &sh,
                         0, 1, threadIdx.x);
  for (int w = sh.w0; w < sh.w1; ++w) {
#pragma unroll
    for (int i = 0; i < TL / 2; ++i) acc[i] = 0.f;
    for (int st = 0; st < stages; ++st, ++q) {
      const int s = q % SB;
      const uint32_t* w_op = stage0 + s * words;
      // tap t: A one tap (4 KB) on, B t d rows (16 bytes each) on; the
      // descriptors' address field counts 16 bytes
      uint64_t ad = smem_desc(w_op + 64 * g * 4, TN * 16);
      uint64_t bd = smem_desc(w_op + a.k * W_TAP_WORDS, HW * 16);
      mbar_wait(&full[s], (q / SB) & 1);  // stage q is in buffer s
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int t = 0; t < a.k; ++t) {
        wgmma_bf16<TL>(acc, ad, bd);
        ad += W_TAP_WORDS / 4;
        bd += a.dilation;
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (st > 0) {  // stage q - 1's MMAs are done: release its buffer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[(q - 1) % SB]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(q - 1) % SB]);  // the tile's last stage
    // where the tile lies: RAGGED, found from the share's start (nothing of
    // it is held across the MMAs)
    int tile = blockIdx.x * tiles + w - sh.w0, b = blockIdx.z,
        co_tile = blockIdx.y;
    if constexpr (RAGGED) {
      Cursor c = sh.work;
      seek<TL, false>(rows_of(a), c, w);
      tile = w - c.base;
      b = c.seg / co_tiles;
      co_tile = c.seg % co_tiles;
    }
    // accumulator layout of m64nN: warp w of the warpgroup holds rows
    // (output channels) 16 w + lane / 4 (+ 8 for e >= 2), columns 8 j +
    // 2 (lane % 4) + e % 2
    const int o0 = co_tile * TN + 64 * g + 16 * ((threadIdx.x % 128) / 32) +
                   lane / 4;
    if (a.length % 8 == 0 && (tile + 1) * TL <= a.length) {
      store_tile_bf16<TL>(a, acc, b, o0, tile * TL, lane % 4);
    } else {  // a ragged tile: column by column
      const int l0 = tile * TL + 2 * (lane % 4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + 8 * e;
        if (o >= a.c_out) continue;
        const float bias = a.bias[o];
        __nv_bfloat16* y_row = a.y + ((int64_t)b * a.c_out + o) * a.length;
#pragma unroll
        for (int j = 0; j < TL / 8; ++j) {
          const int l = l0 + 8 * j;
          if (l < a.length)
            y_row[l] = __float2bfloat16_rn(acc[4 * j + 2 * e] + bias);
          if (l + 1 < a.length)
            y_row[l + 1] = __float2bfloat16_rn(acc[4 * j + 2 * e + 1] + bias);
        }
      }
    }
    if (RAGGED && sh.b0 < sh.b1)
      store_bias_share<TL>(a.y, a.bias, a.extent, a.c_out, a.length, a.pad,
                           &sh, w - sh.w0, sh.w1 - sh.w0, threadIdx.x);
  }
}

// Each CTA finds its share (warp 0; one load of the extents), then runs
// the pipeline for a ragged share or for a run of one segment's tiles.
template <int TL>
__device__ __forceinline__ void run_bf16(const ArgsB& a, int tiles,
                                         uint32_t* carry) {
  extern __shared__ __align__(128) uint32_t smem[];
  // the share, in shared memory: read where used, it holds no registers
  // across the MMAs; and the producers' tiles in flight (pipeline_bf16)
  __shared__ Share sh;
  __shared__ int4 tiles_s[TILES_S];
  if (threadIdx.x == 32) {  // the mbarriers, while warp 0 reads the extents
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full[s], PRODUCERS_B);
      mbar_init(&full[SB + s], CONSUMERS_B / 32);  // empty[s]
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 32) {
    const Share mine = share_of<TL>(a, tiles);
    if (threadIdx.x == 0) sh = mine;
  }
  __syncthreads();
  if (sh.ragged) {
    pipeline_bf16<TL, true>(a, sh, tiles, carry, tiles_s);
  } else {
    pipeline_bf16<TL, false>(a, sh, tiles, carry, tiles_s);
  }
}

template <int TL>
__global__ void __launch_bounds__(THREADS_B, 1)
adain_snake_conv_tile_bf16_kernel(const ArgsB a, int tiles_per_cta) {
  run_bf16<TL>(a, tiles_per_cta, nullptr);
}

// tiles_per_chunk > 1: walk (the carry buffer follows the raw buffers)
template <int TL>
__global__ void __launch_bounds__(THREADS_B, 1)
adain_snake_conv_carry_bf16_kernel(const ArgsB a, int tiles_per_chunk) {
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* carry =
      tiles_per_chunk > 1 ? smem + carry_offset_bf16(TL, a.k) : nullptr;
  run_bf16<TL>(a, tiles_per_chunk, carry);
}

// The grid, with or without extents: one CTA a run of `tiles` tiles of
// each segment, about one wave.
template <int TL>
dim3 grid_bf16(const ArgsB& a, int tiles) {
  const int n_tiles = (a.length + TL - 1) / TL;
  return dim3((n_tiles + tiles - 1) / tiles, (a.c_out + TN - 1) / TN,
              a.batch);
}

template <int TL>
int launch_tile_bf16(const ArgsB& a, int tiles_per_cta, cudaStream_t stream) {
  const int smem = prepare_smem(adain_snake_conv_tile_bf16_kernel<TL>,
                                smem_bytes_bf16(TL, a.k, 0));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  adain_snake_conv_tile_bf16_kernel<TL>
      <<<grid_bf16<TL>(a, tiles_per_cta), THREADS_B, smem, stream>>>(
          a, tiles_per_cta);
  return (int)cudaGetLastError();
}

template <int TL>
int launch_carry_bf16(const ArgsB& a, int tiles_per_chunk,
                      cudaStream_t stream) {
  const int carry_words =
      tiles_per_chunk > 1 ? (a.c_in + 1) / 2 * 2 * a.pad : 0;
  const int smem = prepare_smem(adain_snake_conv_carry_bf16_kernel<TL>,
                                smem_bytes_bf16(TL, a.k, carry_words));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  adain_snake_conv_carry_bf16_kernel<TL>
      <<<grid_bf16<TL>(a, tiles_per_chunk), THREADS_B, smem, stream>>>(
          a, tiles_per_chunk);
  return (int)cudaGetLastError();
}

ArgsB make_args_bf16(const void* x, const float* mask, const float* scale,
                     const float* shift, const float* alpha, const void* w,
                     const float* bias, void* y, const int* extent, int batch,
                     int c_in, int c_out, int length, int k, int dilation) {
  return ArgsB{static_cast<const __nv_bfloat16*>(x),
               mask,
               scale,
               shift,
               alpha,
               static_cast<const __nv_bfloat16*>(w),
               bias,
               static_cast<__nv_bfloat16*>(y),
               extent,
               batch,
               c_in,
               c_out,
               length,
               k,
               dilation,
               (k - 1) * dilation / 2,
               (c_in + CKB - 1) / CKB};
}

}  // namespace

extern "C" int adain_snake_conv_f32(const float* x, const float* mask,
                                    const float* scale, const float* shift,
                                    const float* alpha, const float* w,
                                    const float* bias, float* y,
                                    uint32_t* w_split, int batch, int c_in,
                                    int c_out, int length, int k,
                                    int dilation, int tile_len,
                                    int tiles_per_cta, void* stream) {
  if (!valid(batch, c_in, c_out, length, k, dilation) || tiles_per_cta <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, mask, scale, shift, alpha, w, bias, y, w_split,
                           c_in, c_out, length, k, dilation);
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = split_weights(a, s);
  if (rc != 0) return rc;
  switch (tile_len) {
    case 64: return launch_tile<1>(a, batch, tiles_per_cta, s);
    case 128: return launch_tile<2>(a, batch, tiles_per_cta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int adain_snake_conv_carry_f32(
    const float* x, const float* mask, const float* scale, const float* shift,
    const float* alpha, const float* w, const float* bias, float* y,
    uint32_t* w_split, int batch, int c_in, int c_out, int length, int k,
    int dilation, int tile_len, int tiles_per_chunk, void* stream) {
  if (!valid(batch, c_in, c_out, length, k, dilation) || tiles_per_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, mask, scale, shift, alpha, w, bias, y, w_split,
                           c_in, c_out, length, k, dilation);
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = split_weights(a, s);
  if (rc != 0) return rc;
  switch (tile_len) {
    case 64: return launch_carry<1>(a, batch, tiles_per_chunk, s);
    case 128: return launch_carry<2>(a, batch, tiles_per_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 forms: x and y bfloat16, w stage-packed bfloat16 ([C_out / 128]
// [C_in / 16][k][2][128][8], 16-byte aligned), the rest f32. No scratch.
// With extent [B] (the rows' mask extents) a launch computes only the
// tiles each row's extent reaches, spread over its grid (see run_bf16);
// null: every tile. tiles_per_cta / tiles_per_chunk give the grid, one CTA
// a run of that many tiles of each (row, output-channel tile), either way.
static bool valid_plan(const int* extent, int batch, int c_out, int length,
                       int tile_len) {
  const int64_t tiles = (int64_t)batch * ((c_out + TN - 1) / TN) *
                        ((length + tile_len - 1) / tile_len);
  return extent == nullptr || tiles < INT32_MAX;
}

extern "C" int adain_snake_conv_bf16(const void* x, const float* mask,
                                     const float* scale, const float* shift,
                                     const float* alpha, const void* w,
                                     const float* bias, void* y, int batch,
                                     int c_in, int c_out, int length, int k,
                                     int dilation, int tile_len,
                                     int tiles_per_cta, const int* extent,
                                     void* stream) {
  if (!valid(batch, c_in, c_out, length, k, dilation) || tiles_per_cta <= 0 ||
      tile_len <= 0 || !valid_plan(extent, batch, c_out, length, tile_len))
    return (int)cudaErrorInvalidValue;
  const ArgsB a = make_args_bf16(x, mask, scale, shift, alpha, w, bias, y,
                                 extent, batch, c_in, c_out, length, k,
                                 dilation);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_len) {
    case 64: return launch_tile_bf16<64>(a, tiles_per_cta, s);
    case 128: return launch_tile_bf16<128>(a, tiles_per_cta, s);
    case 256: return launch_tile_bf16<256>(a, tiles_per_cta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int adain_snake_conv_carry_bf16(
    const void* x, const float* mask, const float* scale, const float* shift,
    const float* alpha, const void* w, const float* bias, void* y, int batch,
    int c_in, int c_out, int length, int k, int dilation, int tile_len,
    int tiles_per_chunk, const int* extent, void* stream) {
  if (!valid(batch, c_in, c_out, length, k, dilation) ||
      tiles_per_chunk <= 0 || tile_len <= 0 ||
      !valid_plan(extent, batch, c_out, length, tile_len))
    return (int)cudaErrorInvalidValue;
  const ArgsB a = make_args_bf16(x, mask, scale, shift, alpha, w, bias, y,
                                 extent, batch, c_in, c_out, length, k,
                                 dilation);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_len) {
    case 64: return launch_carry_bf16<64>(a, tiles_per_chunk, s);
    case 128: return launch_carry_bf16<128>(a, tiles_per_chunk, s);
    case 256: return launch_carry_bf16<256>(a, tiles_per_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tally of the bf16 kernels' column tiles on the current device: out[0]
// computed, out[1] of the launches' whole grids, since the module loaded.
// Copied on `stream` (the caller's own, which should wait for no other
// work), then waited for.
extern "C" int adain_snake_conv_tally(unsigned long long* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemcpyFromSymbolAsync(
      out, conv_tally_bf16, sizeof(conv_tally_bf16), 0,
      cudaMemcpyDeviceToHost, s);
  const cudaError_t done = cudaStreamSynchronize(s);
  return (int)(err != cudaSuccess ? err : done);
}

// Dynamic shared memory of a launch in bytes (0 when it does not fit):
// the wrapper's chunk choice checks its own formula against this one.
extern "C" int adain_snake_conv_smem_bytes(int tile_len, int k,
                                           int carry_words) {
  const int bytes = smem_bytes(tile_len, k, carry_words);
  return bytes <= MAX_SMEM ? bytes : 0;
}

extern "C" int adain_snake_conv_smem_bytes_bf16(int tile_len, int k,
                                                int carry_words) {
  const int bytes = smem_bytes_bf16(tile_len, k, carry_words);
  return bytes <= MAX_SMEM ? bytes : 0;
}

// Words of the split-weight scratch a launch needs.
extern "C" int64_t adain_snake_conv_split_words(int c_in, int c_out, int k) {
  return split_words(c_in, c_out, k);
}

// {largest column tile, output channels per tile, largest k, largest pad}:
// the wrapper checks its own constants against these.
extern "C" void adain_snake_conv_geometry(int* out) {
  out[0] = TLMAX;
  out[1] = TN;
  out[2] = KMAX;
  out[3] = PADMAX;
}

// The bf16 forms': {largest column tile, input channels per stage, bytes of
// one tap of a stage's packed weights}.
extern "C" void adain_snake_conv_geometry_bf16(int* out) {
  out[0] = TLB_MAX;
  out[1] = CKB;
  out[2] = W_TAP_WORDS * 4;
}
