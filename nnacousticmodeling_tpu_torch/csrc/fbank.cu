// Log-mel filter bank of a waveform, for Hopper (sm_90a).
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/features.py
// fbank_pallas (:210; pallas_call at :241): per 25 ms frame, the Povey
// window, the 512-point power spectrum, the mel product and
// log(max(., EPS)). The TPU kernel takes frames that frame_signal cut and
// preemphasised outside, and computes the spectrum as two dense 400 x 257
// DFT products on its matrix unit (411 of its ~432 kFLOP a frame).
//
// What bounds it on this card: bytes. The function's least work is a
// 512-point real FFT, the window, the power, the mel bands' ~0.5 k
// nonzeros and 40 logs, ~14 kFLOP a frame, against (160 + 40) x 4 B a
// frame read from the waveform and written: at 67 TFLOP/s float32 and
// 3.35 TB/s the bytes take about as long as the operations. What a frame
// costs beyond both is traffic through the SM's shared memory and L1 (one
// 128-byte wavefront a cycle), and the latency of the steps that hand
// values from thread to thread.
//
// What this design does about it.
// * Framing is fused: a block of FRAMES frames reads the samples its
//   frames span, HOP * (FRAMES - 1) + FRAME_LEN of them, once and
//   coalesced into shared memory, and applies frame_signal's per-frame
//   preemphasis (x[n] - 0.97 x[n-1], the first sample minus itself) and
//   the window with __fmul_rn / __fsub_rn, so the frames the FFT sees are
//   bit-equal to PyTorch's frame_signal(x) * win. The frames entry reads
//   already-preemphasised rows instead and runs the same body.
// * The DFT is a real FFT on the CUDA cores in float32: the 400 windowed
//   samples, zero-padded to 512, are packed as 256 complex values
//   z[n] = y[2n] + i y[2n+1], whose 256-point FFT is taken as 16 x 16
//   (four-step): 16 threads a frame, each first a 16-point DFT of
//   z[16 n1 + t] in registers (two radix-4 levels), times W256^(t k1);
//   one transpose through a padded 16 x 17 tile in shared memory; then
//   each a second 16-point DFT, which leaves Z[t + 16 k2] in thread t. So
//   the four radix-4 stages cross shared memory once, not four times. The
//   split step X[k] = (Z[k] + conj Z[256-k]) / 2 + W512^k (Z[k] -
//   conj Z[256-k]) / 2i takes Z[256-k] from thread 16 - t by a shuffle.
//   Twiddles are exp(-2 pi i e / 512), computed on the host in float64
//   and rounded to float32 once; the pass-1 twiddles W256^(t k1) are a
//   copy of those entries laid out [k1][t], so a warp's load is one line.
// * The mel product sums each filter's band only, in ascending bin order
//   with fmaf: the dense fmaf chain's sum, since fmaf(p, 0, acc) == acc.
//   The host packs the 40 bands into 16 lanes' term lists of about equal
//   length (~31 terms), laid out [term][lane] so that a warp's load of
//   them is one line. logf, not __logf.
// * Blocks are small (FRAMES = 4 frames, 64 threads, at most 80 registers
//   a thread so that 12 blocks fit an SM), so one ~392-frame utterance
//   spreads over ~98 SMs.
// No tensor cores and no TF32 / bf16: the 1e-3 log-domain gate leaves no
// room for them without a tolerance study.
//
// Measurement knobs (bench_fbank.py builds them; values are wrong, times
// only): FBANK_LEAVE_OUT bit 1 leaves out the mel sums (each band's first
// term only), bit 2 the second pass and the split step (the power is that
// of the pass-1 tile), bit 4 everything after the staged samples.

#include <cuda_runtime.h>
#include <math.h>

#ifndef FBANK_LEAVE_OUT
#define FBANK_LEAVE_OUT 0
#endif

namespace {

constexpr int FRAME_LEN = 400;
constexpr int HOP = 160;
constexpr int NC = 256;             // complex FFT length: nfft / 2
constexpr int NMEL = 40;
constexpr int LANES = 16;           // threads a frame
constexpr int FRAMES = 4;           // frames a block
constexpr int THREADS = LANES * FRAMES;
// the samples a block stages: its frames' span, or its rows
__host__ __device__ constexpr int staged(bool wave) {
  return wave ? HOP * (FRAMES - 1) + FRAME_LEN : FRAMES * FRAME_LEN;
}
constexpr int ROW = LANES + 1;      // padded row of the transpose tile
// a frame's tile, 8 float2 longer than 16 rows so that the two frames of a
// warp lie 16 banks apart
constexpr int TILE = LANES * ROW + 8;
constexpr int MEL_AT = 264;         // the band sums' offset in the tile, floats
constexpr int MEL_CHUNK = 8;        // mel terms gathered at a time
constexpr int MIN_BLOCKS = 12;      // resident blocks an SM: <= 80 registers
constexpr float PREEMPH = 0.97f;
constexpr float EPS = 1.1921e-07f;

static_assert(NC + 1 <= MEL_AT && MEL_AT + NMEL <= 2 * TILE, "tile room");

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -__fmul_rn(a.y, w.y)),
                     fmaf(a.x, w.y, __fmul_rn(a.y, w.x)));
}

// y_q = sum_m x_m W4^(m q), W4 = -i
__device__ __forceinline__ void radix4(float2 x0, float2 x1, float2 x2,
                                       float2 x3, float2& y0, float2& y1,
                                       float2& y2, float2& y3) {
  const float2 t0 = make_float2(x0.x + x2.x, x0.y + x2.y);
  const float2 t1 = make_float2(x0.x - x2.x, x0.y - x2.y);
  const float2 t2 = make_float2(x1.x + x3.x, x1.y + x3.y);
  const float2 t3 = make_float2(x1.x - x3.x, x1.y - x3.y);
  y0 = make_float2(t0.x + t2.x, t0.y + t2.y);
  y1 = make_float2(t1.x + t3.y, t1.y - t3.x);
  y2 = make_float2(t0.x - t2.x, t0.y - t2.y);
  y3 = make_float2(t1.x - t3.y, t1.y + t3.x);
}

// In place: a[k] = sum_n a[n] W16^(n k), as two radix-4 levels: n = 4p + q,
// k = r + 4s; the inner DFTs over p, twiddles W16^(q r) = tw[32 q r], the
// outer DFTs over q.
__device__ __forceinline__ void dft16(float2 (&a)[16],
                                      const float2* __restrict__ tw) {
  float2 u[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    radix4(a[q], a[4 + q], a[8 + q], a[12 + q], u[q][0], u[q][1], u[q][2],
           u[q][3]);
#pragma unroll
  for (int q = 1; q < 4; ++q)
#pragma unroll
    for (int r = 1; r < 4; ++r) u[q][r] = cmul(u[q][r], __ldg(tw + 32 * q * r));
#pragma unroll
  for (int r = 0; r < 4; ++r)
    radix4(u[0][r], u[1][r], u[2][r], u[3][r], a[r], a[r + 4], a[r + 8],
           a[r + 12]);
}

// Frame f of the block, staged in xs -> its 40 log-mel energies at o; run
// by the frame's 16 threads (lane t). Both halves of a warp run it, so
// that shuffles and warp syncs take the whole warp; an absent frame's
// (not valid) computes on stale samples and stores nothing.
template <bool WAVE>
__device__ __forceinline__ void frame(const float* xs, float2* tl, int f,
                                      int t, bool valid,
                                      const float* __restrict__ win,
                                      const float2* __restrict__ tw,
                                      const float2* __restrict__ tw1,
                                      const int2* __restrict__ terms, int L,
                                      float* __restrict__ o) {
#if FBANK_LEAVE_OUT & 4
  for (int m = t; m < NMEL && valid; m += LANES) o[m] = xs[HOP * f + m];
  return;
#endif
  // pass 1: a[n1] = z[16 n1 + t], i.e. windowed samples 32 n1 + 2t, +1;
  // zero from sample 400 on (n1 >= 13, or n1 = 12 and t >= 8)
  const float* x = WAVE ? xs + HOP * f : xs + FRAME_LEN * f;
  float2 a[16];
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) {
    const int p = 32 * n1 + 2 * t;
    if (n1 < 13 && p < FRAME_LEN) {
      const float2 v = *reinterpret_cast<const float2*>(x + p);
      const float2 w = __ldg(reinterpret_cast<const float2*>(win + p));
      float2 y = v;
      if (WAVE) {
        const float prev = x[p > 0 ? p - 1 : 0];
        y = make_float2(__fsub_rn(v.x, __fmul_rn(PREEMPH, prev)),
                        __fsub_rn(v.y, __fmul_rn(PREEMPH, v.x)));
      }
      a[n1] = make_float2(__fmul_rn(y.x, w.x), __fmul_rn(y.y, w.y));
    } else {
      a[n1] = make_float2(0.0f, 0.0f);
    }
  }
  dft16(a, tw);
  tl[t] = a[0];
#pragma unroll
  for (int k1 = 1; k1 < 16; ++k1)
    tl[k1 * ROW + t] = cmul(a[k1], __ldg(tw1 + LANES * k1 + t));
  __syncwarp();

  // pass 2: thread t takes row k1 = t; a[k2] = Z[t + 16 k2]
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) a[n2] = tl[t * ROW + n2];
#if !(FBANK_LEAVE_OUT & 2)
  dft16(a, tw);
#endif
  __syncwarp();

  // split step, bins k = t + 16 k2 < 128 with their partners 256 - k:
  // S = Z[k] + conj Z[256-k], D = Z[k] - conj Z[256-k], W = W512^k;
  // X[k] = (S - i W D) / 2, X[256-k] = (conj S - i conj(W D)) / 2
  float* pw = reinterpret_cast<float*>(tl);
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    const int k = t + 16 * k2;
    const float2 z = a[k2];
#if FBANK_LEAVE_OUT & 2
    pw[k] = z.x * z.x + z.y * z.y;
    pw[NC - k] = z.y;
#else
    // Z[256 - k] lies in thread 16 - t as its entry 15 - k2; thread 0's
    // partner is itself, entry 16 - k2
    float2 r = make_float2(
        __shfl_sync(0xffffffffu, a[15 - k2].x, (LANES - t) % LANES, LANES),
        __shfl_sync(0xffffffffu, a[15 - k2].y, (LANES - t) % LANES, LANES));
    if (t == 0) r = a[(16 - k2) % 16];
    if (k == 0) {                       // X[0], X[256] from Z[0]
      const float x0 = z.x + z.y, x256 = z.x - z.y;
      pw[0] = x0 * x0;
      pw[NC] = x256 * x256;
    } else {
      const float2 sum = make_float2(z.x + r.x, z.y - r.y);
      const float2 wd = cmul(make_float2(z.x - r.x, z.y + r.y),
                             __ldg(tw + k));
      const float xr = sum.x + wd.y, xi = sum.y - wd.x;
      const float yr = sum.x - wd.y, yi = sum.y + wd.x;
      pw[k] = 0.25f * fmaf(xr, xr, __fmul_rn(xi, xi));
      pw[NC - k] = 0.25f * fmaf(yr, yr, __fmul_rn(yi, yi));
    }
#endif
  }
  if (t == 0) {                         // X[128] = conj Z[128]
    const float2 z = a[8];
    pw[NC / 2] = fmaf(z.x, z.x, __fmul_rn(z.y, z.y));
  }
  __syncwarp();

  // mel bands: this lane's term list, each band in ascending bins
  // (code: bin | m << 9 | 1 << 15 on the band's last term), into the
  // tile; then the logs, 40 a frame, and the frame's row of the output
#if FBANK_LEAVE_OUT & 1
  for (int m = t; m < NMEL && valid; m += LANES) o[m] = pw[m];
  return;
#endif
  // 8 terms at a time: their codes and powers first, then the sums, so
  // that the gathers do not wait on the band sums' stores
  float* mel = pw + MEL_AT;
  float acc = 0.0f;
  for (int j0 = 0; j0 < L; j0 += MEL_CHUNK) {
    int2 c[MEL_CHUNK];
    float p[MEL_CHUNK];
#pragma unroll
    for (int u = 0; u < MEL_CHUNK; ++u)
      c[u] = __ldg(terms + LANES * (j0 + u) + t);
#pragma unroll
    for (int u = 0; u < MEL_CHUNK; ++u) p[u] = pw[c[u].x & 511];
#pragma unroll
    for (int u = 0; u < MEL_CHUNK; ++u) {
      acc = fmaf(p[u], __int_as_float(c[u].y), acc);
      if (c[u].x & (1 << 15)) {
        mel[(c[u].x >> 9) & 63] = acc;
        acc = 0.0f;
      }
    }
  }
  __syncwarp();
  if (valid)
    for (int m = t; m < NMEL; m += LANES) o[m] = logf(fmaxf(mel[m], EPS));
}

// Block b: frames 4b .. 4b + 3, from the samples they span (or their
// rows), staged in shared memory once.
template <bool WAVE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fbank_kernel(const float* __restrict__ src,    // waveform, or (T, 400) rows
             const float* __restrict__ win,    // (400,)
             const float2* __restrict__ tw,    // (512,) exp(-2 pi i e / 512)
             const float2* __restrict__ tw1,   // (16, 16) W256^(k1 t), [k1][t]
             const int2* __restrict__ terms,   // (L, 16) code, weight bits
             int L,                            // a multiple of MEL_CHUNK
             float* __restrict__ out,          // (T, NMEL)
             int T) {
  __shared__ __align__(16) float xs[staged(WAVE)];
  __shared__ float2 tile[FRAMES][TILE];

  const int f0 = blockIdx.x * FRAMES;
  const int nf = min(FRAMES, T - f0);
  const int n = WAVE ? HOP * (nf - 1) + FRAME_LEN : nf * FRAME_LEN;
  const float* s = src + (size_t)f0 * (WAVE ? HOP : FRAME_LEN);
  for (int e = threadIdx.x; e < n; e += THREADS) xs[e] = __ldcg(s + e);
  __syncthreads();
  const int f = threadIdx.x / LANES, t = threadIdx.x % LANES;
  frame<WAVE>(xs, tile[f], f, t, f < nf, win, tw, tw1, terms, L,
              out + (size_t)(f0 + f) * NMEL);
}

}  // namespace

// src: the waveform (from_wave != 0; at least HOP * (T - 1) + FRAME_LEN
// samples) or (T, FRAME_LEN) preemphasised rows; out (T, NMEL). blocks and
// frames_per_block are the host's plan, checked against this build.
// Returns the cudaError_t of the launch.
extern "C" int fbank_forward(const void* src, int from_wave, const void* win,
                             const void* tw, const void* tw1,
                             const void* terms, int L, void* out, int T,
                             int blocks, int frames_per_block, void* stream) {
  if (T < 0 || L < 0 || L % MEL_CHUNK || frames_per_block != FRAMES
      || blocks != (T + FRAMES - 1) / FRAMES)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const auto kernel = from_wave ? fbank_kernel<true> : fbank_kernel<false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float2*>(tw1),
      static_cast<const int2*>(terms), L, static_cast<float*>(out), T);
  return (int)cudaGetLastError();
}
