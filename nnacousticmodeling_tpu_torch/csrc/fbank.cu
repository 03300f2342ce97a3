// Log-mel filter bank of preemphasised frames, for Hopper (sm_90a).
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/features.py
// fbank_pallas (:210; pallas_call at :241): per frame, the Povey window,
// the real and imaginary DFT products (400 x 257 each), the power
// re^2 + im^2, the mel product (257 x 40) and log(max(., EPS)). Framing
// and preemphasis happen outside, as in the JAX package (frame_signal).
// All arithmetic is float32 on the CUDA cores, in another summation
// order than the plain version's products: the outputs agree within
// 1e-3 in the log domain, the JAX test's tolerance for its kernel.
//
// What bounds it on this card. Operations: ~432 kFLOP a frame (411 k of
// them the two DFT products) against 1.8 KB of frame read and 160 B
// written, so at 67 TFLOP/s float32 the work takes ~10x longer than its
// bytes at 3.35 TB/s.
//
// What this design does about it. A block takes a tile of TF frames and
// stages them, times the window, in shared memory laid out sample-major
// (xs[n][f]), so a thread reads the TF values of a sample as TF/4 float4
// broadcast loads. Each thread owns one frequency bin k and keeps the
// TF real and TF imaginary sums in registers while it streams its
// column of the cos/sin bases (2 x 411 KB, L2-resident, coalesced across
// the threads of a warp): per sample 2 global loads, TF/4 shared loads
// and 2 TF fused multiply-adds. The power goes to shared memory; the mel
// product (41 KB of weights, read through L1) and the log finish the
// tile. Tensor cores (TF32 / bf16) are later work, after a tolerance
// study.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FRAME_LEN = 400;
constexpr int NBINS = 257;          // nfft / 2 + 1
constexpr int NMEL = 40;
constexpr int TF = 16;              // frames per block
constexpr int THREADS = 288;        // >= NBINS, a whole number of warps
constexpr float EPS = 1.1921e-07f;

__global__ void __launch_bounds__(THREADS)
fbank_kernel(const float* __restrict__ frames,   // (T, FRAME_LEN)
             const float* __restrict__ win,      // (FRAME_LEN,)
             const float* __restrict__ cosb,     // (FRAME_LEN, NBINS)
             const float* __restrict__ sinb,     // (FRAME_LEN, NBINS)
             const float* __restrict__ melfb,    // (NBINS, NMEL)
             float* __restrict__ out,            // (T, NMEL)
             int T) {
  __shared__ float4 xs[FRAME_LEN][TF / 4];       // windowed, sample-major
  __shared__ float pw[TF][NBINS];                // power spectra

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * TF;
  const int nf = min(TF, T - f0);
  float* xsf = reinterpret_cast<float*>(xs);
  for (int e = tid; e < TF * FRAME_LEN; e += THREADS) {
    const int f = e / FRAME_LEN, n = e % FRAME_LEN;
    xsf[n * TF + f] =
        f < nf ? frames[(size_t)(f0 + f) * FRAME_LEN + n] * win[n] : 0.0f;
  }
  __syncthreads();

  const int k = tid;
  if (k < NBINS) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.0f;
    for (int n = 0; n < FRAME_LEN; ++n) {
      const float c = cosb[n * NBINS + k];
      const float s = sinb[n * NBINS + k];
#pragma unroll
      for (int q = 0; q < TF / 4; ++q) {
        const float4 x = xs[n][q];
        re[4 * q] = fmaf(x.x, c, re[4 * q]);
        re[4 * q + 1] = fmaf(x.y, c, re[4 * q + 1]);
        re[4 * q + 2] = fmaf(x.z, c, re[4 * q + 2]);
        re[4 * q + 3] = fmaf(x.w, c, re[4 * q + 3]);
        im[4 * q] = fmaf(x.x, s, im[4 * q]);
        im[4 * q + 1] = fmaf(x.y, s, im[4 * q + 1]);
        im[4 * q + 2] = fmaf(x.z, s, im[4 * q + 2]);
        im[4 * q + 3] = fmaf(x.w, s, im[4 * q + 3]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) pw[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int e = tid; e < nf * NMEL; e += THREADS) {
    const int f = e / NMEL, m = e % NMEL;
    float acc = 0.0f;
    for (int b = 0; b < NBINS; ++b) acc = fmaf(pw[f][b], melfb[b * NMEL + m], acc);
    out[(size_t)(f0 + f) * NMEL + m] = logf(fmaxf(acc, EPS));
  }
}

}  // namespace

// frames (T, 400) float32, preemphasised; out (T, 40). Returns the
// cudaError_t of the launch.
extern "C" int fbank_forward(const void* frames, const void* win,
                             const void* cosb, const void* sinb,
                             const void* melfb, void* out, int T,
                             void* stream) {
  if (T == 0) return 0;
  const int blocks = (T + TF - 1) / TF;
  fbank_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(win),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      static_cast<const float*>(melfb), static_cast<float*>(out), T);
  return (int)cudaGetLastError();
}
