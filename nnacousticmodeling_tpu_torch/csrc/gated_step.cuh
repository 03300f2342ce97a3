// Step kernels of the gated recurrences (GRU, and the minimal GRU with or
// without its reset gate) for Hopper (sm_90a): gated_scan.cu's forward
// (one or two launches a step) and the product loop of gated_train.cu's
// backward. The training forward runs gated_persistent.cuh's persistent
// recurrence instead, which sums on the tensor cores in another order, so
// the two forwards agree within the recurrence tolerance, not bit for
// bit. The elementwise arithmetic, pinned with round-to-nearest
// intrinsics, is gated_persistent.cuh's.
//
// kind 0 = gru: proj (B, 3H) packs [r, z, c], w1 = wh_rz (H, 2H) [r | z],
//               w2 = wh_c (H, H) applied to r*h, candidate tanh;
// kind 1 = mgru_r: proj [z, c, r], w1 = [u_z | u_r], w2 = u on r*h;
// kind 2 = mgru: proj (B, 2H) [z, c], w1 = [u_z | u], no w2.
// All kinds: h' = z*hb + (1-z)*h (Chainer's z gates the candidate).
// act (the mgru candidate; the gru wrapper passes tanh): 0 tanh, 1 relu,
// 2 sigmoid.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gated_persistent.cuh"

namespace gated {
namespace {

using gated_persistent::ACT_RELU;
using gated_persistent::ACT_SIGMOID;
using gated_persistent::KIND_GRU;
using gated_persistent::KIND_MGRU;
using gated_persistent::activate;
using gated_persistent::interpolate;
using lstm_persistent::sigmoidf;
using lstm_persistent::store_out;

constexpr int TB = 32;        // batch rows per block
constexpr int TJ = 32;        // hidden units per block
constexpr int KC = 32;        // reduction chunk held in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 2 rows x 2 units

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float load_as_bf16(const float* p) {
  return bf16_round(*p);
}

__device__ __forceinline__ float load_as_bf16(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// acc[r][u][g] += sum_k bf16(a[b0 + tr + r, k]) * w[k, g*H + j0 + tu + u]
// over k < H, for a (B, H) and w (H, NG*H) bf16; f32 FMAs of bf16
// operands from shared-memory tiles (lstm_scan.cu's loop).
template <int NG, typename TA>
__device__ __forceinline__ void fwd_product(
    const TA* __restrict__ a, const __nv_bfloat16* __restrict__ w, int B,
    int H, int b0, int j0, float (*a_sm)[KC + 1], float (*w_sm)[NG * TJ],
    float (&acc)[2][2][NG]) {
  const int tid = threadIdx.x;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  const size_t ldw = (size_t)NG * H;
  for (int k0 = 0; k0 < H; k0 += KC) {
    for (int e = tid; e < TB * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int b = b0 + r, kk = k0 + k;
      a_sm[r][k] = (b < B && kk < H) ? load_as_bf16(a + (size_t)b * H + kk)
                                     : 0.0f;
    }
    for (int e = tid; e < KC * NG * TJ; e += THREADS) {
      const int k = e / (NG * TJ), col = e % (NG * TJ);
      const int g = col / TJ, u = col % TJ;
      const int kk = k0 + k, jj = j0 + u;
      w_sm[k][col] = (kk < H && jj < H)
          ? __bfloat162float(w[(size_t)kk * ldw + (size_t)g * H + jj])
          : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float a0 = a_sm[tr][k];
      const float a1 = a_sm[tr + 1][k];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float2 wv = *reinterpret_cast<const float2*>(
            &w_sm[k][g * TJ + tu]);
        acc[0][0][g] = fmaf(a0, wv.x, acc[0][0][g]);
        acc[0][1][g] = fmaf(a0, wv.y, acc[0][1][g]);
        acc[1][0][g] = fmaf(a1, wv.x, acc[1][0][g]);
        acc[1][1][g] = fmaf(a1, wv.y, acc[1][1][g]);
      }
    }
    __syncthreads();
  }
}

// acc[r][u] += sum_{n<N} a[(b0 + tr + r) * lda + n] * w[(k0u + tu + u) * N
// + n] for a (B, lda) bf16 (its first N columns read) and w (H, N) bf16:
// the product with w^T, reading w by rows, as the gated backward kernels
// (gated_train.cu) form their dh tiles.
__device__ __forceinline__ void bwd_product(
    const __nv_bfloat16* __restrict__ a, int lda,
    const __nv_bfloat16* __restrict__ w, int N, int B, int H, int b0,
    int k0u, float (*a_sm)[KC + 1], float (*w_sm)[KC + 1],
    float (&acc)[2][2]) {
  const int tid = threadIdx.x;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int e = tid; e < TB * KC; e += THREADS) {
      const int r = e / KC, n = e % KC;
      const int b = b0 + r, nn = n0 + n;
      a_sm[r][n] = (b < B && nn < N)
          ? __bfloat162float(a[(size_t)b * lda + nn]) : 0.0f;
    }
    for (int e = tid; e < TJ * KC; e += THREADS) {
      const int u = e / KC, n = e % KC;
      const int k = k0u + u, nn = n0 + n;
      w_sm[u][n] = (k < H && nn < N)
          ? __bfloat162float(w[(size_t)k * N + nn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < KC; ++n) {
      const float d0 = a_sm[tr][n];
      const float d1 = a_sm[tr + 1][n];
      const float w0 = w_sm[tu][n];
      const float w1 = w_sm[tu + 1][n];
      acc[0][0] = fmaf(d0, w0, acc[0][0]);
      acc[0][1] = fmaf(d0, w1, acc[0][1]);
      acc[1][0] = fmaf(d1, w0, acc[1][0]);
      acc[1][1] = fmaf(d1, w1, acc[1][1]);
    }
    __syncthreads();
  }
}

// gru / mgru_r, first launch of a step: r and z of this block's units
// from h @ w1, then bf16(r*h) and z to scratch for the second launch.
template <typename TP>
__global__ void __launch_bounds__(THREADS)
gated_rz_step(const TP* __restrict__ proj_t,            // (B, 3H)
              const __nv_bfloat16* __restrict__ w1,     // (H, 2H)
              const float* __restrict__ h_in,           // (B, H)
              __nv_bfloat16* __restrict__ rh,           // (B, H) out
              float* __restrict__ zbuf,                 // (B, H) out
              int B, int H, int kind) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ __align__(8) float w_sm[KC][2 * TJ];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2][2] = {};
  fwd_product<2>(h_in, w1, B, H, b0, j0, a_sm, w_sm, acc);

  const bool gru = kind == KIND_GRU;
  const size_t off_r = gru ? 0 : 2 * (size_t)H;
  const size_t off_z = gru ? (size_t)H : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, j = j0 + tu + u;
      if (b >= B || j >= H) continue;
      const TP* pr = proj_t + (size_t)b * 3 * H;
      // w1 is [r | z] for gru, [z | r] for mgru_r
      const float m_r = gru ? acc[r][u][0] : acc[r][u][1];
      const float m_z = gru ? acc[r][u][1] : acc[r][u][0];
      const float rg = sigmoidf(__fadd_rn(load_as_bf16(pr + off_r + j), m_r));
      const float zg = sigmoidf(__fadd_rn(load_as_bf16(pr + off_z + j), m_z));
      const size_t idx = (size_t)b * H + j;
      rh[idx] = __float2bfloat16(__fmul_rn(rg, h_in[idx]));
      zbuf[idx] = zg;
    }
  }
}

// gru / mgru_r, second launch: the candidate from bf16(r*h) @ w2, then
// h' for this block's units.
template <typename TP>
__global__ void __launch_bounds__(THREADS)
gated_cand_step(const TP* __restrict__ proj_t,           // (B, 3H)
                const __nv_bfloat16* __restrict__ w2,    // (H, H)
                const __nv_bfloat16* __restrict__ rh,    // (B, H)
                const float* __restrict__ zbuf,          // (B, H)
                const float* __restrict__ h_in,          // (B, H)
                float* __restrict__ h_out,               // (B, H)
                TP* __restrict__ hs_t,                   // (B, H)
                int B, int H, int kind, int act) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ __align__(8) float w_sm[KC][TJ];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2][1] = {};
  fwd_product<1>(rh, w2, B, H, b0, j0, a_sm, w_sm, acc);

  const size_t off_c = (kind == KIND_GRU) ? 2 * (size_t)H : (size_t)H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, j = j0 + tu + u;
      if (b >= B || j >= H) continue;
      const TP* pr = proj_t + (size_t)b * 3 * H;
      const float hb = activate(
          act, __fadd_rn(load_as_bf16(pr + off_c + j), acc[r][u][0]));
      const size_t idx = (size_t)b * H + j;
      const float hn = interpolate(zbuf[idx], hb, h_in[idx]);
      h_out[idx] = hn;
      store_out(hs_t + idx, hn);
    }
  }
}

// mgru (no reset gate): one launch a step, z and the candidate from one
// product h @ [u_z | u].
template <typename TP>
__global__ void __launch_bounds__(THREADS)
gated_mgru_step(const TP* __restrict__ proj_t,           // (B, 2H)
                const __nv_bfloat16* __restrict__ w1,    // (H, 2H)
                const float* __restrict__ h_in,          // (B, H)
                float* __restrict__ h_out,               // (B, H)
                TP* __restrict__ hs_t,                   // (B, H)
                int B, int H, int act) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ __align__(8) float w_sm[KC][2 * TJ];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2][2] = {};
  fwd_product<2>(h_in, w1, B, H, b0, j0, a_sm, w_sm, acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, j = j0 + tu + u;
      if (b >= B || j >= H) continue;
      const TP* pr = proj_t + (size_t)b * 2 * H;
      const float zg = sigmoidf(__fadd_rn(load_as_bf16(pr + j), acc[r][u][0]));
      const float hb = activate(
          act, __fadd_rn(load_as_bf16(pr + H + j), acc[r][u][1]));
      const size_t idx = (size_t)b * H + j;
      const float hn = interpolate(zg, hb, h_in[idx]);
      h_out[idx] = hn;
      store_out(hs_t + idx, hn);
    }
  }
}

// The whole sequence: one launch a step for mgru, two for gru / mgru_r
// (the second product needs r*h of every unit). h ping-pongs between
// h_a (holding h0) and h_b; after the call h_T is in h_a when T is even,
// else in h_b. rh (B, H) bf16 and zbuf (B, H) f32 are scratch (unused,
// may be null, for mgru).
template <typename TP>
int run_gated_fwd(const TP* proj, const __nv_bfloat16* w1,
                  const __nv_bfloat16* w2, float* h_a, float* h_b,
                  __nv_bfloat16* rh, float* zbuf, TP* hs, int T, int B,
                  int H, int kind, int act, cudaStream_t stream) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  const int gp = (kind == KIND_MGRU) ? 2 : 3;
  const size_t step_in = (size_t)B * gp * H;
  const size_t step_out = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = (t % 2 == 0) ? h_a : h_b;
    float* h_out = (t % 2 == 0) ? h_b : h_a;
    if (kind == KIND_MGRU) {
      gated_mgru_step<TP><<<grid, THREADS, 0, stream>>>(
          proj + t * step_in, w1, h_in, h_out, hs + t * step_out, B, H, act);
    } else {
      gated_rz_step<TP><<<grid, THREADS, 0, stream>>>(
          proj + t * step_in, w1, h_in, rh, zbuf, B, H, kind);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      gated_cand_step<TP><<<grid, THREADS, 0, stream>>>(
          proj + t * step_in, w2, rh, zbuf, h_in, h_out, hs + t * step_out,
          B, H, kind, act);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gated
