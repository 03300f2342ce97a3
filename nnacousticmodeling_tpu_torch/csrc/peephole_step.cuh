// Step kernels of the peephole LSTM for Hopper (sm_90a), for
// peephole_scan.cu (inference) alone: the training forward runs the
// persistent recurrence of peephole_persistent.cuh instead, which sums on
// the tensor cores in another order, so the two forwards agree within
// the recurrence tolerance, not bit for bit. The cell arithmetic is
// pinned with round-to-nearest intrinsics. The tiles, the product loop
// and the rounding helpers are gated_step.cuh's.
//
// The cell (Chainer StatefulPeepholeLSTM, full (H, H) peephole matrices;
// rnn_pallas.py:1356-1369):
//
//     z   = bf16(proj[t]) + bf16(h) @ bf16(W_h)            (B, 4H)
//     a   = tanh(z_a)
//     i   = sigmoid(z_i + bf16(c) @ bf16(P_i))
//     f   = sigmoid(z_f + bf16(c) @ bf16(P_f))
//     c'  = f * c + i * a
//     o   = sigmoid(z_o + bf16(c') @ bf16(P_o))
//     h'  = o * tanh(c')
//
// with f32 accumulation, f32 gates and carry. The o-gate needs c' of
// every unit, so a step is two launches: the cell launch (h @ W_h and
// c @ [P_i | P_f], then a, i, f and c', and z_o without its peephole to
// scratch) and the output launch (c' @ P_o, then o and h'). h and c each
// ping-pong between two f32 buffers.
//
// Residual row (training only), bf16 (B, 8H), as _peep_train_fwd_impl
// writes it: [a | i | f | o | tanh c_t | c_{t-1} | h_{t-1} | c_t].

#pragma once

#include "gated_step.cuh"

namespace peep {
namespace {

using gated::KC;
using gated::TB;
using gated::THREADS;
using gated::TJ;
using gated::fwd_product;
using gated::load_as_bf16;
using gated::sigmoidf;
using gated::store_out;

// Cell launch of step t: the block's 32 units x 32 rows of h @ W_h (four
// gate columns) and c @ [P_i | P_f] (two), then the cell update.
template <typename TP>
__global__ void __launch_bounds__(THREADS)
peep_cell_step(const TP* __restrict__ proj_t,            // (B, 4H)
               const __nv_bfloat16* __restrict__ wh,     // (H, 4H)
               const __nv_bfloat16* __restrict__ pif,    // (H, 2H) [P_i|P_f]
               const float* __restrict__ h_in,           // (B, H)
               const float* __restrict__ c_in,           // (B, H)
               float* __restrict__ c_out,                // (B, H)
               float* __restrict__ zo,                   // (B, H) out
               int B, int H) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ __align__(8) float w4_sm[KC][4 * TJ];
  __shared__ __align__(8) float w2_sm[KC][2 * TJ];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2][4] = {};
  float accp[2][2][2] = {};
  fwd_product<4>(h_in, wh, B, H, b0, j0, a_sm, w4_sm, acc);
  fwd_product<2>(c_in, pif, B, H, b0, j0, a_sm, w2_sm, accp);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, j = j0 + tu + u;
      if (b >= B || j >= H) continue;
      const TP* pr = proj_t + (size_t)b * 4 * H;
      const float za = __fadd_rn(load_as_bf16(pr + j), acc[r][u][0]);
      const float zi = __fadd_rn(
          __fadd_rn(load_as_bf16(pr + H + j), acc[r][u][1]), accp[r][u][0]);
      const float zf = __fadd_rn(
          __fadd_rn(load_as_bf16(pr + 2 * H + j), acc[r][u][2]),
          accp[r][u][1]);
      const float a = tanhf(za);
      const float ig = sigmoidf(zi);
      const float f = sigmoidf(zf);
      const size_t idx = (size_t)b * H + j;
      const float cp = c_in[idx];
      const float cn = __fadd_rn(__fmul_rn(f, cp), __fmul_rn(ig, a));
      c_out[idx] = cn;
      zo[idx] = __fadd_rn(load_as_bf16(pr + 3 * H + j), acc[r][u][3]);
    }
  }
}

// Output launch of step t: bf16(c') @ P_o for the block's units, then o
// and h'.
template <typename TP>
__global__ void __launch_bounds__(THREADS)
peep_out_step(const __nv_bfloat16* __restrict__ po,      // (H, H)
              const float* __restrict__ c_new,           // (B, H)
              const float* __restrict__ zo,              // (B, H)
              float* __restrict__ h_out,                 // (B, H)
              TP* __restrict__ hs_t,                     // (B, H)
              int B, int H) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ __align__(8) float w_sm[KC][TJ];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2][1] = {};
  fwd_product<1>(c_new, po, B, H, b0, j0, a_sm, w_sm, acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, j = j0 + tu + u;
      if (b >= B || j >= H) continue;
      const size_t idx = (size_t)b * H + j;
      const float o = sigmoidf(__fadd_rn(zo[idx], acc[r][u][0]));
      const float tc = tanhf(c_new[idx]);
      const float hn = __fmul_rn(o, tc);
      h_out[idx] = hn;
      store_out(hs_t + idx, hn);
    }
  }
}

// The whole sequence, two launches a step. h ping-pongs between h_a
// (holding h0) and h_b, c between c_a (holding c0) and c_b; after the
// call h_T and c_T are in h_a / c_a when T is even, else in h_b / c_b.
// zo (B, H) f32 is scratch.
template <typename TP>
int run_peep_fwd(const TP* proj, const __nv_bfloat16* wh,
                 const __nv_bfloat16* pif, const __nv_bfloat16* po,
                 float* h_a, float* h_b, float* c_a, float* c_b, float* zo,
                 TP* hs, int T, int B, int H, cudaStream_t stream) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  const size_t step_in = (size_t)B * 4 * H;
  const size_t step_out = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const bool even = t % 2 == 0;
    const float* h_in = even ? h_a : h_b;
    float* h_out = even ? h_b : h_a;
    const float* c_in = even ? c_a : c_b;
    float* c_out = even ? c_b : c_a;
    peep_cell_step<TP><<<grid, THREADS, 0, stream>>>(
        proj + t * step_in, wh, pif, h_in, c_in, c_out, zo, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    peep_out_step<TP><<<grid, THREADS, 0, stream>>>(
        po, c_out, zo, h_out, hs + t * step_out, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace peep
