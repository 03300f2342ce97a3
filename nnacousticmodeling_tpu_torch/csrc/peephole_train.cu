// Trainable peephole LSTM recurrence for Hopper (sm_90a): the forward that
// also writes the backward's residuals, the reverse-time backward, and the
// weight-gradient contractions.
//
// Replaces the TPU kernels of nnacousticmodeling_tpu/ops/rnn_pallas.py
// behind peephole_scan_pallas_train (:1270):
//
//   peephole_train_fwd_*  <- _peep_train_fwd_impl (:992, pallas_call :1061)
//   peephole_train_bwd_*  <- _peep_train_bwd_impl (:1101, pallas_call
//   peephole_train_dw        :1221), and its dW / dPeep contractions
//                            (:1195-1208)
//
// Forward: peephole_step.cuh's step kernels (the inference kernel's code,
// so hs, c_T and h_T are bit-equal to peephole_scan.cu's) with the
// residual row bf16 [a | i | f | o | tanh c_t | c_{t-1} | h_{t-1} | c_t].
//
// Backward, per step in reverse time (the operation order of :1147-1191),
// from the bf16 residuals:
//
//     dh_tot = dhs[t] + dh;   dz_o = dh_tot * tanh c_t * o (1 - o)
//     dc = dc + dh_tot * o * (1 - tanh^2 c_t) + bf16(dz_o) @ P_o^T
//     dz_a = dc * i * (1 - a^2);  dz_i = dc * a * i (1 - i)
//     dz_f = dc * c_{t-1} * f (1 - f)
//     dc = dc * f + bf16(dz_i) @ P_i^T + bf16(dz_f) @ P_f^T
//     dh = bf16(dz) @ W_h^T
//
// dproj takes the unrounded f32 dz in proj's dtype, the products take its
// bf16 rounding. After the loop, in f32 from bf16 rows:
// dW_h = sum_t h_{t-1}^T dz, dP_i = sum_t c_{t-1}^T dz_i,
// dP_f = sum_t c_{t-1}^T dz_f, dP_o = sum_t c_t^T dz_o.
//
// What bounds them on this card. At T=20, B=128, H=1024 the forward does
// 2*T*B*H*7H = 37.6 GFLOP (0.038 ms at the bf16 tensor rate) against
// ~110 MB of proj, residuals and hs (0.033 ms at 3.35 TB/s); the
// backward with dW twice that. Both bounds sit far below the floor of
// the serial recurrence, whose steps hold two dependent groups of
// products each way (the o-gate's peephole needs c_t of every unit; in
// reverse, dc needs bf16(dz_o) @ P_o^T of every unit before dz_i and
// dz_f exist), and the weights (14 MB bf16) fit in no SM's shared memory,
// so the TPU design (W_h^T and the three peephole transposes resident
// in VMEM for all T) does not carry over.
//
// What this design does about it. Launch boundaries are the barriers.
// The backward block owns 32 hidden units k x 32 batch rows. Its first
// launch of reverse step t forms dh_t = bf16(dz_{t+1}) @ W_h^T and
// dc_t = dcbuf + bf16([dz_i | dz_f]_{t+1}) @ [P_i | P_f]^T for its tile
// (rows k of W_h, P_i and P_f are contiguous: no transposed copies), then
// dz_o and the o-part of dc; its second launch adds bf16(dz_o) @ P_o^T,
// forms dz_a, dz_i, dz_f and leaves dc * f in dcbuf, one (B, H) f32
// buffer carried from launch to launch. bf16(dz) goes to a (T, B, 4H)
// scratch that the dW contractions read after the loop. So a layer takes
// 2T+1 backward launches plus one dW launch (dw_gemm.cuh, on the tensor
// cores, the four contractions as four problems of one grid). The step
// products run on the CUDA cores as f32 FMAs of bf16 operands from
// shared-memory tiles.

#include "peephole_step.cuh"
#include "dw_gemm.cuh"

namespace peep {
namespace {

using gated::bwd_product;

// First launch of reverse step t: dh_t = bf16(dz_{t+1}) @ W_h^T and
// dc_t = dcbuf + bf16([dz_i | dz_f]_{t+1}) @ [P_i | P_f]^T (dh_init and
// dc_init when dz_next is null, i.e. t = T-1), then dz_o and dc without
// its P_o^T term into dcbuf. res_t null: no step left, dh and dc go to
// dh_out and dc_out (dh0, dc0).
template <typename TD>
__global__ void __launch_bounds__(THREADS)
peep_bwd_gate(const __nv_bfloat16* __restrict__ dz_next,  // (B, 4H)
              const __nv_bfloat16* __restrict__ wh,       // (H, 4H)
              const __nv_bfloat16* __restrict__ pif,      // (H, 2H)
              const float* __restrict__ dh_init,          // (B, H)
              const float* __restrict__ dc_init,          // (B, H)
              const float* __restrict__ dhs_t,            // (B, H)
              const __nv_bfloat16* __restrict__ res_t,    // (B, 8H)
              float* __restrict__ dcbuf,                  // (B, H) in/out
              TD* __restrict__ dproj_t,                   // (B, 4H)
              __nv_bfloat16* __restrict__ dz_t,           // (B, 4H)
              float* __restrict__ dh_out,                 // (B, H)
              float* __restrict__ dc_out,                 // (B, H)
              int B, int H) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ float w_sm[TJ][KC + 1];
  const int tid = threadIdx.x;
  const int k0u = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  const int G = 4 * H;
  float acc_h[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float acc_c[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (dz_next != nullptr) {
    bwd_product(dz_next, G, wh, G, B, H, b0, k0u, a_sm, w_sm, acc_h);
    bwd_product(dz_next + H, G, pif, 2 * H, B, H, b0, k0u, a_sm, w_sm,
                acc_c);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, k = k0u + tu + u;
      if (b >= B || k >= H) continue;
      const size_t idx = (size_t)b * H + k;
      const float dh = (dz_next != nullptr) ? acc_h[r][u] : dh_init[idx];
      const float dc = (dz_next != nullptr) ? dcbuf[idx] + acc_c[r][u]
                                            : dc_init[idx];
      if (res_t == nullptr) {
        dh_out[idx] = dh;
        dc_out[idx] = dc;
        continue;
      }
      const __nv_bfloat16* rr = res_t + (size_t)b * 8 * H + k;
      const float o = __bfloat162float(rr[3 * H]);
      const float tc = __bfloat162float(rr[4 * H]);
      const float dh_tot = dhs_t[idx] + dh;
      const float dz_o = dh_tot * tc * o * (1.0f - o);
      dcbuf[idx] = dc + dh_tot * o * (1.0f - tc * tc);
      const size_t col = (size_t)b * G + 3 * (size_t)H + k;
      store_out(dproj_t + col, dz_o);
      dz_t[col] = __float2bfloat16(dz_o);
    }
  }
}

// Second launch of reverse step t: dc += bf16(dz_o) @ P_o^T, then dz_a,
// dz_i, dz_f, and dc * f into dcbuf for the step before.
template <typename TD>
__global__ void __launch_bounds__(THREADS)
peep_bwd_cell(const __nv_bfloat16* __restrict__ po,      // (H, H)
              const __nv_bfloat16* __restrict__ res_t,   // (B, 8H)
              float* __restrict__ dcbuf,                 // (B, H) in/out
              TD* __restrict__ dproj_t,                  // (B, 4H)
              __nv_bfloat16* __restrict__ dz_t,          // (B, 4H)
              int B, int H) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ float w_sm[TJ][KC + 1];
  const int tid = threadIdx.x;
  const int k0u = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  const int G = 4 * H;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  // reads the dz_o columns; this launch writes only the a, i, f columns
  bwd_product(dz_t + 3 * H, G, po, H, B, H, b0, k0u, a_sm, w_sm, acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, k = k0u + tu + u;
      if (b >= B || k >= H) continue;
      const size_t idx = (size_t)b * H + k;
      const __nv_bfloat16* rr = res_t + (size_t)b * 8 * H + k;
      const float a = __bfloat162float(rr[0]);
      const float ig = __bfloat162float(rr[H]);
      const float f = __bfloat162float(rr[2 * H]);
      const float cp = __bfloat162float(rr[5 * H]);
      const float dc = dcbuf[idx] + acc[r][u];
      const float dz3[3] = {dc * ig * (1.0f - a * a),
                            dc * a * ig * (1.0f - ig),
                            dc * cp * f * (1.0f - f)};
      dcbuf[idx] = dc * f;
      const size_t row = (size_t)b * G + k;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        store_out(dproj_t + row + (size_t)g * H, dz3[g]);
        dz_t[row + (size_t)g * H] = __float2bfloat16(dz3[g]);
      }
    }
  }
}

template <typename TD>
int run_peep_bwd(const __nv_bfloat16* res, const __nv_bfloat16* wh,
                 const __nv_bfloat16* pif, const __nv_bfloat16* po,
                 const float* dhs, const float* dh_T, const float* dc_T,
                 float* dcbuf, TD* dproj, __nv_bfloat16* dz, float* dh0,
                 float* dc0, int T, int B, int H, cudaStream_t stream) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  const size_t step_g = (size_t)B * 4 * H;
  const size_t step_h = (size_t)B * H;
  const size_t step_res = (size_t)B * 8 * H;
  // launch s reads dz of step s (none for s = T) and runs step s - 1
  for (int s = T; s >= 0; --s) {
    const int t = s - 1;
    const bool elem = t >= 0;
    peep_bwd_gate<TD><<<grid, THREADS, 0, stream>>>(
        (s < T) ? dz + s * step_g : nullptr, wh, pif, dh_T, dc_T,
        elem ? dhs + t * step_h : nullptr,
        elem ? res + t * step_res : nullptr, dcbuf,
        elem ? dproj + t * step_g : nullptr,
        elem ? dz + t * step_g : nullptr, dh0, dc0, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (elem) {
      peep_bwd_cell<TD><<<grid, THREADS, 0, stream>>>(
          po, res + t * step_res, dcbuf, dproj + t * step_g,
          dz + t * step_g, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace peep

// Forward with residuals: peephole_scan_*'s arguments plus res
// (T, B, 8H) bf16 out.
extern "C" int peephole_train_fwd_f32(const void* proj, const void* wh,
                                      const void* pif, const void* po,
                                      void* h_a, void* h_b, void* c_a,
                                      void* c_b, void* zo, void* hs,
                                      void* res, int T, int B, int H,
                                      void* stream) {
  return peep::run_peep_fwd<float>(
      static_cast<const float*>(proj), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(pif),
      static_cast<const __nv_bfloat16*>(po), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<float*>(c_a),
      static_cast<float*>(c_b), static_cast<float*>(zo),
      static_cast<float*>(hs), static_cast<__nv_bfloat16*>(res), T, B, H,
      static_cast<cudaStream_t>(stream));
}

extern "C" int peephole_train_fwd_bf16(const void* proj, const void* wh,
                                       const void* pif, const void* po,
                                       void* h_a, void* h_b, void* c_a,
                                       void* c_b, void* zo, void* hs,
                                       void* res, int T, int B, int H,
                                       void* stream) {
  return peep::run_peep_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(proj),
      static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(pif),
      static_cast<const __nv_bfloat16*>(po), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<float*>(c_a),
      static_cast<float*>(c_b), static_cast<float*>(zo),
      static_cast<__nv_bfloat16*>(hs), static_cast<__nv_bfloat16*>(res), T,
      B, H, static_cast<cudaStream_t>(stream));
}

// res (T, B, 8H) bf16, wh (H, 4H), pif (H, 2H) [P_i | P_f] and po (H, H)
// bf16, dhs (T, B, H) f32, dh_T and dc_T (B, H) f32, dcbuf (B, H) f32
// scratch, dproj (T, B, 4H) in proj's dtype, dz (T, B, 4H) bf16 out, dh0
// and dc0 (B, H) f32 out.
extern "C" int peephole_train_bwd_f32(const void* res, const void* wh,
                                      const void* pif, const void* po,
                                      const void* dhs, const void* dh_T,
                                      const void* dc_T, void* dcbuf,
                                      void* dproj, void* dz, void* dh0,
                                      void* dc0, int T, int B, int H,
                                      void* stream) {
  return peep::run_peep_bwd<float>(
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(pif),
      static_cast<const __nv_bfloat16*>(po), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_T), static_cast<const float*>(dc_T),
      static_cast<float*>(dcbuf), static_cast<float*>(dproj),
      static_cast<__nv_bfloat16*>(dz), static_cast<float*>(dh0),
      static_cast<float*>(dc0), T, B, H, static_cast<cudaStream_t>(stream));
}

extern "C" int peephole_train_bwd_bf16(const void* res, const void* wh,
                                       const void* pif, const void* po,
                                       const void* dhs, const void* dh_T,
                                       const void* dc_T, void* dcbuf,
                                       void* dproj, void* dz, void* dh0,
                                       void* dc0, int T, int B, int H,
                                       void* stream) {
  return peep::run_peep_bwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(pif),
      static_cast<const __nv_bfloat16*>(po), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_T), static_cast<const float*>(dc_T),
      static_cast<float*>(dcbuf), static_cast<__nv_bfloat16*>(dproj),
      static_cast<__nv_bfloat16*>(dz), static_cast<float*>(dh0),
      static_cast<float*>(dc0), T, B, H, static_cast<cudaStream_t>(stream));
}

// dW_h (H, 4H) = h_{t-1}^T dz, dP_i = c_{t-1}^T dz_i, dP_f = c_{t-1}^T dz_f
// and dP_o = c_t^T dz_o (each (H, H)), f32 sums over the M = T*B rows of
// the residuals (M, 8H) and dz (M, 4H), both bf16: one launch of
// dw_gemm.cuh over the four problems in desc (see dw_gemm::launch) with the
// tiling that ops/rnn_cuda.py dw_plan("peephole", H) picks.
extern "C" int peephole_train_dw(const long long* desc, int count, int M,
                                 int H, int bn, int bk, int stages,
                                 void* stream) {
  return dw_gemm::launch(desc, count, M, H, bn, bk, stages,
                         static_cast<cudaStream_t>(stream));
}
