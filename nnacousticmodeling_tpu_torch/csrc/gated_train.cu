// Trainable GRU / minimal-GRU recurrence for Hopper (sm_90a): the forward
// that also writes the backward's residuals, the reverse-time backward,
// and the weight-gradient contractions.
//
// Replaces the TPU kernels of nnacousticmodeling_tpu/ops/rnn_pallas.py
// behind gated_scan_pallas_train (:977):
//
//   gated_train_fwd_*  <- _gated_train_fwd_impl (:684, pallas_call :753)
//   gated_train_bwd_*  <- _gated_train_bwd_impl (:785, pallas_call :906),
//   gated_train_dw        its dW1 / dW2 contractions (:886-895)
//
// Forward: gated_step.cuh's step kernels (the inference kernel's code, so
// hs and h_T are bit-equal to gated_scan.cu's) with the residual row
// bf16 [r | z | hb | h_prev] (r = 0 for mgru).
//
// Backward, per step in reverse time (the operation order of :824-881),
// from the bf16 residuals:
//
//     dh_tot = dhs[t] + dh;      dz = dh_tot * (hb - h_prev)
//     dzpre = dz * z * (1 - z);  dcpre = dh_tot * z * act'(hb)
//     dh' = dh_tot * (1 - z)
//     gru / mgru_r:  drh = bf16(dcpre) @ w2^T;  dh' += drh * r
//                    drpre = drh * h_prev * r * (1 - r)
//     dh = dh' + bf16(pair) @ w1^T,  pair in w1's column order:
//          gru [drpre | dzpre], mgru_r [dzpre | drpre], mgru [dzpre | dcpre]
//
// act' is read off the bf16 output hb (tanh: 1 - hb^2, relu: hb > 0,
// sigmoid: hb (1 - hb)); dproj takes the unrounded f32 values in proj's
// packing order, the products take their bf16 roundings. After the loop
// dW1 = sum_t h_prev^T bf16(pair) and dW2 = sum_t bf16(r * h_prev)^T
// bf16(dcpre), r and h_prev read from the bf16 residuals.
//
// What bounds them on this card. At T=20, B=128, H=1024 a GRU layer's
// forward does 16.1 GFLOP (0.016 ms at the bf16 tensor rate) against
// ~60 MB of proj, residuals and hs (0.018 ms at 3.35 TB/s); the backward
// with dW 32.2 GFLOP against ~80 MB. Both sit far below the floor of the
// serial recurrence, whose reverse step holds two dependent products
// (w2^T needs dcpre of every unit, w1^T needs the whole pair), and the
// weights (6 MB bf16) fit in no SM's shared memory, so the TPU design
// (W1^T and W2^T resident in VMEM for all T)
// does not carry over.
//
// What this design does about it. Launch boundaries are the barriers.
// The backward block owns 32 hidden units k x 32 batch rows; its first
// launch of step t forms dh_t = partial_{t+1} + pair_{t+1} @ w1^T for its
// tile (row k of w1 is contiguous, so no transposed copy), then step t's
// elementwise part, all of whose operands are local to its units; for
// gru / mgru_r a second launch forms drh = bf16(dcpre_t) @ w2^T and the
// reset-gate part. partial (dh' without the w1^T term) is one (B, H) f32
// buffer updated in place; bf16(pair) and bf16(dcpre) go to (T, B, .)
// scratch that the dW contractions read after the loop. So a gru /
// mgru_r layer takes 2T+1 backward launches and mgru T+1, plus one dW
// launch (dw_gemm.cuh, on the tensor cores: dW1 and dW2 as two problems
// of one grid, bf16(r * h_prev) formed as its tile lands in shared
// memory). The step products run on the CUDA cores as f32 FMAs of bf16
// operands from shared-memory tiles.

#include "gated_step.cuh"
#include "dw_gemm.cuh"

namespace gated {
namespace {

__device__ __forceinline__ float act_grad(int act, float hb) {
  if (act == ACT_RELU) return hb > 0.0f ? 1.0f : 0.0f;
  if (act == ACT_SIGMOID) return hb * (1.0f - hb);
  return 1.0f - hb * hb;
}

// First launch of reverse step t: dh_t = partial + pair_next @ w1^T
// (dh_init when pair_next is null, i.e. t = T-1), then the z / candidate
// part of step t. res_t null: no step left, dh goes to dh_out (dh0).
template <typename TD>
__global__ void __launch_bounds__(THREADS)
gated_bwd_gate(const __nv_bfloat16* __restrict__ pair_next,  // (B, 2H)
               const __nv_bfloat16* __restrict__ w1,         // (H, 2H)
               const float* __restrict__ dh_init,            // (B, H)
               const float* __restrict__ dhs_t,              // (B, H)
               const __nv_bfloat16* __restrict__ res_t,      // (B, 4H)
               float* __restrict__ partial,                  // (B, H) in/out
               TD* __restrict__ dproj_t,                     // (B, gp*H)
               __nv_bfloat16* __restrict__ pair_t,           // (B, 2H)
               __nv_bfloat16* __restrict__ dc_t,             // (B, H)
               float* __restrict__ dh_out,                   // (B, H)
               int B, int H, int kind, int act) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ float w_sm[TJ][KC + 1];
  const int tid = threadIdx.x;
  const int k0u = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (pair_next != nullptr)
    bwd_product(pair_next, 2 * H, w1, 2 * H, B, H, b0, k0u, a_sm, w_sm,
                acc);

  // dproj columns of z and the candidate, and z's column in the pair
  const bool gru = kind == KIND_GRU;
  const int gp = (kind == KIND_MGRU) ? 2 : 3;
  const size_t off_z = gru ? (size_t)H : 0;
  const size_t off_c = gru ? 2 * (size_t)H : (size_t)H;
  const size_t pz = gru ? (size_t)H : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, k = k0u + tu + u;
      if (b >= B || k >= H) continue;
      const size_t idx = (size_t)b * H + k;
      const float dh = (pair_next != nullptr) ? partial[idx] + acc[r][u]
                                              : dh_init[idx];
      if (res_t == nullptr) {
        dh_out[idx] = dh;
        continue;
      }
      const __nv_bfloat16* rr = res_t + (size_t)b * 4 * H + k;
      const float z = __bfloat162float(rr[H]);
      const float hb = __bfloat162float(rr[2 * H]);
      const float hp = __bfloat162float(rr[3 * H]);
      const float dh_tot = dhs_t[idx] + dh;
      const float dz = dh_tot * (hb - hp);
      const float dhb = dh_tot * z;
      partial[idx] = dh_tot * (1.0f - z);
      const float dzpre = dz * z * (1.0f - z);
      const float dcpre = dhb * act_grad(act, hb);
      TD* dp = dproj_t + (size_t)b * gp * H + k;
      store_out(dp + off_z, dzpre);
      store_out(dp + off_c, dcpre);
      __nv_bfloat16* pp = pair_t + (size_t)b * 2 * H + k;
      pp[pz] = __float2bfloat16(dzpre);
      if (kind == KIND_MGRU)
        pp[H] = __float2bfloat16(dcpre);
      else
        dc_t[idx] = __float2bfloat16(dcpre);
    }
  }
}

// Second launch of reverse step t (gru, mgru_r): drh = bf16(dcpre) @ w2^T,
// then the reset gate's part.
template <typename TD>
__global__ void __launch_bounds__(THREADS)
gated_bwd_reset(const __nv_bfloat16* __restrict__ dc_t,    // (B, H)
                const __nv_bfloat16* __restrict__ w2,      // (H, H)
                const __nv_bfloat16* __restrict__ res_t,   // (B, 4H)
                float* __restrict__ partial,               // (B, H) in/out
                TD* __restrict__ dproj_t,                  // (B, 3H)
                __nv_bfloat16* __restrict__ pair_t,        // (B, 2H)
                int B, int H, int kind) {
  __shared__ float a_sm[TB][KC + 1];
  __shared__ float w_sm[TJ][KC + 1];
  const int tid = threadIdx.x;
  const int k0u = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  bwd_product(dc_t, H, w2, H, B, H, b0, k0u, a_sm, w_sm, acc);

  // r's dproj column and pair column: gru [r, z, c] / [r | z];
  // mgru_r [z, c, r] / [z | r]
  const bool gru = kind == KIND_GRU;
  const size_t off_r = gru ? 0 : 2 * (size_t)H;
  const size_t pr_col = gru ? 0 : (size_t)H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, k = k0u + tu + u;
      if (b >= B || k >= H) continue;
      const size_t idx = (size_t)b * H + k;
      const __nv_bfloat16* rr = res_t + (size_t)b * 4 * H + k;
      const float rg = __bfloat162float(rr[0]);
      const float hp = __bfloat162float(rr[3 * H]);
      const float drh = acc[r][u];
      const float dr = drh * hp;
      partial[idx] = partial[idx] + drh * rg;
      const float drpre = dr * rg * (1.0f - rg);
      store_out(dproj_t + (size_t)b * 3 * H + off_r + k, drpre);
      pair_t[(size_t)b * 2 * H + pr_col + k] = __float2bfloat16(drpre);
    }
  }
}

template <typename TD>
int run_gated_bwd(const __nv_bfloat16* res, const __nv_bfloat16* w1,
                  const __nv_bfloat16* w2, const float* dhs,
                  const float* dh_T, float* partial, TD* dproj,
                  __nv_bfloat16* pair, __nv_bfloat16* dc, float* dh0, int T,
                  int B, int H, int kind, int act, cudaStream_t stream) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  const bool has_w2 = kind != KIND_MGRU;
  const size_t step_g = (size_t)B * (has_w2 ? 3 : 2) * H;
  const size_t step_h = (size_t)B * H;
  const size_t step_pair = (size_t)B * 2 * H;
  const size_t step_res = (size_t)B * 4 * H;
  // launch s reads the pair of step s (none for s = T) and runs step s - 1
  for (int s = T; s >= 0; --s) {
    const int t = s - 1;
    const bool elem = t >= 0;
    gated_bwd_gate<TD><<<grid, THREADS, 0, stream>>>(
        (s < T) ? pair + s * step_pair : nullptr, w1, dh_T,
        elem ? dhs + t * step_h : nullptr,
        elem ? res + t * step_res : nullptr, partial,
        elem ? dproj + t * step_g : nullptr,
        elem ? pair + t * step_pair : nullptr,
        (elem && has_w2) ? dc + t * step_h : nullptr, dh0, B, H, kind, act);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (elem && has_w2) {
      gated_bwd_reset<TD><<<grid, THREADS, 0, stream>>>(
          dc + t * step_h, w2, res + t * step_res, partial,
          dproj + t * step_g, pair + t * step_pair, B, H, kind);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gated

// Forward with residuals: gated_scan_*'s arguments plus res (T, B, 4H)
// bf16 out.
extern "C" int gated_train_fwd_f32(const void* proj, const void* w1,
                                   const void* w2, void* h_a, void* h_b,
                                   void* rh, void* zbuf, void* hs, void* res,
                                   int T, int B, int H, int kind, int act,
                                   void* stream) {
  return gated::run_gated_fwd<float>(
      static_cast<const float*>(proj), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<__nv_bfloat16*>(rh),
      static_cast<float*>(zbuf), static_cast<float*>(hs),
      static_cast<__nv_bfloat16*>(res), T, B, H, kind, act,
      static_cast<cudaStream_t>(stream));
}

extern "C" int gated_train_fwd_bf16(const void* proj, const void* w1,
                                    const void* w2, void* h_a, void* h_b,
                                    void* rh, void* zbuf, void* hs, void* res,
                                    int T, int B, int H, int kind, int act,
                                    void* stream) {
  return gated::run_gated_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(proj),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<__nv_bfloat16*>(rh),
      static_cast<float*>(zbuf), static_cast<__nv_bfloat16*>(hs),
      static_cast<__nv_bfloat16*>(res), T, B, H, kind, act,
      static_cast<cudaStream_t>(stream));
}

// res (T, B, 4H) bf16, w1 (H, 2H) and w2 (H, H) bf16 (w2 null for mgru),
// dhs (T, B, H) f32, dh_T (B, H) f32, partial (B, H) f32 scratch, dproj
// (T, B, gp*H) in proj's dtype, pair (T, B, 2H) bf16 out, dc (T, B, H)
// bf16 out (null for mgru), dh0 (B, H) f32 out.
extern "C" int gated_train_bwd_f32(const void* res, const void* w1,
                                   const void* w2, const void* dhs,
                                   const void* dh_T, void* partial,
                                   void* dproj, void* pair, void* dc,
                                   void* dh0, int T, int B, int H, int kind,
                                   int act, void* stream) {
  return gated::run_gated_bwd<float>(
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_T), static_cast<float*>(partial),
      static_cast<float*>(dproj), static_cast<__nv_bfloat16*>(pair),
      static_cast<__nv_bfloat16*>(dc), static_cast<float*>(dh0), T, B, H,
      kind, act, static_cast<cudaStream_t>(stream));
}

extern "C" int gated_train_bwd_bf16(const void* res, const void* w1,
                                    const void* w2, const void* dhs,
                                    const void* dh_T, void* partial,
                                    void* dproj, void* pair, void* dc,
                                    void* dh0, int T, int B, int H, int kind,
                                    int act, void* stream) {
  return gated::run_gated_bwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_T), static_cast<float*>(partial),
      static_cast<__nv_bfloat16*>(dproj), static_cast<__nv_bfloat16*>(pair),
      static_cast<__nv_bfloat16*>(dc), static_cast<float*>(dh0), T, B, H,
      kind, act, static_cast<cudaStream_t>(stream));
}

// dW1 (H, 2H) f32 = sum over the M = T*B rows of h_prev^T pair and, for gru
// / mgru_r, dW2 (H, H) f32 = sum of bf16(r * h_prev)^T dcpre, from the
// residuals (M, 4H), pair (M, 2H) and dc (M, H), all bf16: one launch of
// dw_gemm.cuh over the 1 or 2 problems in desc (see dw_gemm::launch) with
// the tiling that ops/rnn_cuda.py dw_plan("gated", H, has_w2) picks.
extern "C" int gated_train_dw(const long long* desc, int count, int M, int H,
                              int bn, int bk, int stages, void* stream) {
  return dw_gemm::launch(desc, count, M, H, bn, bk, stages,
                         static_cast<cudaStream_t>(stream));
}
