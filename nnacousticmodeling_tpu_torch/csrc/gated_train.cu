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
// Forward: gated_persistent.cuh's recurrence with the residual row bf16
// [r | z | hb | h_prev] (RES = true; r = 0 for mgru). gated_scan.cu still
// runs gated_step.cuh's per-step kernels, which sum in another order: the
// two forwards agree within the recurrence tolerance, not bit for bit.
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
// serial recurrence, whose steps each hold two dependent products (the
// candidate's w2 product needs r h of every unit; in reverse, w2^T needs
// dcpre of every unit, w1^T the whole pair): two grid-wide exchanges a
// step for gru and mgru_r, one for mgru.
//
// What the designs do about it. The forward is one persistent cooperative
// launch per row chunk (ops/rnn_cuda.py gated_train_fwd_plan; one at
// B=128, H=1024) that walks all T steps with one split grid barrier a
// phase, keeps its 16 units' weight slice in shared memory for all T and
// sums on the tensor cores (gated_persistent.cuh says how). The backward
// still uses launch boundaries as its barriers: a block owns 32 hidden
// units k x 32 batch rows; its first launch of step t forms dh_t =
// partial_{t+1} + pair_{t+1} @ w1^T for its tile (row k of w1 is
// contiguous, so no transposed copy), then step t's elementwise part, all
// of whose operands are local to its units; for gru / mgru_r a second
// launch forms drh = bf16(dcpre_t) @ w2^T and the reset-gate part. partial
// (dh' without the w1^T term) is one (B, H) f32 buffer updated in place;
// bf16(pair) and bf16(dcpre) go to (T, B, .) scratch that the dW
// contractions read after the loop. So a gru / mgru_r layer takes 2T+1
// backward launches and mgru T+1, plus one dW launch (dw_gemm.cuh, on the
// tensor cores: dW1 and dW2 as two problems of one grid, bf16(r * h_prev)
// formed as its tile lands in shared memory). The backward's step
// products run on the CUDA cores as f32 FMAs of bf16 operands from
// shared-memory tiles (gated_step.cuh's bwd_product).

#include "dw_gemm.cuh"
#include "gated_persistent.cuh"
#include "gated_step.cuh"

// ---- forward: the persistent recurrence plus the residual row ---------

namespace {

using namespace gated_persistent;

template <typename TP, bool RESIDENT, int RB>
__global__ void __launch_bounds__(threads_of(RB), min_blocks(RESIDENT, RB))
gated_train_fwd_persistent(const TP* __restrict__ proj,       // (T,B,gp*H)
                           const __nv_bfloat16* __restrict__ w1t,  // (2H,H)
                           const __nv_bfloat16* __restrict__ w2t,  // (H, H)
                           float* __restrict__ h,      // (B, H) h0 -> h_T
                           __nv_bfloat16* hx,          // (2, B, H) exchange
                           __nv_bfloat16* rx,          // (B, H) exchange
                           TP* __restrict__ hs,        // (T, B, H)
                           __nv_bfloat16* __restrict__ res,  // (T, B, 4H)
                           unsigned int* bar,          // zeroed count
                           int T, int B, int H, int row0, int nrows,
                           int kind, int act) {
  recurrence<TP, RESIDENT, true, RB>(proj, w1t, w2t, h, hx, rx, hs, res, bar,
                                     T, B, H, row0, nrows, kind, act);
}

template <typename TP>
int run_fwd(const void* proj, const void* w1t, const void* w2t, void* h,
            void* hx, void* rx, void* hs, void* res, void* bar, int T, int B,
            int H, int row0, int nrows, int kind, int act, int resident,
            int rows, void* stream) {
  if (T < 1 || nrows < 1 || row0 < 0 || row0 + nrows > B || kind < 0 ||
      kind > KIND_MGRU || act < 0 || act > ACT_SIGMOID ||
      (kind != KIND_MGRU && (w2t == nullptr || rx == nullptr)) ||
      !valid_layout(resident, rows))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto kern, bool r, int rb) {
    return cooperative(
        kern, grid_of(H, nrows, rb), threads_of(rb), fwd_smem_bytes(H, r, rb),
        static_cast<cudaStream_t>(stream), static_cast<const TP*>(proj),
        static_cast<const __nv_bfloat16*>(w1t),
        static_cast<const __nv_bfloat16*>(w2t), static_cast<float*>(h),
        static_cast<__nv_bfloat16*>(hx), static_cast<__nv_bfloat16*>(rx),
        static_cast<TP*>(hs), static_cast<__nv_bfloat16*>(res),
        static_cast<unsigned int*>(bar), T, B, H, row0, nrows, kind, act);
  };
  if (resident)
    return args(gated_train_fwd_persistent<TP, true, ROWS>, true, ROWS);
  return rows == ROWS
             ? args(gated_train_fwd_persistent<TP, false, ROWS>, false, ROWS)
             : args(gated_train_fwd_persistent<TP, false, ROWS / 2>, false,
                    ROWS / 2);
}

}  // namespace

// ---- backward: one or two launches a reverse step ----------------------

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

// How many blocks of the forward kernel, with the weight slice resident
// or streamed and rows batch rows a block, can be co-resident on the
// current device at this H, for both proj dtypes: 0 when a block's shared
// memory would exceed the card's or there is no such layout.
extern "C" int gated_train_capacity(int H, int resident, int rows,
                                    int* blocks) {
  *blocks = 0;
  if (H < 1 || !valid_layout(resident, rows)) return 0;
  auto query = [&](auto k32, auto k16, bool r, int rb) {
    return lstm_persistent::capacity(k32, k16, fwd_smem_bytes(H, r, rb),
                                     blocks, threads_of(rb));
  };
  if (resident)
    return query(gated_train_fwd_persistent<float, true, ROWS>,
                 gated_train_fwd_persistent<__nv_bfloat16, true, ROWS>, true,
                 ROWS);
  if (rows == ROWS)
    return query(gated_train_fwd_persistent<float, false, ROWS>,
                 gated_train_fwd_persistent<__nv_bfloat16, false, ROWS>,
                 false, ROWS);
  return query(gated_train_fwd_persistent<float, false, ROWS / 2>,
               gated_train_fwd_persistent<__nv_bfloat16, false, ROWS / 2>,
               false, ROWS / 2);
}

// proj (T, B, gp*H) f32 or bf16, w1t = w1^T (2H, H) and w2t = w2^T (H, H)
// bf16 (w2t null for mgru), h (B, H) f32 holding h0 and left holding h_T,
// hx (2, B, H) and rx (B, H) bf16 scratch (rx null for mgru), hs (T, B,
// H) in proj's dtype, res (T, B, 4H) bf16, bar one zeroed uint32. Runs the
// rows [row0, row0 + nrows) of the batch; kind 0 gru, 1 mgru_r, 2 mgru,
// act 0 tanh, 1 relu, 2 sigmoid; resident: the weight slice stays in
// shared memory (else streamed); rows a block (64, or 32 streamed).
extern "C" int gated_train_fwd_f32(const void* proj, const void* w1t,
                                   const void* w2t, void* h, void* hx,
                                   void* rx, void* hs, void* res, void* bar,
                                   int T, int B, int H, int row0, int nrows,
                                   int kind, int act, int resident, int rows,
                                   void* stream) {
  return run_fwd<float>(proj, w1t, w2t, h, hx, rx, hs, res, bar, T, B, H,
                        row0, nrows, kind, act, resident, rows, stream);
}

extern "C" int gated_train_fwd_bf16(const void* proj, const void* w1t,
                                    const void* w2t, void* h, void* hx,
                                    void* rx, void* hs, void* res, void* bar,
                                    int T, int B, int H, int row0, int nrows,
                                    int kind, int act, int resident,
                                    int rows, void* stream) {
  return run_fwd<__nv_bfloat16>(proj, w1t, w2t, h, hx, rx, hs, res, bar, T,
                                B, H, row0, nrows, kind, act, resident, rows,
                                stream);
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
