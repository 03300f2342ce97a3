// GRU / minimal-GRU recurrence over a hoisted input projection, for
// Hopper (sm_90a): the whole sequence in one persistent, cooperative
// launch.
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/rnn_pallas.py
// gated_scan_pallas (:197, pallas_call at :291). Same function and
// precision contract as its twin gated_scan_mixed_reference (:320):
// bf16(proj), bf16 operands of h @ w1 and of bf16(r*h) @ w2 with f32
// accumulation, f32 gates and carry, hs in proj's dtype.
//
// What bounds it on this card. One GRU step at B=128, H=1024 is two
// dependent products, (B, H) @ (H, 2H) and (B, H) @ (H, H): 0.81 GFLOP
// against 6 MB of bf16 weights (4 MB and 0.54 GFLOP for mgru). Over
// T=512 steps that is 412 GFLOP, ~0.42 ms at the bf16 tensor rate, so
// operation-bound in principle; but the steps are serial, the weights
// fit in no SM's 227 KB of shared memory (the TPU kernel keeps them in
// VMEM for all T), and within a step the second product needs r*h of
// every unit: two grid-wide exchanges a step for gru and mgru_r, one for
// mgru.
//
// What this design does about it: gated_persistent.cuh, whose step code
// the training forward of gated_train.cu shares bit for bit (RES = false
// here: no residual row). One persistent cooperative launch per row chunk
// (ops/rnn_cuda.py gated_scan_plan; one at B=128, H=1024) walks all T
// steps with one split grid barrier a phase; each block keeps the weight
// slice of its 16 units in shared memory for all T (streamed from L2
// beside the exchange where it does not fit), sums on the tensor cores,
// and exchanges bf16(r h) and bf16(h_t) with the grid through L2.

#include "gated_persistent.cuh"

namespace {

using namespace gated_persistent;

template <typename TP, bool RESIDENT, int RB>
__global__ void __launch_bounds__(threads_of(RB), min_blocks(RESIDENT, RB))
gated_scan_persistent(const TP* __restrict__ proj,            // (T,B,gp*H)
                      const __nv_bfloat16* __restrict__ w1t,  // (2H, H)
                      const __nv_bfloat16* __restrict__ w2t,  // (H, H)
                      float* __restrict__ h,       // (B, H) h0 -> h_T
                      __nv_bfloat16* hx,           // (2, B, H) exchange
                      __nv_bfloat16* rx,           // (B, H) exchange
                      TP* __restrict__ hs,         // (T, B, H)
                      unsigned int* bar,           // zeroed count
                      int T, int B, int H, int row0, int nrows, int kind,
                      int act) {
  recurrence<TP, RESIDENT, false, RB>(proj, w1t, w2t, h, hx, rx, hs, nullptr,
                                      bar, T, B, H, row0, nrows, kind, act);
}

template <typename TP>
int run_scan(const void* proj, const void* w1t, const void* w2t, void* h,
             void* hx, void* rx, void* hs, void* bar, int T, int B, int H,
             int row0, int nrows, int kind, int act, int resident, int rows,
             void* stream) {
  if (!args_ok(T, B, row0, nrows, kind, act, w2t, rx, resident, rows))
    return (int)cudaErrorInvalidValue;
  return launch_layout(
      fwd_smem_bytes, H, nrows, resident, rows, stream,
      [](auto L) {
        return gated_scan_persistent<TP, decltype(L)::resident,
                                     decltype(L)::rb>;
      },
      static_cast<const TP*>(proj), static_cast<const __nv_bfloat16*>(w1t),
      static_cast<const __nv_bfloat16*>(w2t), static_cast<float*>(h),
      static_cast<__nv_bfloat16*>(hx), static_cast<__nv_bfloat16*>(rx),
      static_cast<TP*>(hs), static_cast<unsigned int*>(bar), T, B, H, row0,
      nrows, kind, act);
}

}  // namespace

// How many blocks of the kernel, with the weight slice resident or
// streamed and rows batch rows a block, can be co-resident on the current
// device at this H, for both proj dtypes: 0 when a block's shared memory
// would exceed the card's or there is no such layout.
extern "C" int gated_scan_capacity(int H, int resident, int rows,
                                   int* blocks) {
  return layout_capacity(fwd_smem_bytes, H, resident, rows, blocks,
                         [](auto L, auto tp) {
                           return gated_scan_persistent<
                               decltype(tp), decltype(L)::resident,
                               decltype(L)::rb>;
                         });
}

// proj (T, B, gp*H) f32 or bf16, w1t = w1^T (2H, H) and w2t = w2^T (H, H)
// bf16 (w2t null for mgru), h (B, H) f32 holding h0 and left holding h_T,
// hx (2, B, H) and rx (B, H) bf16 scratch (rx null for mgru), hs (T, B,
// H) in proj's dtype, bar one zeroed uint32. Runs the rows [row0, row0 +
// nrows) of the batch; kind 0 gru, 1 mgru_r, 2 mgru, act 0 tanh, 1 relu,
// 2 sigmoid; resident: the weight slice stays in shared memory (else
// streamed); rows a block (64, or 32 streamed).
extern "C" int gated_scan_f32(const void* proj, const void* w1t,
                              const void* w2t, void* h, void* hx, void* rx,
                              void* hs, void* bar, int T, int B, int H,
                              int row0, int nrows, int kind, int act,
                              int resident, int rows, void* stream) {
  return run_scan<float>(proj, w1t, w2t, h, hx, rx, hs, bar, T, B, H, row0,
                         nrows, kind, act, resident, rows, stream);
}

extern "C" int gated_scan_bf16(const void* proj, const void* w1t,
                               const void* w2t, void* h, void* hx, void* rx,
                               void* hs, void* bar, int T, int B, int H,
                               int row0, int nrows, int kind, int act,
                               int resident, int rows, void* stream) {
  return run_scan<__nv_bfloat16>(proj, w1t, w2t, h, hx, rx, hs, bar, T, B,
                                 H, row0, nrows, kind, act, resident, rows,
                                 stream);
}
