// GRU / minimal-GRU recurrence over a hoisted input projection, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/rnn_pallas.py
// gated_scan_pallas (pallas_call at :291). Same function and precision
// contract as its twin gated_scan_mixed_reference (:320): bf16(proj),
// bf16 operands of h @ w1 and of bf16(r*h) @ w2 with f32 accumulation,
// f32 gates and carry, hs in proj's dtype. The step kernels are in
// gated_step.cuh; the training forward (gated_train.cu) runs the
// persistent recurrence of gated_persistent.cuh, which sums in another
// order, so the two agree within the recurrence tolerance.
//
// What bounds it on this card. One GRU step at B=128, H=1024 is two
// dependent products, (B, H) @ (H, 2H) and (B, H) @ (H, H): 0.81 GFLOP
// against 6 MB of bf16 weights (4 MB and 0.54 GFLOP for mgru). Over
// T=512 steps that is 412 GFLOP, ~0.42 ms at the bf16 tensor rate, so
// operation-bound in principle; but the steps are serial, the weights
// fit in no SM's 227 KB of shared memory (the TPU kernel keeps them in
// VMEM for all T), and within a step the second product needs r*h of
// every unit, i.e. a grid-wide barrier between the two products.
//
// What this design does about it. The launch boundary is the barrier:
// two launches a step for gru and mgru_r (r, z and bf16(r*h) to
// scratch; then the candidate and h'), one for mgru, whose single
// product h @ [u_z | u] feeds both of its gates. A block owns 32 hidden
// units x 32 batch rows, h ping-pongs between two f32 buffers, and the
// weights are re-read from L2 each step. The products run on the CUDA
// cores as f32 FMAs of bf16-rounded operands from shared-memory tiles.
// The persistent design of the training forward (gated_persistent.cuh,
// instantiated with RES = false) is later work.

#include "gated_step.cuh"

// proj (T, B, gp*H) in f32 or bf16, w1 (H, 2H) bf16, w2 (H, H) bf16 (null
// for mgru), h_a (B, H) f32 holding h0, h_b (B, H) f32 scratch, rh (B, H)
// bf16 and zbuf (B, H) f32 scratch (null for mgru), hs (T, B, H) in proj's
// dtype. kind 0 gru, 1 mgru_r, 2 mgru; act 0 tanh, 1 relu, 2 sigmoid.
// After the call h_T is in h_a when T is even, else in h_b.
extern "C" int gated_scan_f32(const void* proj, const void* w1,
                              const void* w2, void* h_a, void* h_b, void* rh,
                              void* zbuf, void* hs, int T, int B, int H,
                              int kind, int act, void* stream) {
  return gated::run_gated_fwd<float>(
      static_cast<const float*>(proj), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<__nv_bfloat16*>(rh),
      static_cast<float*>(zbuf), static_cast<float*>(hs), T, B, H, kind, act,
      static_cast<cudaStream_t>(stream));
}

extern "C" int gated_scan_bf16(const void* proj, const void* w1,
                               const void* w2, void* h_a, void* h_b, void* rh,
                               void* zbuf, void* hs, int T, int B, int H,
                               int kind, int act, void* stream) {
  return gated::run_gated_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(proj),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<__nv_bfloat16*>(rh),
      static_cast<float*>(zbuf), static_cast<__nv_bfloat16*>(hs), T, B, H,
      kind, act, static_cast<cudaStream_t>(stream));
}
