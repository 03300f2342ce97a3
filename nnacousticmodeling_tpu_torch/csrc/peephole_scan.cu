// Peephole LSTM recurrence over a hoisted input projection, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/rnn_pallas.py
// peephole_scan_pallas (:1306, pallas_call at :1376). Same function and
// precision contract as its twin peephole_scan_mixed_reference (:1413):
// bf16(proj), bf16 operands of h @ W_h, c @ P_i, c @ P_f and c' @ P_o with
// f32 accumulation, f32 gates and carry, hs in proj's dtype. The step
// kernels are in peephole_step.cuh.
//
// What bounds it on this card. One step at B=128, H=1024 is
// 2*B*H*7H = 1.88 GFLOP in two dependent groups of products: (B, H) @
// (H, 4H) and (B, H) @ (H, 2H), then (B, H) @ (H, H) on the new c,
// against 14 MB of bf16 weights. Over T=512 steps that is 962 GFLOP,
// 0.97 ms at the bf16 tensor rate, so operation-bound in principle; but
// the steps are serial, the weights fit in no SM's 227 KB of shared
// memory (the TPU kernel keeps them in VMEM for all T), and within a
// step the o-gate's product needs c' of every unit, i.e. a grid-wide
// barrier.
//
// What this design does about it. The launch boundary is the barrier:
// two launches a step (the cell launch: h @ W_h and c @ [P_i | P_f], the
// cell update, z_o to scratch; the output launch: c' @ P_o, o and h'). A
// block owns 32 hidden units x 32 batch rows, h and c ping-pong between
// two f32 buffers each, and the weights are re-read from L2 every step.
// The products run on the CUDA cores as f32 FMAs of bf16-rounded
// operands from shared-memory tiles, as lstm_scan.cu's do. Tensor cores,
// the weights split across a persistent grid with a grid sync instead of
// launches, and CUDA graphs are later work.

#include "peephole_step.cuh"

// proj (T, B, 4H) in f32 or bf16, wh (H, 4H) bf16, pif (H, 2H) bf16 the
// concatenation [P_i | P_f], po (H, H) bf16, h_a / c_a (B, H) f32 holding
// h0 / c0, h_b / c_b (B, H) f32 scratch, zo (B, H) f32 scratch, hs
// (T, B, H) in proj's dtype. After the call h_T and c_T are in h_a / c_a
// when T is even, else in h_b / c_b.
extern "C" int peephole_scan_f32(const void* proj, const void* wh,
                                 const void* pif, const void* po, void* h_a,
                                 void* h_b, void* c_a, void* c_b, void* zo,
                                 void* hs, int T, int B, int H,
                                 void* stream) {
  return peep::run_peep_fwd<float>(
      static_cast<const float*>(proj), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(pif),
      static_cast<const __nv_bfloat16*>(po), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<float*>(c_a),
      static_cast<float*>(c_b), static_cast<float*>(zo),
      static_cast<float*>(hs), T, B, H,
      static_cast<cudaStream_t>(stream));
}

extern "C" int peephole_scan_bf16(const void* proj, const void* wh,
                                  const void* pif, const void* po, void* h_a,
                                  void* h_b, void* c_a, void* c_b, void* zo,
                                  void* hs, int T, int B, int H,
                                  void* stream) {
  return peep::run_peep_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(proj),
      static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(pif),
      static_cast<const __nv_bfloat16*>(po), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<float*>(c_a),
      static_cast<float*>(c_b), static_cast<float*>(zo),
      static_cast<__nv_bfloat16*>(hs), T, B, H,
      static_cast<cudaStream_t>(stream));
}
