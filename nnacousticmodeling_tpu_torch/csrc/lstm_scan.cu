// LSTM recurrence over a hoisted input projection, for Hopper (sm_90a):
// the whole sequence in one persistent, cooperative launch.
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/rnn_pallas.py
// lstm_scan_pallas (pallas_call at :158). Same function and precision
// contract as its twin lstm_scan_mixed_reference (:356): per step
//
//     z = bf16(proj[t]) + bf16(h) @ bf16(W_h)     (f32 accumulation)
//     a, i, f, o = tanh, sigmoid, sigmoid, sigmoid of z's four H-blocks
//     c = f * c + i * a;   h = o * tanh(c)        (f32 carry)
//
// and hs[t] = h in proj's dtype.
//
// What bounds it on this card. One step is a (B, H) @ (H, 4H) product:
// 2*B*H*4H = 1.07 GFLOP at B=128, H=1024 (~1.1 us at 989 TFLOP/s bf16),
// against W_h = 8 MB in bf16; over T=512 steps 0.556 ms (operations). The
// steps are serial: every unit of step t+1 needs all of h_t. The TPU
// kernel keeps W_h and the (h, c) carry in VMEM for all T; no single SM
// holds W_h, but the grid does (~64 KB-128 KB a block), and the floor is
// then a grid-wide exchange of h per step, not the arithmetic.
//
// What this design does about it: lstm_persistent.cuh, whose step code
// the training forward of lstm_train.cu shares bit for bit. One
// persistent cooperative launch walks all T steps; each block keeps its
// slice of W_h (128 KB at H=1024) in shared memory for all T, sums on
// the tensor cores, and exchanges h with the grid through L2 at one grid
// barrier a step. Batches larger than one co-resident grid holds go
// through the kernel in row chunks, one launch each (ops/rnn_cuda.py
// lstm_scan_plan); B <= 128 at H=1024 is one launch.

#include "lstm_persistent.cuh"

namespace {

using namespace lstm_persistent;

template <typename TP, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 1 : 2)
lstm_scan_persistent(const TP* __restrict__ proj,            // (T, B, 4H)
                     const __nv_bfloat16* __restrict__ wt,   // (4H, H) W_h^T
                     float* __restrict__ h,        // (B, H) h0 in, h_T out
                     float* __restrict__ c,        // (B, H) c0 in, c_T out
                     __nv_bfloat16* hx,            // (2, B, H) h exchange
                     TP* __restrict__ hs,          // (T, B, H)
                     __nv_bfloat16* res,           // unused: no residuals
                     unsigned int* bar,            // zeroed barrier count
                     int T, int B, int H, int row0, int nrows) {
  recurrence<TP, RESIDENT, false>(proj, wt, h, c, hx, hs, nullptr, bar, T,
                                  B, H, row0, nrows);
}

template <typename TP>
int run_scan(const void* proj, const void* wt, void* h, void* c, void* hx,
             void* hs, void* bar, int T, int B, int H, int row0, int nrows,
             int resident, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident
      ? launch<TP>(lstm_scan_persistent<TP, true>, true, proj, wt, h, c, hx,
                   hs, nullptr, bar, T, B, H, row0, nrows, st)
      : launch<TP>(lstm_scan_persistent<TP, false>, false, proj, wt, h, c,
                   hx, hs, nullptr, bar, T, B, H, row0, nrows, st);
}

}  // namespace

// How many blocks of the kernel (W_h slice resident or streamed) can be
// co-resident on the current device at this H, for both proj dtypes: 0
// when a block's shared memory would exceed the card's.
extern "C" int lstm_scan_capacity(int H, int resident, int* blocks) {
  *blocks = 0;
  if (H < 1) return 0;
  const size_t smem = smem_bytes(H, resident != 0);
  return resident
      ? capacity(lstm_scan_persistent<float, true>,
                 lstm_scan_persistent<__nv_bfloat16, true>, smem, blocks)
      : capacity(lstm_scan_persistent<float, false>,
                 lstm_scan_persistent<__nv_bfloat16, false>, smem, blocks);
}

// proj (T, B, 4H) f32 or bf16, wt = W_h^T (4H, H) bf16, h and c (B, H)
// f32 holding h0 / c0 and left holding h_T / c_T, hx (2, B, H) bf16
// scratch, hs (T, B, H) in proj's dtype, bar one zeroed uint32. Runs the
// rows [row0, row0 + nrows) of the batch; resident: W_h's slice stays in
// shared memory (else streamed from L2 each step).
extern "C" int lstm_scan_f32(const void* proj, const void* wt, void* h,
                             void* c, void* hx, void* hs, void* bar, int T,
                             int B, int H, int row0, int nrows, int resident,
                             void* stream) {
  return run_scan<float>(proj, wt, h, c, hx, hs, bar, T, B, H, row0, nrows,
                         resident, stream);
}

extern "C" int lstm_scan_bf16(const void* proj, const void* wt, void* h,
                              void* c, void* hx, void* hs, void* bar, int T,
                              int B, int H, int row0, int nrows,
                              int resident, void* stream) {
  return run_scan<__nv_bfloat16>(proj, wt, h, c, hx, hs, bar, T, B, H, row0,
                                 nrows, resident, stream);
}
