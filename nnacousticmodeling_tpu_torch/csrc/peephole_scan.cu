// Peephole LSTM recurrence over a hoisted input projection, for Hopper
// (sm_90a): the whole sequence in one persistent, cooperative launch.
//
// Replaces the TPU kernel nnacousticmodeling_tpu/ops/rnn_pallas.py
// peephole_scan_pallas (:1306, pallas_call at :1376). Same function and
// precision contract as its twin peephole_scan_mixed_reference (:1413):
// bf16(proj), bf16 operands of h @ W_h, c @ P_i, c @ P_f and c' @ P_o with
// f32 accumulation, f32 gates and carry, hs in proj's dtype.
//
// What bounds it on this card. One step at B=128, H=1024 is
// 2*B*H*7H = 1.88 GFLOP in two dependent groups of products: (B, H) @
// (H, 4H) and (B, H) @ (H, 2H), then (B, H) @ (H, H) on the new c,
// against 14 MB of bf16 weights. Over T=512 steps that is 962 GFLOP,
// 0.97 ms at the bf16 tensor rate, so operation-bound in principle; but
// the steps are serial, the weights fit in no SM's 227 KB of shared
// memory (the TPU kernel keeps them in VMEM for all T), and within a
// step the o-gate's product needs c' of every unit: two grid-wide
// exchanges a step.
//
// What this design does about it: peephole_persistent.cuh, whose step
// code the training forward of peephole_train.cu shares bit for bit
// (RES = false here: no residual row). One persistent cooperative launch
// per row chunk (ops/rnn_cuda.py peephole_scan_plan; one at B=128,
// H=1024) walks all T steps with two split grid barriers a step; each
// block keeps its 8 units' 7H-wide weight slice in shared memory for all
// T (streamed from L2 beside the exchange where it does not fit), sums on
// the tensor cores, and exchanges c_t and h_t with the grid through L2.

#include "peephole_persistent.cuh"

namespace {

using namespace peephole_persistent;

template <typename TP, bool RESIDENT, int RB>
__global__ void __launch_bounds__(threads_of(RB), min_blocks(RESIDENT, RB))
peephole_scan_persistent(const TP* __restrict__ proj,          // (T,B,4H)
                         const __nv_bfloat16* __restrict__ wt,  // (4H,H)
                         const __nv_bfloat16* __restrict__ pt,  // (3H,H)
                         float* __restrict__ h,     // (B, H) h0 -> h_T
                         float* __restrict__ c,     // (B, H) c0 -> c_T
                         __nv_bfloat16* hx,         // (B, H) exchange
                         __nv_bfloat16* cx,         // (2, B, H) exchange
                         TP* __restrict__ hs,       // (T, B, H)
                         unsigned int* bar,         // zeroed count
                         int T, int B, int H, int row0, int nrows) {
  recurrence<TP, RESIDENT, false, RB>(proj, wt, pt, h, c, hx, cx, hs,
                                      nullptr, bar, T, B, H, row0, nrows);
}

template <typename TP>
int run_scan(const void* proj, const void* wt, const void* pt, void* h,
             void* c, void* hx, void* cx, void* hs, void* bar, int T, int B,
             int H, int row0, int nrows, int resident, int rows,
             void* stream) {
  if (T < 1 || nrows < 1 || row0 < 0 || row0 + nrows > B ||
      !valid_layout(resident, rows))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto kern, bool r, int rb) {
    return cooperative(
        kern, grid_of(H, nrows, rb), threads_of(rb), fwd_smem_bytes(H, r, rb),
        static_cast<cudaStream_t>(stream), static_cast<const TP*>(proj),
        static_cast<const __nv_bfloat16*>(wt),
        static_cast<const __nv_bfloat16*>(pt), static_cast<float*>(h),
        static_cast<float*>(c), static_cast<__nv_bfloat16*>(hx),
        static_cast<__nv_bfloat16*>(cx), static_cast<TP*>(hs),
        static_cast<unsigned int*>(bar), T, B, H, row0, nrows);
  };
  if (resident)
    return args(peephole_scan_persistent<TP, true, 128>, true, 128);
  return rows == 128
             ? args(peephole_scan_persistent<TP, false, 128>, false, 128)
             : args(peephole_scan_persistent<TP, false, 64>, false, 64);
}

}  // namespace

// How many blocks of the kernel, with the weight slice resident or
// streamed and rows batch rows a block, can be co-resident on the current
// device at this H, for both proj dtypes: 0 when a block's shared memory
// would exceed the card's or there is no such layout.
extern "C" int peephole_scan_capacity(int H, int resident, int rows,
                                      int* blocks) {
  *blocks = 0;
  if (H < 1 || !valid_layout(resident, rows)) return 0;
  auto query = [&](auto k32, auto k16, bool r, int rb) {
    return lstm_persistent::capacity(k32, k16, fwd_smem_bytes(H, r, rb),
                                     blocks, threads_of(rb));
  };
  if (resident)
    return query(peephole_scan_persistent<float, true, 128>,
                 peephole_scan_persistent<__nv_bfloat16, true, 128>, true,
                 128);
  if (rows == 128)
    return query(peephole_scan_persistent<float, false, 128>,
                 peephole_scan_persistent<__nv_bfloat16, false, 128>, false,
                 128);
  return query(peephole_scan_persistent<float, false, 64>,
               peephole_scan_persistent<__nv_bfloat16, false, 64>, false, 64);
}

// proj (T, B, 4H) f32 or bf16, wt = W_h^T (4H, H), pt = [P_o | P_i | P_f]^T
// (3H, H) bf16, h and c (B, H) f32 holding h0 / c0 and left holding h_T /
// c_T, hx (B, H) and cx (2, B, H) bf16 scratch, hs (T, B, H) in proj's
// dtype, bar one zeroed uint32. Runs the rows [row0, row0 + nrows) of the
// batch, rows (128, or 64 streamed) a block; resident: the weight slice
// stays in shared memory (else streamed).
extern "C" int peephole_scan_f32(const void* proj, const void* wt,
                                 const void* pt, void* h, void* c, void* hx,
                                 void* cx, void* hs, void* bar, int T, int B,
                                 int H, int row0, int nrows, int resident,
                                 int rows, void* stream) {
  return run_scan<float>(proj, wt, pt, h, c, hx, cx, hs, bar, T, B, H, row0,
                         nrows, resident, rows, stream);
}

extern "C" int peephole_scan_bf16(const void* proj, const void* wt,
                                  const void* pt, void* h, void* c, void* hx,
                                  void* cx, void* hs, void* bar, int T,
                                  int B, int H, int row0, int nrows,
                                  int resident, int rows, void* stream) {
  return run_scan<__nv_bfloat16>(proj, wt, pt, h, c, hx, cx, hs, bar, T, B,
                                 H, row0, nrows, resident, rows, stream);
}
