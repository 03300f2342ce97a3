// Trainable LSTM recurrence for Hopper (sm_90a): the forward that also
// writes the backward's residuals, the reverse-time backward, and the
// weight-gradient contraction.
//
// Replaces the TPU kernels of nnacousticmodeling_tpu/ops/rnn_pallas.py
// behind lstm_scan_pallas_train (:627):
//
//   lstm_train_fwd_*  <- _lstm_train_fwd_impl (:384, pallas_call :448)
//   lstm_train_bwd_*  <- _lstm_train_bwd_impl (:485, pallas_call :590),
//   lstm_train_dw        its dW contraction (:575-580)
//
// Forward: lstm_persistent.cuh's recurrence with the residual row
// (RES = true), the step code of lstm_scan.cu, so hs, c_T and h_T are
// bit-equal to lstm_scan's; per step it also writes
// res[t] = bf16([a | i | f | o | tanh c | c_{t-1} | h_{t-1}]) (7H).
//
// Backward, per step in reverse time (the operation order of :532-571):
//
//     dh_tot = dhs[t] + dh;   do = dh_tot * tanh c
//     dc = dc + dh_tot * o * (1 - tanh^2 c)
//     dz = [dc*i*(1-a^2), dc*a*i(1-i), dc*c_{t-1}*f(1-f), do*o(1-o)]
//     dproj[t] = dz (unrounded, in proj's dtype);  dzb = bf16(dz)
//     dh = dzb @ bf16(W_h)^T (f32 accumulation);  dc = dc * f
//
// and dW = sum_t bf16(h_{t-1})^T dzb_t in f32, as one contraction over
// the T*B rows after the reverse loop (dw_gemm.cuh, on the tensor cores).
//
// What bounds them on this card. At T=20, B=128, H=1024 the forward
// does 2*T*B*H*4H = 21.5 GFLOP (0.022 ms at the bf16 tensor rate)
// against ~90 MB of proj, residuals and hs (0.027 ms at 3.35 TB/s); the
// backward 43 GFLOP against ~140 MB. Both sit far below the floor of the
// serial recurrence: T dependent steps, each a grid-wide exchange.
//
// What the designs do about it. Each is one persistent cooperative
// launch per row chunk (ops/rnn_cuda.py lstm_scan_plan and
// lstm_train_bwd_plan; one at B=128, H=1024) that walks all T steps with
// one split grid barrier a step, and keeps its W_h slice in shared
// memory for all T (streamed from L2 beside the exchange where it does
// not fit). The backward block owns U = 16 hidden units k for RB = 64
// batch rows: its dc stays in registers for all T, and its dh_t, dc and
// residuals are all local to it, as the forward's cell update is. Its
// product dh_t = dzb_{t+1} @ W_h^T reduces over 4H: the B operand is the
// rows k0..k0+U of the (H, 4H) W_h, contiguous along the reduction (no
// transposed copy; 128 KB at H=1024), the A operand dzb_{t+1} for the
// block's rows, streamed from L2 in 128-wide chunks through a cp.async
// ring. The (T, B, 4H) bf16 dz scratch that the dW GEMM reads is the
// exchange buffer: step t writes slice t and nothing overwrites it. The
// product is mma.sync.m16n8k16 (bf16 operands, f32 accumulation); N is
// only 16 units, so the 8 warps split each chunk's reduction (16 columns
// a warp) and add their partials in shared memory in one fixed order:
// the same inputs give the same bits. Per reverse step the grid pulls
// dzb from L2 once for every unit block, B * 4H * 2 bytes * H/U = 64 MB
// at B=128, H=1024; yet a step takes about as long at a quarter of those
// bytes (bench_lstm_train_steps.py): what bounds it grows with the 32
// ring stages a step walks and the barrier, not with the stream.

#include "dw_gemm.cuh"
#include "lstm_persistent.cuh"

namespace {

using lstm_persistent::grid_arrive;
using lstm_persistent::grid_wait;
using lstm_persistent::store_out;
using namespace mma_ptx;

// ---- forward: the shared recurrence plus the residual row -------------

template <typename TP, bool RESIDENT>
__global__ void __launch_bounds__(lstm_persistent::THREADS, RESIDENT ? 1 : 2)
lstm_train_fwd_persistent(const TP* __restrict__ proj,           // (T, B, 4H)
                          const __nv_bfloat16* __restrict__ wt,  // (4H, H)
                          float* __restrict__ h,      // (B, H) h0 in, h_T out
                          float* __restrict__ c,      // (B, H) c0 in, c_T out
                          __nv_bfloat16* hx,          // (2, B, H) exchange
                          TP* __restrict__ hs,        // (T, B, H)
                          __nv_bfloat16* __restrict__ res,   // (T, B, 7H)
                          unsigned int* bar,          // zeroed barrier count
                          int T, int B, int H, int row0, int nrows) {
  lstm_persistent::recurrence<TP, RESIDENT, true>(
      proj, wt, h, c, hx, hs, res, bar, T, B, H, row0, nrows);
}

template <typename TP>
int run_fwd(const void* proj, const void* wt, void* h, void* c, void* hx,
            void* hs, void* res, void* bar, int T, int B, int H, int row0,
            int nrows, int resident, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident
      ? lstm_persistent::launch<TP>(lstm_train_fwd_persistent<TP, true>,
                                    true, proj, wt, h, c, hx, hs, res, bar,
                                    T, B, H, row0, nrows, st)
      : lstm_persistent::launch<TP>(lstm_train_fwd_persistent<TP, false>,
                                    false, proj, wt, h, c, hx, hs, res, bar,
                                    T, B, H, row0, nrows, st);
}

// ---- backward: one persistent launch over all reverse steps -----------

namespace bwd {

constexpr int U = 16;          // hidden units per block
constexpr int RB = 64;         // batch rows per block
constexpr int KC = 128;        // reduction chunk of one ring stage
constexpr int THREADS = 256;   // 8 warps, one 16-wide slice of a chunk each
constexpr int WARPS = THREADS / 32;
constexpr int LDK = KC + 8;    // padded row of a ring tile (elements)
constexpr int LDP = U + 4;     // padded row of a warp's partials (floats)
// ring depth: 5 stages beside a resident W_h slice, 4 (of dzb and W_h)
// when W_h is streamed; both hold the warps' partials once drained
__host__ __device__ constexpr int ring_stages(bool resident) {
  return resident ? 5 : 4;
}
__host__ __device__ constexpr int stage_elems(bool resident) {
  return (RB + (resident ? 0 : U)) * LDK;
}
static_assert((size_t)WARPS * RB * LDP * 4 <=
                  (size_t)ring_stages(true) * stage_elems(true) * 2 &&
              (size_t)WARPS * RB * LDP * 4 <=
                  (size_t)ring_stages(false) * stage_elems(false) * 2,
              "the drained ring holds every warp's partials");

__host__ __device__ inline int reduce_extent(int H) {
  return (4 * H + KC - 1) / KC * KC;
}

inline size_t smem_bytes(int H, bool resident) {
  const size_t ring =
      (size_t)ring_stages(resident) * stage_elems(resident) * 2;
  const size_t w = resident ? (size_t)U * (reduce_extent(H) + 8) * 2 : 0;
  return w + ring;
}

}  // namespace bwd

template <typename TD, bool RESIDENT>
__global__ void __launch_bounds__(bwd::THREADS, RESIDENT ? 1 : 2)
lstm_train_bwd_persistent(const __nv_bfloat16* __restrict__ res,  // (T,B,7H)
                          const __nv_bfloat16* __restrict__ wh,   // (H, 4H)
                          const float* __restrict__ dhs,          // (T, B, H)
                          const float* __restrict__ dh_T,         // (B, H)
                          float* __restrict__ dc,     // (B, H) dc_T -> dc0
                          TD* __restrict__ dproj,                 // (T,B,4H)
                          __nv_bfloat16* dz,          // (T, B, 4H) exchange
                          float* __restrict__ dh0,                // (B, H)
                          unsigned int* bar,          // zeroed barrier count
                          int T, int B, int H, int row0, int nrows) {
  using namespace bwd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const int Kx = reduce_extent(H), NK = Kx / KC, LDW = Kx + 8;
  constexpr int STAGES = ring_stages(RESIDENT);
  constexpr int STAGE = stage_elems(RESIDENT);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [u][n]
  __nv_bfloat16* ring = w_s + (RESIDENT ? U * LDW : 0);
  float* part = reinterpret_cast<float*>(ring);   // [warp][row][unit]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * U;
  const int b0 = row0 + blockIdx.y * RB;
  const int bend = row0 + nrows;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const size_t BG = (size_t)B * G, BH = (size_t)B * H;
  const bool vec = G % 8 == 0;   // 16-byte aligned rows of dz and W_h

  // U rows x kcount columns (a multiple of 8) of W_h[k0:k0+U, n0:] into
  // dst (row stride ld); zeros past 4H and past H
  auto load_w = [&](__nv_bfloat16* dst, int ld, int n0, int kcount) {
    for (int e = tid; e < U * (kcount / 8); e += THREADS) {
      const int r = e / (kcount / 8), n = (e % (kcount / 8)) * 8;
      const int kk = k0 + r;
      copy8(dst + r * ld + n, kk < H ? wh + (size_t)kk * G + n0 + n : wh,
            kk < H ? G - (n0 + n) : 0, vec);
    }
  };
  // ring stage s <- chunk kc of dzb (RB rows x KC) and, streaming, of W_h
  auto load_stage = [&](int s, int kc, const __nv_bfloat16* src) {
    __nv_bfloat16* dst = ring + s * STAGE;
    const int n0 = kc * KC;
    for (int e = tid; e < RB * (KC / 8); e += THREADS) {
      const int r = e / (KC / 8), n = (e % (KC / 8)) * 8;
      const int b = b0 + r;
      copy8(dst + r * LDK + n, b < bend ? src + (size_t)b * G + n0 + n : src,
            b < bend ? G - (n0 + n) : 0, vec);
    }
    if (!RESIDENT) load_w(dst + RB * LDK, LDK, n0, KC);
  };

  if (RESIDENT) {
    load_w(w_s, LDW, 0, Kx);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // the thread's cells: unit k, rows rq, rq + 16, rq + 32, rq + 48 of the
  // tile. dc lives in its registers for all T; the step's residuals and
  // dhs are loaded behind the previous step's barrier.
  const int u = tid % U, rq = tid / U;
  const int k = k0 + u;
  float dc_r[4], dh_r[4], dhs_r[4];
  __nv_bfloat162 r_r[4][3];   // (a, i), (f, o), (tanh c, c_{t-1})
  size_t idx[4];
  bool own[4];
  auto load_step = [&](int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!own[q]) continue;
      const __nv_bfloat16* rr =
          res + ((size_t)t * B + b0 + rq + 16 * q) * 7 * H + k;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        r_r[q][g] = __halves2bfloat162(rr[2 * g * H], rr[(2 * g + 1) * H]);
      dhs_r[q] = dhs[(size_t)t * BH + idx[q]];
    }
  };
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = b0 + rq + 16 * q;
    own[q] = k < H && b < bend;
    idx[q] = own[q] ? (size_t)b * H + k : 0;
    dc_r[q] = own[q] ? dc[idx[q]] : 0.0f;
    dh_r[q] = own[q] ? dh_T[idx[q]] : 0.0f;   // the last step: no product
  }
  load_step(T - 1);

  // dh_r <- (dzb of one step, src (B, 4H)) @ W_h^T for the thread's cells
  auto product = [&](const __nv_bfloat16* src) {
    float acc[4][2][4];   // [16-row tile][8-unit tile][fragment]
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < NK) load_stage(s, s, src);
      cp_async_commit();
    }
    const int ldb = RESIDENT ? LDW : LDK;
    const int kk = warp * 16;   // the warp's slice of each chunk
    for (int kc = 0; kc < NK; ++kc) {
      const int s = kc % STAGES;
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nk = kc + STAGES - 1;
      if (nk < NK) load_stage(nk % STAGES, nk, src);
      cp_async_commit();
      const __nv_bfloat16* a_s = ring + s * STAGE;
      const __nv_bfloat16* b_s = RESIDENT ? w_s + kc * KC : a_s + RB * LDK;
      // W tile [unit][n]: tiles (u 0, n 0), (u 0, n 8), (u 8, n 0),
      // (u 8, n 8) give b0, b1 of the two 8-unit tiles
      uint32_t bf[4];
      ldmatrix_x4(bf, b_s + (size_t)((lane / 16) * 8 + lane % 8) * ldb + kk
                          + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // dzb tile [row][n]: tiles (r 0, n 0), (r 8, n 0), (r 0, n 8),
        // (r 8, n 8) give a0..a3
        uint32_t af[4];
        ldmatrix_x4(af, a_s + (mi * 16 + ((lane / 8) % 2) * 8 + lane % 8)
                                  * LDK
                            + kk + (lane / 16) * 8);
        mma_bf16(acc[mi][0], af, bf[0], bf[1]);
        mma_bf16(acc[mi][1], af, bf[2], bf[3]);
      }
    }
    // the drained ring takes each warp's partials; they are added in
    // warp order
    cp_async_wait<0>();
    __syncthreads();
    const int g = lane / 4, q4 = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        float* pp = part + (warp * RB + mi * 16 + g) * LDP + ni * 8 + 2 * q4;
        pp[0] = acc[mi][ni][0];
        pp[1] = acc[mi][ni][1];
        pp[8 * LDP] = acc[mi][ni][2];
        pp[8 * LDP + 1] = acc[mi][ni][3];
      }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += part[(w * RB + rq + 16 * q) * LDP + u];
      dh_r[q] = sum;
    }
  };

  for (int t = T - 1;; --t) {
    // step t's elementwise part: dzb_t (the exchange) and dproj_t
    float dzv[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!own[q]) continue;
      const float a = __low2float(r_r[q][0]);
      const float ig = __high2float(r_r[q][0]);
      const float f = __low2float(r_r[q][1]);
      const float o = __high2float(r_r[q][1]);
      const float tc = __low2float(r_r[q][2]);
      const float cp = __high2float(r_r[q][2]);
      const float dh_tot = dhs_r[q] + dh_r[q];
      const float dout = dh_tot * tc;
      const float dcv = dc_r[q] + dh_tot * o * (1.0f - tc * tc);
      const float da = dcv * ig;
      const float dig = dcv * a;
      const float df = dcv * cp;
      dc_r[q] = dcv * f;
      dzv[q][0] = da * (1.0f - a * a);
      dzv[q][1] = dig * ig * (1.0f - ig);
      dzv[q][2] = df * f * (1.0f - f);
      dzv[q][3] = dout * o * (1.0f - o);
      __nv_bfloat16* zr = dz + (size_t)t * BG
                          + (size_t)(b0 + rq + 16 * q) * G + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) zr[g * H] = __float2bfloat16(dzv[q][g]);
    }
    // arrive once dzb_t is written; dproj_t and the next step's inputs
    // while the other blocks catch up
    grid_arrive(bar);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!own[q]) continue;
      TD* pr = dproj + (size_t)t * BG + (size_t)(b0 + rq + 16 * q) * G + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) store_out(pr + g * H, dzv[q][g]);
    }
    if (t > 0) load_step(t - 1);
    grid_wait(bar, nblocks * (unsigned int)(T - t));
    // dh of step t - 1 (dh0 after t = 0)
    product(dz + (size_t)t * BG);
    if (t == 0) break;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!own[q]) continue;
    dc[idx[q]] = dc_r[q];
    dh0[idx[q]] = dh_r[q];
  }
}

template <typename TD, bool RESIDENT>
int launch_bwd(const void* res, const void* wh, const void* dhs,
               const void* dh_T, void* dc, void* dproj, void* dz, void* dh0,
               void* bar, int T, int B, int H, int row0, int nrows,
               cudaStream_t stream) {
  auto kern = lstm_train_bwd_persistent<TD, RESIDENT>;
  const size_t smem = bwd::smem_bytes(H, RESIDENT);
  if (smem > lstm_persistent::SMEM_MAX || T < 1 || nrows < 1 || row0 < 0 ||
      row0 + nrows > B)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* p_res = static_cast<const __nv_bfloat16*>(res);
  const __nv_bfloat16* p_wh = static_cast<const __nv_bfloat16*>(wh);
  const float* p_dhs = static_cast<const float*>(dhs);
  const float* p_dh_T = static_cast<const float*>(dh_T);
  float* p_dc = static_cast<float*>(dc);
  TD* p_dproj = static_cast<TD*>(dproj);
  __nv_bfloat16* p_dz = static_cast<__nv_bfloat16*>(dz);
  float* p_dh0 = static_cast<float*>(dh0);
  unsigned int* p_bar = static_cast<unsigned int*>(bar);
  void* args[] = {&p_res, &p_wh, &p_dhs, &p_dh_T, &p_dc, &p_dproj, &p_dz,
                  &p_dh0, &p_bar, &T, &B, &H, &row0, &nrows};
  const dim3 grid((H + bwd::U - 1) / bwd::U, (nrows + bwd::RB - 1) / bwd::RB);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    grid, dim3(bwd::THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TD>
int run_bwd(const void* res, const void* wh, const void* dhs,
            const void* dh_T, void* dc, void* dproj, void* dz, void* dh0,
            void* bar, int T, int B, int H, int row0, int nrows, int resident,
            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident
      ? launch_bwd<TD, true>(res, wh, dhs, dh_T, dc, dproj, dz, dh0, bar, T,
                             B, H, row0, nrows, st)
      : launch_bwd<TD, false>(res, wh, dhs, dh_T, dc, dproj, dz, dh0, bar,
                              T, B, H, row0, nrows, st);
}

}  // namespace

// How many blocks of the forward (backward = 0) or the backward kernel,
// with W_h's slice resident or streamed, can be co-resident on the
// current device at this H, for both dtypes: 0 when a block's shared
// memory would exceed the card's.
extern "C" int lstm_train_capacity(int backward, int H, int resident,
                                   int* blocks) {
  *blocks = 0;
  if (H < 1) return 0;
  using lstm_persistent::capacity;
  if (backward) {
    const size_t smem = bwd::smem_bytes(H, resident != 0);
    return resident
        ? capacity(lstm_train_bwd_persistent<float, true>,
                   lstm_train_bwd_persistent<__nv_bfloat16, true>, smem,
                   blocks)
        : capacity(lstm_train_bwd_persistent<float, false>,
                   lstm_train_bwd_persistent<__nv_bfloat16, false>, smem,
                   blocks);
  }
  const size_t smem = lstm_persistent::smem_bytes(H, resident != 0);
  return resident
      ? capacity(lstm_train_fwd_persistent<float, true>,
                 lstm_train_fwd_persistent<__nv_bfloat16, true>, smem,
                 blocks)
      : capacity(lstm_train_fwd_persistent<float, false>,
                 lstm_train_fwd_persistent<__nv_bfloat16, false>, smem,
                 blocks);
}

// proj (T, B, 4H) f32 or bf16, wt = W_h^T (4H, H) bf16, h and c (B, H)
// f32 holding h0 / c0 and left holding h_T / c_T, hx (2, B, H) bf16
// scratch, hs (T, B, H) in proj's dtype, res (T, B, 7H) bf16, bar one
// zeroed uint32. Runs the rows [row0, row0 + nrows) of the batch;
// resident: W_h's slice stays in shared memory (else streamed).
extern "C" int lstm_train_fwd_f32(const void* proj, const void* wt, void* h,
                                  void* c, void* hx, void* hs, void* res,
                                  void* bar, int T, int B, int H, int row0,
                                  int nrows, int resident, void* stream) {
  return run_fwd<float>(proj, wt, h, c, hx, hs, res, bar, T, B, H, row0,
                        nrows, resident, stream);
}

extern "C" int lstm_train_fwd_bf16(const void* proj, const void* wt, void* h,
                                   void* c, void* hx, void* hs, void* res,
                                   void* bar, int T, int B, int H, int row0,
                                   int nrows, int resident, void* stream) {
  return run_fwd<__nv_bfloat16>(proj, wt, h, c, hx, hs, res, bar, T, B, H,
                                row0, nrows, resident, stream);
}

// res (T, B, 7H) bf16, wh (H, 4H) bf16, dhs (T, B, H) f32, dh_T (B, H)
// f32, dc (B, H) f32 holding dc_T and left holding dc0, dproj (T, B, 4H)
// in proj's dtype, dz (T, B, 4H) bf16 scratch (left holding bf16(dz) for
// the dW contraction), dh0 (B, H) f32 out, bar one zeroed uint32. Runs
// the rows [row0, row0 + nrows) of the batch; resident as for the
// forward.
extern "C" int lstm_train_bwd_f32(const void* res, const void* wh,
                                  const void* dhs, const void* dh_T, void* dc,
                                  void* dproj, void* dz, void* dh0, void* bar,
                                  int T, int B, int H, int row0, int nrows,
                                  int resident, void* stream) {
  return run_bwd<float>(res, wh, dhs, dh_T, dc, dproj, dz, dh0, bar, T, B, H,
                        row0, nrows, resident, stream);
}

extern "C" int lstm_train_bwd_bf16(const void* res, const void* wh,
                                   const void* dhs, const void* dh_T,
                                   void* dc, void* dproj, void* dz,
                                   void* dh0, void* bar, int T, int B, int H,
                                   int row0, int nrows, int resident,
                                   void* stream) {
  return run_bwd<__nv_bfloat16>(res, wh, dhs, dh_T, dc, dproj, dz, dh0, bar,
                                T, B, H, row0, nrows, resident, stream);
}

// dW_h (H, 4H) f32 = sum over the M = T*B rows of h_{t-1}^T dz, from the
// residuals (M, 7H) bf16 (h_{t-1} in the last H columns) and dz (M, 4H)
// bf16: one problem of dw_gemm.cuh, described by desc (see dw_gemm::launch)
// with the tiling that ops/rnn_cuda.py dw_plan("lstm", H) picks.
extern "C" int lstm_train_dw(const long long* desc, int count, int M, int H,
                             int bn, int bk, int stages, void* stream) {
  return dw_gemm::launch(desc, count, M, H, bn, bk, stages,
                         static_cast<cudaStream_t>(stream));
}
