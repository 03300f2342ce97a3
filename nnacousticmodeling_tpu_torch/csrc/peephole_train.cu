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
// Forward: peephole_persistent.cuh's recurrence with the residual row
// bf16 [a | i | f | o | tanh c_t | c_{t-1} | h_{t-1} | c_t] (RES = true);
// peephole_scan.cu runs the same body without it, so the two forwards'
// hs, c_T and h_T are bit-equal.
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
// dz_f exist): two grid-wide exchanges a step.
//
// What the designs do about it. Each is one persistent cooperative
// launch per row chunk (ops/rnn_cuda.py peephole_train_fwd_plan and
// peephole_train_bwd_plan; one at B=128, H=1024) that walks all T steps
// with two split grid barriers a step, keeps its weight slice in shared
// memory for all T (streamed from L2 beside the exchange where it does
// not fit) and runs its products on the tensor cores (mma.sync, bf16
// operands, f32 accumulation). The forward is peephole_persistent.cuh's.
// The backward block owns U = 8 hidden units k for RB = 128 batch rows
// (64 where the forward's blocks take 64, the same layouts), 16 a warp:
// dc stays in registers for all T, and the dh, dc and four dz
// columns of its units are local to it. Its products reduce over the dz
// of all units, gate block by gate block; their B operand, per unit k,
// is a dh row (row k of W_h, over 4H) and a dc row (row k of
// [P_i | P_f | P_o], over 3H), both contiguous along the reduction: no
// transposed copy, 115 KB resident at H=1024. Per reverse step:
//
//   1. dz_o and dc's local part; bf16(dz_o) exchanged;
//   2. over the o block: dc += bf16(dz_o) @ P_o^T, and dh's o share;
//      then dz_a, dz_i, dz_f; bf16 of them exchanged;
//   3. over the a, i, f blocks: dh's rest, dc = dc f + the P_i, P_f terms.
//
// The exchange is the (T, B, 4H) bf16 dz scratch that the dW GEMM reads:
// step t writes slice t and nothing overwrites it, so no double buffer.
// The dh and dc sums of a cell are the two n8 tiles of one warp's mma, in
// the registers of the thread that owns the cell: no partials cross
// warps, and every sum runs in one fixed order (the same inputs give the
// same bits). The dW contractions run after the loop as four problems of
// one dw_gemm.cuh launch, on the tensor cores.

#include "dw_gemm.cuh"
#include "peephole_persistent.cuh"

namespace {

using namespace peephole_persistent;

// ---- forward: the persistent recurrence plus the residual row ---------

template <typename TP, bool RESIDENT, int RB>
__global__ void __launch_bounds__(threads_of(RB), min_blocks(RESIDENT, RB))
peephole_train_fwd_persistent(const TP* __restrict__ proj,      // (T,B,4H)
                              const __nv_bfloat16* __restrict__ wt,  // (4H,H)
                              const __nv_bfloat16* __restrict__ pt,  // (3H,H)
                              float* __restrict__ h,    // (B, H) h0 -> h_T
                              float* __restrict__ c,    // (B, H) c0 -> c_T
                              __nv_bfloat16* hx,        // (B, H) exchange
                              __nv_bfloat16* cx,        // (2, B, H) exchange
                              TP* __restrict__ hs,      // (T, B, H)
                              __nv_bfloat16* __restrict__ res,  // (T,B,8H)
                              unsigned int* bar,        // zeroed count
                              int T, int B, int H, int row0, int nrows) {
  recurrence<TP, RESIDENT, true, RB>(proj, wt, pt, h, c, hx, cx, hs, res, bar,
                                     T, B, H, row0, nrows);
}

template <typename TP>
int run_fwd(const void* proj, const void* wt, const void* pt, void* h,
            void* c, void* hx, void* cx, void* hs, void* res, void* bar,
            int T, int B, int H, int row0, int nrows, int resident,
            int rows, void* stream) {
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
        static_cast<__nv_bfloat16*>(res), static_cast<unsigned int*>(bar), T,
        B, H, row0, nrows);
  };
  if (resident) return args(peephole_train_fwd_persistent<TP, true, 128>,
                            true, 128);
  return rows == 128
             ? args(peephole_train_fwd_persistent<TP, false, 128>, false, 128)
             : args(peephole_train_fwd_persistent<TP, false, 64>, false, 64);
}

// ---- backward: one persistent launch over all reverse steps -----------

namespace bwd {

// per unit: a dh row (4 gate blocks) and a dc row (3), each block padded
// to whole chunks, each row by 8; streamed, a ring stage holds the
// chunk's U dh rows and U dc rows beside the dz tile of rb rows
inline size_t smem_bytes(int H, bool resident, int rb) {
  const size_t ring = (size_t)ring_stages(resident) *
                      (rb + (resident ? 0 : 2 * U)) * ldk(resident) * 2;
  const size_t w =
      resident ? (size_t)U * (7 * reduce_extent(H, true) + 16) * 2 : 0;
  return w + ring;
}

}  // namespace bwd

template <typename TD, bool RESIDENT, int RB>
__global__ void __launch_bounds__(threads_of(RB), min_blocks(RESIDENT, RB))
peephole_train_bwd_persistent(
    const __nv_bfloat16* __restrict__ res,  // (T, B, 8H)
    const __nv_bfloat16* __restrict__ wh,   // (H, 4H)
    const __nv_bfloat16* __restrict__ pm,   // (H, 3H) [P_i | P_f | P_o]
    const float* __restrict__ dhs,          // (T, B, H)
    const float* __restrict__ dh_T,         // (B, H)
    float* __restrict__ dc,                 // (B, H) dc_T in, dc0 out
    TD* __restrict__ dproj,                 // (T, B, 4H)
    __nv_bfloat16* dz,                      // (T, B, 4H) exchange
    float* __restrict__ dh0,                // (B, H)
    unsigned int* bar,                      // zeroed barrier count
    int T, int B, int H, int row0, int nrows) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(valid_layout(RESIDENT, RB), "no such layout");
  constexpr int THREADS = threads_of(RB);
  constexpr int KC = chunk(RESIDENT), LDK = ldk(RESIDENT);
  constexpr int STAGES = ring_stages(RESIDENT);
  constexpr int STAGE = (RB + (RESIDENT ? 0 : 2 * U)) * LDK;
  const int Hk = reduce_extent(H, RESIDENT), NKB = Hk / KC;
  const int LD4 = 4 * Hk + 8, LD3 = 3 * Hk + 8;   // resident row strides
  __nv_bfloat16* dh_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [u][n]
  __nv_bfloat16* dc_s = dh_s + (RESIDENT ? U * LD4 : 0);
  __nv_bfloat16* ring = dc_s + (RESIDENT ? U * LD3 : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0u = blockIdx.x * U;
  const int b0 = row0 + blockIdx.y * RB;
  const int bend = row0 + nrows;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const int G = 4 * H;
  const size_t BG = (size_t)B * G, BH = (size_t)B * H;
  const bool vec = H % 8 == 0;   // 16-byte aligned gate blocks

  // U dh rows (gate block blk of W_h's rows k) and, for blk >= 1, U dc
  // rows (block blk - 1 of [P_i | P_f | P_o]'s rows k), kcount columns (a
  // multiple of 8) from column n0 of the block, into dh_dst / dc_dst (row
  // strides ld4 / ld3); zeros past H
  auto load_w = [&](__nv_bfloat16* dh_dst, int ld4, __nv_bfloat16* dc_dst,
                    int ld3, int blk, int n0, int kcount) {
    const int per = kcount / 8, rows = blk >= 1 ? 2 * U : U;
    for (int e = tid; e < rows * per; e += THREADS) {
      const int r = e / per, n = n0 + (e % per) * 8;
      const int k = k0u + r % U;
      const bool dcrow = r >= U;
      const __nv_bfloat16* src =
          dcrow ? pm + (size_t)k * 3 * H + (blk - 1) * H + n
                : wh + (size_t)k * G + blk * H + n;
      __nv_bfloat16* dst = dcrow ? dc_dst + (r - U) * ld3 + (n - n0)
                                 : dh_dst + r * ld4 + (n - n0);
      copy8(dst, k < H ? src : wh, k < H ? H - n : 0, vec);
    }
  };
  if (RESIDENT) {
    for (int blk = 0; blk < 4; ++blk)
      load_w(dh_s + blk * Hk, LD4, dc_s + (blk - 1) * Hk, LD3, blk, 0, Hk);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // acc_h += bf16(dz_t) @ W_h^T and acc_c[blk - 1] += the peephole part
  // of gate block blk, over the gate blocks [blk0, blk0 + nblk) of the dz
  // of all units, for the thread's cells
  auto product = [&](const __nv_bfloat16* src, int blk0, int nblk,
                     float (&acc_h)[1][4], float (&acc_c)[3][4]) {
    auto load = [&](int s, int kc) {
      __nv_bfloat16* dst = ring + s * STAGE;
      const int blk = blk0 + kc / NKB, n0 = (kc % NKB) * KC;
      for (int e = tid; e < RB * (KC / 8); e += THREADS) {
        const int r = e / (KC / 8), n = (e % (KC / 8)) * 8;
        const int b = b0 + r;
        stage8(dst + r * LDK + n,
               b < bend ? src + (size_t)b * G + blk * H + n0 + n : src,
               b < bend ? H - (n0 + n) : 0, vec);
      }
      if (!RESIDENT)
        load_w(dst + RB * LDK, LDK, dst + (RB + U) * LDK, LDK, blk, n0, KC);
    };
    auto compute = [&](int s, int kc) {
      if (PEEP_LEAVE_OUT == 2) return;
      const int blk = blk0 + kc / NKB, n0 = (kc % NKB) * KC;
      const __nv_bfloat16* a_s = ring + s * STAGE + warp * 16 * LDK;
      const __nv_bfloat16* bh = RESIDENT ? dh_s + blk * Hk + n0
                                         : ring + s * STAGE + RB * LDK;
      const int ldh = RESIDENT ? LD4 : LDK;
      if (blk == 0) {   // the a block: no peephole
        warp_mma<1, KC>(acc_h, a_s, LDK, bh, ldh);
        return;
      }
      const __nv_bfloat16* bc = RESIDENT ? dc_s + (blk - 1) * Hk + n0
                                         : bh + U * LDK;
      const int ldc = RESIDENT ? LD3 : LDK;
      // one ldmatrix_x4 over both B tiles: lanes 0-15 address the dh rows
      // (b0, b1 of tile 0), lanes 16-31 the dc rows (tile 1)
      const __nv_bfloat16* bl =
          lane < 16 ? bh + (size_t)(lane % 8) * ldh
                    : bc + (size_t)(lane % 8) * ldc;
      auto mma2 = [&](float (&ac)[4]) {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, a_s + (((lane / 8) % 2) * 8 + lane % 8) * LDK
                              + kk + (lane / 16) * 8);
          ldmatrix_x4(bf, bl + kk + ((lane / 8) % 2) * 8);
          mma_bf16(acc_h[0], af, bf[0], bf[1]);
          mma_bf16(ac, af, bf[2], bf[3]);
        }
      };
      // constant indices: the accumulators stay in registers
      if (blk == 1)
        mma2(acc_c[0]);
      else if (blk == 2)
        mma2(acc_c[1]);
      else
        mma2(acc_c[2]);
    };
    if (PEEP_LEAVE_OUT != 3) ring_loop<STAGES>(nblk * NKB, load, compute);
  };

  // the thread's 4 cells (peephole_persistent::Cells). dc lives in its
  // registers for all T; the step's residuals and dhs are loaded behind
  // the previous step's second barrier. The elementwise arithmetic is
  // pinned to round-to-nearest intrinsics in the order of :1147-1191, so
  // no FMA contraction moves a dz across a bf16 rounding boundary.
  const Cells cl(b0 + warp * 16, bend, k0u, H);
  float dc_r[4], dh_r[4], dhs_r[4];
  __nv_bfloat162 r_r[4][3];   // (a, i), (f, o), (tanh c_t, c_{t-1})
  auto load_step = [&](int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const __nv_bfloat16* rr =
          res + ((size_t)t * B + cl.b[e]) * 8 * H + cl.j[e];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        r_r[e][p] = __halves2bfloat162(rr[2 * p * H], rr[(2 * p + 1) * H]);
      dhs_r[e] = dhs[(size_t)t * BH + cl.idx[e]];
    }
  };
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dc_r[e] = cl.own[e] ? dc[cl.idx[e]] : 0.0f;
    dh_r[e] = cl.own[e] ? dh_T[cl.idx[e]] : 0.0f;
  }
  load_step(T - 1);

  unsigned int barriers = 0;
  for (int t = T - 1;; --t) {
    const size_t zt = (size_t)t * BG;
    // ---- 1. dz_o and dc without its P_o term; bf16(dz_o) exchanged
    float dzo[4], dcp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const float o = __high2float(r_r[e][1]);
      const float tc = __low2float(r_r[e][2]);
      const float dh_tot = __fadd_rn(dhs_r[e], dh_r[e]);
      dzo[e] = __fmul_rn(__fmul_rn(__fmul_rn(dh_tot, tc), o),
                         __fsub_rn(1.0f, o));
      dcp[e] = __fadd_rn(dc_r[e],
                         __fmul_rn(__fmul_rn(dh_tot, o),
                                   __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      dz[zt + (size_t)cl.b[e] * G + 3 * H + cl.j[e]] =
          __float2bfloat16(dzo[e]);
    }
    grid_arrive(bar);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      store_out(dproj + zt + (size_t)cl.b[e] * G + 3 * H + cl.j[e], dzo[e]);
    }
    grid_wait(bar, nblocks * ++barriers);

    // ---- 2. over the o block: dc's P_o term and dh's o share; then
    // dz_a, dz_i, dz_f, exchanged
    float acc_h[1][4] = {}, acc_c[3][4] = {};
    product(dz + zt, 3, 1, acc_h, acc_c);
    float dzv[4][3], dcf[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const float a = __low2float(r_r[e][0]);
      const float ig = __high2float(r_r[e][0]);
      const float f = __low2float(r_r[e][1]);
      const float cp = __high2float(r_r[e][2]);
      const float dcv = __fadd_rn(dcp[e], acc_c[2][e]);
      dzv[e][0] = __fmul_rn(__fmul_rn(dcv, ig),
                            __fsub_rn(1.0f, __fmul_rn(a, a)));
      dzv[e][1] = __fmul_rn(__fmul_rn(__fmul_rn(dcv, a), ig),
                            __fsub_rn(1.0f, ig));
      dzv[e][2] = __fmul_rn(__fmul_rn(__fmul_rn(dcv, cp), f),
                            __fsub_rn(1.0f, f));
      dcf[e] = __fmul_rn(dcv, f);
      __nv_bfloat16* zr = dz + zt + (size_t)cl.b[e] * G + cl.j[e];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
        zr[gt * H] = __float2bfloat16(dzv[e][gt]);
    }
    // arrive once they are written; dproj and the next step's inputs
    // while the other blocks catch up
    grid_arrive(bar);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      TD* pr = dproj + zt + (size_t)cl.b[e] * G + cl.j[e];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) store_out(pr + gt * H, dzv[e][gt]);
    }
    if (t > 0) load_step(t - 1);
    grid_wait(bar, nblocks * ++barriers);

    // ---- 3. over the a, i, f blocks: dh of step t - 1 (dh0 after t = 0)
    // and dc = dc f + the P_i term + the P_f term
    product(dz + zt, 0, 3, acc_h, acc_c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      dh_r[e] = acc_h[0][e];
      dc_r[e] = __fadd_rn(__fadd_rn(dcf[e], acc_c[0][e]), acc_c[1][e]);
    }
    if (t == 0) break;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!cl.own[e]) continue;
    dc[cl.idx[e]] = dc_r[e];
    dh0[cl.idx[e]] = dh_r[e];
  }
}

template <typename TD>
int run_bwd(const void* res, const void* wh, const void* pm, const void* dhs,
            const void* dh_T, void* dc, void* dproj, void* dz, void* dh0,
            void* bar, int T, int B, int H, int row0, int nrows,
            int resident, int rows, void* stream) {
  if (T < 1 || nrows < 1 || row0 < 0 || row0 + nrows > B ||
      !valid_layout(resident, rows))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto kern, bool r, int rb) {
    return cooperative(
        kern, grid_of(H, nrows, rb), threads_of(rb),
        bwd::smem_bytes(H, r, rb), static_cast<cudaStream_t>(stream),
        static_cast<const __nv_bfloat16*>(res),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<const __nv_bfloat16*>(pm),
        static_cast<const float*>(dhs), static_cast<const float*>(dh_T),
        static_cast<float*>(dc), static_cast<TD*>(dproj),
        static_cast<__nv_bfloat16*>(dz), static_cast<float*>(dh0),
        static_cast<unsigned int*>(bar), T, B, H, row0, nrows);
  };
  if (resident) return args(peephole_train_bwd_persistent<TD, true, 128>,
                            true, 128);
  return rows == 128
             ? args(peephole_train_bwd_persistent<TD, false, 128>, false, 128)
             : args(peephole_train_bwd_persistent<TD, false, 64>, false, 64);
}

}  // namespace

// How many blocks of the forward (backward = 0) or the backward kernel,
// with the weight slice resident or streamed and rows batch rows a block,
// can be co-resident on the current device at this H, for both dtypes: 0
// when a block's shared memory would exceed the card's or there is no
// such layout.
extern "C" int peephole_train_capacity(int backward, int H, int resident,
                                       int rows, int* blocks) {
  *blocks = 0;
  if (H < 1 || !valid_layout(resident, rows)) return 0;
  using lstm_persistent::capacity;
  auto query = [&](auto fwd_f32, auto fwd_bf16, auto bwd_f32, auto bwd_bf16,
                   bool r, int rb) {
    return backward ? capacity(bwd_f32, bwd_bf16, bwd::smem_bytes(H, r, rb),
                               blocks, threads_of(rb))
                    : capacity(fwd_f32, fwd_bf16, fwd_smem_bytes(H, r, rb),
                               blocks, threads_of(rb));
  };
  if (resident)
    return query(peephole_train_fwd_persistent<float, true, 128>,
                 peephole_train_fwd_persistent<__nv_bfloat16, true, 128>,
                 peephole_train_bwd_persistent<float, true, 128>,
                 peephole_train_bwd_persistent<__nv_bfloat16, true, 128>,
                 true, 128);
  if (rows == 128)
    return query(peephole_train_fwd_persistent<float, false, 128>,
                 peephole_train_fwd_persistent<__nv_bfloat16, false, 128>,
                 peephole_train_bwd_persistent<float, false, 128>,
                 peephole_train_bwd_persistent<__nv_bfloat16, false, 128>,
                 false, 128);
  return query(peephole_train_fwd_persistent<float, false, 64>,
               peephole_train_fwd_persistent<__nv_bfloat16, false, 64>,
               peephole_train_bwd_persistent<float, false, 64>,
               peephole_train_bwd_persistent<__nv_bfloat16, false, 64>,
               false, 64);
}

// proj (T, B, 4H) f32 or bf16, wt = W_h^T (4H, H), pt = [P_o | P_i | P_f]^T
// (3H, H) bf16, h and c (B, H) f32 holding h0 / c0 and left holding h_T /
// c_T, hx (B, H) and cx (2, B, H) bf16 scratch, hs (T, B, H) in proj's
// dtype, res (T, B, 8H) bf16, bar one zeroed uint32. Runs the rows
// [row0, row0 + nrows) of the batch, rows (128, or 64 streamed) a block;
// resident: the weight slice stays in shared memory (else streamed).
extern "C" int peephole_train_fwd_f32(const void* proj, const void* wt,
                                      const void* pt, void* h, void* c,
                                      void* hx, void* cx, void* hs,
                                      void* res, void* bar, int T, int B,
                                      int H, int row0, int nrows,
                                      int resident, int rows, void* stream) {
  return run_fwd<float>(proj, wt, pt, h, c, hx, cx, hs, res, bar, T, B, H,
                        row0, nrows, resident, rows, stream);
}

extern "C" int peephole_train_fwd_bf16(const void* proj, const void* wt,
                                       const void* pt, void* h, void* c,
                                       void* hx, void* cx, void* hs,
                                       void* res, void* bar, int T, int B,
                                       int H, int row0, int nrows,
                                       int resident, int rows, void* stream) {
  return run_fwd<__nv_bfloat16>(proj, wt, pt, h, c, hx, cx, hs, res, bar, T,
                                B, H, row0, nrows, resident, rows, stream);
}

// res (T, B, 8H) bf16, wh (H, 4H) and pm = [P_i | P_f | P_o] (H, 3H) bf16,
// dhs (T, B, H) f32, dh_T (B, H) f32, dc (B, H) f32 holding dc_T and left
// holding dc0, dproj (T, B, 4H) in proj's dtype, dz (T, B, 4H) bf16
// scratch (left holding bf16(dz) for the dW contractions), dh0 (B, H) f32
// out, bar one zeroed uint32. Runs the rows [row0, row0 + nrows) of the
// batch; resident and rows as for the forward.
extern "C" int peephole_train_bwd_f32(const void* res, const void* wh,
                                      const void* pm, const void* dhs,
                                      const void* dh_T, void* dc,
                                      void* dproj, void* dz, void* dh0,
                                      void* bar, int T, int B, int H,
                                      int row0, int nrows, int resident,
                                      int rows, void* stream) {
  return run_bwd<float>(res, wh, pm, dhs, dh_T, dc, dproj, dz, dh0, bar, T,
                        B, H, row0, nrows, resident, rows, stream);
}

extern "C" int peephole_train_bwd_bf16(const void* res, const void* wh,
                                       const void* pm, const void* dhs,
                                       const void* dh_T, void* dc,
                                       void* dproj, void* dz, void* dh0,
                                       void* bar, int T, int B, int H,
                                       int row0, int nrows, int resident,
                                       int rows, void* stream) {
  return run_bwd<__nv_bfloat16>(res, wh, pm, dhs, dh_T, dc, dproj, dz, dh0,
                                bar, T, B, H, row0, nrows, resident, rows,
                                stream);
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
