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
// [r | z | hb | h_prev] (RES = true; r = 0 for mgru); gated_scan.cu runs
// the same body without it, so the two forwards' hs and h_T are
// bit-equal.
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
// What the designs do about it. Each is one persistent cooperative launch
// per row chunk (ops/rnn_cuda.py gated_train_fwd_plan and
// gated_train_bwd_plan; one at B=128, H=1024) that walks all T steps with
// one split grid barrier a phase, keeps its weight slice in shared memory
// for all T (streamed from L2 beside the exchange where it does not fit)
// and sums on the tensor cores (mma.sync, bf16 operands, f32
// accumulation). The forward is gated_persistent.cuh's. The backward
// takes the forward's layouts: a block owns UB = 16 hidden units k for 64
// batch rows (32 where the forward's blocks take 32), warps of 16 rows x
// 8 units, so that the dh sums of a cell land in the registers of the
// thread that owns it, and the carried partial dh' stays there for all
// T. Its B operands, per unit k, are row k of w1 (over the 2H pair
// columns, as two groups of H) and row k of w2 (over H), contiguous along
// the reduction: no transposed copy, the forward's three groups of
// slice (99 KB at H=1024). Per reverse step t:
//
//   A:  the z and candidate part, all of whose operands are local to the
//       block's cells; bf16(dzpre) (and bf16(dcpre): mgru into the pair,
//       gru / mgru_r into dc) exchanged;
//   B:  (gru, mgru_r) drh = bf16(dc_t) @ w2^T, then the reset gate's
//       part; bf16(drpre) exchanged into the pair;
//
// each ended by one split grid barrier, then dh = dh' + bf16(pair_t) @
// w1^T for step t - 1 (dh0 after t = 0). The exchanges are the (T, B, 2H)
// pair and (T, B, H) dc scratch that the dW contractions read after the
// loop: step t writes slice t and nothing overwrites it, so no double
// buffer. Every sum runs in one fixed order (the same inputs give the
// same bits). The dW contractions are one dw_gemm.cuh launch on the
// tensor cores: dW1 and dW2 as two problems of one grid, bf16(r * h_prev)
// formed as its tile lands in shared memory.

#include "dw_gemm.cuh"
#include "gated_persistent.cuh"

namespace {

using namespace gated_persistent;

// ---- forward: the persistent recurrence plus the residual row ---------

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
  if (!args_ok(T, B, row0, nrows, kind, act, w2t, rx, resident, rows))
    return (int)cudaErrorInvalidValue;
  return launch_layout(
      fwd_smem_bytes, H, nrows, resident, rows, stream,
      [](auto L) {
        return gated_train_fwd_persistent<TP, decltype(L)::resident,
                                          decltype(L)::rb>;
      },
      static_cast<const TP*>(proj), static_cast<const __nv_bfloat16*>(w1t),
      static_cast<const __nv_bfloat16*>(w2t), static_cast<float*>(h),
      static_cast<__nv_bfloat16*>(hx), static_cast<__nv_bfloat16*>(rx),
      static_cast<TP*>(hs), static_cast<__nv_bfloat16*>(res),
      static_cast<unsigned int*>(bar), T, B, H, row0, nrows, kind, act);
}

// ---- backward: one persistent launch over all reverse steps -----------

namespace bwd {

// the resident slice (room for the three groups, each row padded by 8)
// and the ring; a streamed ring stage holds one group's UB rows of the
// chunk beside the exchange tile of rb rows
inline size_t smem_bytes(int H, bool resident, int rb) {
  const size_t ring = (size_t)ring_stages(resident) *
                      (rb + (resident ? 0 : UB)) * ldk(resident) * 2;
  const size_t w =
      resident ? (size_t)GROUPS * UB * (reduce_extent(H, true) + 8) * 2 : 0;
  return w + ring;
}

// d act / d pre-activation through the output hb, in the reference's
// order
__device__ __forceinline__ float act_grad(int act, float hb) {
  if (act == ACT_RELU) return hb > 0.0f ? 1.0f : 0.0f;
  if (act == ACT_SIGMOID) return __fmul_rn(hb, __fsub_rn(1.0f, hb));
  return __fsub_rn(1.0f, __fmul_rn(hb, hb));
}

}  // namespace bwd

template <typename TD, bool RESIDENT, int RB>
__global__ void __launch_bounds__(threads_of(RB), min_blocks(RESIDENT, RB))
gated_train_bwd_persistent(
    const __nv_bfloat16* __restrict__ res,  // (T, B, 4H)
    const __nv_bfloat16* __restrict__ w1,   // (H, 2H)
    const __nv_bfloat16* __restrict__ w2,   // (H, H), null for mgru
    const float* __restrict__ dhs,          // (T, B, H)
    const float* __restrict__ dh_T,         // (B, H)
    TD* __restrict__ dproj,                 // (T, B, gp*H)
    __nv_bfloat16* pair,                    // (T, B, 2H) exchange
    __nv_bfloat16* dc,                      // (T, B, H) exchange, or null
    float* __restrict__ dh0,                // (B, H)
    unsigned int* bar,                      // zeroed barrier count
    int T, int B, int H, int row0, int nrows, int kind, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(valid_layout(RESIDENT, RB), "no such layout");
  constexpr int THREADS = threads_of(RB), RW = RB / 16;
  constexpr int KC = chunk(RESIDENT), LDK = ldk(RESIDENT);
  constexpr int STAGES = ring_stages(RESIDENT);
  constexpr int STAGE = (RB + (RESIDENT ? 0 : UB)) * LDK;
  const bool gru = kind == KIND_GRU, two = kind != KIND_MGRU;
  const int Hk = reduce_extent(H, RESIDENT), NKB = Hk / KC, LDW = Hk + 8;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [g][u][n]
  __nv_bfloat16* ring = w_s + (RESIDENT ? GROUPS * UB * LDW : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp % RW, wu = warp / RW;   // the warp's rows and units
  const int k0u = blockIdx.x * UB;
  const int b0 = row0 + blockIdx.y * RB;
  const int bend = row0 + nrows;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const size_t G = (size_t)(two ? 3 : 2) * H, BH = (size_t)B * H;
  const bool vec = H % 8 == 0;   // 16-byte aligned rows and groups

  // UB rows of group g of the block's slice -- g < 2: the columns [g H,
  // g H + H) of w1's rows k, g = 2: w2's rows k -- kcount columns (a
  // multiple of 8) from column n0 of the group into dst (row stride ld);
  // zeros past H
  auto load_w = [&](__nv_bfloat16* dst, int ld, int g, int n0, int kcount) {
    const int per = kcount / 8;
    for (int e = tid; e < UB * per; e += THREADS) {
      const int u = e / per, n = n0 + (e % per) * 8;
      const int k = k0u + u;
      const __nv_bfloat16* src = g < 2 ? w1 + (size_t)k * 2 * H + g * H + n
                                       : w2 + (size_t)k * H + n;
      copy8(dst + u * ld + (n - n0), k < H ? src : w1, k < H ? H - n : 0,
            vec);
    }
  };
  if (RESIDENT) {
    for (int g = 0; g < (two ? 3 : 2); ++g)
      load_w(w_s + g * UB * LDW, LDW, g, 0, Hk);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // acc += bf16(x) @ (the warp's 8 rows of the groups [g0, g0 + ng))^T
  // for the warp's rows: x (B, .) with row stride ldx holds group g's
  // reduction columns at (g - g0) H
  auto product = [&](float (&acc)[1][4], const __nv_bfloat16* x, int ldx,
                     int g0, int ng) {
    auto load = [&](int s, int kc) {
      __nv_bfloat16* dst = ring + s * STAGE;
      const int g = g0 + kc / NKB, n0 = (kc % NKB) * KC;
      const __nv_bfloat16* xs = x + (size_t)(g - g0) * H + n0;
      for (int e = tid; e < RB * (KC / 8); e += THREADS) {
        const int r = e / (KC / 8), n = (e % (KC / 8)) * 8;
        const int b = b0 + r;
        stage8(dst + r * LDK + n, b < bend ? xs + (size_t)b * ldx + n : x,
               b < bend ? H - (n0 + n) : 0, vec);
      }
      if (!RESIDENT) load_w(dst + RB * LDK, LDK, g, n0, KC);
    };
    auto compute = [&](int s, int kc) {
      if (PEEP_LEAVE_OUT == 2) return;
      const int g = g0 + kc / NKB, n0 = (kc % NKB) * KC;
      const __nv_bfloat16* a_s = ring + s * STAGE + wr * 16 * LDK;
      if (RESIDENT)
        warp_mma<1, KC>(acc, a_s, LDK,
                        w_s + (size_t)(g * UB + wu * 8) * LDW + n0, LDW);
      else
        warp_mma<1, KC>(acc, a_s, LDK, ring + s * STAGE + (RB + wu * 8) * LDK,
                        LDK);
    };
    if (PEEP_LEAVE_OUT != 3) ring_loop<STAGES>(ng * NKB, load, compute);
  };

  // the thread's 4 cells (peephole_persistent::Cells). dh and the partial
  // dh' live in its registers for all T; the step's residuals and dhs are
  // loaded behind the previous step's last barrier. The elementwise
  // arithmetic is pinned to round-to-nearest intrinsics in the order of
  // :824-881, so no FMA contraction moves a value across a bf16 rounding
  // boundary that the plain version does not cross.
  const Cells cl(b0 + wr * 16, bend, k0u + wu * 8, H);
  float dh_r[4], part_r[4], dhs_r[4];
  __nv_bfloat162 r_rz[4], r_bh[4];   // (r, z), (hb, h_prev)
  auto load_step = [&](int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const __nv_bfloat16* rr =
          res + ((size_t)t * B + cl.b[e]) * 4 * H + cl.j[e];
      r_rz[e] = __halves2bfloat162(rr[0], rr[H]);
      r_bh[e] = __halves2bfloat162(rr[2 * H], rr[3 * H]);
      dhs_r[e] = dhs[(size_t)t * BH + cl.idx[e]];
    }
  };
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dh_r[e] = cl.own[e] ? dh_T[cl.idx[e]] : 0.0f;
    part_r[e] = 0.0f;
  }
  load_step(T - 1);

  // dproj columns of r, z and the candidate (gru [r, z, c]; mgru_r [z, c,
  // r]; mgru [z, c]) and pair columns of z and r (gru [r | z], mgru_r
  // [z | r]; mgru [z | c])
  const size_t off_r = gru ? 0 : 2 * (size_t)H;
  const size_t off_z = gru ? (size_t)H : 0;
  const size_t off_c = gru ? 2 * (size_t)H : (size_t)H;
  const size_t pz = gru ? (size_t)H : 0, pr = gru ? 0 : (size_t)H;
  unsigned int barriers = 0;
  for (int t = T - 1;; --t) {
    const size_t gt = (size_t)t * B * G;
    __nv_bfloat16* pair_t = pair + (size_t)t * 2 * BH;
    // ---- A: dzpre and dcpre; bf16 of them exchanged
    float dzp[4], dcp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const float z = __high2float(r_rz[e]);
      const float hb = __low2float(r_bh[e]), hp = __high2float(r_bh[e]);
      const float dh_tot = __fadd_rn(dhs_r[e], dh_r[e]);
      const float dz = __fmul_rn(dh_tot, __fsub_rn(hb, hp));
      const float dhb = __fmul_rn(dh_tot, z);
      part_r[e] = __fmul_rn(dh_tot, __fsub_rn(1.0f, z));
      dzp[e] = __fmul_rn(__fmul_rn(dz, z), __fsub_rn(1.0f, z));
      dcp[e] = __fmul_rn(dhb, bwd::act_grad(act, hb));
      __nv_bfloat16* pp = pair_t + (size_t)cl.b[e] * 2 * H + cl.j[e];
      pp[pz] = __float2bfloat16(dzp[e]);
      if (two)
        dc[(size_t)t * BH + cl.idx[e]] = __float2bfloat16(dcp[e]);
      else
        pp[H] = __float2bfloat16(dcp[e]);
    }
    // arrive once they are written; dproj (and for mgru the next step's
    // inputs) while the other blocks catch up
    grid_arrive(bar);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      TD* dp = dproj + gt + (size_t)cl.b[e] * G + cl.j[e];
      store_out(dp + off_z, dzp[e]);
      store_out(dp + off_c, dcp[e]);
    }
    if (!two && t > 0) load_step(t - 1);
    grid_wait(bar, nblocks * ++barriers);

    if (two) {
      // ---- B: drh = bf16(dcpre) @ w2^T, then the reset gate's part;
      // bf16(drpre) exchanged
      float acc[1][4] = {};
      product(acc, dc + (size_t)t * BH, H, 2, 1);
      float drp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!cl.own[e]) continue;
        const float r = __low2float(r_rz[e]);
        const float hp = __high2float(r_bh[e]);
        const float drh = acc[0][e];
        const float dr = __fmul_rn(drh, hp);
        part_r[e] = __fadd_rn(part_r[e], __fmul_rn(drh, r));
        drp[e] = __fmul_rn(__fmul_rn(dr, r), __fsub_rn(1.0f, r));
        pair_t[(size_t)cl.b[e] * 2 * H + pr + cl.j[e]] =
            __float2bfloat16(drp[e]);
      }
      grid_arrive(bar);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!cl.own[e]) continue;
        store_out(dproj + gt + (size_t)cl.b[e] * G + off_r + cl.j[e],
                  drp[e]);
      }
      if (t > 0) load_step(t - 1);
      grid_wait(bar, nblocks * ++barriers);
    }

    // ---- dh of step t - 1 (dh0 after t = 0): dh' + bf16(pair_t) @ w1^T
    float acc[1][4] = {};
    product(acc, pair_t, 2 * H, 0, 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) dh_r[e] = __fadd_rn(part_r[e], acc[0][e]);
    if (t == 0) break;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (cl.own[e]) dh0[cl.idx[e]] = dh_r[e];
}

template <typename TD>
int run_bwd(const void* res, const void* w1, const void* w2, const void* dhs,
            const void* dh_T, void* dproj, void* pair, void* dc, void* dh0,
            void* bar, int T, int B, int H, int row0, int nrows, int kind,
            int act, int resident, int rows, void* stream) {
  if (!args_ok(T, B, row0, nrows, kind, act, w2, dc, resident, rows))
    return (int)cudaErrorInvalidValue;
  return launch_layout(
      bwd::smem_bytes, H, nrows, resident, rows, stream,
      [](auto L) {
        return gated_train_bwd_persistent<TD, decltype(L)::resident,
                                          decltype(L)::rb>;
      },
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_T), static_cast<TD*>(dproj),
      static_cast<__nv_bfloat16*>(pair), static_cast<__nv_bfloat16*>(dc),
      static_cast<float*>(dh0), static_cast<unsigned int*>(bar), T, B, H,
      row0, nrows, kind, act);
}

}  // namespace

// How many blocks of the forward (backward = 0) or the backward kernel,
// with the weight slice resident or streamed and rows batch rows a block,
// can be co-resident on the current device at this H, for both dtypes: 0
// when a block's shared memory would exceed the card's or there is no
// such layout.
extern "C" int gated_train_capacity(int backward, int H, int resident,
                                    int rows, int* blocks) {
  if (backward)
    return layout_capacity(bwd::smem_bytes, H, resident, rows, blocks,
                           [](auto L, auto tp) {
                             return gated_train_bwd_persistent<
                                 decltype(tp), decltype(L)::resident,
                                 decltype(L)::rb>;
                           });
  return layout_capacity(fwd_smem_bytes, H, resident, rows, blocks,
                         [](auto L, auto tp) {
                           return gated_train_fwd_persistent<
                               decltype(tp), decltype(L)::resident,
                               decltype(L)::rb>;
                         });
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
// dhs (T, B, H) f32, dh_T (B, H) f32, dproj (T, B, gp*H) in proj's dtype,
// pair (T, B, 2H) and dc (T, B, H) bf16 scratch (dc null for mgru; left
// holding bf16(pair) and bf16(dcpre) for the dW contractions), dh0 (B, H)
// f32 out, bar one zeroed uint32. Runs the rows [row0, row0 + nrows) of
// the batch; kind, act, resident and rows as for the forward.
extern "C" int gated_train_bwd_f32(const void* res, const void* w1,
                                   const void* w2, const void* dhs,
                                   const void* dh_T, void* dproj, void* pair,
                                   void* dc, void* dh0, void* bar, int T,
                                   int B, int H, int row0, int nrows,
                                   int kind, int act, int resident, int rows,
                                   void* stream) {
  return run_bwd<float>(res, w1, w2, dhs, dh_T, dproj, pair, dc, dh0, bar,
                        T, B, H, row0, nrows, kind, act, resident, rows,
                        stream);
}

extern "C" int gated_train_bwd_bf16(const void* res, const void* w1,
                                    const void* w2, const void* dhs,
                                    const void* dh_T, void* dproj,
                                    void* pair, void* dc, void* dh0,
                                    void* bar, int T, int B, int H, int row0,
                                    int nrows, int kind, int act,
                                    int resident, int rows, void* stream) {
  return run_bwd<__nv_bfloat16>(res, w1, w2, dhs, dh_T, dproj, pair, dc,
                                dh0, bar, T, B, H, row0, nrows, kind, act,
                                resident, rows, stream);
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
