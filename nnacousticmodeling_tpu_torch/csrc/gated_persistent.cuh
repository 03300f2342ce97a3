// The persistent gated recurrence (GRU, and the minimal GRU with or
// without its reset gate), one source for two kernels: the serving scan
// (gated_scan.cu, kernel gated_scan_persistent) and the training forward,
// which also writes the backward's residual row (gated_train.cu, kernel
// gated_train_fwd_persistent). Both instantiate recurrence() below, so
// their hs and h_T are bit-equal by construction. Also the block layout
// that the training backward (gated_train.cu) takes.
//
// Per step (the precision contract of _gated_train_fwd_impl,
// nnacousticmodeling_tpu/ops/rnn_pallas.py:722-747), with p = bf16(proj[t])
// and m1 = bf16(h) @ bf16(w1) (f32 accumulation):
//
//     gru:     r = sigmoid(p_r + m1_r),  z = sigmoid(p_z + m1_z),
//              hb = tanh(p_c + bf16(r h) @ bf16(w2))
//     mgru_r:  z = sigmoid(p_z + m1_z),  r = sigmoid(p_r + m1_r),
//              hb = act(p_c + bf16(r h) @ bf16(w2))
//     mgru:    z = sigmoid(p_z + m1_z),  hb = act(p_c + m1_c),  r = 0
//     all:     h' = z hb + (1 - z) h     (f32 carry; z gates the candidate)
//
// Packing orders: gru proj [r, z, c], w1 [r | z]; mgru_r proj [z, c, r],
// w1 [z | r]; mgru proj [z, c], w1 [z | c] (no w2). act: tanh, relu or
// sigmoid (tanh for gru). hs[t] = h' in proj's dtype, and with RES the
// residual row res[t] = bf16([r | z | hb | h_prev]) (4H).
//
// gru and mgru_r need r h of every unit before the candidate's product,
// so a step is two phases, each ended by one split grid barrier:
//
//   A:  bf16(h_{t-1}) @ w1 (2 gate groups) -> r, z; bf16(r h) exchanged;
//   B:  bf16(r h) @ w2 (1 group) -> hb and h_t; bf16(h_t) exchanged.
//
// mgru takes one phase a step, bf16(h_{t-1}) @ [u_z | u] -> z, hb, h_t,
// like the LSTM.
//
// The layout. One cooperative launch (every block co-resident) walks all
// T steps. A block owns UB = 16 hidden units -- all gate columns of them --
// for RB = 64 batch rows. Each warp owns 16 rows x 8 units, one n8 tile of
// the mma a gate, so that each thread's accumulators hold all gates of the
// same 4 cells (peephole_persistent::Cells) and the cell update, z between
// the phases and the f32 h stay in its registers; only bf16 copies, what
// the products take, are exchanged. The block's 3 UB x H weight slice (w1^T
// rows of its two groups, w2^T rows; two groups for mgru) is loaded into
// shared memory once (99 KB at H=1024) and stays for all T; where it does
// not fit (H > 1792), or the grid is not co-resident at one block an SM,
// the same code streams it from L2 beside the exchange each phase (two
// blocks an SM), and where H/16 such blocks are not co-resident either
// (H > 4224 on a 132-SM card) a block takes RB = 32 rows (four blocks an
// SM, H <= 8448). The ring, the chunks and the warp products are
// peephole_persistent.cuh's, with its measurement knobs (PEEP_LEAVE_OUT
// for bench_gated_layouts.py). Why 16 units: each phase every block reads
// the whole exchange vector of its rows from L2, (H / UB) x B x H x 2
// bytes across the grid, the largest part of a peephole step (PERF.md);
// 16 units read half of what 8 do. GATED_UNITS=8 (RB = 128, narrow 64)
// builds the other layout for bench_gated_layouts.py.
//
// Exchange buffers: hx (2, B, H), h_t in slot t % 2, and rx (B, H). rx is
// written in phase A of step t and read in phase B; its next write, in
// phase A of step t+1, follows the barrier ending phase B, at which every
// block arrives only once its product has drained its ring. mgru writes
// h_t in the phase that reads h_{t-1}, hence two h slots; gru and mgru_r
// keep them too. Between an arrive and its wait a block touches no
// exchange buffer (only its hs and residual stores and the next proj
// loads). The products run on the tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 accumulation); every sum runs in one fixed order, so the
// same inputs give the same bits. The elementwise arithmetic is pinned to
// round-to-nearest intrinsics in the reference's order (activate and
// interpolate below).

#pragma once

#include "peephole_persistent.cuh"

#ifndef GATED_UNITS
#define GATED_UNITS 16
#endif

// Not in an unnamed namespace, for the reason lstm_persistent.cuh gives.
namespace gated_persistent {

using namespace mma_ptx;
using lstm_persistent::as_bf16;
using lstm_persistent::grid_arrive;
using lstm_persistent::grid_wait;
using lstm_persistent::sigmoidf;
using lstm_persistent::store_out;
using peephole_persistent::Cells;
using peephole_persistent::chunk;
using peephole_persistent::cooperative;
using peephole_persistent::ldk;
using peephole_persistent::reduce_extent;
using peephole_persistent::ring_loop;
using peephole_persistent::ring_stages;
using peephole_persistent::stage8;
using peephole_persistent::warp_mma;

enum { KIND_GRU = 0, KIND_MGRU_R = 1, KIND_MGRU = 2 };
enum { ACT_TANH = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

__device__ __forceinline__ float activate(int act, float x) {
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  if (act == ACT_SIGMOID) return sigmoidf(x);
  return tanhf(x);
}

// z * hb + (1 - z) * h, each operation rounded on its own
__device__ __forceinline__ float interpolate(float z, float hb, float h) {
  return __fadd_rn(__fmul_rn(z, hb), __fmul_rn(__fsub_rn(1.0f, z), h));
}

constexpr int UB = GATED_UNITS;        // hidden units per block
constexpr int ROWS = 1024 / UB;        // batch rows per block
constexpr int GROUPS = 3;              // gate groups a resident slice holds
static_assert(UB == 8 || UB == 16, "GATED_UNITS is 8 or 16");

// A block owns ROWS batch rows, or half as many where the grid of
// streamed ROWS-row blocks is not co-resident; the slice is resident only
// at ROWS. Its warps: RB / 16 along the rows times UB / 8 along the units.
__host__ __device__ constexpr int threads_of(int rb) {
  return rb / 16 * (UB / 8) * 32;
}
__host__ __device__ constexpr bool valid_layout(bool resident, int rb) {
  return rb == ROWS || (rb == ROWS / 2 && !resident);
}
// co-resident blocks an SM the kernels are built for: 128 registers a
// thread at most where streamed
__host__ __device__ constexpr int min_blocks(bool resident, int rb) {
  return resident ? 1 : 512 / threads_of(rb);
}

// the resident slice (room for 3 groups of every kind) and the ring; a
// streamed ring stage holds the exchange tile and up to 2 groups' rows
inline size_t fwd_smem_bytes(int H, bool resident, int rb) {
  const size_t ring = (size_t)ring_stages(resident) *
                      (rb + (resident ? 0 : 2 * UB)) * ldk(resident) * 2;
  const size_t w =
      resident ? (size_t)GROUPS * UB * (reduce_extent(H, true) + 8) * 2 : 0;
  return w + ring;
}

inline dim3 grid_of(int H, int nrows, int rb) {
  return dim3((H + UB - 1) / UB, (nrows + rb - 1) / rb);
}

// ---- the host side that the scan, the training forward and the training
// backward share: the layout dispatch, the argument checks, the launch and
// the co-residency query

// A layout as types, for the kernel templates.
template <bool R, int RB>
struct Layout {
  static constexpr bool resident = R;
  static constexpr int rb = RB;
};

// f(Layout<...>{}) for the layout (resident, rows), which the caller has
// checked with valid_layout.
template <typename F>
int with_layout(bool resident, int rows, F f) {
  if (resident) return f(Layout<true, ROWS>{});
  return rows == ROWS ? f(Layout<false, ROWS>{})
                      : f(Layout<false, ROWS / 2>{});
}

// The arguments of a launch over the rows [row0, row0 + nrows); w2 and
// x2 are the w2 operand and its exchange buffer, which mgru goes without.
inline bool args_ok(int T, int B, int row0, int nrows, int kind, int act,
                    const void* w2, const void* x2, int resident, int rows) {
  return T >= 1 && nrows >= 1 && row0 >= 0 && row0 + nrows <= B &&
         kind >= 0 && kind <= KIND_MGRU && act >= 0 && act <= ACT_SIGMOID &&
         (kind == KIND_MGRU || (w2 != nullptr && x2 != nullptr)) &&
         valid_layout(resident, rows);
}

// One cooperative launch of pick(layout), a kernel over nrows rows at
// this H, with smem(H, resident, rb) bytes of shared memory; args are the
// kernel's arguments, of its exact parameter types.
template <typename Smem, typename Pick, typename... Args>
int launch_layout(Smem smem, int H, int nrows, int resident, int rows,
           void* stream, Pick pick, Args... args) {
  return with_layout(resident, rows, [&](auto L) {
    using Lt = decltype(L);
    return cooperative(pick(L), grid_of(H, nrows, Lt::rb),
                       threads_of(Lt::rb), smem(H, Lt::resident, Lt::rb),
                       static_cast<cudaStream_t>(stream), args...);
  });
}

// How many blocks of pick(layout, dtype) -- one kernel for each dtype,
// float and bf16 -- can be co-resident on the current device at this H
// with smem(H, resident, rb) bytes of shared memory: 0 when that exceeds
// the card's or there is no such layout.
template <typename Smem, typename Pick>
int layout_capacity(Smem smem, int H, int resident, int rows, int* blocks,
             Pick pick) {
  *blocks = 0;
  if (H < 1 || !valid_layout(resident, rows)) return 0;
  return with_layout(resident, rows, [&](auto L) {
    using Lt = decltype(L);
    return lstm_persistent::capacity(
        pick(L, float{}), pick(L, __nv_bfloat16{}),
        smem(H, Lt::resident, Lt::rb), blocks, threads_of(Lt::rb));
  });
}

// The kernel's arguments: proj (T, B, gp*H) f32 or bf16 (gp = 3, or 2 for
// mgru), w1t = w1^T (2H, H) and w2t = w2^T (H, H) bf16 (null for mgru), h
// (B, H) f32 holding h0 and left holding h_T, hx (2, B, H) and rx (B, H)
// bf16 exchange (rx unused for mgru), hs (T, B, H) in proj's dtype, res
// (T, B, 4H) bf16 (RES only), bar one zeroed uint32; the rows [row0, row0
// + nrows) of the batch, RB rows a block; kind and act as the enums above.
template <typename TP, bool RESIDENT, bool RES, int RB>
__device__ __forceinline__ void recurrence(
    const TP* __restrict__ proj, const __nv_bfloat16* __restrict__ w1t,
    const __nv_bfloat16* __restrict__ w2t, float* __restrict__ h,
    __nv_bfloat16* hx, __nv_bfloat16* rx, TP* __restrict__ hs,
    __nv_bfloat16* __restrict__ res, unsigned int* bar, int T, int B, int H,
    int row0, int nrows, int kind, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(valid_layout(RESIDENT, RB), "no such layout");
  constexpr int THREADS = threads_of(RB), RW = RB / 16;
  constexpr int KC = chunk(RESIDENT), LDK = ldk(RESIDENT);
  constexpr int STAGES = ring_stages(RESIDENT);
  constexpr int STAGE = (RB + (RESIDENT ? 0 : 2 * UB)) * LDK;
  const bool gru = kind == KIND_GRU, two = kind != KIND_MGRU;
  const int NG = two ? 3 : 2;   // gate groups: w1's two, w2's one
  const int Hk = reduce_extent(H, RESIDENT), NK = Hk / KC, LDW = Hk + 8;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [n][k]
  __nv_bfloat16* ring = w_s + (RESIDENT ? GROUPS * UB * LDW : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp % RW, wu = warp / RW;   // the warp's rows and units
  const int j0 = blockIdx.x * UB;
  const int b0 = row0 + blockIdx.y * RB;
  const int bend = row0 + nrows;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const size_t G = (size_t)(two ? 3 : 2) * H, BH = (size_t)B * H;
  const bool vec = H % 8 == 0;   // 16-byte aligned rows of the operands

  // ng * UB rows x kcount columns (a multiple of 8) of the gate groups
  // [g0, g0 + ng) of the block's slice from column k0 into dst (row stride
  // ld); zeros past H. Row n holds unit j0 + 8 (n / 8ng) + n % 8 of group
  // g0 + (n / 8) % ng -- each warp's groups are consecutive n8 tiles. A
  // group g < 2 row is w1^T's row g H + j, group 2 w2^T's row j.
  auto load_w = [&](__nv_bfloat16* dst, int ld, int g0, int ng, int k0,
                    int kcount) {
    const int per = kcount / 8;
    for (int e = tid; e < ng * UB * per; e += THREADS) {
      const int n = e / per, k = (e % per) * 8;
      const int g = g0 + (n / 8) % ng;
      const int jj = j0 + n / (8 * ng) * 8 + n % 8;
      const __nv_bfloat16* row =
          g < 2 ? w1t + ((size_t)g * H + jj) * H : w2t + (size_t)jj * H;
      copy8(dst + (size_t)n * ld + k, jj < H ? row + k0 + k : w1t,
            jj < H ? H - (k0 + k) : 0, vec);
    }
  };
  // acc[ni] += bf16(x) @ gate group g0 + ni of the warp's units, for its
  // rows; x (B, H) an exchange vector
  auto product = [&](auto& acc, const __nv_bfloat16* x, int g0) {
    constexpr int NT = sizeof(acc) / sizeof(acc[0]);
    auto load = [&](int s, int kc) {
      __nv_bfloat16* dst = ring + s * STAGE;
      const int k0 = kc * KC;
      for (int e = tid; e < RB * (KC / 8); e += THREADS) {
        const int r = e / (KC / 8), k = (e % (KC / 8)) * 8;
        const int b = b0 + r;
        stage8(dst + r * LDK + k, b < bend ? x + (size_t)b * H + k0 + k : x,
               b < bend ? H - (k0 + k) : 0, vec);
      }
      if (!RESIDENT) load_w(dst + RB * LDK, LDK, g0, NT, k0, KC);
    };
    auto compute = [&](int s, int kc) {
      if (PEEP_LEAVE_OUT == 2) return;
      const __nv_bfloat16* a_s = ring + s * STAGE + wr * 16 * LDK;
      if (RESIDENT)
        warp_mma<NT, KC>(acc, a_s, LDK,
                         w_s + (size_t)(wu * NG + g0) * 8 * LDW + kc * KC,
                         LDW);
      else
        warp_mma<NT, KC>(acc, a_s, LDK,
                         ring + s * STAGE + (RB + wu * NT * 8) * LDK, LDK);
    };
    if (PEEP_LEAVE_OUT != 3) ring_loop<STAGES>(NK, load, compute);
  };

  if (RESIDENT) {
    load_w(w_s, LDW, 0, NG, 0, Hk);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // the thread's 4 cells: h, z between the phases and the next proj row
  // live in its registers (proj as loaded: rounded to bf16 where it is
  // used, so that the load's latency hides behind the barrier)
  const Cells cl(b0 + wr * 16, bend, j0 + wu * 8, H);
  float h_r[4], z_r[4];
  TP p_r[4][3] = {};
  // with RES: the cell's residual row of the step, in bf16, until its
  // stores behind the barrier
  __nv_bfloat162 r_rz[4], r_bh[4];
  auto load_proj = [&](int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const TP* pr = proj + ((size_t)t * B + cl.b[e]) * G + cl.j[e];
      p_r[e][0] = pr[0];
      p_r[e][1] = pr[H];
      if (two) p_r[e][2] = pr[2 * H];
    }
  };
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h_r[e] = cl.own[e] ? h[cl.idx[e]] : 0.0f;
    if (cl.own[e]) hx[cl.idx[e]] = __float2bfloat16(h_r[e]);   // slot 0
  }
  unsigned int barriers = 1;
  grid_arrive(bar);
  load_proj(0);
  grid_wait(bar, nblocks);

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hsrc = hx + (size_t)(t & 1) * BH;
    __nv_bfloat16* hdst = hx + (size_t)((t + 1) & 1) * BH;
    float hb_r[4];
    if (two) {
      // ---- phase A: bf16(h_{t-1}) @ w1, then r, z and bf16(r h)
      {
        float acc[2][4] = {};
        product(acc, hsrc, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!cl.own[e]) continue;
          // gru: [r | z] and proj [r, z, c]; mgru_r: [z | r], [z, c, r]
          const float m_r = gru ? acc[0][e] : acc[1][e];
          const float m_z = gru ? acc[1][e] : acc[0][e];
          const float rg =
              sigmoidf(__fadd_rn(as_bf16(gru ? p_r[e][0] : p_r[e][2]), m_r));
          const float zg =
              sigmoidf(__fadd_rn(as_bf16(gru ? p_r[e][1] : p_r[e][0]), m_z));
          z_r[e] = zg;
          if (RES) r_rz[e] = __floats2bfloat162_rn(rg, zg);
          rx[cl.idx[e]] = __float2bfloat16(__fmul_rn(rg, h_r[e]));
        }
      }
      grid_arrive(bar);
      grid_wait(bar, nblocks * ++barriers);
      // ---- phase B: bf16(r h) @ w2, the candidate
      {
        float acc[1][4] = {};
        product(acc, rx, 2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hb_r[e] = activate(act, __fadd_rn(as_bf16(gru ? p_r[e][2]
                                                        : p_r[e][1]),
                                            acc[0][e]));
      }
    } else {
      // ---- one phase: bf16(h_{t-1}) @ [u_z | u], z and the candidate
      float acc[2][4] = {};
      product(acc, hsrc, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z_r[e] = sigmoidf(__fadd_rn(as_bf16(p_r[e][0]), acc[0][e]));
        hb_r[e] = activate(act, __fadd_rn(as_bf16(p_r[e][1]), acc[1][e]));
        if (RES) r_rz[e] = __floats2bfloat162_rn(0.0f, z_r[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const float hn = interpolate(z_r[e], hb_r[e], h_r[e]);
      if (RES) r_bh[e] = __floats2bfloat162_rn(hb_r[e], h_r[e]);
      h_r[e] = hn;
      hdst[cl.idx[e]] = __float2bfloat16(hn);
    }
    // arrive once h_t is written; hs (and the residual row) and the next
    // proj row while the other blocks catch up
    if (t + 1 < T) grid_arrive(bar);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      store_out(hs + (size_t)t * BH + cl.idx[e], h_r[e]);
      if (RES) {
        __nv_bfloat16* rr = res + ((size_t)t * B + cl.b[e]) * 4 * H + cl.j[e];
        rr[0] = __low2bfloat16(r_rz[e]);
        rr[H] = __high2bfloat16(r_rz[e]);
        rr[2 * H] = __low2bfloat16(r_bh[e]);
        rr[3 * H] = __high2bfloat16(r_bh[e]);
      }
    }
    if (t + 1 == T) break;
    load_proj(t + 1);
    grid_wait(bar, nblocks * ++barriers);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (cl.own[e]) h[cl.idx[e]] = h_r[e];
}

}  // namespace gated_persistent
