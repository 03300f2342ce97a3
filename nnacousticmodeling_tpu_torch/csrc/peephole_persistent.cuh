// The persistent peephole LSTM recurrence, one source for two kernels: the
// serving scan (peephole_scan.cu, kernel peephole_scan_persistent) and the
// training forward, which also writes the backward's residual row
// (peephole_train.cu, kernel peephole_train_fwd_persistent). Both
// instantiate recurrence() below, so their hs, c_T and h_T are bit-equal
// by construction. Also the block layout, the cp.async ring and the warp
// products that the training backward (peephole_train.cu) and the gated
// recurrence (gated_persistent.cuh) share.
//
// Per step (the precision contract of _peep_train_fwd_impl,
// nnacousticmodeling_tpu/ops/rnn_pallas.py:1031-1054):
//
//     z   = bf16(proj[t]) + bf16(h) @ bf16(W_h)          (f32 accumulation)
//     a   = tanh(z_a)
//     i   = sigmoid(z_i + bf16(c_{t-1}) @ bf16(P_i))
//     f   = sigmoid(z_f + bf16(c_{t-1}) @ bf16(P_f))
//     c_t = f * c_{t-1} + i * a                           (f32 carry)
//     o   = sigmoid(z_o + bf16(c_t) @ bf16(P_o));   h = o * tanh(c_t)
//
// hs[t] = h in proj's dtype, and with RES the residual row res[t] =
// bf16([a | i | f | o | tanh c_t | c_{t-1} | h_{t-1} | c_t]) (8H).
//
// The peepholes are full (H, H) matrices, so a step holds two dependent
// products that each need a grid-wide exchange: o needs c_t of every
// unit. A step is two phases, each ended by one split grid barrier:
//
//   A (step t):  bf16(h_{t-1}) @ W_h (4 gate groups) plus the stored
//                P_i / P_f terms -> a, i, f, c_t; c_t exchanged;
//   B (step t):  bf16(c_t) @ [P_o | P_i | P_f] (3 groups) -> o, h_t, and
//                the P_i / P_f terms of step t+1; h_t exchanged.
//
// A prologue forms bf16(c0) @ [P_i | P_f] from the carried-in c0. Both
// exchange vectors go as bf16, exactly what the products take.
//
// The layout. One cooperative launch (every block co-resident) walks all
// T steps. A block owns U = 8 hidden units -- one n8 tile of the mma a
// gate, so that each thread's accumulators hold all gates of the same 4
// cells (2 rows x 2 units) and the cell update runs in registers, with no
// shared-memory pass -- for RB = 128 batch rows, 16 a warp (8 warps). Its
// 7U x H weight slice (W_h^T's 4 gate rows, then P_o^T, P_i^T, P_f^T) is
// loaded into shared memory once (116 KB at H=1024) and stays for all T;
// where the slice does not fit, or the grid it needs is not co-resident
// at one block an SM, the same code streams it from L2 beside the
// exchange each phase (two blocks an SM), and where H/8 such blocks are
// not co-resident either (H > 2112 on a 132-SM card) a block takes RB =
// 64 rows (4 warps, four blocks an SM, H <= 4224). The exchange vector
// of the block's rows streams from L2 through a cp.async ring: 128-wide
// chunks, 3 stages, when the slice is resident (8 stages a phase at
// H=1024); 64-wide, 4 stages, when streamed. The products run on the
// tensor cores (mma.sync.m16n8k16, bf16 operands, f32 accumulation);
// every sum runs in one fixed order, so the same inputs give the same
// bits. The cell arithmetic is pinned to round-to-nearest intrinsics in
// the reference's order, so no FMA contraction moves a value across a
// bf16 rounding boundary that the plain version does not cross.
//
// Exchange buffers without double buffering: hx (B, H) and cx (2, B, H).
// A block writes c_t into cx[0] in phase A of step t; the blocks read it
// in phase B of step t, and the next write is in phase A of step t+1,
// after the barrier that ends phase B, at which every block arrives only
// once its phase-B product has drained its ring. The same holds for hx
// between phase B of step t and phase A of step t+1. Between an arrive
// and its wait a block touches no exchange buffer (only its hs and
// residual stores and the next proj loads). The one exception is the
// prologue, whose product reads c0 while the first phase A already
// writes c_0: c0 therefore has a slot of its own, cx[1].

#pragma once

#include "lstm_persistent.cuh"

// Measurement knobs for bench_peephole_ring_variants.py and
// bench_gated_layouts.py; the package builds with none of them.
// PEEP_RING_KC / PEEP_RING_STAGES: the chunk and depth of the ring beside
// a resident weight slice. PEEP_LEAVE_OUT leaves parts of every ring out
// of the kernels built on it (the peephole and gated persistent
// kernels), which then compute wrong values: 1 the exchange
// loads, 2 the tensor-core products, 3 the ring altogether, 4 the loads,
// zeros written in their place.
#ifndef PEEP_RING_KC
#define PEEP_RING_KC 128
#endif
#ifndef PEEP_RING_STAGES
#define PEEP_RING_STAGES 3
#endif
#ifndef PEEP_LEAVE_OUT
#define PEEP_LEAVE_OUT 0
#endif

// Not in an unnamed namespace, for the reason lstm_persistent.cuh gives.
namespace peephole_persistent {

using namespace mma_ptx;
using lstm_persistent::as_bf16;
using lstm_persistent::grid_arrive;
using lstm_persistent::grid_wait;
using lstm_persistent::sigmoidf;
using lstm_persistent::store_out;
using lstm_persistent::SMEM_MAX;

constexpr int U = 8;           // hidden units per block: one n8 tile a gate
constexpr int WROWS = 7 * U;   // forward weight rows: 4 gates, then o, i, f

// A block owns RB batch rows, 16 a warp: 128 (8 warps), or 64 (4 warps)
// where the grid of 128-row blocks is not co-resident; the weight slice
// is resident only at 128.
__host__ __device__ constexpr int threads_of(int rb) { return 2 * rb; }
__host__ __device__ constexpr bool valid_layout(bool resident, int rb) {
  return rb == 128 || (rb == 64 && !resident);
}
// co-resident blocks an SM the kernels are built for: 128 registers a
// thread at most in every layout
__host__ __device__ constexpr int min_blocks(bool resident, int rb) {
  return resident ? 1 : 512 / threads_of(rb);
}

// reduction chunk of one ring stage and ring depth, with the weight slice
// resident / streamed
__host__ __device__ constexpr int chunk(bool resident) {
  return resident ? PEEP_RING_KC : 64;
}
__host__ __device__ constexpr int ring_stages(bool resident) {
  return resident ? PEEP_RING_STAGES : 4;
}
__host__ __device__ constexpr int ldk(bool resident) {
  return chunk(resident) + 8;   // padded row of a ring tile (elements)
}

// a ring stage's exchange load of 8 elements (see PEEP_LEAVE_OUT)
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int avail,
                                       bool vec) {
  if (PEEP_LEAVE_OUT == 4)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if (PEEP_LEAVE_OUT != 1)
    copy8(dst, src, avail, vec);
}

// H rounded up to whole chunks
__host__ __device__ inline int reduce_extent(int H, bool resident) {
  return (H + chunk(resident) - 1) / chunk(resident) * chunk(resident);
}

inline size_t fwd_smem_bytes(int H, bool resident, int rb) {
  const size_t ring = (size_t)ring_stages(resident) *
                      (rb + (resident ? 0 : 4 * U)) * ldk(resident) * 2;
  const size_t w =
      resident ? (size_t)WROWS * (reduce_extent(H, true) + 8) * 2 : 0;
  return w + ring;
}

// The ring: prefetch STAGES-1 chunks, then per chunk wait for it, issue
// the load STAGES-1 ahead, and run compute(stage, chunk); drained and
// synchronised at the end, so the next call may refill any stage.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void ring_loop(int nk, Load load,
                                          Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kc + STAGES - 1;
    if (next < nk) load(next % STAGES, next);
    cp_async_commit();
    compute(kc % STAGES, kc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc[ni] += A @ B_ni^T over KC: A the warp's 16 rows at a_s (row stride
// lda, [row][k]), B_ni the 8 rows b_s + 8 ni (row stride ldb, [n][k]).
template <int NT, int KC>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const __nv_bfloat16* a_s, int lda,
                                         const __nv_bfloat16* b_s, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    // A tiles (r 0, k 0), (r 8, k 0), (r 0, k 8), (r 8, k 8): a0..a3
    uint32_t af[4];
    ldmatrix_x4(af, a_s + (((lane / 8) % 2) * 8 + lane % 8) * lda + kk
                        + (lane / 16) * 8);
#pragma unroll
    for (int nh = 0; nh < NT / 2; ++nh) {
      // B tiles (n 0, k 0), (n 0, k 8), (n 8, k 0), (n 8, k 8): b0, b1 of
      // the n8 tiles 2 nh and 2 nh + 1
      uint32_t bf[4];
      ldmatrix_x4(bf, b_s + (size_t)(nh * 16 + (lane / 16) * 8 + lane % 8)
                                * ldb
                          + kk + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * nh], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nh + 1], af, bf[2], bf[3]);
    }
    if (NT % 2) {
      uint32_t bf[2];
      ldmatrix_x2(bf, b_s + (size_t)((NT - 1) * 8 + lane % 8) * ldb + kk
                          + ((lane / 8) % 2) * 8);
      mma_bf16(acc[NT - 1], af, bf[0], bf[1]);
    }
  }
}

// The thread's cells, in the mma accumulator layout: lane (g, q) of a warp
// whose 16 x 8 tile starts at row r0 and unit u0 holds, in every n8 tile,
// rows r0 + g and r0 + g + 8 and units u0 + 2q and u0 + 2q + 1. Cell e =
// 2 r + v: row r, unit v.
struct Cells {
  int b[4];        // batch row
  int j[4];        // hidden unit
  bool own[4];     // inside the batch chunk and H
  size_t idx[4];   // b * H + j (0 where not owned)

  __device__ __forceinline__ Cells(int r0, int bend, int u0, int H) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[e] = r0 + lane / 4 + 8 * (e / 2);
      j[e] = u0 + 2 * (lane % 4) + e % 2;
      own[e] = j[e] < H && b[e] < bend;
      idx[e] = own[e] ? (size_t)b[e] * H + j[e] : 0;
    }
  }
};

// The kernel's arguments: proj (T, B, 4H) f32 or bf16, wt = W_h^T (4H, H)
// bf16, pt = [P_o | P_i | P_f]^T (3H, H) bf16, h and c (B, H) f32 holding
// h0 / c0 and left holding h_T / c_T, hx (B, H) and cx (2, B, H) bf16
// exchange, hs (T, B, H) in proj's dtype, res (T, B, 8H) bf16 (RES only),
// bar one zeroed uint32; the rows [row0, row0 + nrows) of the batch, RB
// rows a block.
template <typename TP, bool RESIDENT, bool RES, int RB>
__device__ __forceinline__ void recurrence(
    const TP* __restrict__ proj, const __nv_bfloat16* __restrict__ wt,
    const __nv_bfloat16* __restrict__ pt, float* __restrict__ h,
    float* __restrict__ c, __nv_bfloat16* hx, __nv_bfloat16* cx,
    TP* __restrict__ hs, __nv_bfloat16* __restrict__ res, unsigned int* bar,
    int T, int B, int H, int row0, int nrows) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(valid_layout(RESIDENT, RB), "no such layout");
  constexpr int THREADS = threads_of(RB);
  constexpr int KC = chunk(RESIDENT), LDK = ldk(RESIDENT);
  constexpr int STAGES = ring_stages(RESIDENT);
  constexpr int STAGE = (RB + (RESIDENT ? 0 : 4 * U)) * LDK;
  const int Hk = reduce_extent(H, RESIDENT), NK = Hk / KC, LDW = Hk + 8;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [n][k]
  __nv_bfloat16* ring = w_s + (RESIDENT ? WROWS * LDW : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int j0 = blockIdx.x * U;
  const int b0 = row0 + blockIdx.y * RB;
  const int bend = row0 + nrows;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const size_t G = (size_t)4 * H, BH = (size_t)B * H;
  const bool vec = H % 8 == 0;   // 16-byte aligned rows of the operands

  // rows [n0, n0 + rows) x kcount columns (a multiple of 8) of the block's
  // weight slice from column k0 into dst (row stride ld); zeros past H.
  // Row n < 4U is W_h^T's row (n / U) H + j, row n >= 4U pt's row
  // ((n - 4U) / U) H + j, with j = j0 + n % U.
  auto load_w = [&](__nv_bfloat16* dst, int ld, int n0, int rows, int k0,
                    int kcount) {
    for (int e = tid; e < rows * (kcount / 8); e += THREADS) {
      const int n = n0 + e / (kcount / 8), k = (e % (kcount / 8)) * 8;
      const int jj = j0 + n % U;
      const __nv_bfloat16* row =
          n < 4 * U ? wt + ((size_t)(n / U) * H + jj) * H
                    : pt + ((size_t)((n - 4 * U) / U) * H + jj) * H;
      copy8(dst + (n - n0) * ld + k, jj < H ? row + k0 + k : wt,
            jj < H ? H - (k0 + k) : 0, vec);
    }
  };
  // acc += bf16(x) @ the weight rows [n0, n0 + 8 NT) for the block's
  // rows, x (B, H) an exchange vector
  auto product = [&](auto& acc, const __nv_bfloat16* x, int n0) {
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
      if (!RESIDENT) load_w(dst + RB * LDK, LDK, n0, 8 * NT, k0, KC);
    };
    auto compute = [&](int s, int kc) {
      if (PEEP_LEAVE_OUT == 2) return;
      const __nv_bfloat16* a_s = ring + s * STAGE;
      if (RESIDENT)
        warp_mma<NT, KC>(acc, a_s + warp * 16 * LDK, LDK,
                         w_s + (size_t)n0 * LDW + kc * KC, LDW);
      else
        warp_mma<NT, KC>(acc, a_s + warp * 16 * LDK, LDK, a_s + RB * LDK,
                         LDK);
    };
    if (PEEP_LEAVE_OUT != 3) ring_loop<STAGES>(NK, load, compute);
  };

  if (RESIDENT) {
    load_w(w_s, LDW, 0, WROWS, 0, Hk);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // the thread's 4 cells: c, h, the pending P_i / P_f terms, z_o between
  // the phases and the next proj row live in its registers (proj as
  // loaded: rounded to bf16 where it is used, so that the load's latency
  // hides behind the barrier)
  const Cells cl(b0 + warp * 16, bend, j0, H);
  float c_r[4], h_r[4], pi_r[4], pf_r[4], zo_r[4];
  TP p_r[4][4];
  // with RES: the cell's residual row of the step, in bf16, from its
  // update until its stores behind a barrier
  __nv_bfloat162 r_ai[4], r_fc[4], r_hc[4], r_ot[4];
  auto load_proj = [&](int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      const TP* pr = proj + ((size_t)t * B + cl.b[e]) * G + cl.j[e];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) p_r[e][gt] = pr[gt * H];
    }
  };
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c_r[e] = cl.own[e] ? c[cl.idx[e]] : 0.0f;
    h_r[e] = cl.own[e] ? h[cl.idx[e]] : 0.0f;
    if (cl.own[e]) {
      hx[cl.idx[e]] = __float2bfloat16(h_r[e]);
      cx[BH + cl.idx[e]] = __float2bfloat16(c_r[e]);   // c0's own slot
    }
  }
  unsigned int barriers = 1;
  grid_arrive(bar);
  load_proj(0);
  grid_wait(bar, nblocks);

  {  // prologue: bf16(c0) @ [P_i | P_f] (rows 5U..7U of the slice)
    float acc[2][4] = {};
    product(acc, cx + BH, 5 * U);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pi_r[e] = acc[0][e];
      pf_r[e] = acc[1][e];
    }
  }

  for (int t = 0; t < T; ++t) {
    // ---- phase A: bf16(h_{t-1}) @ W_h, then a, i, f and c_t
    {
      float acc[4][4] = {};
      product(acc, hx, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!cl.own[e]) continue;
        const float za = as_bf16(p_r[e][0]) + acc[0][e];
        const float zi = (as_bf16(p_r[e][1]) + acc[1][e]) + pi_r[e];
        const float zf = (as_bf16(p_r[e][2]) + acc[2][e]) + pf_r[e];
        zo_r[e] = as_bf16(p_r[e][3]) + acc[3][e];
        const float a = tanhf(za);
        const float ig = sigmoidf(zi);
        const float f = sigmoidf(zf);
        const float cn = __fadd_rn(__fmul_rn(f, c_r[e]), __fmul_rn(ig, a));
        if (RES) {
          r_ai[e] = __floats2bfloat162_rn(a, ig);
          r_fc[e] = __floats2bfloat162_rn(f, c_r[e]);
          r_hc[e] = __floats2bfloat162_rn(h_r[e], cn);
        }
        c_r[e] = cn;
        cx[cl.idx[e]] = __float2bfloat16(cn);
      }
    }
    // arrive once c_t is written; this phase's residuals while the other
    // blocks catch up
    grid_arrive(bar);
    if (RES) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!cl.own[e]) continue;
        __nv_bfloat16* rr = res + ((size_t)t * B + cl.b[e]) * 8 * H + cl.j[e];
        rr[0] = __low2bfloat16(r_ai[e]);
        rr[H] = __high2bfloat16(r_ai[e]);
        rr[2 * H] = __low2bfloat16(r_fc[e]);
        rr[5 * H] = __high2bfloat16(r_fc[e]);
        rr[6 * H] = __low2bfloat16(r_hc[e]);
        rr[7 * H] = __high2bfloat16(r_hc[e]);
      }
    }
    grid_wait(bar, nblocks * ++barriers);

    // ---- phase B: bf16(c_t) @ [P_o | P_i | P_f], then o and h_t
    {
      float acc[3][4] = {};
      product(acc, cx, 4 * U);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!cl.own[e]) continue;
        const float o = sigmoidf(zo_r[e] + acc[0][e]);
        const float tc = tanhf(c_r[e]);
        const float hn = __fmul_rn(o, tc);
        pi_r[e] = acc[1][e];
        pf_r[e] = acc[2][e];
        if (RES) r_ot[e] = __floats2bfloat162_rn(o, tc);
        h_r[e] = hn;
        hx[cl.idx[e]] = __float2bfloat16(hn);
      }
    }
    // arrive once h_t is written; hs (and the residuals) and the next
    // proj row while the other blocks catch up
    if (t + 1 < T) grid_arrive(bar);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!cl.own[e]) continue;
      store_out(hs + (size_t)t * BH + cl.idx[e], h_r[e]);
      if (RES) {
        __nv_bfloat16* rr = res + ((size_t)t * B + cl.b[e]) * 8 * H + cl.j[e];
        rr[3 * H] = __low2bfloat16(r_ot[e]);
        rr[4 * H] = __high2bfloat16(r_ot[e]);
      }
    }
    if (t + 1 == T) break;
    load_proj(t + 1);
    grid_wait(bar, nblocks * ++barriers);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!cl.own[e]) continue;
    c[cl.idx[e]] = c_r[e];
    h[cl.idx[e]] = h_r[e];
  }
}

// One cooperative launch of kern on the grid of units x row tiles, with
// threads a block and smem bytes of dynamic shared memory; args are the
// kernel's arguments, of its exact parameter types.
template <typename K, typename... Args>
int cooperative(K kern, dim3 grid, int threads, size_t smem,
                cudaStream_t stream, Args... args) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* ptrs[] = {&args...};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    grid, dim3(threads), ptrs, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid of a launch over nrows rows at this H, rb rows a block.
inline dim3 grid_of(int H, int nrows, int rb) {
  return dim3((H + U - 1) / U, (nrows + rb - 1) / rb);
}

}  // namespace peephole_persistent
