// The persistent LSTM recurrence, one source for two kernels: the serving
// scan (lstm_scan.cu, kernel lstm_scan_persistent) and the training
// forward, which also writes the backward's residual row (lstm_train.cu,
// kernel lstm_train_fwd_persistent). Both instantiate recurrence() below,
// so their hs, c_T and h_T are bit-equal by construction. The grid
// barrier is also the training backward's (lstm_train.cu).
//
// Per step (the precision contract of lstm_scan_mixed_reference,
// nnacousticmodeling_tpu/ops/rnn_pallas.py:356):
//
//     z = bf16(proj[t]) + bf16(h) @ bf16(W_h)     (f32 accumulation)
//     a, i, f, o = tanh, sigmoid, sigmoid, sigmoid of z's four H-blocks
//     c = f * c + i * a;   h = o * tanh(c)        (f32 carry)
//
// hs[t] = h in proj's dtype, and with RES the residual row
// res[t] = bf16([a | i | f | o | tanh c_t | c_{t-1} | h_{t-1}]) (7H, the
// order of _lstm_train_fwd_impl, rnn_pallas.py:434-440).
//
// The design (lstm_scan.cu says what bounds it). One cooperative launch
// (every block co-resident, checked by cudaLaunchCooperativeKernel) walks
// all T steps. A block owns U = 16 hidden units -- all four gate columns
// of them, so the cell update and c stay in its registers for all T --
// for a tile of RB = 64 batch rows. Its H x 4U slice of W_h (from W_h^T,
// so that each gate column is one contiguous row) is loaded into shared
// memory once and stays there; where the slice does not fit (H > 1088),
// the same code streams it from L2 beside h each step. The step product
// runs on the tensor cores (mma.sync.m16n8k16, bf16 operands, f32
// accumulation; 8 warps of 16 rows x 32 gate columns) over h, which the
// blocks exchange as bf16 through a double-buffered (by step parity)
// global buffer that stays in L2, streamed in 64-wide chunks through an
// 8-stage cp.async ring (4 when W_h streams beside it). One grid barrier
// a step, split: arrive once h_{t+1} is written, then the hs stores (and
// the residual row), the next proj loads, then wait. Every sum runs in
// one fixed order: the same inputs give the same bits.

#pragma once

#include "mma_ptx.cuh"

// Not in an unnamed namespace: lstm_scan.cu names this namespace in a
// using-directive inside its own unnamed namespace, and nvcc's generated
// registration code then could not tell the two unnamed namespaces apart.
namespace lstm_persistent {

using namespace mma_ptx;

constexpr int U = 16;          // hidden units per block
constexpr int NC = 4 * U;      // gate columns per block: n = gate * U + unit
constexpr int RB = 64;         // batch rows per block
constexpr int KC = 64;         // reduction chunk of one ring stage
// ring depth: 8 stages (7 chunks of h in flight) beside a resident W_h
// slice, 4 (of h and W_h) when W_h is streamed
__host__ __device__ constexpr int ring_stages(bool resident) {
  return resident ? 8 : 4;
}
constexpr int THREADS = 256;   // 8 warps: 4 groups of 16 rows x 2 of 32 cols
constexpr int LDK = KC + 8;    // padded row of a ring tile (elements)
constexpr int LDZ = NC + 4;    // padded row of the pre-activations (floats)
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory of one block

__host__ __device__ inline int reduce_extent(int H) {
  return (H + KC - 1) / KC * KC;
}

inline size_t smem_bytes(int H, bool resident) {
  const size_t ring =
      (size_t)ring_stages(resident) * (RB + (resident ? 0 : NC)) * LDK * 2;
  const size_t w = resident ? (size_t)NC * (reduce_extent(H) + 8) * 2 : 0;
  return w + ring + (size_t)RB * LDZ * sizeof(float);
}

__device__ __forceinline__ float as_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float as_bf16(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The grid barrier, in two halves so that a block does other work (its
// hs stores, the next proj loads) between them. count rises by one per
// block per barrier; target = blocks x barriers so far.
//
// arrive: the block's writes so far (h for the next step) become visible
// before its arrival is counted.
__device__ __forceinline__ void grid_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

// wait: every block has arrived. A wait longer than 10 s means a block
// never arrived: trap (the launch fails with an error) rather than spin
// for ever.
__device__ __forceinline__ void grid_wait(unsigned int* count,
                                          unsigned int target) {
  if (threadIdx.x == 0) {
    const unsigned long long start = global_ns();
    unsigned int seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      if (global_ns() - start > 10000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The kernels' arguments: proj (T, B, 4H) f32 or bf16, wt = W_h^T (4H, H)
// bf16, h and c (B, H) f32 holding h0 / c0 and left holding h_T / c_T, hx
// (2, B, H) bf16 exchange, hs (T, B, H) in proj's dtype, res (T, B, 7H)
// bf16 (RES only), bar one zeroed uint32; the rows [row0, row0 + nrows)
// of the batch.
template <typename TP, bool RESIDENT, bool RES>
__device__ __forceinline__ void recurrence(
    const TP* __restrict__ proj, const __nv_bfloat16* __restrict__ wt,
    float* __restrict__ h, float* __restrict__ c, __nv_bfloat16* hx,
    TP* __restrict__ hs, __nv_bfloat16* __restrict__ res, unsigned int* bar,
    int T, int B, int H, int row0, int nrows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hk = reduce_extent(H), NK = Hk / KC, LDW = Hk + 8;
  constexpr int STAGES = ring_stages(RESIDENT);
  constexpr int STAGE = (RB + (RESIDENT ? 0 : NC)) * LDK;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [n][k]
  __nv_bfloat16* ring = w_s + (RESIDENT ? NC * LDW : 0);
  float* zs = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [row][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * U;
  const int b0 = row0 + blockIdx.y * RB;
  const int bend = row0 + nrows;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const size_t G = (size_t)4 * H, BH = (size_t)B * H;
  const bool vec = H % 8 == 0;   // 16-byte aligned rows of hx and W_h^T

  // NC rows x kcount columns (a multiple of 8) of this block's W_h^T
  // slice from column k0 into dst (row stride ld); zeros past H
  auto load_w = [&](__nv_bfloat16* dst, int ld, int k0, int kcount) {
    for (int e = tid; e < NC * (kcount / 8); e += THREADS) {
      const int n = e / (kcount / 8), k = (e % (kcount / 8)) * 8;
      const int jj = j0 + n % U;
      const __nv_bfloat16* row = wt + ((size_t)(n / U) * H + jj) * H;
      copy8(dst + n * ld + k, jj < H ? row + k0 + k : wt,
            jj < H ? H - (k0 + k) : 0, vec);
    }
  };
  // ring stage s <- chunk kc of h (RB rows x KC) and, streaming, of W_h^T
  auto load_stage = [&](int s, int kc, const __nv_bfloat16* hsrc) {
    __nv_bfloat16* dst = ring + s * STAGE;
    const int k0 = kc * KC;
    for (int e = tid; e < RB * (KC / 8); e += THREADS) {
      const int r = e / (KC / 8), k = (e % (KC / 8)) * 8;
      const int b = b0 + r;
      copy8(dst + r * LDK + k,
            b < bend ? hsrc + (size_t)b * H + k0 + k : hsrc,
            b < bend ? H - (k0 + k) : 0, vec);
    }
    if (!RESIDENT) load_w(dst + RB * LDK, LDK, k0, KC);
  };

  if (RESIDENT) {
    load_w(w_s, LDW, 0, Hk);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // the thread's cells: unit j, rows rq, rq + 16, rq + 32, rq + 48 of
  // the tile; c, h and the next proj row live in its registers (proj as
  // loaded: rounded to bf16 where it is used, so that the load's latency
  // hides behind the barrier and the step's product)
  const int u = tid % U, rq = tid / U;
  const int j = j0 + u;
  float c_r[4], h_r[4];
  TP p_r[4][4];
  size_t idx[4];
  bool own[4];
  // with RES: the cell's residual row of the step, in bf16, from its
  // update until its stores behind the barrier
  __nv_bfloat162 r_ai[4], r_fo[4], r_tc[4];
  __nv_bfloat16 r_h[4];
  auto load_proj = [&](int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!own[q]) continue;
      const TP* pr = proj + (size_t)t * B * G + (idx[q] / H) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) p_r[q][g] = pr[g * H];
    }
  };
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = b0 + rq + 16 * q;
    own[q] = j < H && b < bend;
    idx[q] = own[q] ? (size_t)b * H + j : 0;
    c_r[q] = own[q] ? c[idx[q]] : 0.0f;
    h_r[q] = own[q] ? h[idx[q]] : 0.0f;
    if (own[q]) hx[idx[q]] = __float2bfloat16(h_r[q]);   // parity 0: h0
  }
  grid_arrive(bar);
  load_proj(0);
  grid_wait(bar, nblocks);

  const int wr = (warp % 4) * 16, wc = (warp / 4) * 32;
  const int g = lane / 4, q4 = lane % 4;
  const int ldb = RESIDENT ? LDW : LDK;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hsrc = hx + (size_t)(t & 1) * BH;
    __nv_bfloat16* hdst = hx + (size_t)((t + 1) & 1) * BH;

    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < NK) load_stage(s, s, hsrc);
      cp_async_commit();
    }
    for (int kc = 0; kc < NK; ++kc) {
      const int s = kc % STAGES;
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nk = kc + STAGES - 1;
      if (nk < NK) load_stage(nk % STAGES, nk, hsrc);
      cp_async_commit();
      const __nv_bfloat16* a_s = ring + s * STAGE;
      const __nv_bfloat16* b_s = RESIDENT ? w_s + kc * KC : a_s + RB * LDK;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        // h tile [row][k]: tiles (r 0, k 0), (r 8, k 0), (r 0, k 8),
        // (r 8, k 8) give a0..a3
        uint32_t af[4];
        ldmatrix_x4(af, a_s + (wr + ((lane / 8) % 2) * 8 + lane % 8) * LDK
                            + kk + (lane / 16) * 8);
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          // W tile [n][k]: tiles (n 0, k 0), (n 0, k 8), (n 8, k 0),
          // (n 8, k 8) give b0, b1 of two n8 tiles
          uint32_t bf[4];
          ldmatrix_x4(bf, b_s + (size_t)(wc + nh * 16 + (lane / 16) * 8
                                         + lane % 8) * ldb
                              + kk + ((lane / 8) % 2) * 8);
          mma_bf16(acc[2 * nh], af, bf[0], bf[1]);
          mma_bf16(acc[2 * nh + 1], af, bf[2], bf[3]);
        }
      }
    }

    // pre-activations to shared memory (zs was last read before the
    // previous barrier), then the cell update of the thread's cells
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      float* z = zs + (wr + g) * LDZ + wc + ni * 8 + 2 * q4;
      z[0] = acc[ni][0];
      z[1] = acc[ni][1];
      z[8 * LDZ] = acc[ni][2];
      z[8 * LDZ + 1] = acc[ni][3];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!own[q]) continue;
      const float* zr = zs + (rq + 16 * q) * LDZ + u;
      const float za = as_bf16(p_r[q][0]) + zr[0];
      const float zi = as_bf16(p_r[q][1]) + zr[U];
      const float zf = as_bf16(p_r[q][2]) + zr[2 * U];
      const float zo = as_bf16(p_r[q][3]) + zr[3 * U];
      const float a = tanhf(za);
      const float ig = sigmoidf(zi);
      const float f = sigmoidf(zf);
      const float o = sigmoidf(zo);
      const float cn = f * c_r[q] + ig * a;
      const float tc = tanhf(cn);
      const float hn = o * tc;
      if (RES) {
        r_ai[q] = __floats2bfloat162_rn(a, ig);
        r_fo[q] = __floats2bfloat162_rn(f, o);
        r_tc[q] = __floats2bfloat162_rn(tc, c_r[q]);
        r_h[q] = __float2bfloat16(h_r[q]);
      }
      c_r[q] = cn;
      h_r[q] = hn;
      hdst[idx[q]] = __float2bfloat16(hn);
    }
    // arrive once h_{t+1} is written; hs (and the residual row) and the
    // next proj row while the other blocks catch up
    if (t + 1 < T) grid_arrive(bar);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!own[q]) continue;
      store_out(hs + (size_t)t * BH + idx[q], h_r[q]);
      if (RES) {
        __nv_bfloat16* rr =
            res + ((size_t)t * B + b0 + rq + 16 * q) * 7 * H + j;
        rr[0] = __low2bfloat16(r_ai[q]);
        rr[H] = __high2bfloat16(r_ai[q]);
        rr[2 * H] = __low2bfloat16(r_fo[q]);
        rr[3 * H] = __high2bfloat16(r_fo[q]);
        rr[4 * H] = __low2bfloat16(r_tc[q]);
        rr[5 * H] = __high2bfloat16(r_tc[q]);
        rr[6 * H] = r_h[q];
      }
    }
    if (t + 1 == T) break;
    load_proj(t + 1);
    grid_wait(bar, nblocks * (unsigned int)(t + 2));
  }
  cp_async_wait<0>();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!own[q]) continue;
    c[idx[q]] = c_r[q];
    h[idx[q]] = h_r[q];
  }
}

// One cooperative launch of kern (a __global__ wrapper of recurrence,
// RESIDENT as resident) on the rows [row0, row0 + nrows).
template <typename TP, typename K>
int launch(K kern, bool resident, const void* proj, const void* wt, void* h,
           void* c, void* hx, void* hs, void* res, void* bar, int T, int B,
           int H, int row0, int nrows, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, resident);
  if (smem > SMEM_MAX || T < 1 || nrows < 1 || row0 < 0 || row0 + nrows > B)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const TP* p_proj = static_cast<const TP*>(proj);
  const __nv_bfloat16* p_wt = static_cast<const __nv_bfloat16*>(wt);
  float* p_h = static_cast<float*>(h);
  float* p_c = static_cast<float*>(c);
  __nv_bfloat16* p_hx = static_cast<__nv_bfloat16*>(hx);
  TP* p_hs = static_cast<TP*>(hs);
  __nv_bfloat16* p_res = static_cast<__nv_bfloat16*>(res);
  unsigned int* p_bar = static_cast<unsigned int*>(bar);
  void* args[] = {&p_proj, &p_wt, &p_h, &p_c, &p_hx, &p_hs, &p_res, &p_bar,
                  &T, &B, &H, &row0, &nrows};
  const dim3 grid((H + U - 1) / U, (nrows + RB - 1) / RB);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    grid, dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename K>
int blocks_per_sm(K kern, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern,
                                                            threads, smem);
}

// Co-resident blocks on the current device of the smaller of two kernels'
// occupancies (one per proj dtype) with threads a block and smem bytes of
// shared memory each: 0 when that exceeds the card's.
template <typename K32, typename K16>
int capacity(K32 k32, K16 k16, size_t smem, int* blocks,
             int threads = THREADS) {
  *blocks = 0;
  if (smem > SMEM_MAX) return 0;
  int dev = 0, sms = 0, n32 = 0, n16 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int e = blocks_per_sm(k32, threads, smem, &n32);
  if (e == 0) e = blocks_per_sm(k16, threads, smem, &n16);
  if (e != 0) return e;
  *blocks = (n32 < n16 ? n32 : n16) * sms;
  return 0;
}

}  // namespace lstm_persistent
