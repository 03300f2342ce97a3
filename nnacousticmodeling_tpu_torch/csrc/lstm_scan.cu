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
// What this design does about it. One cooperative launch (every block
// co-resident, checked by cudaLaunchCooperativeKernel) walks all T steps.
// A block owns U = 16 hidden units -- all four gate columns of them, so
// the cell update and c stay in its registers for all T -- for a tile of
// RB = 64 batch rows. Its H x 4U slice of W_h (128 KB at H=1024, from
// W_h^T so that each gate column is one contiguous row) is loaded into
// shared memory once and stays there; where the slice does not fit
// (H > 1088), the same kernel streams it from L2 beside h each step. The
// step product runs on the tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 accumulation; 8 warps of 16 rows x 32 gate columns) over
// h, which the blocks exchange as bf16 through a double-buffered (by step
// parity) global buffer that stays in L2, streamed in 64-wide chunks
// through an 8-stage cp.async ring (4 when W_h streams beside it), so
// that enough of h is in flight to cover L2's latency. One grid barrier a
// step (an atomic counter with fences and an acquire load); proj[t+1] is
// loaded into registers before it. Every sum runs in one fixed order: the
// same inputs give the same bits. Batches larger than one co-resident
// grid holds go through the kernel in row chunks, one launch each
// (ops/rnn_cuda.py lstm_scan_plan); B <= 128 at H=1024 is one launch.

#include "mma_ptx.cuh"

namespace {

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

template <typename TP, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 1 : 2)
lstm_scan_persistent(const TP* __restrict__ proj,            // (T, B, 4H)
                     const __nv_bfloat16* __restrict__ wt,   // (4H, H) W_h^T
                     float* __restrict__ h,        // (B, H) h0 in, h_T out
                     float* __restrict__ c,        // (B, H) c0 in, c_T out
                     __nv_bfloat16* hx,            // (2, B, H) h exchange
                     TP* __restrict__ hs,          // (T, B, H)
                     unsigned int* bar,            // zeroed barrier count
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
      const float hn = o * tanhf(cn);
      c_r[q] = cn;
      h_r[q] = hn;
      hdst[idx[q]] = __float2bfloat16(hn);
    }
    // arrive once h_{t+1} is written; hs and the next proj row while the
    // other blocks catch up
    if (t + 1 < T) grid_arrive(bar);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (own[q]) store_out(hs + (size_t)t * BH + idx[q], h_r[q]);
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

template <typename TP, bool RESIDENT>
int launch_scan(const void* proj, const void* wt, void* h, void* c, void* hx,
                void* hs, void* bar, int T, int B, int H, int row0,
                int nrows, cudaStream_t stream) {
  auto kern = lstm_scan_persistent<TP, RESIDENT>;
  const size_t smem = smem_bytes(H, RESIDENT);
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
  unsigned int* p_bar = static_cast<unsigned int*>(bar);
  void* args[] = {&p_proj, &p_wt, &p_h, &p_c, &p_hx, &p_hs, &p_bar,
                  &T, &B, &H, &row0, &nrows};
  const dim3 grid((H + U - 1) / U, (nrows + RB - 1) / RB);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    grid, dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TP>
int run_scan(const void* proj, const void* wt, void* h, void* c, void* hx,
             void* hs, void* bar, int T, int B, int H, int row0, int nrows,
             int resident, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident
      ? launch_scan<TP, true>(proj, wt, h, c, hx, hs, bar, T, B, H, row0,
                              nrows, st)
      : launch_scan<TP, false>(proj, wt, h, c, hx, hs, bar, T, B, H, row0,
                               nrows, st);
}

template <typename TP, bool RESIDENT>
int blocks_per_sm(int H, int* out) {
  auto kern = lstm_scan_persistent<TP, RESIDENT>;
  const size_t smem = smem_bytes(H, RESIDENT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern,
                                                            THREADS, smem);
}

}  // namespace

// How many blocks of the kernel (W_h slice resident or streamed) can be
// co-resident on the current device at this H, for both proj dtypes: 0
// when a block's shared memory would exceed the card's.
extern "C" int lstm_scan_capacity(int H, int resident, int* blocks) {
  *blocks = 0;
  if (H < 1 || smem_bytes(H, resident != 0) > SMEM_MAX) return 0;
  int dev = 0, sms = 0, n32 = 0, n16 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int e = resident ? blocks_per_sm<float, true>(H, &n32)
                   : blocks_per_sm<float, false>(H, &n32);
  if (e == 0)
    e = resident ? blocks_per_sm<__nv_bfloat16, true>(H, &n16)
                 : blocks_per_sm<__nv_bfloat16, false>(H, &n16);
  if (e != 0) return e;
  *blocks = (n32 < n16 ? n32 : n16) * sms;
  return 0;
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
