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
// Forward, per step (the math of lstm_scan.cu; that kernel now sums the
// product on the tensor cores in another order, so the two agree within
// the recurrence tolerance, not bit for bit):
//
//     z = bf16(proj[t]) + bf16(h) @ bf16(W_h)     (f32 accumulation)
//     a, i, f, o = tanh, sigmoid, sigmoid, sigmoid of z's four H-blocks
//     c = f * c + i * a;   h = o * tanh(c)        (f32 carry)
//     res[t] = bf16([a | i | f | o | tanh c | c_{t-1} | h_{t-1}])  (7H)
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
// backward 43 GFLOP against ~140 MB. Both bounds sit far below the
// floor of the serial recurrence: T dependent steps, each a grid-wide
// barrier, and W_h (8 MB in bf16) fits in no SM's 227 KB of shared
// memory, so the TPU kernels' design (W_h resident for the whole
// sequence) does not carry over here yet: lstm_scan.cu's persistent grid
// is the design these step kernels are to take next.
//
// What this design does about it. One launch per step on the caller's
// stream; the launch boundary is the barrier. The forward block is
// lstm_scan.cu's (32 units x 32 rows x 4 gate columns, h ping-pong, c
// in place) and adds the residual row of its units. The backward block
// owns 32 hidden units k x 32 batch rows: it first forms its tile of
// dh_{t} = dzb_{t+1} @ W_h^T -- row k of the (H, 4H) W_h is contiguous,
// so no transposed copy is needed -- and then runs step t's elementwise
// part for its own units, whose dh, dc and residuals are all local to
// it, as the forward's cell update is. dc is one (B, H) f32 buffer
// updated in place; dzb goes to a (T, B, 4H) bf16 scratch. dW is not on
// the serial path: dw_gemm.cuh's tensor-core GEMM, launched once after
// the loop, contracts the T*B rows of h_{t-1} (read from the residuals)
// against dzb. The step products run on the CUDA cores as f32 FMAs of
// bf16-rounded operands (exact products, f32 sums) from shared-memory
// tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dw_gemm.cuh"

namespace {

constexpr int TB = 32;        // batch rows per block
constexpr int TJ = 32;        // hidden units per block (x4 gate columns)
constexpr int KC = 32;        // reduction chunk held in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 2 rows x 2 units

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float load_as_bf16(const float* p) {
  return bf16_round(*p);
}

__device__ __forceinline__ float load_as_bf16(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---- forward: lstm_scan.cu's step kernel plus the residual row --------

template <typename TP>
__global__ void __launch_bounds__(THREADS)
lstm_train_fwd_step(const TP* __restrict__ proj_t,           // (B, 4H)
                    const __nv_bfloat16* __restrict__ wh,    // (H, 4H)
                    const float* __restrict__ h_in,          // (B, H)
                    float* __restrict__ c,                   // (B, H) in/out
                    float* __restrict__ h_out,               // (B, H)
                    TP* __restrict__ hs_t,                   // (B, H)
                    __nv_bfloat16* __restrict__ res_t,       // (B, 7H)
                    int B, int H) {
  __shared__ float h_sm[TB][KC + 1];          // [row][k], padded
  __shared__ __align__(8) float w_sm[KC][4 * TJ];  // [k][gate * TJ + unit]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;   // first of this thread's two units
  const int tr = (tid / 16) * 2;   // first of this thread's two rows
  const size_t G = (size_t)4 * H;

  float acc[2][2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][u][g] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += KC) {
    for (int e = tid; e < TB * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int b = b0 + r, kk = k0 + k;
      h_sm[r][k] = (b < B && kk < H) ? bf16_round(h_in[(size_t)b * H + kk])
                                     : 0.0f;
    }
    for (int e = tid; e < KC * 4 * TJ; e += THREADS) {
      const int k = e / (4 * TJ), col = e % (4 * TJ);
      const int g = col / TJ, u = col % TJ;
      const int kk = k0 + k, jj = j0 + u;
      w_sm[k][col] = (kk < H && jj < H)
          ? __bfloat162float(wh[(size_t)kk * G + (size_t)g * H + jj])
          : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float h0 = h_sm[tr][k];
      const float h1 = h_sm[tr + 1][k];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 w = *reinterpret_cast<const float2*>(
            &w_sm[k][g * TJ + tu]);
        acc[0][0][g] = fmaf(h0, w.x, acc[0][0][g]);
        acc[0][1][g] = fmaf(h0, w.y, acc[0][1][g]);
        acc[1][0][g] = fmaf(h1, w.x, acc[1][0][g]);
        acc[1][1][g] = fmaf(h1, w.y, acc[1][1][g]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, j = j0 + tu + u;
      if (b >= B || j >= H) continue;
      const TP* pr = proj_t + (size_t)b * G;
      const float za = load_as_bf16(pr + j) + acc[r][u][0];
      const float zi = load_as_bf16(pr + H + j) + acc[r][u][1];
      const float zf = load_as_bf16(pr + 2 * H + j) + acc[r][u][2];
      const float zo = load_as_bf16(pr + 3 * H + j) + acc[r][u][3];
      const float a = tanhf(za);
      const float ig = sigmoidf(zi);
      const float f = sigmoidf(zf);
      const float o = sigmoidf(zo);
      const size_t idx = (size_t)b * H + j;
      const float cp = c[idx];
      const float hp = h_in[idx];
      const float cn = f * cp + ig * a;
      const float tc = tanhf(cn);
      const float hn = o * tc;
      c[idx] = cn;
      h_out[idx] = hn;
      store_out(hs_t + idx, hn);
      __nv_bfloat16* rr = res_t + (size_t)b * 7 * H + j;
      rr[0] = __float2bfloat16(a);
      rr[H] = __float2bfloat16(ig);
      rr[2 * H] = __float2bfloat16(f);
      rr[3 * H] = __float2bfloat16(o);
      rr[4 * H] = __float2bfloat16(tc);
      rr[5 * H] = __float2bfloat16(cp);
      rr[6 * H] = __float2bfloat16(hp);
    }
  }
}

template <typename TP>
int run_fwd(const TP* proj, const __nv_bfloat16* wh, float* h_a, float* h_b,
            float* c, TP* hs, __nv_bfloat16* res, int T, int B, int H,
            cudaStream_t stream) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  const size_t step_in = (size_t)B * 4 * H;
  const size_t step_out = (size_t)B * H;
  const size_t step_res = (size_t)B * 7 * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = (t % 2 == 0) ? h_a : h_b;
    float* h_out = (t % 2 == 0) ? h_b : h_a;
    lstm_train_fwd_step<TP><<<grid, THREADS, 0, stream>>>(
        proj + t * step_in, wh, h_in, c, h_out, hs + t * step_out,
        res + t * step_res, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---- backward: dh_t = dzb_{t+1} @ W_h^T, then step t's elementwise part --
//
// dz_next null: no product, dh = dh_init (the first launch, t = T-1).
// res_t null:   no elementwise part, dh goes to dh_out (the last launch,
//               whose product gives dh0).

template <typename TD>
__global__ void __launch_bounds__(THREADS)
lstm_train_bwd_step(const __nv_bfloat16* __restrict__ dz_next,  // (B, 4H)
                    const __nv_bfloat16* __restrict__ wh,       // (H, 4H)
                    const float* __restrict__ dh_init,          // (B, H)
                    const float* __restrict__ dhs_t,            // (B, H)
                    const __nv_bfloat16* __restrict__ res_t,    // (B, 7H)
                    float* __restrict__ dc,                     // (B, H) in/out
                    TD* __restrict__ dproj_t,                   // (B, 4H)
                    __nv_bfloat16* __restrict__ dz_t,           // (B, 4H)
                    float* __restrict__ dh_out,                 // (B, H)
                    int B, int H) {
  __shared__ float dz_sm[TB][KC + 1];   // [row][n], padded
  __shared__ float w_sm[TJ][KC + 1];    // [unit k][n], padded

  const int tid = threadIdx.x;
  const int k0u = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const int tu = (tid % 16) * 2;
  const int tr = (tid / 16) * 2;
  const int G = 4 * H;

  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (dz_next != nullptr) {
    for (int n0 = 0; n0 < G; n0 += KC) {
      for (int e = tid; e < TB * KC; e += THREADS) {
        const int r = e / KC, n = e % KC;
        const int b = b0 + r, nn = n0 + n;
        dz_sm[r][n] = (b < B && nn < G)
            ? __bfloat162float(dz_next[(size_t)b * G + nn]) : 0.0f;
      }
      for (int e = tid; e < TJ * KC; e += THREADS) {
        const int u = e / KC, n = e % KC;
        const int k = k0u + u, nn = n0 + n;
        w_sm[u][n] = (k < H && nn < G)
            ? __bfloat162float(wh[(size_t)k * G + nn]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < KC; ++n) {
        const float d0 = dz_sm[tr][n];
        const float d1 = dz_sm[tr + 1][n];
        const float w0 = w_sm[tu][n];
        const float w1 = w_sm[tu + 1][n];
        acc[0][0] = fmaf(d0, w0, acc[0][0]);
        acc[0][1] = fmaf(d0, w1, acc[0][1]);
        acc[1][0] = fmaf(d1, w0, acc[1][0]);
        acc[1][1] = fmaf(d1, w1, acc[1][1]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + tr + r, k = k0u + tu + u;
      if (b >= B || k >= H) continue;
      const size_t idx = (size_t)b * H + k;
      const float dh = (dz_next != nullptr) ? acc[r][u] : dh_init[idx];
      if (res_t == nullptr) {
        dh_out[idx] = dh;
        continue;
      }
      const __nv_bfloat16* rr = res_t + (size_t)b * 7 * H + k;
      const float a = __bfloat162float(rr[0]);
      const float ig = __bfloat162float(rr[H]);
      const float f = __bfloat162float(rr[2 * H]);
      const float o = __bfloat162float(rr[3 * H]);
      const float tc = __bfloat162float(rr[4 * H]);
      const float cp = __bfloat162float(rr[5 * H]);
      const float dh_tot = dhs_t[idx] + dh;
      const float dout = dh_tot * tc;
      const float dcv = dc[idx] + dh_tot * o * (1.0f - tc * tc);
      const float da = dcv * ig;
      const float dig = dcv * a;
      const float df = dcv * cp;
      dc[idx] = dcv * f;
      const float dz4[4] = {da * (1.0f - a * a), dig * ig * (1.0f - ig),
                            df * f * (1.0f - f), dout * o * (1.0f - o)};
      const size_t row = (size_t)b * G + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        store_out(dproj_t + row + (size_t)g * H, dz4[g]);
        dz_t[row + (size_t)g * H] = __float2bfloat16(dz4[g]);
      }
    }
  }
}

template <typename TD>
int run_bwd(const __nv_bfloat16* res, const __nv_bfloat16* wh,
            const float* dhs, const float* dh_T, float* dc, TD* dproj,
            __nv_bfloat16* dz, float* dh0, int T, int B, int H,
            cudaStream_t stream) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  const size_t step_g = (size_t)B * 4 * H;
  const size_t step_h = (size_t)B * H;
  const size_t step_res = (size_t)B * 7 * H;
  // launch s reads dzb of step s (none for s = T) and runs step s - 1
  for (int s = T; s >= 0; --s) {
    const int t = s - 1;
    const __nv_bfloat16* dz_next = (s < T) ? dz + s * step_g : nullptr;
    const bool elem = t >= 0;
    lstm_train_bwd_step<TD><<<grid, THREADS, 0, stream>>>(
        dz_next, wh, dh_T, elem ? dhs + t * step_h : nullptr,
        elem ? res + t * step_res : nullptr, dc,
        elem ? dproj + t * step_g : nullptr,
        elem ? dz + t * step_g : nullptr, dh0, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// proj (T, B, 4H), wh (H, 4H) bf16, h_a (B, H) holding h0, h_b (B, H)
// scratch, c (B, H) holding c0 and updated in place, hs (T, B, H), res
// (T, B, 7H) bf16. After the call h_T is in h_a when T is even, else in
// h_b.
extern "C" int lstm_train_fwd_f32(const void* proj, const void* wh, void* h_a,
                                  void* h_b, void* c, void* hs, void* res,
                                  int T, int B, int H, void* stream) {
  return run_fwd<float>(static_cast<const float*>(proj),
                        static_cast<const __nv_bfloat16*>(wh),
                        static_cast<float*>(h_a), static_cast<float*>(h_b),
                        static_cast<float*>(c), static_cast<float*>(hs),
                        static_cast<__nv_bfloat16*>(res), T, B, H,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int lstm_train_fwd_bf16(const void* proj, const void* wh,
                                   void* h_a, void* h_b, void* c, void* hs,
                                   void* res, int T, int B, int H,
                                   void* stream) {
  return run_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(proj),
      static_cast<const __nv_bfloat16*>(wh), static_cast<float*>(h_a),
      static_cast<float*>(h_b), static_cast<float*>(c),
      static_cast<__nv_bfloat16*>(hs), static_cast<__nv_bfloat16*>(res),
      T, B, H, static_cast<cudaStream_t>(stream));
}

// res (T, B, 7H) bf16, wh (H, 4H) bf16, dhs (T, B, H) f32, dh_T (B, H)
// f32, dc (B, H) f32 holding dc_T and left holding dc0, dproj (T, B, 4H)
// in proj's dtype, dz (T, B, 4H) bf16 scratch, dh0 (B, H) f32 out.
extern "C" int lstm_train_bwd_f32(const void* res, const void* wh,
                                  const void* dhs, const void* dh_T, void* dc,
                                  void* dproj, void* dz, void* dh0, int T,
                                  int B, int H, void* stream) {
  return run_bwd<float>(static_cast<const __nv_bfloat16*>(res),
                        static_cast<const __nv_bfloat16*>(wh),
                        static_cast<const float*>(dhs),
                        static_cast<const float*>(dh_T),
                        static_cast<float*>(dc), static_cast<float*>(dproj),
                        static_cast<__nv_bfloat16*>(dz),
                        static_cast<float*>(dh0), T, B, H,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int lstm_train_bwd_bf16(const void* res, const void* wh,
                                   const void* dhs, const void* dh_T,
                                   void* dc, void* dproj, void* dz, void* dh0,
                                   int T, int B, int H, void* stream) {
  return run_bwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(wh), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_T), static_cast<float*>(dc),
      static_cast<__nv_bfloat16*>(dproj), static_cast<__nv_bfloat16*>(dz),
      static_cast<float*>(dh0), T, B, H, static_cast<cudaStream_t>(stream));
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
