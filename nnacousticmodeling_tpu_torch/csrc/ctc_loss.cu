// The CTC loss and its gradient, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's CTC loss is
// optax.ctc_loss (nnacousticmodeling_tpu/models/ctc.py ctc_loss :92-101),
// a jax.lax.scan that XLA compiles into the jitted training step. These
// two kernels are optax's recursion (ctc_loss_with_forward_probs, optax
// 0.2.6) and its adjoint, as ops/ctc_cuda.py's plain version computes
// them: log(0) is LOG_EPSILON, so an alignment that cannot fit its
// frames gives a large finite loss and a finite gradient; every length
// stays on the card, so the step that calls them can be one CUDA graph.
//
// The lattice of a row of S padded labels (ops/ctc_cuda.py gives the
// recursion): phi[0..S] (the blank after n labels) and emit[0..S-1]
// (label n being emitted). Frame t needs the previous frame's phi[n],
// emit[n] and emit[n-1], the frame's blank log-probability and the
// log-probability of label n.
//
// The block route, ctc_forward_kernel: one block an utterance, a thread
// a lattice position n (phi[n] and emit[n]; looping when S+1 exceeds the
// block), the state double-buffered in shared memory, one __syncthreads a
// frame. The loop stops at the utterance's length (a padded frame carries
// the state); the state after each frame goes to states (B, T, 2S+1) =
// [phi | emit], which the backward reads; thread 0 writes -last[L].
//
// ctc_backward_kernel: the same blocks run the adjoint of each frame's
// operations from the last frame down, the forward values recomputed
// from the saved state before the frame (the same operations, so the
// same bits). logaddexp's derivative is jax.numpy.logaddexp's,
// g * exp(x - out), as autograd through the plain version computes it.
// A frame's blank gradient (a sum over n) is a fixed-order tree
// reduction in shared memory, and a class's gradient sums the label
// positions that name it in order of n: no atomics, so two runs give the
// same bits. Padded frames' rows are zero.
//
// The warp route (ctc_forward_warp / ctc_backward_warp, S+1 <= 256
// lattice positions and C <= WARP_MAX_CLASSES) runs one warp an
// utterance, 1-4 independent warps a block, no block barrier: position n
// lives in lane n % 32, slot n / 32 (K = threads_for(S) / 32 slots a
// lane, a template parameter), the state of the frame in registers,
// emit[n-1] by a shuffle, and a lane's slots as straight-line code (the
// inactive positions discarded by selects), so their logaddexp chains
// interleave. What a frame reads and the recursion does not produce (the
// frame's blank and label log-probabilities, and in the backward the
// saved states before and after the frame) is copied several frames
// ahead into a per-warp ring in shared memory (cp.async), so no frame
// waits on device memory. The backward takes the frame's last two
// logaddexps from the saved state after the frame (the forward computed
// them from the same operands, so they are the bits a recompute gives):
// one logaddexp a position a frame where the block route recomputes
// three. A class's gradient is summed by the lane holding the first label
// position naming it, along a chain built once an utterance (next[n], the
// next position naming the same class), in order of n as the block route
// walks all S positions for each class; the other classes' entries are
// the blank's sum or 0. The blank's sum is the block route's tree over
// threads_for(S) threads, done in lane registers and then by
// __shfl_down_sync, and every other operation keeps the block route's
// order (__fmul_rn where it has it), so the two routes give the same
// bits. The block route (the first kernels below) takes S+1 > 256.
//
// Bound: latency. A frame is a chain of dependent logaddexps (expf,
// log1pf); T frames run in sequence in each warp (block). The bytes (the
// valid frames' log-probability rows, each row's own lattice written and
// read back, the gradient written whole) bound the two kernels at 8.6
// and 12.1 us at phase 32's shape (B=128, T=470, C=49, S=50). There the
// block route takes 0.32-0.36 and 1.21-1.26 ms (a device-memory load and
// a barrier on each frame's path) and the warp route 0.23 and 0.57 ms
// (chip_smoke.py; H100 80GB HBM3, 700.00 W): one warp's chain of
// logaddexps and exps a frame, then the class sums and the ring copies
// (bench_ctc_loss_variants.py gives the split).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG_EPSILON = -1e5f;
constexpr int BLANK = 0;
constexpr int MAX_THREADS = 256;

// torch.logaddexp on the card (BinaryMiscOpsKernels.cu): the same
// operations, so the plain version and the kernel round alike.
__device__ __forceinline__ float lae(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Per-row label tables: lab[n], label n's column in [0, C) or -1 (its
// log-probability is 0, optax's one-hot of it being zero); eps_rep[n] =
// LOG_EPSILON * rep[n], eps_norep[n] = LOG_EPSILON * (1 - rep[n]), rep[n]
// whether label n equals label n+1 (0 for the last).
__device__ void label_tables(const int* yb, int S, int C, int* lab,
                             float* eps_rep, float* eps_norep) {
  for (int n = threadIdx.x; n < S; n += blockDim.x) {
    const int y = yb[n];
    lab[n] = (y >= 0 && y < C) ? y : -1;
    const float rep = (n + 1 < S && y == yb[n + 1]) ? 1.0f : 0.0f;
    eps_rep[n] = LOG_EPSILON * rep;
    eps_norep[n] = LOG_EPSILON * (1.0f - rep);
  }
}

__device__ __forceinline__ float label_lp(const float* row, int col) {
  return col >= 0 ? row[col] : 0.0f;
}

__global__ void __launch_bounds__(MAX_THREADS)
ctc_forward_kernel(const float* __restrict__ logprobs,  // (B, T, C)
                   const int* __restrict__ labels,      // (B, S)
                   const int* __restrict__ logit_lengths,
                   const int* __restrict__ label_lengths,
                   float* __restrict__ loss,            // (B,)
                   float* __restrict__ states,          // (B, T, 2S+1)
                   int T, int C, int S) {
  extern __shared__ float smem[];
  float* phi_a = smem;                 // S+1
  float* phi_b = phi_a + (S + 1);      // S+1
  float* em_a = phi_b + (S + 1);       // S+1 (S used)
  float* em_b = em_a + (S + 1);        // S+1
  float* eps_rep = em_b + (S + 1);     // S
  float* eps_norep = eps_rep + S;      // S
  int* lab = reinterpret_cast<int*>(eps_norep + S);  // S

  const int b = blockIdx.x;
  const int W = 2 * S + 1;
  label_tables(labels + (size_t)b * S, S, C, lab, eps_rep, eps_norep);
  for (int n = threadIdx.x; n <= S; n += blockDim.x) {
    phi_a[n] = n == 0 ? 0.0f : LOG_EPSILON;
    em_a[n] = LOG_EPSILON;
  }
  __syncthreads();

  const int len = min(max(logit_lengths[b], 0), T);
  const float* lp = logprobs + (size_t)b * T * C;
  float* st = states + (size_t)b * T * W;
  float *P = phi_a, *E = em_a, *Pn = phi_b, *En = em_b;
  for (int t = 0; t < len; ++t) {
    const float* row = lp + (size_t)t * C;
    const float lb = row[BLANK];
    float* out = st + (size_t)t * W;
    for (int n = threadIdx.x; n <= S; n += blockDim.x) {
      float pp = P[n];
      float em_prev = 0.0f;
      if (n > 0) {
        em_prev = E[n - 1];
        pp = lae(P[n], em_prev + eps_rep[n - 1]);
      }
      if (n < S) {
        const float le = label_lp(row, lab[n]);
        const float e = lae(pp + le, E[n] + le);
        En[n] = e;
        out[S + 1 + n] = e;
      }
      float q = pp + lb;
      if (n > 0) q = lae(q, em_prev + lb + eps_norep[n - 1]);
      Pn[n] = q;
      out[n] = q;
    }
    __syncthreads();
    float* tmp = P; P = Pn; Pn = tmp;
    tmp = E; E = En; En = tmp;
  }
  if (threadIdx.x == 0) {
    const int L = min(max(label_lengths[b], 0), S);
    loss[b] = -(L == 0 ? P[0] : lae(P[L], E[L - 1]));
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
ctc_backward_kernel(const float* __restrict__ logprobs,  // (B, T, C)
                    const int* __restrict__ labels,      // (B, S)
                    const int* __restrict__ logit_lengths,
                    const int* __restrict__ label_lengths,
                    const float* __restrict__ states,    // (B, T, 2S+1)
                    const float* __restrict__ grad,      // (B,)
                    float* __restrict__ dlogprobs,       // (B, T, C)
                    int T, int C, int S) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  float* gP = smem;                    // S+1: adjoint of the state after t
  float* gE = gP + (S + 1);            // S+1 (S used)
  float* gP_prev = gE + (S + 1);       // S+1: adjoint of the state before t
  float* gY = gP_prev + (S + 1);       // S+1: emit[n] -> emit[n]
  float* gZ = gY + (S + 1);            // S+2: emit[n-1] -> phi[n], blank
  float* gA = gZ + (S + 2);            // S+2: emit[n-1] -> phi'[n]
  float* gle = gA + (S + 2);           // S+1: label n's log-probability
  float* red = gle + (S + 1);          // nt: the blank's partial sums
  float* eps_rep = red + nt;           // S
  float* eps_norep = eps_rep + S;      // S
  int* lab = reinterpret_cast<int*>(eps_norep + S);  // S

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = 2 * S + 1;
  label_tables(labels + (size_t)b * S, S, C, lab, eps_rep, eps_norep);
  const int len = min(max(logit_lengths[b], 0), T);
  const int L = min(max(label_lengths[b], 0), S);
  const float* lp = logprobs + (size_t)b * T * C;
  const float* st = states + (size_t)b * T * W;
  float* dlp = dlogprobs + (size_t)b * T * C;
  for (long long i = tid; i < (long long)(T - len) * C; i += nt)
    dlp[(size_t)len * C + i] = 0.0f;
  for (int n = tid; n <= S + 1; n += nt) {
    if (n <= S) {
      gP[n] = 0.0f;
      gE[n] = 0.0f;
    }
    gZ[n] = 0.0f;
    gA[n] = 0.0f;
  }
  __syncthreads();
  // the seed: loss = -last[L], last[L] = lae(phi[L], emit[L-1]) on the
  // state after the last frame
  if (tid == 0) {
    const float* fin = len > 0 ? st + (size_t)(len - 1) * W : nullptr;
    const float g = -grad[b];
    if (L == 0) {
      gP[0] = g;
    } else {
      const float p = fin ? fin[L] : LOG_EPSILON;
      const float e = fin ? fin[S + L] : LOG_EPSILON;
      const float o = lae(p, e);
      gP[L] = __fmul_rn(g, expf(p - o));
      gE[L - 1] = __fmul_rn(g, expf(e - o));
    }
  }
  __syncthreads();

  for (int t = len - 1; t >= 0; --t) {
    const float* prev = t > 0 ? st + (size_t)(t - 1) * W : nullptr;
    const float* row = lp + (size_t)t * C;
    const float lb = row[BLANK];
    float part = 0.0f;
    for (int n = tid; n <= S; n += nt) {
      const float p = prev ? prev[n] : (n == 0 ? 0.0f : LOG_EPSILON);
      const float em_prev =
          n > 0 ? (prev ? prev[S + n] : LOG_EPSILON) : 0.0f;
      float pp = p, a = 0.0f;
      if (n > 0) {
        a = em_prev + eps_rep[n - 1];
        pp = lae(p, a);
      }
      // phi_t[n] = lae(pp + lb, em_prev + lb + eps_norep)
      const float q = pp + lb;
      const float g_out = gP[n];
      float gq = g_out, gz = 0.0f;
      if (n > 0) {
        const float z = em_prev + lb + eps_norep[n - 1];
        const float o = lae(q, z);
        gq = __fmul_rn(g_out, expf(q - o));
        gz = __fmul_rn(g_out, expf(z - o));
      }
      float gpp = gq;
      // emit_t[n] = lae(pp + le, emit[n] + le)
      if (n < S) {
        const float em = prev ? prev[S + 1 + n] : LOG_EPSILON;
        const float le = label_lp(row, lab[n]);
        const float x = pp + le, y = em + le;
        const float o = lae(x, y);
        const float ge = gE[n];
        const float gx = __fmul_rn(ge, expf(x - o));
        const float gy = __fmul_rn(ge, expf(y - o));
        gpp = gpp + gx;
        gle[n] = gx + gy;
        gY[n] = gy;
      }
      // pp = lae(phi[n], emit[n-1] + eps_rep)
      float gp = gpp, ga = 0.0f;
      if (n > 0) {
        gp = __fmul_rn(gpp, expf(p - pp));
        ga = __fmul_rn(gpp, expf(a - pp));
      }
      gP_prev[n] = gp;
      gZ[n] = gz;
      gA[n] = ga;
      part = part + (gq + gz);
    }
    red[tid] = part;
    __syncthreads();
    for (int n = tid; n <= S; n += nt) {
      gP[n] = gP_prev[n];
      if (n < S) gE[n] = gY[n] + gZ[n + 1] + gA[n + 1];
    }
    for (int off = nt >> 1; off > 0; off >>= 1) {
      if (tid < off) red[tid] = red[tid] + red[tid + off];
      __syncthreads();
    }
    const float glb = red[0];
    float* drow = dlp + (size_t)t * C;
    for (int k = tid; k < C; k += nt) {
      float v = k == BLANK ? glb : 0.0f;
      for (int n = 0; n < S; ++n)
        if (lab[n] == k) v = v + gle[n];
      drow[k] = v;
    }
    __syncthreads();
  }
}

// ---- the warp route ------------------------------------------------------

// lae's value with its special case as a select: a lane's slots then run
// as straight-line code the compiler can interleave (a branch a slot
// serialises them). Where a == b == +-inf the discarded sum is NaN.
__device__ __forceinline__ float lae_sel(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = m + log1pf(expf(-fabsf(a - b)));
  return (isinf(a) && a == b) ? a : r;
}

// Warps a block: one where the batch leaves SMs to spare (each warp then
// has an SM's load/store and shuffle pipe to itself), up to MAX_WARPS
// where it does not. Measurement builds (bench_ctc_loss_variants.py) may
// fix the warps a block (CTC_WARPS), set the rings' depths (powers of
// two: CTC_FWD_DEPTH frames copied ahead in the forward, CTC_BWD_DEPTH
// stages in the backward) and CTC_LEAVE_OUT, a mask of parts left out
// (their results then wrong): 1 the backward's class sums (a row gets its
// blank term only), 2 its blank sum (glb is lane 0's own term), 4 the
// ring copies of each frame (every frame reads what the prologue copied),
// 8 the forward's state rows, 16 the backward's chains past their first
// position.
#ifndef CTC_WARPS
#define CTC_WARPS 0
#endif
#ifndef CTC_FWD_DEPTH
#define CTC_FWD_DEPTH 16
#endif
#ifndef CTC_BWD_DEPTH
#define CTC_BWD_DEPTH 8
#endif
#ifndef CTC_LEAVE_OUT
#define CTC_LEAVE_OUT 0
#endif
constexpr int MAX_WARPS = 4;
constexpr int CHAIN = 3;              // a chain's positions kept in registers
constexpr int FWD_DEPTH = CTC_FWD_DEPTH;
constexpr int BWD_DEPTH = CTC_BWD_DEPTH;
constexpr int LEAVE_OUT = CTC_LEAVE_OUT;
constexpr int WARP_MAX_SLOTS = 8;     // S+1 <= 256
constexpr int WARP_MAX_CLASSES = 4096;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this lane's copies but the N newest complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's label tables for its slots: col[j], the column of label n =
// lane + 32 j (-1 for none, as lab[] above); erep[j] / enorep[j], the
// block route's eps_rep[n-1] / eps_norep[n-1].
template <int K>
__device__ __forceinline__ void lane_tables(const int* yb, int S, int C,
                                            int lane, int* col, float* erep,
                                            float* enorep) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = lane + 32 * j;
    col[j] = -1;
    erep[j] = 0.0f;
    enorep[j] = 0.0f;
    if (n < S) {
      const int y = yb[n];
      col[j] = (y >= 0 && y < C) ? y : -1;
    }
    if (n > 0 && n <= S) {
      const float rep = (n < S && yb[n - 1] == yb[n]) ? 1.0f : 0.0f;
      erep[j] = LOG_EPSILON * rep;
      enorep[j] = LOG_EPSILON * (1.0f - rep);
    }
  }
}

// Frame t's label and blank log-probabilities into a ring stage: le[n]
// at [n] for n < S with a label in [0, C), the blank at [S].
template <int K>
__device__ __forceinline__ void copy_row(float* dst, const float* row,
                                         const int* col, int S, int lane) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = lane + 32 * j;
    if (n < S && col[j] >= 0) cp_async4(dst + n, row + col[j]);
    if (n == S) cp_async4(dst + S, row + BLANK);
  }
}

template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ctc_forward_warp(const float* __restrict__ logprobs,  // (B, T, C)
                 const int* __restrict__ labels,      // (B, S)
                 const int* __restrict__ logit_lengths,
                 const int* __restrict__ label_lengths,
                 float* __restrict__ loss,            // (B,)
                 float* __restrict__ states,          // (B, T, 2S+1)
                 int B, int T, int C, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int R = S + 1;                  // a ring stage
  const int W = 2 * S + 1;
  float* ring = smem + (size_t)warp * FWD_DEPTH * R;
  int col[K];
  float erep[K], enorep[K], P[K], E[K];
  lane_tables<K>(labels + (size_t)b * S, S, C, lane, col, erep, enorep);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    P[j] = lane + 32 * j == 0 ? 0.0f : LOG_EPSILON;
    E[j] = LOG_EPSILON;
  }
  const int len = min(max(logit_lengths[b], 0), T);
  const float* lp = logprobs + (size_t)b * T * C;
  float* st = states + (size_t)b * T * W;
  for (int t = 0; t < FWD_DEPTH - 1; ++t) {
    if (t < len)
      copy_row<K>(ring + (t & (FWD_DEPTH - 1)) * R, lp + (size_t)t * C, col, S,
                  lane);
    cp_async_commit();
  }
  for (int t = 0; t < len; ++t) {
    __syncwarp();                       // every lane done with frame t-1's stage
    const int ahead = t + FWD_DEPTH - 1;
    if (ahead < len && !(LEAVE_OUT & 4))
      copy_row<K>(ring + (ahead & (FWD_DEPTH - 1)) * R, lp + (size_t)ahead * C,
                  col, S, lane);
    cp_async_commit();
    cp_async_wait<FWD_DEPTH - 1>();
    __syncwarp();                       // the other lanes' copies visible
    const float* in = ring + (t & (FWD_DEPTH - 1)) * R;
    const float lb = in[S];
    float* out = st + (size_t)t * W;
    // emit[n-1]: lane - 1's slot, lane 31's previous slot for lane 0
    float r[K];
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = __shfl_sync(FULL, E[j], (lane + 31) & 31);
    // every slot computed, inactive positions discarded by selects: the
    // kept values are the block route's operations on the same operands
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int n = lane + 32 * j;
      const float em_prev =
          lane == 0 ? (j > 0 ? r[j > 0 ? j - 1 : 0] : 0.0f) : r[j];
      const float pp = n > 0 ? lae_sel(P[j], em_prev + erep[j]) : P[j];
      const float le = col[j] >= 0 ? in[n < S ? n : S] : 0.0f;
      const float e = lae_sel(pp + le, E[j] + le);
      const float z = lae_sel(pp + lb, em_prev + lb + enorep[j]);
      const float q = n > 0 ? z : pp + lb;
      if (n < S) {
        E[j] = e;
        if (!(LEAVE_OUT & 8)) out[S + 1 + n] = e;
      }
      if (n <= S) {
        P[j] = q;
        if (!(LEAVE_OUT & 8)) out[n] = q;
      }
    }
  }
  const int L = min(max(label_lengths[b], 0), S);
  float pl = 0.0f, el = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j == (L >> 5)) pl = P[j];
    if (L > 0 && j == ((L - 1) >> 5)) el = E[j];
  }
  pl = __shfl_sync(FULL, pl, L & 31);
  el = __shfl_sync(FULL, el, (L + 31) & 31);
  if (lane == 0) loss[b] = -(L == 0 ? pl : lae(pl, el));
}

// Shared memory of one warp of ctc_backward_warp, in 4-byte words: the
// ring (BWD_DEPTH stages of the state before the frame, W, and the frame's
// log-probabilities, S+1), gle (S), then the int tables lab (S), next
// (S), head (C).
__host__ __device__ __forceinline__ size_t backward_warp_words(int S,
                                                               int C) {
  return (size_t)BWD_DEPTH * (3 * (size_t)S + 2) + 3 * (size_t)S + (size_t)C;
}

template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ctc_backward_warp(const float* __restrict__ logprobs,  // (B, T, C)
                  const int* __restrict__ labels,      // (B, S)
                  const int* __restrict__ logit_lengths,
                  const int* __restrict__ label_lengths,
                  const float* __restrict__ states,    // (B, T, 2S+1)
                  const float* __restrict__ grad,      // (B,)
                  float* __restrict__ dlogprobs,       // (B, T, C)
                  int B, int T, int C, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int W = 2 * S + 1;
  const int R = W + S + 1;              // a ring stage: [state | le | lb]
  float* ring = smem + (size_t)warp * backward_warp_words(S, C);
  float* gle = ring + (size_t)BWD_DEPTH * R;
  int* lab = reinterpret_cast<int*>(gle + S);
  int* next = lab + S;
  int* head = next + S;

  const int* yb = labels + (size_t)b * S;
  int col[K];
  float erep[K], enorep[K];
  lane_tables<K>(yb, S, C, lane, col, erep, enorep);
  const int len = min(max(logit_lengths[b], 0), T);
  const int L = min(max(label_lengths[b], 0), S);
  // the class chains: head[k] the first position naming k, next[n] the
  // next position naming lab[n] (-1: none). Positions at or past the label
  // length are left out: their adjoints stay +0 from the seed down, so
  // their gle is +0, and adding +0 to a sum that is never -0 changes no
  // bit of the block route's walk.
  for (int n = lane; n < S; n += 32) {
    const int y = yb[n];
    lab[n] = (n < L && y >= 0 && y < C) ? y : -1;
  }
  for (int k = lane; k < C; k += 32) head[k] = -1;
  __syncwarp();
  for (int n = lane; n < S; n += 32) {
    const int c = lab[n];
    int nx = -1;
    if (c >= 0) {
      for (int m = n + 1; m < S && nx < 0; ++m)
        if (lab[m] == c) nx = m;
      bool first = true;
      for (int m = 0; m < n && first; ++m)
        if (lab[m] == c) first = false;
      if (first) head[c] = n;
    }
    next[n] = nx;
  }
  __syncwarp();
  // lead bit j: this lane's slot j holds the first position of a class's
  // chain; chain[j][0..CHAIN-1] its next positions (-1: none), rest[j] the
  // one after those (walked in shared memory); plain bit i: class lane +
  // 32 i (i < 32) names no position (its entry is the blank's sum or 0)
  unsigned lead = 0, plain = 0;
  int chain[K][CHAIN], rest[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = lane + 32 * j;
    int m = -1;
    if (!(LEAVE_OUT & 1) && n < L && col[j] >= 0 && head[col[j]] == n) {
      lead |= 1u << j;
      m = (LEAVE_OUT & 16) ? -1 : next[n];
    }
#pragma unroll
    for (int i = 0; i < CHAIN; ++i) {
      chain[j][i] = m;
      if (m >= 0) m = next[m];
    }
    rest[j] = m;
  }
  for (int i = 0; i < 32 && lane + 32 * i < C; ++i)
    if ((LEAVE_OUT & 1) || head[lane + 32 * i] < 0) plain |= 1u << i;

  const float* lp = logprobs + (size_t)b * T * C;
  const float* st = states + (size_t)b * T * W;
  float* dlp = dlogprobs + (size_t)b * T * C;
  for (long long i = lane; i < (long long)(T - len) * C; i += 32)
    dlp[(size_t)len * C + i] = 0.0f;
  // the seed: loss = -last[L], last[L] = lae(phi[L], emit[L-1]) on the
  // state after the last frame
  float gP[K], gE[K];
#pragma unroll
  for (int j = 0; j < K; ++j) gP[j] = gE[j] = 0.0f;
  {
    const float g = -grad[b];
    if (L == 0) {
      if (lane == 0) gP[0] = g;
    } else {
      const float* fin = len > 0 ? st + (size_t)(len - 1) * W : nullptr;
      const float p = fin ? fin[L] : LOG_EPSILON;
      const float e = fin ? fin[S + L] : LOG_EPSILON;
      const float o = lae(p, e);
      const float gp = __fmul_rn(g, expf(p - o));
      const float ge = __fmul_rn(g, expf(e - o));
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int n = lane + 32 * j;
        if (n == L) gP[j] = gp;
        if (n == L - 1) gE[j] = ge;
      }
    }
  }

  // frame t's stage: the state after frame t-1 (none for t = 0) and, for
  // t < len, the frame's log-probabilities. Frame t reads its own stage
  // and frame t+1's (the state after frame t: the forward's values of
  // the frame's last two logaddexps, the same bits as recomputing them),
  // so the copies run BWD_DEPTH-2 frames ahead, the first one being frame
  // len's (the state after the last frame only).
  auto copy_frame = [&](int t) {
    if (t >= 0) {
      float* dst = ring + (t & (BWD_DEPTH - 1)) * R;
      if (t > 0) {                      // W = 2S + 1 < 64 K words
        const float* prev = st + (size_t)(t - 1) * W;
#pragma unroll
        for (int i = 0; i < 2 * K; ++i)
          if (lane + 32 * i < W)
            cp_async4(dst + lane + 32 * i, prev + lane + 32 * i);
      }
      if (t < len) copy_row<K>(dst + W, lp + (size_t)t * C, col, S, lane);
    }
    cp_async_commit();
  };
  for (int i = 0; i < BWD_DEPTH - 1; ++i) copy_frame(len - i);

  for (int t = len - 1; t >= 0; --t) {
    __syncwarp();                       // frame t+2's stage and gle read
    if (!(LEAVE_OUT & 4)) copy_frame(t - (BWD_DEPTH - 2));
    else cp_async_commit();
    cp_async_wait<BWD_DEPTH - 2>();
    __syncwarp();
    const float* in = ring + (t & (BWD_DEPTH - 1)) * R;
    const float* after = ring + ((t + 1) & (BWD_DEPTH - 1)) * R;
    const bool first = t == 0;
    const float lb = in[W + S];
    float gPn[K], gz[K], ga[K], gy[K], part[K], gl[K];
    // every slot computed, inactive positions discarded by selects (as in
    // the forward); the kept values are the block route's operations
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int n = lane + 32 * j;
      const int m = n < S ? n : S;          // an index within the stage
      const float p = first ? (n == 0 ? 0.0f : LOG_EPSILON) : in[m];
      const float em_prev = n > 0 ? (first ? LOG_EPSILON : in[S + m]) : 0.0f;
      const float em =
          first ? LOG_EPSILON : in[S + 1 + (n < S ? n : S - 1)];
      const float le = col[j] >= 0 ? in[W + m] : 0.0f;
      // pp = lae(phi[n], emit[n-1] + eps_rep)
      const float a = n > 0 ? em_prev + erep[j] : 0.0f;
      const float pp = n > 0 ? lae_sel(p, a) : p;
      // phi_t[n] = lae(pp + lb, em_prev + lb + eps_norep), saved
      const float q = pp + lb;
      const float z = em_prev + lb + enorep[j];
      const float oq = after[m];
      const float g_out = gP[j];
      const float gq = n > 0 ? __fmul_rn(g_out, expf(q - oq)) : g_out;
      const float gzv = n > 0 ? __fmul_rn(g_out, expf(z - oq)) : 0.0f;
      // emit_t[n] = lae(pp + le, emit[n] + le), saved
      const float x = pp + le, y = em + le;
      const float ox = after[S + 1 + (n < S ? n : S - 1)];
      const float ge = gE[j];
      const float gx = __fmul_rn(ge, expf(x - ox));
      const float gyv = __fmul_rn(ge, expf(y - ox));
      const float gpp = n < S ? gq + gx : gq;
      const float gp = n > 0 ? __fmul_rn(gpp, expf(p - pp)) : gpp;
      const float gav = n > 0 ? __fmul_rn(gpp, expf(a - pp)) : 0.0f;
      const bool live = n <= S;
      gPn[j] = live ? gp : 0.0f;
      gz[j] = live ? gzv : 0.0f;
      ga[j] = live ? gav : 0.0f;
      gy[j] = n < S ? gyv : 0.0f;
      gl[j] = n < S ? gx + gyv : 0.0f;
      part[j] = live ? 0.0f + (gq + gzv) : 0.0f;
    }
    // the blank: the block route's tree over threads_for(S) = 32 K
    // threads, its strides 16 K .. 32 within a lane, then across lanes
#pragma unroll
    for (int h = K / 2; h >= 1; h >>= 1)
#pragma unroll
      for (int j = 0; j < h; ++j) part[j] = part[j] + part[j + h];
    float v = part[0];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      v = v + __shfl_down_sync(FULL, v, off);
    const float glb = (LEAVE_OUT & 2) ? part[0] : __shfl_sync(FULL, v, 0);
    // gE[n] = gY[n] + gZ[n+1] + gA[n+1]: lane + 1's slot, lane 0's next
    // slot for lane 31
    float rz[K], ra[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      rz[j] = __shfl_sync(FULL, gz[j], (lane + 1) & 31);
      ra[j] = __shfl_sync(FULL, ga[j], (lane + 1) & 31);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int n = lane + 32 * j;
      const int jn = j + 1 < K ? j + 1 : j;
      const float zn = lane == 31 ? (j + 1 < K ? rz[jn] : 0.0f) : rz[j];
      const float an = lane == 31 ? (j + 1 < K ? ra[jn] : 0.0f) : ra[j];
      gE[j] = n < S ? gy[j] + zn + an : 0.0f;
      gP[j] = gPn[j];
      if (n < S) gle[n] = gl[j];
    }
    __syncwarp();
    // a labelled class's sum, by the lane holding its first position
    float* drow = dlp + (size_t)t * C;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float s = col[j] == BLANK ? glb : 0.0f;
      s = s + gl[j];
      float v[CHAIN];
#pragma unroll
      for (int i = 0; i < CHAIN; ++i)
        v[i] = gle[chain[j][i] > 0 ? chain[j][i] : 0];
#pragma unroll
      for (int i = 0; i < CHAIN; ++i) s = chain[j][i] >= 0 ? s + v[i] : s;
      if (rest[j] >= 0) {
#pragma unroll 1
        for (int m = rest[j]; m >= 0; m = next[m]) s = s + gle[m];
      }
      if (lead >> j & 1u) drow[col[j] > 0 ? col[j] : 0] = s;
    }
    // every other class: the blank's sum or 0
#pragma unroll 1
    for (int k = lane, i = 0; k < C; k += 32, ++i)
      if (i < 32 ? (plain >> i & 1u) : ((LEAVE_OUT & 1) || head[k] < 0))
        drow[k] = k == BLANK ? glb : 0.0f;
  }
}

int threads_for(int S) {
  int n = 32;
  while (n < S + 1 && n < MAX_THREADS) n <<= 1;
  return n;
}

int launch_config(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Warps a block for B utterances: one while B blocks fit the card's SMs
// once, more (up to MAX_WARPS) as B grows.
int warps_for(int B) {
  if (CTC_WARPS > 0) return CTC_WARPS;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  const int w = (B + sms - 1) / sms;
  return w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
}

// Whether the warp route takes S labels and C classes.
bool warp_fits(int S, int C) {
  return S >= 0 && S + 1 <= 32 * WARP_MAX_SLOTS && C <= WARP_MAX_CLASSES;
}

template <int K>
int forward_warp_launch(const float* logprobs, const int* labels,
                        const int* logit_lengths, const int* label_lengths,
                        float* loss, float* states, int B, int T, int C,
                        int S, cudaStream_t stream) {
  const int warps = warps_for(B);
  const size_t smem = sizeof(float) * warps * FWD_DEPTH * (size_t)(S + 1);
  int err = launch_config((const void*)ctc_forward_warp<K>, smem);
  if (err) return err;
  ctc_forward_warp<K><<<(B + warps - 1) / warps, 32 * warps, smem, stream>>>(
      logprobs, labels, logit_lengths, label_lengths, loss, states, B, T, C,
      S);
  return (int)cudaGetLastError();
}

template <int K>
int backward_warp_launch(const float* logprobs, const int* labels,
                         const int* logit_lengths, const int* label_lengths,
                         const float* states, const float* grad,
                         float* dlogprobs, int B, int T, int C, int S,
                         cudaStream_t stream) {
  const int warps = warps_for(B);
  const size_t smem = sizeof(float) * warps * backward_warp_words(S, C);
  int err = launch_config((const void*)ctc_backward_warp<K>, smem);
  if (err) return err;
  ctc_backward_warp<K><<<(B + warps - 1) / warps, 32 * warps, smem,
                         stream>>>(logprobs, labels, logit_lengths,
                                   label_lengths, states, grad, dlogprobs, B,
                                   T, C, S);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points of both routes take the same arguments and write the
// same outputs, bit for bit. Each returns the cudaError_t of its launch;
// the warp route's return cudaErrorInvalidValue where S+1 > 256 or C >
// WARP_MAX_CLASSES.
//
// Forward: logprobs (B, T, C) float32, labels (B, S) int32, the lengths
// (B,) int32 (clamped to [0, T] and [0, S]); writes loss (B,) and, for
// the frames before each length, states (B, T, 2S+1).
extern "C" int ctc_loss_forward_block(const void* logprobs,
                                      const void* labels,
                                      const void* logit_lengths,
                                      const void* label_lengths, void* loss,
                                      void* states, int B, int T, int C,
                                      int S, void* stream) {
  const int nt = threads_for(S);
  const size_t smem = sizeof(float) * (4 * (size_t)(S + 1) + 2 * (size_t)S)
                      + sizeof(int) * (size_t)S;
  int err = launch_config((const void*)ctc_forward_kernel, smem);
  if (err) return err;
  ctc_forward_kernel<<<B, nt, smem, (cudaStream_t)stream>>>(
      (const float*)logprobs, (const int*)labels, (const int*)logit_lengths,
      (const int*)label_lengths, (float*)loss, (float*)states, T, C, S);
  return (int)cudaGetLastError();
}

extern "C" int ctc_loss_forward_warp(const void* logprobs, const void* labels,
                                     const void* logit_lengths,
                                     const void* label_lengths, void* loss,
                                     void* states, int B, int T, int C, int S,
                                     void* stream) {
  if (!warp_fits(S, C)) return (int)cudaErrorInvalidValue;
  const int k = threads_for(S) / 32;
  auto launch = &forward_warp_launch<8>;
  if (k == 1) launch = &forward_warp_launch<1>;
  if (k == 2) launch = &forward_warp_launch<2>;
  if (k == 4) launch = &forward_warp_launch<4>;
  return launch((const float*)logprobs, (const int*)labels,
                (const int*)logit_lengths, (const int*)label_lengths,
                (float*)loss, (float*)states, B, T, C, S,
                (cudaStream_t)stream);
}

// Backward: the same inputs, the forward's states and grad (B,) float32
// (dL/dloss); writes dlogprobs (B, T, C) whole.
extern "C" int ctc_loss_backward_block(const void* logprobs,
                                       const void* labels,
                                       const void* logit_lengths,
                                       const void* label_lengths,
                                       const void* states, const void* grad,
                                       void* dlogprobs, int B, int T, int C,
                                       int S, void* stream) {
  const int nt = threads_for(S);
  const size_t smem =
      sizeof(float) * (7 * (size_t)(S + 1) + 2 + (size_t)nt + 2 * (size_t)S)
      + sizeof(int) * (size_t)S;
  int err = launch_config((const void*)ctc_backward_kernel, smem);
  if (err) return err;
  ctc_backward_kernel<<<B, nt, smem, (cudaStream_t)stream>>>(
      (const float*)logprobs, (const int*)labels, (const int*)logit_lengths,
      (const int*)label_lengths, (const float*)states, (const float*)grad,
      (float*)dlogprobs, T, C, S);
  return (int)cudaGetLastError();
}

extern "C" int ctc_loss_backward_warp(const void* logprobs, const void* labels,
                                      const void* logit_lengths,
                                      const void* label_lengths,
                                      const void* states, const void* grad,
                                      void* dlogprobs, int B, int T, int C,
                                      int S, void* stream) {
  if (!warp_fits(S, C)) return (int)cudaErrorInvalidValue;
  const int k = threads_for(S) / 32;
  auto launch = &backward_warp_launch<8>;
  if (k == 1) launch = &backward_warp_launch<1>;
  if (k == 2) launch = &backward_warp_launch<2>;
  if (k == 4) launch = &backward_warp_launch<4>;
  return launch((const float*)logprobs, (const int*)labels,
                (const int*)logit_lengths, (const int*)label_lengths,
                (const float*)states, (const float*)grad, (float*)dlogprobs,
                B, T, C, S, (cudaStream_t)stream);
}
