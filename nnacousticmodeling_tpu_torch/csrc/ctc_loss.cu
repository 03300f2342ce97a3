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
// ctc_loss_forward: one block an utterance, a thread a lattice position
// n (phi[n] and emit[n]; looping when S+1 exceeds the block), the state
// double-buffered in shared memory, one __syncthreads a frame. The loop
// stops at the utterance's length (a padded frame carries the state);
// the state after each frame goes to states (B, T, 2S+1) = [phi | emit],
// which the backward reads; thread 0 writes -last[L].
//
// ctc_loss_backward: the same blocks run the adjoint of each frame's
// operations from the last frame down, the forward values recomputed
// from the saved state before the frame (the same operations, so the
// same bits). logaddexp's derivative is jax.numpy.logaddexp's,
// g * exp(x - out), as autograd through the plain version computes it.
// A frame's blank gradient (a sum over n) is a fixed-order tree
// reduction in shared memory, and a class's gradient sums the label
// positions that name it in order of n: no atomics, so two runs give the
// same bits. Padded frames' rows are zero.
//
// Bound: latency. A frame is a chain of dependent logaddexps (expf,
// log1pf) and a barrier; T frames run in sequence in each block. The
// bytes (the valid frames' log-probability rows, each row's own lattice
// written and read back, the gradient written whole) bound the two
// kernels at 8.6 and 12.1 us at phase 32's shape (B=128, T=470, C=49,
// S=50); they take 0.321 and 1.260 ms there (chip_smoke.py; H100 80GB
// HBM3, 700.00 W), ~0.5 % of a CTC training step. Simple first: a block
// an utterance (B blocks, ~1 an SM), no tensor cores; making it fast
// (several utterances a block, the states in registers, warp shuffles in
// place of barriers, the class sums of a frame in one pass) is later
// work.

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

}  // namespace

// logprobs (B, T, C) float32, labels (B, S) int32, the lengths (B,) int32
// (clamped to [0, T] and [0, S]); writes loss (B,) and, for the frames
// before each length, states (B, T, 2S+1). Returns the cudaError_t of the
// launch.
extern "C" int ctc_loss_forward(const void* logprobs, const void* labels,
                                const void* logit_lengths,
                                const void* label_lengths, void* loss,
                                void* states, int B, int T, int C, int S,
                                void* stream) {
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

// The same inputs, ctc_loss_forward's states and grad (B,) float32
// (dL/dloss); writes dlogprobs (B, T, C) whole. Returns the cudaError_t
// of the launch.
extern "C" int ctc_loss_backward(const void* logprobs, const void* labels,
                                 const void* logit_lengths,
                                 const void* label_lengths,
                                 const void* states, const void* grad,
                                 void* dlogprobs, int B, int T, int C, int S,
                                 void* stream) {
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
