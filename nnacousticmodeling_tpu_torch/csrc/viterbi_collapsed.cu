// Right-context-collapsed triphone Viterbi forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel nnacousticmodeling_tpu/decoder/
// viterbi_collapsed.py PallasCollapsedViterbi._kernel (pallas_call in
// _forward_impl at :525). Same outputs, bit for bit: per utterance and
// frame t, packed[t, j] = a* * pack + t_entry + 1 for every collapsed
// lane j, and end[t, p] = the end-lane score of phone p, with the TPU
// kernel's float32 operation order (each step one IEEE add; strict `>`
// updates; first max over left contexts; ((pc + lm) + pip) on entry;
// the beam threshold of frame t clamps frame t's end row and frame
// t+1's entry). A column whose max is NaN (jnp.max propagates it) matches
// no row, so its key is jnp.min over none, 2**31 - 1, and its exported
// score NaN; the beam's row max propagates NaN too.
//
// Two routes, chosen by the host's viterbi_cluster_plan from the image's
// size, never as a fallback:
//
// * the cluster route, collapsed_viterbi_cluster (viterbi_cluster.cuh
//   says what bounds the other route and what this design does about
//   it): one thread-block cluster an utterance keeps the DP state on
//   chip, one cluster barrier a frame: in its threads' registers where
//   the slice is one chunk a warp and the rows are an even count of row
//   steps up to REG_STEPS (the register route, one kernel a count), else
//   in its blocks' shared memory;
// * the device-memory route, collapsed_viterbi_kernel below, for images
//   whose state no cluster of at most 16 blocks holds: one block per
//   utterance walks its frames with the state in device memory laid out
//   lane-fastest; each thread owns lanes and walks the left contexts
//   a = 0..PS-1 in order, so the running strict-`>` maximum gives the
//   first max with no cross-thread reduction. Per frame the block stages
//   the posterior row (S floats) and the previous exported row pc (L
//   floats, double-buffered) in shared memory; the beam's row maximum is
//   one block reduction a frame. It moves the whole state (2.65 MB an
//   utterance on the synthetic 48-phone image) through device memory
//   every frame.
//
// Both read the observation as the gather lp[pdf[s, a, j]] (no per-frame
// table of distinct-pdf scores) and the entry as the exact gather
// pc[src[a, j % Pp]] that replaces the TPU kernel's one-hot matmul.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "viterbi_cluster.cuh"

namespace {

constexpr float NEG_INF = -1.0e20f;
constexpr float THR0 = -3.0e38f;
constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
collapsed_viterbi_kernel(const float* __restrict__ lp,       // (U, T, S)
                         const int* __restrict__ lengths,    // (U,)
                         const int* __restrict__ pdf,        // (3, PS, L)
                         const float* __restrict__ tps,      // (6, PS, L)
                         const int* __restrict__ src,        // (PS, Pp)
                         const float* __restrict__ lmq,      // (PS, Pp)
                         const float* __restrict__ lmmax,    // (L,)
                         const float* __restrict__ lmend,    // (Pp,)
                         const float* __restrict__ p0,       // (L,)
                         const int* __restrict__ pc0_map,    // (P,)
                         float* __restrict__ pp,             // (U, 3, PS, L)
                         int* __restrict__ tt,               // (U, 3, PS, L)
                         int* __restrict__ packed,           // (U, T, L)
                         float* __restrict__ end,            // (U, T, P)
                         int T, int S, int P, int PS, int L, int Pp,
                         int pack, float pip, float beam, int use_beam) {
  extern __shared__ float smem[];
  float* pc_a = smem;              // L
  float* pc_b = smem + L;          // L
  float* lps = smem + 2 * L;       // S
  float* red = lps + S;            // one slot per warp

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = (nt + 31) / 32;
  const int len = min(lengths[u], T);
  const size_t plane = (size_t)PS * L;
  float* ppu = pp + (size_t)u * 3 * plane;
  int* ttu = tt + (size_t)u * 3 * plane;

  for (size_t e = tid; e < 3 * plane; e += nt) {
    ppu[e] = NEG_INF;
    ttu[e] = 0;
  }
  for (int j = tid; j < L; j += nt) pc_a[j] = p0[j];
  float thr = THR0;
  float* pcp = pc_a;
  float* pcn = pc_b;

  for (int t = 0; t < len; ++t) {
    const float* lpt = lp + ((size_t)u * T + t) * S;
    for (int k = tid; k < S; k += nt) lps[k] = lpt[k];
    __syncthreads();   // lps staged; pcp complete; state writes visible

    float local = -INFINITY;
    for (int j = tid; j < L; j += nt) {
      const int bp = j % Pp;
      float best = 0.0f;
      int key = 0;
#pragma unroll 2
      for (int a = 0; a < PS; ++a) {
        const size_t i0 = (size_t)a * L + j;
        const size_t i1 = plane + i0;
        const size_t i2 = 2 * plane + i0;
        const float old0 = ppu[i0], old1 = ppu[i1], old2 = ppu[i2];
        const int t0o = ttu[i0], t1o = ttu[i1], t2o = ttu[i2];

        // entry: ((pc + lm) -> beam clamp) + pip
        const int sl = src[a * Pp + bp];
        float q = (sl >= 0 ? pcp[sl] : 0.0f) + lmq[a * Pp + bp];
        if (use_beam) q = (q >= thr) ? q : NEG_INF;
        const float p_in = q + pip;

        const float go2 = old1 + tps[4 * plane + i0];
        const float stay2 = old2 + tps[2 * plane + i0];
        const bool take2 = go2 > stay2;
        const float pp2 = (take2 ? go2 : stay2) + lps[pdf[i2]];
        const int tt2 = take2 ? t1o : t2o;

        const float go1 = old0 + tps[3 * plane + i0];
        const float stay1 = old1 + tps[plane + i0];
        const bool take1 = go1 > stay1;
        const float pp1 = (take1 ? go1 : stay1) + lps[pdf[i1]];
        const int tt1 = take1 ? t0o : t1o;

        const float stay0 = old0 + tps[i0];
        const bool take0 = p_in > stay0;
        const float pp0 = (take0 ? p_in : stay0) + lps[pdf[i0]];
        const int tt0 = take0 ? t - 1 : t0o;

        ppu[i0] = pp0;
        ppu[i1] = pp1;
        ppu[i2] = pp2;
        ttu[i0] = tt0;
        ttu[i1] = tt1;
        ttu[i2] = tt2;

        // export: first max over left contexts (strict >, ascending a;
        // the first NaN sticks)
        const float out = pp2 + tps[5 * plane + i0];
        if (a == 0 || viterbi_cluster::first_max_takes(out, best)) {
          best = out;
          key = a * pack + tt2 + 1;
        }
      }
      packed[((size_t)u * T + t) * L + j] = best == best ? key : 0x7fffffff;
      pcn[j] = best;
      local = viterbi_cluster::nan_max(local, best + lmmax[j]);
    }

    // beam threshold of this frame: max over lanes of (pnew + lmmax)
    float thr_new = thr;
    if (use_beam) {
      for (int off = 16; off > 0; off >>= 1)
        local = viterbi_cluster::nan_max(
            local, __shfl_xor_sync(0xffffffffu, local, off));
      if ((tid & 31) == 0) red[tid >> 5] = local;
    }
    __syncthreads();   // pcn complete; warp maxima staged
    if (use_beam) {
      float rowm = red[0];
      for (int w = 1; w < nwarps; ++w)
        rowm = viterbi_cluster::nan_max(rowm, red[w]);
      thr_new = rowm - beam;
    }
    for (int p = tid; p < P; p += nt) {
      const int jl = pc0_map[p];
      float e = pcn[jl] + lmend[jl];
      if (use_beam) e = (e >= thr_new) ? e : NEG_INF;
      end[((size_t)u * T + t) * P + p] = e;
    }
    thr = thr_new;
    float* swap = pcp;
    pcp = pcn;
    pcn = swap;
  }
}

template <int RS>
__global__ void __launch_bounds__(viterbi_cluster::MAX_THREADS, 1)
collapsed_viterbi_cluster_kernel(const float* __restrict__ lp,
                                 const int* __restrict__ lengths,
                                 const int* __restrict__ order,
                                 const int* __restrict__ rec,
                                 const float* __restrict__ lmq,
                                 const float* __restrict__ lmmax,
                                 const float* __restrict__ lmend,
                                 const float* __restrict__ p0,
                                 const int* __restrict__ pc0_map,
                                 int* __restrict__ packed,
                                 float* __restrict__ end, int T, int S,
                                 int P, int PS, int L, int pack, float pip,
                                 float beam, int use_beam) {
  const viterbi_cluster::Collapsed pol{lmq, lmmax, lmend, pc0_map, pack};
  viterbi_cluster::decode<viterbi_cluster::Collapsed, RS>(
      pol, lp, lengths, order, rec, p0, packed, end, T, S, P, PS, L, pip,
      beam, use_beam);
}

// The cluster route's kernel for rs row steps in registers (0: the state
// in shared memory), nullptr for a count none is built for.
using ClusterKernel = decltype(&collapsed_viterbi_cluster_kernel<0>);
static_assert(viterbi_cluster::REG_STEPS == 12, "one kernel an even count");
ClusterKernel cluster_kernel(int rs) {
  switch (rs) {
    case 0: return collapsed_viterbi_cluster_kernel<0>;
    case 2: return collapsed_viterbi_cluster_kernel<2>;
    case 4: return collapsed_viterbi_cluster_kernel<4>;
    case 6: return collapsed_viterbi_cluster_kernel<6>;
    case 8: return collapsed_viterbi_cluster_kernel<8>;
    case 10: return collapsed_viterbi_cluster_kernel<10>;
    case 12: return collapsed_viterbi_cluster_kernel<12>;
    default: return nullptr;
  }
}
// rs of the route: PS / 4 row steps on the register route, else 0.
int row_steps(int PS, int registers) {
  return registers ? PS / viterbi_cluster::ROW_GROUPS : 0;
}

}  // namespace

// The device-memory route. One block per utterance. pp/tt are (U, 3,
// PS, L) scratch the kernel initialises; packed (U, T, L) and end (U, T,
// P) rows t < lengths[u] are written. Returns the cudaError_t of the
// launch.
extern "C" int collapsed_viterbi_forward(
    const void* lp, const void* lengths, const void* pdf, const void* tps,
    const void* src, const void* lmq, const void* lmmax, const void* lmend,
    const void* p0, const void* pc0_map, void* pp, void* tt, void* packed,
    void* end, int U, int T, int S, int P, int PS, int L, int Pp, int pack,
    float pip, float beam, int use_beam, void* stream) {
  if (U == 0 || T == 0) return 0;
  const int threads = THREADS;
  const size_t smem = ((size_t)2 * L + S + threads / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        collapsed_viterbi_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  collapsed_viterbi_kernel<<<U, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int*>(lengths),
      static_cast<const int*>(pdf), static_cast<const float*>(tps),
      static_cast<const int*>(src), static_cast<const float*>(lmq),
      static_cast<const float*>(lmmax), static_cast<const float*>(lmend),
      static_cast<const float*>(p0), static_cast<const int*>(pc0_map),
      static_cast<float*>(pp), static_cast<int*>(tt),
      static_cast<int*>(packed), static_cast<float*>(end), T, S, P, PS, L,
      Pp, pack, pip, beam, use_beam);
  return (int)cudaGetLastError();
}

// The cluster route: U clusters of c blocks; cluster i decodes utterance
// order[i], its DP state in registers (registers != 0: the register
// route, for at most REG_FRAMES frames) or in shared memory. rec (8 PS
// L,) int32 and lmq (PS L,) are the cells' records in the order of
// viterbi_cluster.cuh; packed (U, T, L) and end (U, T, P) rows t <
// lengths[u] are written; no scratch. Returns the cudaError_t of the
// layout check, the co-residency query or the launch.
extern "C" int collapsed_viterbi_cluster(
    const void* lp, const void* lengths, const void* order, const void* rec,
    const void* lmq, const void* lmmax, const void* lmend, const void* p0,
    const void* pc0_map, void* packed, void* end, int U, int T, int S,
    int P, int PS, int L, int pack, float pip, float beam, int use_beam,
    int c, int registers, void* stream) {
  if (U == 0 || T == 0) return 0;
  const int rs = row_steps(PS, registers);
  const ClusterKernel kern = cluster_kernel(rs);
  if (!kern) return (int)cudaErrorInvalidValue;
  const int err = viterbi_cluster::check_frames(T, rs);
  if (err) return err;
  return viterbi_cluster::launch(
      kern, U, PS, L, S, c, rs, stream,
      static_cast<const float*>(lp), static_cast<const int*>(lengths),
      static_cast<const int*>(order), static_cast<const int*>(rec),
      static_cast<const float*>(lmq), static_cast<const float*>(lmmax),
      static_cast<const float*>(lmend), static_cast<const float*>(p0),
      static_cast<const int*>(pc0_map), static_cast<int*>(packed),
      static_cast<float*>(end), T, S, P, PS, L, pack, pip, beam, use_beam);
}

// How many clusters of c blocks the card holds at once for this geometry
// and route.
extern "C" int collapsed_viterbi_cluster_capacity(int PS, int L, int S,
                                                  int c, int registers,
                                                  int* out) {
  const int rs = row_steps(PS, registers);
  const ClusterKernel kern = cluster_kernel(rs);
  if (!kern) return (int)cudaErrorInvalidValue;
  return viterbi_cluster::capacity(kern, PS, L, S, c, rs, out);
}
