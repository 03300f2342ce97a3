// Dense-cube triphone Viterbi forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel nnacousticmodeling_tpu/decoder/
// viterbi_pallas.py PallasCubeViterbi._kernel (:255; pallas_call in
// _forward_impl at :394). Same outputs, bit for bit: per utterance and
// frame t, packed[t, j] = (a* * a_coef + tri_base[j]) * 2048 + t_entry + 1
// for every right-major lane j = c*P + b (out-biphone (b, c)), and
// end[t, p] = the exported score at lane end_lane[p], with the TPU
// kernel's float32 operation order (each step one IEEE add; p_in = q +
// pip; strict `>` go/stay selects with the observation added after the
// select; a first max over left contexts of pp2 + tps[5]; pnew = mx + lm;
// then the beam clamp pnew >= rowmax - beam). A column whose max is NaN
// (jnp.max propagates it) matches no row: the TPU kernel's arg is then P
// and its bt the entry time of pad row P (0 where PS = P); the beam's row
// max propagates NaN too.
//
// Why the gathers are exact. The TPU kernel rearranged the exported row
// with a one-hot matmul q = (Ea * p) @ Fb and extracted irregular end
// rows with p @ E_end; each output of those products has exactly one
// nonzero term (x * 1 plus zeros), so it equals the gathered value bit
// for bit. Here q[a, b] = p[b*P + a] (0.0 on pad rows a >= P, where the
// product has no nonzero term) and end[p] = p[end_lane[p]]. The
// observation of a cell is lp[pdf[s, a, j]], the pdf the TPU kernel's
// sublane gathers selected. No matmul and no TF32 is left.
//
// Two routes, chosen by the host's viterbi_cluster_plan from the image's
// size, never as a fallback:
//
// * the cluster route, cube_viterbi_cluster (viterbi_cluster.cuh says
//   what bounds the other route and what this design does about it): one
//   thread-block cluster an utterance keeps the DP state in its blocks'
//   shared memory (not in registers, as the collapsed kernel's register
//   route does: this kernel's instantiation of it spilled at the
//   96-register ceiling and ran 31-33 % slower a frame on the 48-phone
//   image), one cluster barrier a frame; the beam clamp pnew >=
//   rowmax - beam becomes a select applied as the exported row is read,
//   for the next frame's entry and for the end row (a select changes no
//   bits);
// * the device-memory route, cube_viterbi_kernel below, for images whose
//   state no cluster of at most 16 blocks holds (or whose lane count no
//   cluster splits into slices of a multiple of 8 lanes): one block per
//   utterance walks its frames up to its own length (rows at or past the
//   length are left unwritten, the TPU kernel's chunk-skip contract) with
//   the state in device memory laid out lane-fastest. Each thread owns
//   lanes and walks the rows a = 0..PS-1 in order, so its loads and
//   stores are coalesced and the running strict-`>` maximum gives the
//   first max with no cross-thread reduction. Per frame the block stages
//   the posterior row (S floats) and the previous exported row (B floats,
//   double-buffered) in shared memory; the beam's row maximum is one
//   block reduction a frame. It moves the whole state (2.65 MB an
//   utterance on the synthetic 48-phone 1909-pdf image, with six
//   transition planes and three pdf planes, 3.98 MB, from L2) every
//   frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "viterbi_cluster.cuh"

namespace {

constexpr float NEG_INF = -1.0e20f;
constexpr int TIME_PACK = 2048;
constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
cube_viterbi_kernel(const float* __restrict__ lp,        // (U, T, S)
                    const int* __restrict__ lengths,     // (U,)
                    const int* __restrict__ pdf,         // (3, PS, B)
                    const float* __restrict__ tps,       // (6, PS, B)
                    const float* __restrict__ lm,        // (B,)
                    const float* __restrict__ p0,        // (B,)
                    const int* __restrict__ tri_base,    // (B,)
                    const int* __restrict__ end_lane,    // (P,)
                    float* __restrict__ pp,              // (U, 3, PS, B)
                    int* __restrict__ tt,                // (U, 3, PS, B)
                    int* __restrict__ packed,            // (U, T, B)
                    float* __restrict__ end,             // (U, T, P)
                    int T, int S, int P, int PS, int B, int a_coef,
                    float pip, float beam, int use_beam) {
  extern __shared__ float smem[];
  float* pc_a = smem;              // B
  float* pc_b = smem + B;          // B
  float* lps = smem + 2 * B;       // S
  float* red = lps + S;            // one slot per warp

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = (nt + 31) / 32;
  const int len = min(lengths[u], T);
  const size_t plane = (size_t)PS * B;
  float* ppu = pp + (size_t)u * 3 * plane;
  int* ttu = tt + (size_t)u * 3 * plane;

  for (size_t e = tid; e < 3 * plane; e += nt) {
    ppu[e] = NEG_INF;
    ttu[e] = 0;
  }
  for (int j = tid; j < B; j += nt) pc_a[j] = p0[j];
  float* pcp = pc_a;
  float* pcn = pc_b;

  for (int t = 0; t < len; ++t) {
    const float* lpt = lp + ((size_t)u * T + t) * S;
    for (int k = tid; k < S; k += nt) lps[k] = lpt[k];
    __syncthreads();   // lps staged; pcp complete; state writes visible

    float local = -INFINITY;
    for (int j = tid; j < B; j += nt) {
      const int b = j % P;
      float best = 0.0f;
      int arg = 0, bt = 0, tt_pad = 0;
#pragma unroll 2
      for (int a = 0; a < PS; ++a) {
        const size_t i0 = (size_t)a * B + j;
        const size_t i1 = plane + i0;
        const size_t i2 = 2 * plane + i0;
        const float old0 = ppu[i0], old1 = ppu[i1], old2 = ppu[i2];
        const int t0o = ttu[i0], t1o = ttu[i1], t2o = ttu[i2];

        // entry: q[a, b] = p[b*P + a] (0.0 on pad rows), then + pip
        const float q = a < P ? pcp[b * P + a] : 0.0f;
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
          arg = a;
          bt = tt2;
        }
        if (a == P) tt_pad = tt2;
      }
      if (best != best) {
        arg = P;
        bt = tt_pad;
      }
      packed[((size_t)u * T + t) * B + j] =
          (arg * a_coef + tri_base[j]) * TIME_PACK + bt + 1;
      const float pnew = best + lm[j];
      pcn[j] = pnew;
      local = viterbi_cluster::nan_max(local, pnew);
    }

    // beam: clamp this frame's row below (row max - beam)
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
      const float thr = rowm - beam;
      for (int j = tid; j < B; j += nt)
        pcn[j] = (pcn[j] >= thr) ? pcn[j] : NEG_INF;
      __syncthreads();   // clamped row complete
    }
    for (int p = tid; p < P; p += nt)
      end[((size_t)u * T + t) * P + p] = pcn[end_lane[p]];
    float* swap = pcp;
    pcp = pcn;
    pcn = swap;
  }
}

__global__ void __launch_bounds__(viterbi_cluster::MAX_THREADS, 1)
cube_viterbi_cluster_kernel(const float* __restrict__ lp,
                            const int* __restrict__ lengths,
                            const int* __restrict__ order,
                            const int* __restrict__ rec,
                            const float* __restrict__ lm,
                            const float* __restrict__ p0,
                            const int* __restrict__ tri_base,
                            const int* __restrict__ end_lane,
                            int* __restrict__ packed,
                            float* __restrict__ end, int T, int S, int P,
                            int PS, int B, int a_coef, float pip, float beam,
                            int use_beam) {
  const viterbi_cluster::Cube pol{lm, tri_base, end_lane, P, a_coef};
  viterbi_cluster::decode<viterbi_cluster::Cube, 0>(
      pol, lp, lengths, order, rec, p0, packed, end, T, S, P, PS, B, pip,
      beam, use_beam);
}

}  // namespace

// The device-memory route. One block per utterance. pp/tt are (U, 3,
// PS, B) scratch the kernel initialises; packed (U, T, B) and end (U, T,
// P) rows t < lengths[u] are written. Returns the cudaError_t of the
// launch.
extern "C" int cube_viterbi_forward(
    const void* lp, const void* lengths, const void* pdf, const void* tps,
    const void* lm, const void* p0, const void* tri_base,
    const void* end_lane, void* pp, void* tt, void* packed, void* end,
    int U, int T, int S, int P, int PS, int B, int a_coef, float pip,
    float beam, int use_beam, void* stream) {
  if (U == 0 || T == 0) return 0;
  const int threads = THREADS;
  const size_t smem = ((size_t)2 * B + S + threads / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cube_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cube_viterbi_kernel<<<U, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int*>(lengths),
      static_cast<const int*>(pdf), static_cast<const float*>(tps),
      static_cast<const float*>(lm), static_cast<const float*>(p0),
      static_cast<const int*>(tri_base), static_cast<const int*>(end_lane),
      static_cast<float*>(pp), static_cast<int*>(tt),
      static_cast<int*>(packed), static_cast<float*>(end), T, S, P, PS, B,
      a_coef, pip, beam, use_beam);
  return (int)cudaGetLastError();
}

// The cluster route: U clusters of c blocks; cluster i decodes utterance
// order[i]. rec (8 PS B,) int32 are the cells' records in the order of
// viterbi_cluster.cuh; packed (U, T, B) and end (U, T, P) rows t <
// lengths[u] are written; no scratch. Returns the cudaError_t of the
// layout check, the co-residency query or the launch.
extern "C" int cube_viterbi_cluster(
    const void* lp, const void* lengths, const void* order, const void* rec,
    const void* lm, const void* p0, const void* tri_base,
    const void* end_lane, void* packed, void* end, int U, int T, int S,
    int P, int PS, int B, int a_coef, float pip, float beam, int use_beam,
    int c, void* stream) {
  if (U == 0 || T == 0) return 0;
  return viterbi_cluster::launch(
      cube_viterbi_cluster_kernel, U, PS, B, S, c, 0, stream,
      static_cast<const float*>(lp), static_cast<const int*>(lengths),
      static_cast<const int*>(order), static_cast<const int*>(rec),
      static_cast<const float*>(lm), static_cast<const float*>(p0),
      static_cast<const int*>(tri_base), static_cast<const int*>(end_lane),
      static_cast<int*>(packed), static_cast<float*>(end), T, S, P, PS, B,
      a_coef, pip, beam, use_beam);
}

// How many clusters of c blocks the card holds at once for this geometry.
extern "C" int cube_viterbi_cluster_capacity(int PS, int B, int S, int c,
                                             int* out) {
  return viterbi_cluster::capacity(cube_viterbi_cluster_kernel, PS, B, S, c,
                                   0, out);
}
