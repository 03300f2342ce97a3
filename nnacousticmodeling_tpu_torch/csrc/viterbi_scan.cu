// The scan twins' forward as one kernel a decode, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX decoder's scan twins are lax.scans
// that XLA compiles into one program under jax.jit(jax.vmap(
// _decode_device)) (nnacousticmodeling_tpu/decoder/viterbi.py
// _forward_scan_cube :370-445, _forward_scan :447-500). Run as T frames of
// ~40 eager PyTorch operations each over (U, P, P, P) tensors, the port's
// loops took ~745 ms of device time for 128 utterances of 512 frames on
// the 48-phone image; this kernel is one launch for all of them.
//
// For each utterance u and each frame k < T, bit for bit what
// decoder/viterbi.py's general twin computes (the cube twin gives the same
// bits on a dense cube):
//  * p_in = p[biphone_in] + pip, where p is the previous frame's export
//    (p0 at k = 0) and, with a beam, values below the previous frame's
//    threshold read as NEG_INF;
//  * per triphone and state s: stay = pp[s] + tp_self[s], go = p_in (s=0)
//    or pp[s-1] + tp_trans[s-1], take = go > stay (strict: NaN stays),
//    pp[s] = (take ? go : stay) + lp[u, k, pdf[s]], tt[s] = take ? (k-1
//    for s=0, else tt[s-1]) : tt[s]; every add a separate float32 add;
//  * per biphone b: the first max of out = pp[2] + tp_trans[2] over its
//    fan-in slots in CSR order, a NaN beating every number (jnp.argmax);
//    padding slots score NEG_INF with id -1, so a row with padding whose
//    valid slots all score below NEG_INF exports mx = NEG_INF, tri = -1
//    and the last triphone's new tt[2] (JAX indexes -1 from the end), and
//    an empty row exports NEG_INF, tri = 0 and triphone 0's new tt[2];
//    packed[u, k, b] = tri * pack + tt[2] + 1; p_new[b] = mx + lm[b];
//  * with a beam: thr = (max over b of p_new, NaN propagating) - beam, and
//    p_new[b] >= thr ? p_new[b] : NEG_INF is the export;
//  * end[u, k, i] = the export at end_idxs[i].
//
// Layout and bound. One block an utterance loops over the T frames; its
// threads own biphones (b = tid + i * blockDim), and a biphone's triphones
// are its fan-in slots, so no thread reads another's DP state. The DP
// state is 24 bytes a slot (pp 0-2 and tt 0 as one 16-byte word, tt 1-2 as
// an 8-byte word) in a slot-major (F, B) scratch, read and written once a
// frame with streaming hints; the tables (40 bytes a slot, shared by all
// utterances, 4.4 MB at P = 48) stay in L2. The frame's posterior row and
// the score row p sit in shared memory, both double-buffered: the next
// posterior row arrives by cp.async during the frame, and a frame needs
// one __syncthreads, after which the beam threshold (one row of warp
// maxima), the rows that export through padding or are empty (with the
// entry time of the last triphone or of triphone 0, which their owners
// publish) and the end scores are finished. Bound: the
// state's 48 bytes a slot a frame from device memory, ~104 ms for U = 128,
// T = 512 at P = 48 on 3.35 TB/s (680 MB a frame).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e20f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_BPT = 32;            // biphones a thread: one mask bit each
constexpr size_t SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// max that propagates NaN, as torch.amax and jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <bool BEAM>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_scan_kernel(const float* __restrict__ lp,      // (U, T, S)
                    const int4* __restrict__ idx,      // (F, B)
                    const float4* __restrict__ tpa,    // (F, B)
                    const float2* __restrict__ tpb,    // (F, B)
                    const int* __restrict__ fan,       // (F, B)
                    const int* __restrict__ count,     // (B,)
                    const float* __restrict__ lm,      // (B,)
                    const float* __restrict__ p0,      // (B,)
                    const int* __restrict__ end_idxs,  // (P,)
                    int4* __restrict__ st_a,           // (U, F, B)
                    int2* __restrict__ st_b,           // (U, F, B)
                    int* __restrict__ packed,          // (U, T, B)
                    float* __restrict__ end,           // (U, T, P)
                    int T, int S, int B, int F, int P, int zero_slot,
                    int last_slot, int pack, int bpt, float pip,
                    float beam) {
  extern __shared__ __align__(16) float smem[];
  float* s_obs = smem;                       // 2 x S
  float* s_p = s_obs + 2 * S;                // 2 x B
  float* s_red = s_p + 2 * B;                // 2 x 32
  int* s_pub = reinterpret_cast<int*>(s_red + 64);  // 2 x (tri 0, last)

  const int u = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const size_t FB = (size_t)F * B;
  const float* lpu = lp + (size_t)u * T * S;
  int4* sa = st_a + (size_t)u * FB;
  int2* sb = st_b + (size_t)u * FB;
  int* pku = packed + (size_t)u * T * B;
  float* endu = end + (size_t)u * T * P;

  for (int i = tid; i < S; i += nth) s_obs[i] = __ldg(lpu + i);
  for (int b = tid; b < B; b += nth) s_p[b] = __ldg(p0 + b);
  __syncthreads();

  float thr = 0.0f;
  bool use_thr = false;                      // p0 is never clamped
  for (int k = 0; k < T; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    if (k + 1 < T) {
      const float* row = lpu + (size_t)(k + 1) * S;
      float* dst = s_obs + nxt * S;
      for (int i = tid; i < S; i += nth) cp_async4(dst + i, row + i);
      cp_async_commit();
    }
    const float* obs = s_obs + cur * S;
    const float* pc = s_p + cur * B;
    float* pn = s_p + nxt * B;
    float local = -INFINITY;
    unsigned padded = 0, empty = 0;          // biphones exporting -1, 0
    for (int i = 0; i < bpt; ++i) {
      const int b = tid + i * nth;
      if (b >= B) break;
      const int cnt = __ldg(count + b);
      float best = 0.0f;
      int col = 0, bt = 0;
#pragma unroll 2
      for (int j = 0; j < cnt; ++j) {
        const int e = j * B + b;
        const int4 ix = __ldg(idx + e);
        const float4 ta = __ldg(tpa + e);
        const float2 tb = __ldg(tpb + e);
        float q0 = NEG_INF, q1 = NEG_INF, q2 = NEG_INF;
        int t0 = 0, t1 = 0, t2 = 0;
        if (k > 0) {
          const int4 a = __ldcs(sa + e);
          const int2 c = __ldcs(sb + e);
          q0 = __int_as_float(a.x);
          q1 = __int_as_float(a.y);
          q2 = __int_as_float(a.z);
          t0 = a.w;
          t1 = c.x;
          t2 = c.y;
        }
        float pin = pc[ix.w];
        if (BEAM && use_thr && !(pin >= thr)) pin = NEG_INF;
        pin = __fadd_rn(pin, pip);

        float stay = __fadd_rn(q2, ta.z);
        float go = __fadd_rn(q1, tb.x);
        bool take = go > stay;
        const float n2 = __fadd_rn(take ? go : stay, obs[ix.z]);
        const int u2 = take ? t1 : t2;

        stay = __fadd_rn(q1, ta.y);
        go = __fadd_rn(q0, ta.w);
        take = go > stay;
        const float n1 = __fadd_rn(take ? go : stay, obs[ix.y]);
        const int u1 = take ? t0 : t1;

        stay = __fadd_rn(q0, ta.x);
        take = pin > stay;
        const float n0 = __fadd_rn(take ? pin : stay, obs[ix.x]);
        const int u0 = take ? k - 1 : t0;

        __stcs(sa + e, make_int4(__float_as_int(n0), __float_as_int(n1),
                                 __float_as_int(n2), u0));
        __stcs(sb + e, make_int2(u1, u2));
        if (e == zero_slot) s_pub[2 * cur] = u2;
        if (e == last_slot) s_pub[2 * cur + 1] = u2;

        const float out = __fadd_rn(n2, tb.y);
        // first max in slot order; the first NaN beats every number
        if (j == 0 || (out != out ? best == best : out > best)) {
          best = out;
          col = j;
          bt = u2;
        }
      }
      float mx = best;
      if (cnt == 0) {
        mx = NEG_INF;
        empty |= 1u << i;
      } else if (cnt < F && best == best && best < NEG_INF) {
        mx = NEG_INF;                        // a padding slot wins
        padded |= 1u << i;
      } else {
        __stcs(pku + (size_t)k * B + b,
               __ldg(fan + col * B + b) * pack + bt + 1);
      }
      const float v = __fadd_rn(mx, __ldg(lm + b));
      pn[b] = v;
      if (BEAM) local = nan_max(local, v);
    }
    if (BEAM) {
      for (int off = 16; off > 0; off >>= 1)
        local = nan_max(local, __shfl_xor_sync(0xffffffffu, local, off));
      if (lane == 0) s_red[cur * 32 + warp] = local;
    }
    if (k + 1 < T) cp_async_wait_all();
    __syncthreads();

    if (BEAM) {
      float m = s_red[cur * 32];
      for (int w = 1; w < nwarps; ++w) m = nan_max(m, s_red[cur * 32 + w]);
      thr = __fsub_rn(m, beam);
      use_thr = true;
    }
    for (int i = 0; padded | empty; ++i, padded >>= 1, empty >>= 1) {
      if (padded & 1u)
        __stcs(pku + (size_t)k * B + tid + i * nth,
               s_pub[2 * cur + 1] + 1 - pack);
      else if (empty & 1u)
        __stcs(pku + (size_t)k * B + tid + i * nth, s_pub[2 * cur] + 1);
    }
    for (int i = tid; i < P; i += nth) {
      float v = pn[__ldg(end_idxs + i)];
      if (BEAM && !(v >= thr)) v = NEG_INF;
      endu[(size_t)k * P + i] = v;
    }
  }
}

template <bool BEAM>
int launch(const void* lp, const void* idx, const void* tpa, const void* tpb,
           const void* fan, const void* count, const void* lm, const void* p0,
           const void* end_idxs, void* st_a, void* st_b, void* packed,
           void* end, int U, int T, int S, int B, int F, int P,
           int zero_slot, int last_slot, int pack, int threads, int bpt,
           float pip, float beam, cudaStream_t stream) {
  auto kern = viterbi_scan_kernel<BEAM>;
  const size_t smem = 4 * (2 * (size_t)S + 2 * (size_t)B + 64 + 4);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<U, threads, smem, stream>>>(
      static_cast<const float*>(lp), static_cast<const int4*>(idx),
      static_cast<const float4*>(tpa), static_cast<const float2*>(tpb),
      static_cast<const int*>(fan), static_cast<const int*>(count),
      static_cast<const float*>(lm), static_cast<const float*>(p0),
      static_cast<const int*>(end_idxs), static_cast<int4*>(st_a),
      static_cast<int2*>(st_b), static_cast<int*>(packed),
      static_cast<float*>(end), T, S, B, F, P, zero_slot, last_slot, pack,
      bpt, pip, beam);
  return (int)cudaGetLastError();
}

}  // namespace

// lp (U, T, S) float32; the tables of decoder/viterbi_scan.py::ScanTables
// (idx (F, B, 4) int32, tpa (F, B, 4) and tpb (F, B, 2) float32, fan (F,
// B) int32, count (B,) int32, lm and p0 (B,) float32, end_idxs (P,)
// int32); st_a (U, F, B, 4) and st_b (U, F, B, 2) int32 scratch, written
// before it is read; packed (U, T, B) int32 and end (U, T, P) float32
// written whole. zero_slot / last_slot = j * B + b of the slots of
// triphone 0 and of the last triphone; a block of `threads` (whole warps,
// at most 1024) whose threads own `bpt` (at most 32) biphones each,
// threads * bpt >= B (viterbi_scan.py::launch_shape); pack > T
// with num_triphones * pack < 2**31 (the wrapper checks). Returns the
// cudaError_t of the launch.
extern "C" int viterbi_scan_forward(const void* lp, const void* idx,
                                    const void* tpa, const void* tpb,
                                    const void* fan, const void* count,
                                    const void* lm, const void* p0,
                                    const void* end_idxs, void* st_a,
                                    void* st_b, void* packed, void* end,
                                    int U, int T, int S, int B, int F, int P,
                                    int zero_slot, int last_slot, int pack,
                                    int threads, int bpt, float pip,
                                    float beam, int has_beam, void* stream) {
  if (U == 0 || T == 0) return 0;
  if (U < 0 || T < 0 || S <= 0 || B <= 0 || F <= 0 || P <= 0 ||
      zero_slot < 0 || (size_t)zero_slot >= (size_t)F * B ||
      last_slot < 0 || (size_t)last_slot >= (size_t)F * B || pack <= T ||
      threads <= 0 || threads > MAX_THREADS || threads % 32 != 0 ||
      bpt <= 0 || bpt > MAX_BPT || (size_t)threads * bpt < (size_t)B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCAN_ARGS                                                         \
  lp, idx, tpa, tpb, fan, count, lm, p0, end_idxs, st_a, st_b, packed, end, \
      U, T, S, B, F, P, zero_slot, last_slot, pack, threads, bpt, pip, beam, \
      s
  return has_beam ? launch<true>(SCAN_ARGS) : launch<false>(SCAN_ARGS);
#undef SCAN_ARGS
}
