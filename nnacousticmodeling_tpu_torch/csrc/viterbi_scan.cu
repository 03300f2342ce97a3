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
// Two routes, chosen by the host's scan_cluster_plan (decoder/
// viterbi_scan.py) from the image's shape, never as a fallback.
//
// The device-memory route (viterbi_scan_forward, the first kernel). One
// block an utterance loops over the T frames; its threads own biphones
// (b = tid + i * blockDim), and a biphone's triphones are its fan-in
// slots, so no thread reads another's DP state. The DP state is 24 bytes
// a slot (pp 0-2 and tt 0 as one 16-byte word, tt 1-2 as an 8-byte word)
// in a slot-major (F, B) scratch, read and written once a frame with
// streaming hints; the tables (40 bytes a slot, shared by all utterances,
// 4.4 MB at P = 48) stay in L2. The frame's posterior row and the score
// row p sit in shared memory, both double-buffered: the next posterior
// row arrives by cp.async during the frame, and a frame needs one
// __syncthreads, after which the beam threshold (one row of warp maxima),
// the rows that export through padding or are empty (with the entry time
// of the last triphone or of triphone 0, which their owners publish) and
// the end scores are finished. Bound: the state's 48 bytes a slot a frame
// from device memory, ~104 ms for U = 128, T = 512 at P = 48 on 3.35 TB/s
// (680 MB a frame).
//
// The cluster route (viterbi_scan_cluster), which takes that state off
// device memory, as viterbi_cluster.cuh does for the collapsed and cube
// kernels: one thread-block cluster of c blocks an utterance keeps the
// utterance's DP state (2.65 MB at P = 48) in its blocks' shared memory
// for all T frames.
//  * Ownership. Block r owns the biphones [r W, (r + 1) W), W = B / c
//    rounded up to 8, with all F fan-in slots of each, and keeps their
//    state (an int2 (score, entry time) a state, 24 bytes a slot: 166 KB
//    at P = 48, c = 16) beside two full score rows (18.4 KB), two
//    posterior rows (15.3 KB) and its publish slots.
//  * Threads. 144 biphones a block would give one thread a biphone 4.5
//    warps an SM, so a warp owns 8 biphones (a chunk) and each biphone's
//    slots are split over 4 threads: thread (g, jj) takes the slots j =
//    4 i + g of biphone 8 k + jj, so a slot has one owner in both passes
//    and no thread reads another's state. A butterfly over the four
//    threads gives the first max in slot order: the first NaN beats every
//    number, else the greater value, on equal values the smaller slot.
//    Each thread's walk gives its own first max (the first NaN sticks),
//    and that order is total, so the butterfly returns the twins' slot.
//  * Records. A slot's tables come as 32 bytes (viterbi_collapsed.py::
//    cluster_records in the (step, chunk, thread) order of the warp's
//    reads): self-loops 1-2 and transitions 0-1 (an int4), transition 2
//    with the pdf ids of states 1-2 (an int2), self-loop 0 with the pdf
//    id of state 0 and the in-biphone (an int2), ids in 16 bits (the
//    plan takes the device-memory route where they do not fit).
//  * One cluster barrier a frame, around half the frame's work. Frame
//    k's export needs only frame k-1's states 1-2, so pass 1 updates
//    states 2 and 1 and the export, writes the block's slice of row k
//    into its own copy of the row, its row max and (from the owners of
//    triphone 0 and of the last triphone) those new entry times into
//    slot k % 2, and arrives (release). Pass 2 updates state 0 from the
//    block's full copy of row k-1. After the wait (acquire) each block
//    gathers the peers' slices of row k through distributed shared
//    memory, takes the threshold from the peers' row maxima, fetches
//    the two entry times, and finishes its padding and
//    empty exports and its share of the end row. A peer overwrites slot
//    k % 2 at frame k + 2, after barrier k + 1, which this block reaches
//    only after its reads of frame k; a last barrier keeps every block
//    resident until its peers' last reads are done.
//  * The beam's row max: a block's warps fold their values into one
//    shared word by atomicMax of order-preserving keys, NaN the largest
//    (viterbi_cluster.cuh max_key), and a peer reads that one word.
// What bounds the cluster route: with the state on chip, a slot still
// reads its 32 bytes of records from L2 every frame (3.5 MB an
// utterance-frame at P = 48, shared by every cluster) beside its state's
// shared-memory traffic and the gathers of posteriors and entry scores;
// 16-block clusters co-reside 7 at a time (20 of 132 SMs idle).

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "viterbi_cluster.cuh"

namespace {

namespace vcl = viterbi_cluster;
namespace cg = cooperative_groups;
using vcl::cp_async4;
using vcl::cp_async_commit;
using vcl::cp_async_wait_all;
using vcl::key_value;
using vcl::max_key;
using vcl::nan_max;

constexpr float NEG_INF = -1e20f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_BPT = 32;            // biphones a thread: one mask bit each
constexpr size_t SMEM_DEFAULT = 48 * 1024;

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


// ---- the cluster route ----------------------------------------------------

constexpr int CHUNK = 8;               // biphones a warp
constexpr int SLOT_GROUPS = 4;         // threads a biphone (32 / CHUNK)
constexpr int MAX_CHUNKS_A_WARP = 32;  // one mask bit each

// The block's layout, mirrored by scan_cluster_plan (decoder/
// viterbi_scan.py): W biphones a block, 32 threads a chunk of 8.
__host__ __device__ inline int slice_of(int B, int c) {
  return ((B + c - 1) / c + CHUNK - 1) / CHUNK * CHUNK;
}
inline int cluster_threads(int B, int c) {
  return vcl::threads_of(slice_of(B, c));
}
inline size_t cluster_smem(int F, int B, int S, int c) {
  const int w = slice_of(B, c);
  return (size_t)3 * vcl::round4(F) * w * 8   // state: (score, entry time)
         + (size_t)2 * c * w * 4              // score rows (2)
         + (size_t)2 * vcl::round4(S) * 4     // posterior rows (2)
         + 16 * 4;              // entry times, row maxima, thresholds
}
// 0 if c blocks can decode this geometry on the cluster route.
inline int cluster_layout(int F, int B, int S, int c) {
  if (c < 1 || c > vcl::MAX_CLUSTER || F <= 0 || B <= 0 || S <= 0 ||
      S > (1 << 16) || B > (1 << 15) ||
      slice_of(B, c) / CHUNK >
          MAX_CHUNKS_A_WARP * (cluster_threads(B, c) / 32) ||
      cluster_smem(F, B, S, c) > vcl::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool BEAM>
__global__ void __launch_bounds__(vcl::MAX_THREADS, 1)
viterbi_scan_cluster_kernel(const float* __restrict__ lp,      // (U, T, S)
                            const int* __restrict__ rec,       // records
                            const int* __restrict__ fan,       // (F, B)
                            const int* __restrict__ count,     // (B,)
                            const float* __restrict__ lm,      // (B,)
                            const float* __restrict__ p0,      // (B,)
                            const int* __restrict__ end_idxs,  // (P,)
                            int* __restrict__ packed,          // (U, T, B)
                            float* __restrict__ end,           // (U, T, P)
                            int T, int S, int B, int F, int P,
                            int zero_slot, int last_slot, int pack,
                            float pip, float beam) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int W = slice_of(B, c);
  const int RW = c * W;                     // a score row, padded
  const int steps = vcl::round4(F) / SLOT_GROUPS;
  const int nchunks = W / CHUNK;            // chunks of this block
  const int nkb = (B + CHUNK - 1) / CHUNK;  // chunks of the records
  const int k0 = rank * nchunks;            // this block's first chunk
  const int plane = steps * nchunks * 32;   // slots of one state here
  const int S4 = vcl::round4(S);
  const size_t n = (size_t)steps * SLOT_GROUPS * nkb * CHUNK;
  const int4* __restrict__ rec12 = reinterpret_cast<const int4*>(rec);
  const int2* __restrict__ rec3 = reinterpret_cast<const int2*>(rec + 4 * n);
  const int2* __restrict__ rec0 = reinterpret_cast<const int2*>(rec + 6 * n);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* st = reinterpret_cast<int2*>(smem_raw);               // (3, plane)
  float* rows = reinterpret_cast<float*>(st + 3 * plane);     // (2, RW)
  float* lps = rows + 2 * RW;                                 // (2, S4)
  int* pub = reinterpret_cast<int*>(lps + 2 * S4);            // 2 x 2
  int* got = pub + 4;                                         // 2 x 2
  int* row_max = got + 4;                                     // 2 (keys)
  float* thr_s = reinterpret_cast<float*>(row_max + 2);       // 2

  const int u = blockIdx.x / c;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int g = lane / CHUNK, jj = lane % CHUNK;
  const float* lpu = lp + (size_t)u * T * S;
  int* pku = packed + (size_t)u * T * B;
  float* endu = end + (size_t)u * T * P;
  const int z_rank = (zero_slot % B) / W, l_rank = (last_slot % B) / W;

  const int2 init = make_int2(__float_as_int(NEG_INF), 0);
  for (int e = tid; e < 3 * plane; e += nt) st[e] = init;
  for (int b = tid; b < B; b += nt) rows[RW + b] = __ldg(p0 + b);
  for (int i = tid; i < S; i += nt) lps[i] = __ldg(lpu + i);
  if (tid < 2) row_max[tid] = INT_MIN;
  __syncthreads();

  float thr = 0.0f;
  bool use_thr = false;                      // p0 is never clamped
  for (int k = 0; k < T; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    if (k + 1 < T) {
      const float* row = lpu + (size_t)(k + 1) * S;
      float* dst = lps + nxt * S4;
      for (int i = tid; i < S; i += nt) cp_async4(dst + i, row + i);
    }
    cp_async_commit();
    const float* obs = lps + cur * S4;
    const float* pc = rows + nxt * RW;       // row k-1 (p0 at k = 0)
    float* pn = rows + cur * RW;             // row k
    int local = INT_MIN;                     // the beam's max key
    unsigned padded = 0, empty = 0;          // chunks exporting -1, 0

    // ---- pass 1: states 2 and 1, the export of frame k ----
    for (int kc = warp, m = 0; kc < nchunks; kc += nwarps, ++m) {
      const int b = (k0 + kc) * CHUNK + jj;
      const int cnt = b < B ? __ldg(count + b) : 0;
      const int ni = cnt > g ? (cnt - g + SLOT_GROUPS - 1) / SLOT_GROUPS : 0;
      float best = -INFINITY;                // no slot: loses every tie
      int col = F, bt = 0;
      // a trip count, not a break, so the unrolled steps' record loads
      // issue together
#pragma unroll 4
      for (int i = 0; i < ni; ++i) {
        const int j = i * SLOT_GROUPS + g;
        const int e = ((i * nkb + k0 + kc) << 5) + lane;
        const int si = ((i * nchunks + kc) << 5) + lane;
        const int4 r = __ldg(rec12 + e);
        const int2 r3 = __ldg(rec3 + e);
        const int2 c0 = st[si], c1 = st[plane + si], c2 = st[2 * plane + si];
        const float q0 = __int_as_float(c0.x);
        const float q1 = __int_as_float(c1.x);
        const float q2 = __int_as_float(c2.x);

        float stay = __fadd_rn(q2, __int_as_float(r.y));
        float go = __fadd_rn(q1, __int_as_float(r.w));
        bool take = go > stay;
        const float n2 =
            __fadd_rn(take ? go : stay, obs[(unsigned)r3.y >> 16]);
        const int u2 = take ? c1.y : c2.y;

        stay = __fadd_rn(q1, __int_as_float(r.x));
        go = __fadd_rn(q0, __int_as_float(r.z));
        take = go > stay;
        const float n1 = __fadd_rn(take ? go : stay, obs[r3.y & 0xffff]);
        const int u1 = take ? c0.y : c1.y;

        st[plane + si] = make_int2(__float_as_int(n1), u1);
        st[2 * plane + si] = make_int2(__float_as_int(n2), u2);
        const int slot = j * B + b;
        if (slot == zero_slot) pub[2 * cur] = u2;
        if (slot == last_slot) pub[2 * cur + 1] = u2;

        const float out = __fadd_rn(n2, __int_as_float(r3.x));
        if (i == 0 || vcl::first_max_takes(out, best)) {
          best = out;
          col = j;
          bt = u2;
        }
      }
#pragma unroll
      for (int off = CHUNK; off < 32; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oc = __shfl_xor_sync(0xffffffffu, col, off);
        const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
        if (vcl::partner_wins(ob, oc, best, col)) {
          best = ob;
          col = oc;
          bt = ot;
        }
      }
      if (g == 0 && b < B) {
        const float lmb = __ldg(lm + b);   // issued before the stores
        float mx = best;
        if (cnt == 0) {
          mx = NEG_INF;
          empty |= 1u << m;
        } else if (cnt < F && best == best && best < NEG_INF) {
          mx = NEG_INF;                      // a padding slot wins
          padded |= 1u << m;
        } else {
          pku[(size_t)k * B + b] = __ldg(fan + col * B + b) * pack + bt + 1;
        }
        const float v = __fadd_rn(mx, lmb);
        pn[b] = v;
        if (BEAM) local = max(local, max_key(v));
      }
    }
    if (BEAM) {
      local = __reduce_max_sync(0xffffffffu, local);
      if (lane == 0) atomicMax(row_max + cur, local);
    }
    vcl::cluster_arrive();     // row k's slice, its max, entry times out

    // ---- pass 2: state 0, entering from row k-1 ----
    for (int kc = warp; kc < nchunks; kc += nwarps) {
      const int b = (k0 + kc) * CHUNK + jj;
      const int cnt = b < B ? __ldg(count + b) : 0;
      const int ni = cnt > g ? (cnt - g + SLOT_GROUPS - 1) / SLOT_GROUPS : 0;
#pragma unroll 4
      for (int i = 0; i < ni; ++i) {
        const int e = ((i * nkb + k0 + kc) << 5) + lane;
        const int si = ((i * nchunks + kc) << 5) + lane;
        const int2 r = __ldg(rec0 + e);
        const int2 c0 = st[si];
        float pin = pc[r.y >> 16];
        if (BEAM && use_thr && !(pin >= thr)) pin = NEG_INF;
        pin = __fadd_rn(pin, pip);
        const float stay = __fadd_rn(__int_as_float(c0.x),
                                     __int_as_float(r.x));
        const bool take = pin > stay;
        const float n0 = __fadd_rn(take ? pin : stay, obs[r.y & 0xffff]);
        st[si] = make_int2(__float_as_int(n0), take ? k - 1 : c0.y);
      }
    }
    vcl::cluster_wait();

    // ---- the exchange: row k, its threshold, the two entry times ----
    for (int e = 4 * tid; e < RW; e += 4 * nt) {
      const int r = e / W;
      if (r == rank) continue;
      *reinterpret_cast<float4*>(pn + e) =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(pn + e,
                                                                   r));
    }
    if (tid == 0) {
      got[2 * cur] = *cluster.map_shared_rank(pub + 2 * cur, z_rank);
      got[2 * cur + 1] = *cluster.map_shared_rank(pub + 2 * cur + 1, l_rank);
      row_max[nxt] = INT_MIN;  // frame k+1's: the peers read k-1's by now
    }
    if (BEAM && warp == nwarps - 1) {
      // lane r < c reads block r's row max: one remote load a block
      const int mk = __reduce_max_sync(
          0xffffffffu,
          lane < c ? *cluster.map_shared_rank(row_max + cur, lane) : INT_MIN);
      if (lane == 0) thr_s[cur] = __fsub_rn(key_value(mk), beam);
    }
    cp_async_wait_all();
    __syncthreads();           // row k, its threshold, posterior row k+1

    if (BEAM) {
      thr = thr_s[cur];
      use_thr = true;
    }
    for (int m = 0; padded | empty; ++m, padded >>= 1, empty >>= 1) {
      const int b = (k0 + warp + m * nwarps) * CHUNK + jj;
      if (padded & 1u)
        pku[(size_t)k * B + b] = got[2 * cur + 1] + 1 - pack;
      else if (empty & 1u)
        pku[(size_t)k * B + b] = got[2 * cur] + 1;
    }
    for (int i = rank * nt + tid; i < P; i += c * nt) {
      float v = pn[__ldg(end_idxs + i)];
      if (BEAM && !(v >= thr)) v = NEG_INF;
      endu[(size_t)k * P + i] = v;
    }
  }
  vcl::cluster_arrive();       // no block leaves while a peer reads it
  vcl::cluster_wait();
}

template <bool BEAM>
int cluster_launch(const void* lp, const void* rec, const void* fan,
                   const void* count, const void* lm, const void* p0,
                   const void* end_idxs, void* packed, void* end, int U,
                   int T, int S, int B, int F, int P, int zero_slot,
                   int last_slot, int pack, int c, float pip, float beam,
                   cudaStream_t stream) {
  auto kern = viterbi_scan_cluster_kernel<BEAM>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int err = (int)vcl::configure(kern, U, c, cluster_threads(B, c),
                                cluster_smem(F, B, S, c), stream, &attr,
                                &cfg);
  if (err) return err;
  int active = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err) return err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  err = (int)cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(lp), static_cast<const int*>(rec),
      static_cast<const int*>(fan), static_cast<const int*>(count),
      static_cast<const float*>(lm), static_cast<const float*>(p0),
      static_cast<const int*>(end_idxs), static_cast<int*>(packed),
      static_cast<float*>(end), T, S, B, F, P, zero_slot, last_slot, pack,
      pip, beam);
  if (err) return err;
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

// The cluster route: U clusters of c blocks, cluster u decoding utterance
// u. rec (8 n,) int32, n = round4(F) * round8(B): the slots' records of
// decoder/viterbi_scan.py::scan_records; fan, count, lm, p0, end_idxs,
// zero_slot, last_slot, pack as viterbi_scan_forward; packed (U, T, B)
// and end (U, T, P) written whole; no scratch. Returns the cudaError_t of
// the layout check, the co-residency query (at least one cluster must
// fit) or the launch.
extern "C" int viterbi_scan_cluster(const void* lp, const void* rec,
                                    const void* fan, const void* count,
                                    const void* lm, const void* p0,
                                    const void* end_idxs, void* packed,
                                    void* end, int U, int T, int S, int B,
                                    int F, int P, int zero_slot,
                                    int last_slot, int pack, int c,
                                    float pip, float beam, int has_beam,
                                    void* stream) {
  if (U == 0 || T == 0) return 0;
  if (U < 0 || T < 0 || P <= 0 || zero_slot < 0 ||
      (size_t)zero_slot >= (size_t)F * B || last_slot < 0 ||
      (size_t)last_slot >= (size_t)F * B || pack <= T)
    return (int)cudaErrorInvalidValue;
  const int err = cluster_layout(F, B, S, c);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLUSTER_ARGS                                                      \
  lp, rec, fan, count, lm, p0, end_idxs, packed, end, U, T, S, B, F, P,   \
      zero_slot, last_slot, pack, c, pip, beam, s
  return has_beam ? cluster_launch<true>(CLUSTER_ARGS)
                  : cluster_launch<false>(CLUSTER_ARGS);
#undef CLUSTER_ARGS
}

// How many clusters of c blocks the card holds at once for this geometry
// (into *out).
extern "C" int viterbi_scan_cluster_capacity(int F, int B, int S, int c,
                                             int* out) {
  int err = cluster_layout(F, B, S, c);
  if (err) return err;
  auto kern = viterbi_scan_cluster_kernel<false>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = (int)vcl::configure(kern, 1, c, cluster_threads(B, c),
                            cluster_smem(F, B, S, c), nullptr, &attr, &cfg);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}
