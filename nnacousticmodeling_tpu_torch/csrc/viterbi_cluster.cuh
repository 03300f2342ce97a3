// The cluster route of the two triphone Viterbi forwards (collapsed and
// dense-cube), for Hopper (sm_90a): one thread-block cluster decodes one
// utterance, and the utterance's DP state stays on the cluster's SMs for
// all its frames: in its threads' registers (the collapsed kernel's
// register route) or in its blocks' shared memory.
//
// What bounds the device-memory route (viterbi_collapsed.cu,
// viterbi_cube.cu). One block an utterance keeps the DP state -- (3
// states, PS rows, L lanes) scores and entry times, 2.65 MB on the
// synthetic 48-phone 1909-pdf image -- in device memory and reads and
// writes it whole every frame. The TPU kernels kept it in VMEM; one SM's
// 227 KB cannot hold it, but a cluster of 16 SMs can.
//
// The layout. A cluster of c blocks decodes utterance order[cluster]
// (the caller hands the clusters out longest first). Block r owns the
// lane slice [r W, (r + 1) W), W = L / c, for all 3 states and PS rows.
// A warp owns 8 lanes (a chunk) and its four groups of 8 threads the
// rows a = g, g + 4, ...: thread (g, jj) of chunk k handles cell (a =
// 4 i + g, lane 8 k + jj) at row step i. Where a block's slice is at
// most one chunk a warp and the rows are 4 rs for an even rs <= REG_STEPS
// (the collapsed kernel's register route), a thread owns the same cells
// for the whole utterance and keeps their scores and entry times in
// registers, in a kernel built for exactly rs row steps: at 48 rows, 12
// row steps x 3 states, 36 floats and 18 registers of 16-bit entry time
// pairs. Elsewhere they stay in the block's shared memory, one int2 a
// cell, indexed (i, k, thread) so a warp's 32 cells are contiguous. A
// cell's tables come as 32 bytes of records (six f32 transitions, three
// 16-bit pdf ids and, for the collapsed kernel, its 16-bit entry
// source), an int4 and two int2, laid out on the host in the same (i,
// global chunk, thread) order, so each of a warp's record loads reads
// contiguous bytes. A
// butterfly over the four groups picks the first maximum over left
// contexts: the greater value, or on equal values the smaller row. For
// finite values (NEG_INF is -1e20) that is the row and the value bits a
// sequential strict-`>` walk from a = 0 gives. A NaN sticks in a group's
// walk and wins the butterfly, and the beam's maxima propagate it, as
// the TPU kernels' jnp.max does: no row then matches the column's max,
// so the collapsed key is 2**31 - 1 and the cube export takes row P
// (Pol::nan_key), the bits of their plain versions.
//
// One cluster barrier a frame, split around half the frame's work. The
// export of frame t depends only on frame t-1's states (state 2 reads
// states 1 and 2), so a frame runs in two passes. Pass 1 updates states
// 2 and 1 and the export, writes the block's exported slice and (with a
// beam) its row max (max_key) into its publish slot t % 2, and arrives at
// barrier.cluster (release). Pass 2 updates state 0, whose entry reads
// the exchanged row of frame t-1; then the block waits (acquire), reads
// every peer's slot of frame t through distributed shared memory into
// its own full row pc_t (double-buffered: pass 2 of frame t still read
// pc_(t-1)), takes the frame's beam threshold from the peers' maxima,
// and writes its share of end row t. Double slots make one barrier a
// frame race-free: a peer overwrites slot t % 2 at frame t + 2, after
// barrier t + 1, which this block reaches only after its reads of frame
// t. A last barrier keeps every block resident until its peers' last
// reads are done; every block of a cluster walks the same length, so the
// barrier counts agree, and a zero-length utterance crosses only that
// one. The cube kernel's beam clamps the exported row itself: a select
// applied wherever the row is read.
//
// What bounds this route. Each cell reads its 32 bytes of records (36
// with the collapsed kernel's entry score) from L2 every frame -- 3.5 MB
// an utterance-frame on the synthetic image, shared by every cluster --
// and gathers its posteriors and entry score through the SM's load/store
// pipe; each frame ends with the cluster barrier's wait and a
// distributed-shared-memory gather of the L-float exported row. The
// shared-memory route adds 56 bytes of state traffic a cell a frame
// (three int2 loads and two stores in pass 1, one of each in pass 2),
// which the register route takes off the pipe. On one H100 at the
// 48-phone image (bench_viterbi_cluster.py, which splits a frame with the
// VIT_LEAVE_OUT measurement builds) the collapsed kernel's frame is 5.79
// us a co-resident cluster on the register route against 6.57 on the
// shared-memory route: 2.86 us of on-chip work (the record loads through
// L1, the bank-conflicted gathers), 1.80 of the L2 record stream and 1.07
// of barrier and exchange, against 4.27, 1.39 and 0.96 (each the time a
// build that leaves it out saves; on the register route the two savings
// add up, 2.93 us for both). A 576-thread block gets 96 registers a
// thread (18 warps put 5 on some of the SM's four register-file
// quarters): 54 hold the 12-step kernel's state, so the rest leave room
// for a few steps' record loads in flight, which each step's being free
// of branches lets the compiler issue early.
//
// Float order: each cell's operations are the device-memory route's (one
// IEEE add a step, the observation added after the select, strict `>`),
// with no multiply anywhere to contract; the posterior row of frame t+1
// is staged by cp.async while frame t computes.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// Measurement builds only (bench_viterbi_cluster.py), whose values are
// wrong: 1 reads every row step's records from row step 0 (L1 hits: no
// L2 stream), 2 leaves out the cluster barrier and the exchange of the
// exported row, 3 both. The package builds 0.
#ifndef VIT_LEAVE_OUT
#define VIT_LEAVE_OUT 0
#endif

namespace viterbi_cluster {

namespace cg = cooperative_groups;

constexpr float NEG_INF = -1.0e20f;
constexpr float THR0 = -3.0e38f;
constexpr int LANE_CHUNK = 8;     // lanes a warp
constexpr int ROW_GROUPS = 4;     // row groups a warp (32 / LANE_CHUNK)
constexpr int MAX_WARPS = 18;
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int MAX_CLUSTER = 16;
constexpr size_t SMEM_LIMIT = 232448;
// Row steps a thread keeps in registers on the register route: PS / 4
// exactly, with a kernel built for each even count up to REG_STEPS (the
// collapsed kernel's rows are a multiple of 8), so no step runs past the
// rows. Its entry times (-1 to T - 2) are 16 bits, two cells' a
// register, so it decodes at most REG_FRAMES frames.
constexpr int REG_STEPS = 12;
constexpr int REG_FRAMES = 32767;

// The block's layout, mirrored by viterbi_cluster_plan (decoder/
// viterbi_collapsed.py). rs: the row steps a thread keeps in registers
// (PS / 4 on the register route), 0 with the state in shared memory.
__host__ __device__ inline int threads_of(int w) {
  const int warps = w / LANE_CHUNK;
  return 32 * (warps < MAX_WARPS ? warps : MAX_WARPS);
}
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
inline size_t smem_bytes(int PS, int lanes, int S, int c, int rs) {
  const int w = lanes / c;
  return (rs ? 0 : (size_t)3 * PS * w * 8)    // state: (score, entry time)
         + (size_t)2 * (lanes + PS) * 4       // exported rows pc (2, padded)
         + (size_t)2 * w * 4                  // publish slots
         + 4 * 4                              // row maxima (2, padded)
         + 4 * 4                              // thresholds (2, padded)
         + (size_t)2 * round4(S) * 4;         // posterior rows (2)
}
// 0 if c blocks of lanes / c lanes each can decode this geometry, with
// the state in shared memory (rs = 0) or, one chunk a warp and its rows
// in rs row steps (an even rs up to REG_STEPS), in registers.
inline int check_layout(int PS, int lanes, int S, int c, int rs) {
  if (c < 1 || c > MAX_CLUSTER || lanes % c != 0 || PS % ROW_GROUPS != 0)
    return (int)cudaErrorInvalidValue;
  const int w = lanes / c;
  if (w % LANE_CHUNK != 0 || smem_bytes(PS, lanes, S, c, rs) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (rs && (rs != PS / ROW_GROUPS || rs > REG_STEPS || rs % 2 != 0 ||
             w / LANE_CHUNK > MAX_WARPS))
    return (int)cudaErrorInvalidValue;
  return 0;
}
// 0 if the route of rs row steps in registers decodes T frames.
inline int check_frames(int T, int rs) {
  return rs && T > REG_FRAMES ? (int)cudaErrorInvalidValue : 0;
}

// The register route's entry times: cell i of a thread's row steps in the
// low (even i) or high (odd i) 16 bits of register i / 2, sign-extended.
__device__ __forceinline__ int half_time(int w, int i) {
  return i & 1 ? w >> 16 : (int)(short)(w & 0xffff);
}
__device__ __forceinline__ int with_half_time(int w, int i, int v) {
  return i & 1 ? __byte_perm(w, v, 0x5410) : __byte_perm(w, v, 0x3254);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ float clamp(float x, float thr) {
  return (x >= thr) ? x : NEG_INF;
}

// max that propagates NaN, as torch.amax and jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// A walk's running first max in ascending order takes `out` over `best`:
// the greater value, and the first NaN, which then sticks.
__device__ __forceinline__ bool first_max_takes(float out, float best) {
  return best == best && !(out <= best);
}

// The beam's row max as an int: order-preserving keys of the float bits,
// every NaN the largest key (INT_MAX), so an int max over keys is the
// NaN-propagating max of the values (up to the sign of a zero, which
// max - beam does not see). A block's warps fold their keys into one
// shared word by atomicMax, so a peer makes one remote load a block, not
// one a warp (remote loads are slow). INT_MIN: no value.
__device__ __forceinline__ int max_key(float v) {
  const int i = __float_as_int(v);
  return v != v ? 0x7fffffff : (i >= 0 ? i : i ^ 0x7fffffff);
}
__device__ __forceinline__ float key_value(int k) {
  return k == 0x7fffffff ? __int_as_float(0x7fffffff)
                         : __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// A butterfly partner's (value, index) beats this thread's: the first NaN
// (by index) beats every number; else the greater value, or on equal
// values the smaller index.
__device__ __forceinline__ bool partner_wins(float ob, int oa, float best,
                                             int arg) {
  const bool o_nan = ob != ob, b_num = best == best, first = oa < arg;
  // bitwise, not short-circuit: predicates, no branches
  return (o_nan & (b_num | first)) |
         (!o_nan & b_num & ((ob > best) | ((ob == best) & first)));
}

// The right-context-collapsed kernel's entry, export and end row.
struct Collapsed {
  const float* __restrict__ lmq;     // (n,) entry lm of each cell
  const float* __restrict__ lmmax;   // (L,)
  const float* __restrict__ lmend;   // (Pp,)
  const int* __restrict__ pc0_map;   // (P,)
  int pack;

  static constexpr bool PAD_ROW = false;   // a NaN column's key is fixed

  __device__ int lane_ctx(int) const { return 0; }
  __device__ int pc_slot(int e) const { return e; }
  // ((pc[src] + lm) -> beam clamp) + pip; src < 0: no entry (0.0 + lm)
  __device__ float entry(int, int, int idx, int src, const float* pc,
                         float thr, int use_beam, float pip) const {
    float q = (src >= 0 ? pc[src] : 0.0f) + __ldg(lmq + idx);
    if (use_beam) q = clamp(q, thr);
    return q + pip;
  }
  __device__ float exported(float best, int) const { return best; }
  __device__ float beam_score(float v, int j) const {
    return v + __ldg(lmmax + j);
  }
  __device__ int key(int a, int tt, int) const { return a * pack + tt + 1; }
  // a NaN max: jnp.min over no matching row of the keys
  __device__ int pad_row() const { return -1; }
  __device__ int nan_key(int, int) const { return 0x7fffffff; }
  __device__ float end_score(int p, const float* pc, float thr,
                             int use_beam) const {
    const int jl = __ldg(pc0_map + p);
    const float e = pc[jl] + __ldg(lmend + jl);
    return use_beam ? clamp(e, thr) : e;
  }
};

// The dense-cube kernel's. Its beam clamps the exported row itself: a
// select applied wherever the row is read (the entry, the end row). The
// row is kept with its biphone rows P + 1 apart, so a warp's transposed
// entry reads pc[b*P + a] (8 b's x 4 a's) fall on distinct banks but for
// pairs.
struct Cube {
  const float* __restrict__ lm;        // (B,)
  const int* __restrict__ tri_base;    // (B,)
  const int* __restrict__ end_lane;    // (P,)
  int P, a_coef;
  static constexpr int TIME_PACK = 2048;
  static constexpr bool PAD_ROW = true;    // a NaN column's key reads row P

  __device__ int lane_ctx(int j) const { return (j % P) * (P + 1); }
  __device__ int pc_slot(int e) const { return e + e / P; }
  // q[a, b] = p[b*P + a] (0.0 on pad rows), then + pip
  __device__ float entry(int a, int ctx, int, int, const float* pc,
                         float thr, int use_beam, float pip) const {
    float q = 0.0f;
    if (a < P) q = use_beam ? clamp(pc[ctx + a], thr) : pc[ctx + a];
    return q + pip;
  }
  __device__ float exported(float best, int j) const {
    return best + __ldg(lm + j);
  }
  __device__ float beam_score(float v, int) const { return v; }
  __device__ int key(int a, int tt, int j) const {
    return (a * a_coef + __ldg(tri_base + j)) * TIME_PACK + tt + 1;
  }
  // a NaN max: arg = P, bt = the entry time of pad row P (0 if PS = P)
  __device__ int pad_row() const { return P; }
  __device__ int nan_key(int tt_pad, int j) const { return key(P, tt_pad, j); }
  __device__ float end_score(int p, const float* pc, float thr,
                             int use_beam) const {
    const float e = pc[pc_slot(__ldg(end_lane + p))];
    return use_beam ? clamp(e, thr) : e;
  }
};

// RS: the row steps a thread keeps in registers (the register route; PS
// / ROW_GROUPS, as check_layout requires), or 0 (the state in shared
// memory). The register route's steps are fully unrolled, so each cell's
// state has a register of its own, and carry no branch, so the compiler
// can issue later steps' record loads early.
template <class Pol, int RS>
__device__ __forceinline__ void decode(
    const Pol& pol, const float* __restrict__ lp,   // (U, T, S)
    const int* __restrict__ lengths,                // (U,)
    const int* __restrict__ order,                  // (U,) cluster -> u
    const int* __restrict__ rec,                    // (8 PS L,) records
    const float* __restrict__ p0,                   // (L,)
    int* __restrict__ packed,                       // (U, T, L)
    float* __restrict__ end,                        // (U, T, P)
    int T, int S, int P, int PS, int L, float pip, float beam,
    int use_beam) {
  // The register route serves the collapsed kernel alone: the cube
  // kernel's instantiation spilled at the 96-register ceiling (its pad
  // row's entry time, read by a NaN column's key, among the cost).
  static_assert(RS == 0 || !Pol::PAD_ROW, "no register route with a pad row");
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int W = L / c;
  const int S4 = round4(S);
  const int lane0 = rank * W;
  const int u = order[blockIdx.x / c];
  const int len = min(lengths[u], T);
  const int splane = PS * W;         // cells of one state in this block
  const int pcn = L + PS;            // floats of one (padded) row pc
  const size_t n = (size_t)PS * L;   // cells: records of each kind
  const int4* __restrict__ rec12 = reinterpret_cast<const int4*>(rec);
  const int2* __restrict__ rec3 = reinterpret_cast<const int2*>(rec + 4 * n);
  const int2* __restrict__ rec0 = reinterpret_cast<const int2*>(rec + 6 * n);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* st = reinterpret_cast<int2*>(smem_raw);     // (3, PS W) if RS = 0
  float* pcl = reinterpret_cast<float*>(st + (RS ? 0 : 3 * splane));
                                                    // (2, pcn)
  float* pub = pcl + 2 * pcn;                                  // (2, W)
  int* row_max = reinterpret_cast<int*>(pub + 2 * W);          // 2 (+2)
  float* thr_s = reinterpret_cast<float*>(row_max + 4);        // 2 (+2)
  float* lps = thr_s + 4;                                      // (2, S4)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane / LANE_CHUNK;
  const int jj = lane % LANE_CHUNK;
  const int nchunks = W / LANE_CHUNK;
  const int nk = L / LANE_CHUNK;     // chunks of the whole row
  const int k0 = lane0 / LANE_CHUNK;
  const int steps = PS / ROW_GROUPS;

  // the register route's state: this thread's cells (4 i + g, lane jj of
  // its warp's chunk), score and entry time (half_time) of each state
  float sc[3][RS ? RS : 1];
  int tm[3][RS ? (RS + 1) / 2 : 1];
  if constexpr (RS > 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int i = 0; i < RS; ++i) sc[q][i] = NEG_INF;
#pragma unroll
      for (int i = 0; i < (RS + 1) / 2; ++i) tm[q][i] = 0;
    }
  } else {
    const int2 init = make_int2(__float_as_int(NEG_INF), 0);
    for (int e = tid; e < 3 * splane; e += nt) st[e] = init;
  }
  for (int j = tid; j < L; j += nt) pcl[pcn + pol.pc_slot(j)] = p0[j];
  if (len > 0) {
    const float* lp0 = lp + (size_t)u * T * S;
    for (int k = tid; k < S; k += nt) lps[k] = lp0[k];
  }
  if (tid < 2) row_max[tid] = INT_MIN;
  float thr = THR0;
  __syncthreads();

  // Frame t in two passes. States 1-2 and the export of frame t need
  // only frame t-1's states, so they go first and are published; state
  // 0's entry reads the exchanged row of frame t-1 (pc_prev), so its
  // pass runs between this block's arrival at barrier t and its wait.
  for (int t = 0; t < len; ++t) {
    const int buf = t & 1;
    const float* lpc = lps + buf * S4;
    const float* pc_prev = pcl + (buf ^ 1) * pcn;
    if (t + 1 < len) {
      float* lpn = lps + (buf ^ 1) * S4;
      const float* lpt = lp + ((size_t)u * T + t + 1) * S;
      for (int k = tid; k < S; k += nt) cp_async4(lpn + k, lpt + k);
    }
    cp_async_commit();

    // ---- pass 1: states 2 and 1, the export of frame t ----
    int local = INT_MIN;                      // the beam's max key
    unsigned nan_chunks = 0;   // chunks whose max is NaN (a slice that
                               // fits holds < 32 chunks a warp)
    // on the register route a warp walks its own chunk alone (the slice
    // is one chunk a warp); bounding the loop there shows the compiler
    // one pass, which keeps the 12-step kernel within its 96 registers
    for (int k = warp, m = 0; k < (RS > 0 ? warp + 1 : nchunks);
         k += nwarps, ++m) {
      const int jl = k * LANE_CHUNK + jj;     // lane within the slice
      const int j = lane0 + jl;               // lane of the row
      float best = 0.0f;
      int arg = 0, bt = 0;
#pragma unroll (RS > 0 ? RS : 4)
      for (int i = 0; i < (RS > 0 ? RS : steps); ++i) {
        const int idx =
            (((VIT_LEAVE_OUT & 1 ? 0 : i * nk) + k0 + k) << 5) + lane;
        const int si = ((i * nchunks + k) << 5) + lane;
        const int4 r = __ldg(rec12 + idx);
        const int2 r3 = __ldg(rec3 + idx);
        float old0, old1, old2;
        int t0o, t1o, t2o;
        if constexpr (RS > 0) {
          old0 = sc[0][i], old1 = sc[1][i], old2 = sc[2][i];
          t0o = half_time(tm[0][i / 2], i);
          t1o = half_time(tm[1][i / 2], i);
          t2o = half_time(tm[2][i / 2], i);
        } else {
          const int2 c0 = st[si], c1 = st[splane + si],
                     c2 = st[2 * splane + si];
          old0 = __int_as_float(c0.x), old1 = __int_as_float(c1.x);
          old2 = __int_as_float(c2.x);
          t0o = c0.y, t1o = c1.y, t2o = c2.y;
        }

        const float go2 = old1 + __int_as_float(r.w);
        const float stay2 = old2 + __int_as_float(r.y);
        const bool take2 = go2 > stay2;
        const float pp2 =
            (take2 ? go2 : stay2) + lpc[(unsigned)r3.y >> 16];
        const int tt2 = take2 ? t1o : t2o;

        const float go1 = old0 + __int_as_float(r.z);
        const float stay1 = old1 + __int_as_float(r.x);
        const bool take1 = go1 > stay1;
        const float pp1 = (take1 ? go1 : stay1) + lpc[r3.y & 0xffff];
        const int tt1 = take1 ? t0o : t1o;

        if constexpr (RS > 0) {
          sc[1][i] = pp1, sc[2][i] = pp2;
          tm[1][i / 2] = with_half_time(tm[1][i / 2], i, tt1);
          tm[2][i / 2] = with_half_time(tm[2][i / 2], i, tt2);
        } else {
          st[splane + si] = make_int2(__float_as_int(pp1), tt1);
          st[2 * splane + si] = make_int2(__float_as_int(pp2), tt2);
        }

        // export: first max over this group's rows (strict >, ascending a)
        const float out = pp2 + __int_as_float(r3.x);
        if (i == 0 || first_max_takes(out, best)) {
          best = out;
          arg = i * ROW_GROUPS + g;
          bt = tt2;
        }
      }
      // first max over the four groups: greater, or equal and smaller row
#pragma unroll
      for (int off = LANE_CHUNK; off < 32; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
        if (partner_wins(ob, oa, best, arg)) {
          best = ob;
          arg = oa;
          bt = ot;
        }
      }
      if (g == 0) {
        // both tables' loads issue before the store
        const int key = pol.key(arg, bt, j);
        const float v = pol.exported(best, j);
        packed[((size_t)u * T + t) * L + j] = key;
        if (best != best) nan_chunks |= 1u << m;  // rekeyed after the barrier
        pub[buf * W + jl] = v;
        if (use_beam) local = max(local, max_key(pol.beam_score(v, j)));
      }
    }
    if (use_beam) {
      local = __reduce_max_sync(0xffffffffu, local);
      if (lane == 0) atomicMax(row_max + buf, local);
    }
#if !(VIT_LEAVE_OUT & 2)
    cluster_arrive();    // frame t's slice and row max published
#endif

    // ---- pass 2: state 0, entering from frame t-1's row ----
    for (int k = warp; k < (RS > 0 ? warp + 1 : nchunks); k += nwarps) {
      const int jl = k * LANE_CHUNK + jj;
      const int ctx = pol.lane_ctx(lane0 + jl);
#pragma unroll (RS > 0 ? RS : 4)
      for (int i = 0; i < (RS > 0 ? RS : steps); ++i) {
        const int idx =
            (((VIT_LEAVE_OUT & 1 ? 0 : i * nk) + k0 + k) << 5) + lane;
        const int si = ((i * nchunks + k) << 5) + lane;
        const int2 r = __ldg(rec0 + idx);
        float old0;
        int t0o;
        if constexpr (RS > 0) {
          old0 = sc[0][i], t0o = half_time(tm[0][i / 2], i);
        } else {
          const int2 c0 = st[si];
          old0 = __int_as_float(c0.x), t0o = c0.y;
        }
        const float p_in = pol.entry(i * ROW_GROUPS + g, ctx, idx,
                                     r.y >> 16, pc_prev, thr, use_beam, pip);
        const float stay0 = old0 + __int_as_float(r.x);
        const bool take0 = p_in > stay0;
        const float pp0 = (take0 ? p_in : stay0) + lpc[r.y & 0xffff];
        const int tt0 = take0 ? t - 1 : t0o;
        if constexpr (RS > 0) {
          sc[0][i] = pp0;
          tm[0][i / 2] = with_half_time(tm[0][i / 2], i, tt0);
        } else {
          st[si] = make_int2(__float_as_int(pp0), tt0);
        }
      }
    }
#if !(VIT_LEAVE_OUT & 2)
    cluster_wait();
#endif

    // ---- the exchange: row t (and its threshold) from every block ----
    float* pc_t = pcl + buf * pcn;
    for (int e = 4 * tid; e < (VIT_LEAVE_OUT & 2 ? 0 : L); e += 4 * nt) {
      const int r = e / W;
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(pub + buf * W + (e - r * W), r));
      pc_t[pol.pc_slot(e)] = v.x;
      pc_t[pol.pc_slot(e + 1)] = v.y;
      pc_t[pol.pc_slot(e + 2)] = v.z;
      pc_t[pol.pc_slot(e + 3)] = v.w;
    }
    if (use_beam && warp == nwarps - 1) {
      // lane r < c reads block r's row max: one remote word a block
      const int mk = __reduce_max_sync(
          0xffffffffu,
          lane < c ? *cluster.map_shared_rank(row_max + buf, lane) : INT_MIN);
      if (lane == 0) thr_s[buf] = key_value(mk) - beam;
    }
    if (tid == 0) row_max[buf ^ 1] = INT_MIN;  // frame t+1's; peers read
                                               // frame t-1's before wait t
    cp_async_wait_all();
    __syncthreads();     // row t, its threshold, posterior row t + 1
    if (use_beam) thr = thr_s[buf];
    // a NaN max matches no row: the key of pad row P with its new entry
    // time (state 2, untouched by pass 2), if the rows have one (never on
    // the register route)
    for (int m = 0; nan_chunks; ++m, nan_chunks >>= 1) {
      if (!(nan_chunks & 1u)) continue;
      const int k = warp + m * nwarps;
      const int pr = pol.pad_row();
      const int tt = RS == 0 && pr >= 0 && pr < PS
                         ? st[2 * splane +
                              (((pr / ROW_GROUPS) * nchunks + k) << 5) +
                              (pr % ROW_GROUPS) * LANE_CHUNK + jj].y
                         : 0;
      const int j = lane0 + k * LANE_CHUNK + jj;
      packed[((size_t)u * T + t) * L + j] = pol.nan_key(tt, j);
    }

    float* endt = end + ((size_t)u * T + t) * P;
    for (int p = rank * nt + tid; p < P; p += c * nt)
      endt[p] = pol.end_score(p, pc_t, thr, use_beam);
  }
  cluster_arrive();      // no block leaves while a peer reads its slots
  cluster_wait();
}

// cudaLaunchKernelEx's configuration of a grid of `clusters` clusters of
// c blocks; sets the kernel's shared-memory and cluster-size attributes.
template <class K>
cudaError_t configure(K kern, int clusters, int c, int threads, size_t smem,
                      cudaStream_t stream, cudaLaunchAttribute* attr,
                      cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (c > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * c);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of c blocks the card holds at once (into *out).
template <class K>
int capacity(K kern, int PS, int lanes, int S, int c, int rs, int* out) {
  int err = check_layout(PS, lanes, S, c, rs);
  if (err) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int w = lanes / c;
  err = (int)configure(kern, 1, c, threads_of(w),
                       smem_bytes(PS, lanes, S, c, rs), nullptr, &attr, &cfg);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// One launch of U clusters of c blocks, kern being the instantiation of
// rs row steps in registers. Fails (never falls back) if the layout is
// refused, the card holds no such cluster, or the launch fails.
template <class K, class... Args>
int launch(K kern, int U, int PS, int lanes, int S, int c, int rs,
           void* stream, Args... args) {
  int err = check_layout(PS, lanes, S, c, rs);
  if (err) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int w = lanes / c;
  err = (int)configure(kern, U, c, threads_of(w),
                       smem_bytes(PS, lanes, S, c, rs),
                       static_cast<cudaStream_t>(stream), &attr, &cfg);
  if (err) return err;
  int active = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err) return err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  err = (int)cudaLaunchKernelEx(&cfg, kern, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace viterbi_cluster
