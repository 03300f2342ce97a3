// The Viterbi backtrace of every decoder backend, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's backtrace is a
// jax.lax.while_loop that XLA compiles into one program with the forward
// kernel (nnacousticmodeling_tpu/decoder/viterbi.py _collapsed_backtrace
// :217-260, _device_backtrace :503-544, vmapped behind the kernel in
// _pallas_decode_traced :262-271). Run as T hops of eager PyTorch
// operations, that loop cost the host ~16,400 launches a 512-frame decode;
// as this one kernel, a decode is the forward kernel and then this one,
// queued with no host round-trip.
//
// For each utterance u (C++ phone_recog.cpp:224-244), bit for bit what
// decoder/viterbi_backtrace.py's plain version computes:
//  * lengths[u] <= 0: counts[u] = 0 and the row stays zero; nothing of
//    end_scores or packed is read (the forwards leave those rows
//    unwritten);
//  * else t = len-1 and cur = end_map[first max of end_scores[u, t, :]]
//    (lowest index on ties, NaN the largest, as torch.argmax);
//  * one hop while t >= 0: entry = packed[u, t, lane], t_new = entry mod
//    pack - 1 (floor division, as the plain version's);
//    - lane-map mode (cube kernel and scan twins): lane = cur, tri =
//      entry div pack, next cur = step_map[tri];
//    - collapsed modes: lane = step_map[cur] (bi2lane), a = entry div
//      pack, b = cur div P, c = cur mod P, tri = b*P*P + a*P + c ('bac')
//      or a*P*P + b*P + c ('abc'), next cur = a*P + b;
//    segs[u, k] = (t_new+1, t+1, tri), k += 1; t = -1 if t_new >= t (the
//    native decoder's endless loop on a path of < 3 frames), else t_new;
//  * counts[u] = k; rows k.. stay zero.
// Every hop moves to an earlier frame, so k <= len <= T. A lane or table
// index outside its table (only a corrupt row names one; the plain version
// raises there) ends the walk instead of reading out of bounds.
//
// Bound: latency. A hop is a chain of dependent operations, one hop a
// segment, ~40-50 an utterance of a trained model on the synthetic
// 48-phone image. The bytes (the zeroed segs, the rows read and written)
// are ~0.8 MB at U=128, T=512: 0.25 us at the HBM rate. The design makes
// the packed entry the one dependent global load of a hop:
//  * pack is a power of two (the wrapper passes shift = log2 pack and
//    refuses any other): q = entry >> shift and t_new = (entry & (pack-1))
//    - 1, which on int32 (an arithmetic shift) are the floor division and
//    modulo of the contract, negative entries included;
//  * the collapsed walk carries its biphone as the pair (b, c) and moves
//    it to (q, b) each hop, so no division; it goes on while 0 <= q < P,
//    which is the contract's "0 <= q*P + b < M" for M = P*P; tri is built
//    in 32-bit wrapping arithmetic, the low 32 bits of the int64 product
//    the plain version truncates;
//  * the collapsed modes stage end_map and bi2lane (P*P int32, 9.2 KB at
//    P=48) in shared memory once a block. The lane map has two routes:
//    route 0 ("shared") stages end_map and an int16 copy of its triphone
//    -> lane table (216 KB at P=48), route 1 ("global") reads them through
//    the read-only path (__ldg), for a table that does not fit. Staging
//    216 KB costs ~3.6 us a block, which walks of ~20 hops or more win
//    back (a trained model's walk ~50; PERF.md, bench_backtrace.py).
// One warp an utterance: the lanes zero its (T, 3) rows and reduce the
// first max of its last end row with warp shuffles; lane 0 walks. No
// allocation, no synchronisation with the host.
//
// backtrace_chase: a measurement entry used by bench_backtrace.py only, one
// thread following next[i] `hops` times: the latency of one dependent
// global load (L2 only, as the walk loads packed), HBM or L2 by whether
// the chain was flushed from L2 first.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MODE_LANES = 0;
constexpr int MODE_BAC = 1;
constexpr int MODE_ABC = 2;
constexpr int ROUTE_SHARED = 0;
constexpr int WARPS_SMALL = 4;    // a block whose tables take <= 48 KB
constexpr int WARPS_LARGE = 16;   // one staging of a large table, 16 walks
constexpr size_t SMEM_DEFAULT = 48 * 1024;

// Whether (v, i) replaces (best, arg) as torch.argmax's first maximum:
// arg == INT_MAX holds nothing yet; NaN beats every number.
__device__ __forceinline__ bool takes(float v, int i, float best, int arg) {
  if (i == INT_MAX) return false;
  if (arg == INT_MAX) return true;
  const bool vn = v != v, bn = best != best;
  if (vn || bn) return vn && (!bn || i < arg);
  return v > best || (v == best && i < arg);
}

// bytes (even) from src to the 16-byte aligned shared dst, by the block:
// a thread's 16-byte loads go out STAGE_BATCH at a time, so staging takes
// a few round trips to L2, not one a load.
constexpr int STAGE_BATCH = 8;
__device__ __forceinline__ void stage(void* dst, const void* src,
                                      int bytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = bytes >> 4, step = blockDim.x;
    const int4* s = static_cast<const int4*>(src);
    int4* d = static_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n16; i += STAGE_BATCH * step) {
      int4 v[STAGE_BATCH];
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j)
        if (i + j * step < n16) v[j] = __ldg(s + i + j * step);
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j)
        if (i + j * step < n16) d[i + j * step] = v[j];
    }
    done = n16 << 4;
  }
  const unsigned short* s = static_cast<const unsigned short*>(src);
  unsigned short* d = static_cast<unsigned short*>(dst);
  for (int i = (done >> 1) + threadIdx.x; i < (bytes >> 1); i += blockDim.x)
    d[i] = __ldg(s + i);
}

template <bool SHARED, class Step>
__device__ __forceinline__ int table(const Step* tab, int i) {
  if (SHARED) return tab[i];
  return __ldg(tab + i);
}

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

template <int MODE, class Step, bool SHARED>
__global__ void __launch_bounds__(WARPS_LARGE * 32)
viterbi_backtrace_kernel(const int* __restrict__ packed,       // (U, T, L)
                         const float* __restrict__ end_scores, // (U, T, E)
                         const int* __restrict__ lengths,      // (U,)
                         const int* __restrict__ end_map,      // (E,)
                         const Step* __restrict__ step_map,    // (M,)
                         int* __restrict__ segs,               // (U, T, 3)
                         long long* __restrict__ counts,       // (U,)
                         int U, int T, int L, int E, int M, int P,
                         int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* ends = end_map;
  const Step* steps = step_map;
  if (SHARED) {
    int* s_end = reinterpret_cast<int*>(smem);
    Step* s_step = reinterpret_cast<Step*>(smem + align16(4 * E));
    stage(s_end, end_map, 4 * E);
    stage(s_step, step_map, (int)sizeof(Step) * M);
    ends = s_end;
    steps = s_step;
  }

  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  int len = 0, arg = INT_MAX;
  int* out = segs + (size_t)u * T * 3;
  if (u < U) {                               // the whole warp
    len = min(__ldg(lengths + u), T);
    for (int i = lane; i < 3 * T; i += 32) out[i] = 0;
    if (len > 0) {
      const float* last = end_scores + ((size_t)u * T + len - 1) * E;
      float best = 0.0f;
      for (int j = lane; j < E; j += 32) {
        const float v = __ldg(last + j);
        if (takes(v, j, best, arg)) {
          best = v;
          arg = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (takes(ob, oa, best, arg)) {
          best = ob;
          arg = oa;
        }
      }
    } else if (lane == 0) {
      counts[u] = 0;
    }
  }
  if (SHARED) __syncthreads();               // the staged tables
  else __syncwarp();                         // the zeros before lane 0's rows
  if (u >= U || len <= 0 || lane != 0) return;

  const int* pk = packed + (size_t)u * T * L;
  const int mask = (1 << shift) - 1;
  int* row = out;
  int t = len - 1;
  long long k = 0;
  int cur = ends[arg];
  if (MODE == MODE_LANES) {
    while ((unsigned)cur < (unsigned)L) {    // t >= 0 here
      const int entry = __ldcg(pk + (size_t)t * L + cur);
      const int q = entry >> shift;
      const int t_new = (entry & mask) - 1;
      row[0] = t_new + 1;
      row[1] = t + 1;
      row[2] = q;
      row += 3;
      ++k;
      if (t_new >= t || t_new < 0) break;    // t would be -1
      t = t_new;
      if ((unsigned)q >= (unsigned)M) break; // no next lane
      cur = table<SHARED>(steps, q);
    }
  } else if ((unsigned)cur < (unsigned)M) {  // M = P*P
    int b = cur / P, c = cur - b * P;        // the biphone (b, c), once
    for (;;) {
      const int ln = table<SHARED>(steps, b * P + c);
      if ((unsigned)ln >= (unsigned)L) break;
      const int entry = __ldcg(pk + (size_t)t * L + ln);
      const int q = entry >> shift;
      const int t_new = (entry & mask) - 1;
      const unsigned uP = (unsigned)P;
      const unsigned tri =
          MODE == MODE_BAC
              ? ((unsigned)b * uP + (unsigned)q) * uP + (unsigned)c
              : ((unsigned)q * uP + (unsigned)b) * uP + (unsigned)c;
      row[0] = t_new + 1;
      row[1] = t + 1;
      row[2] = (int)tri;
      row += 3;
      ++k;
      if (t_new >= t || t_new < 0) break;
      t = t_new;
      if ((unsigned)q >= (unsigned)P) break; // q*P + b outside the table
      c = b;
      b = q;
    }
  }
  counts[u] = k;
}

__global__ void chase_kernel(const int* __restrict__ next, int start,
                             int hops, int* __restrict__ out) {
  int i = start;
  for (int h = 0; h < hops; ++h) i = __ldcg(next + i);
  *out = i;
}

template <int MODE, class Step, bool SHARED>
int launch(const void* packed, const void* end_scores, const void* lengths,
           const void* end_map, const void* step_map, void* segs,
           void* counts, int U, int T, int L, int E, int M, int P, int shift,
           cudaStream_t stream) {
  auto kern = viterbi_backtrace_kernel<MODE, Step, SHARED>;
  const size_t smem =
      SHARED ? (size_t)align16(4 * E) + sizeof(Step) * (size_t)M : 0;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int warps = smem > SMEM_DEFAULT ? WARPS_LARGE : WARPS_SMALL;
  kern<<<(U + warps - 1) / warps, warps * 32, smem, stream>>>(
      static_cast<const int*>(packed), static_cast<const float*>(end_scores),
      static_cast<const int*>(lengths), static_cast<const int*>(end_map),
      static_cast<const Step*>(step_map), static_cast<int*>(segs),
      static_cast<long long*>(counts), U, T, L, E, M, P, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// segs (U, T, 3) int32 and counts (U,) int64 are written whole; packed
// (U, T, L) int32 and end_scores (U, T, E) float32 are read only at rows
// t < lengths[u]. mode: 0 lane map (step_map = triphone -> predecessor
// lane), 1 collapsed 'bac', 2 collapsed 'abc' (step_map = biphone ->
// lane, M = P*P); M entries in step_map. The collapsed modes stage their
// tables in shared memory (route 0 only). The lane map: route 0 stages
// them (step_map an int16 copy), route 1 reads them from device memory
// (step_map int32). shift = log2 of the pack factor (0..30). Returns the
// cudaError_t of the launch.
extern "C" int viterbi_backtrace(const void* packed, const void* end_scores,
                                 const void* lengths, const void* end_map,
                                 const void* step_map, void* segs,
                                 void* counts, int U, int T, int L, int E,
                                 int M, int P, int shift, int mode, int route,
                                 void* stream) {
  if (U == 0) return 0;
  if (shift < 0 || shift > 30 || E <= 0 || mode < 0 || mode > 2 ||
      route < 0 || route > 1 ||
      (mode != MODE_LANES && (M != P * P || route != ROUTE_SHARED)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BT_ARGS                                                          \
  packed, end_scores, lengths, end_map, step_map, segs, counts, U, T, L, \
      E, M, P, shift, s
  if (mode == MODE_BAC) return launch<MODE_BAC, int, true>(BT_ARGS);
  if (mode == MODE_ABC) return launch<MODE_ABC, int, true>(BT_ARGS);
  return route == ROUTE_SHARED ? launch<MODE_LANES, short, true>(BT_ARGS)
                               : launch<MODE_LANES, int, false>(BT_ARGS);
#undef BT_ARGS
}

// One thread follows next[] from `start` for `hops` dependent loads and
// writes where it ended to *out (bench_backtrace.py's latency chase).
extern "C" int backtrace_chase(const void* next, int start, int hops,
                               void* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), start, hops, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
