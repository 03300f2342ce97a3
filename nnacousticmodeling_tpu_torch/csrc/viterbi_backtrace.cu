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
// Bound: latency. A hop is a chain of dependent loads (the lane table, the
// packed entry, the predecessor table), one hop a segment, ~40-50 an
// utterance on the synthetic 48-phone image. The bytes (the zeroed segs,
// the rows read and written) are ~0.8 MB at U=128, T=512: 0.25 us at the
// HBM rate. Design, simple first: one warp an utterance, four a block; the
// lanes zero the utterance's (T, 3) rows and reduce the first max of its
// last end row with warp shuffles; lane 0 walks. The tables are read
// through the read-only path (__ldg) and stay in L1/L2; no shared memory,
// no allocation, no synchronisation with the host.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int MODE_LANES = 0;
constexpr int MODE_BAC = 1;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Whether (v, i) replaces (best, arg) as torch.argmax's first maximum:
// arg == INT_MAX holds nothing yet; NaN beats every number.
__device__ __forceinline__ bool takes(float v, int i, float best, int arg) {
  if (i == INT_MAX) return false;
  if (arg == INT_MAX) return true;
  const bool vn = v != v, bn = best != best;
  if (vn || bn) return vn && (!bn || i < arg);
  return v > best || (v == best && i < arg);
}

__global__ void __launch_bounds__(WARPS * 32)
viterbi_backtrace_kernel(const int* __restrict__ packed,       // (U, T, L)
                         const float* __restrict__ end_scores, // (U, T, E)
                         const int* __restrict__ lengths,      // (U,)
                         const int* __restrict__ end_map,      // (E,)
                         const int* __restrict__ step_map,     // (M,)
                         int* __restrict__ segs,               // (U, T, 3)
                         long long* __restrict__ counts,       // (U,)
                         int U, int T, int L, int E, int M, int P, int pack,
                         int mode) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= U) return;                        // the whole warp
  int* out = segs + (size_t)u * T * 3;
  for (long long i = lane; i < 3LL * T; i += 32) out[i] = 0;
  const int len = min(lengths[u], T);
  if (len <= 0) {                            // the whole warp
    if (lane == 0) counts[u] = 0;
    return;
  }

  const float* last = end_scores + ((size_t)u * T + len - 1) * E;
  float best = 0.0f;
  int arg = INT_MAX;
  for (int j = lane; j < E; j += 32) {
    const float v = last[j];
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
  __syncwarp();                              // the zeros before lane 0's rows
  if (lane != 0) return;

  const int* pk = packed + (size_t)u * T * L;
  int cur = __ldg(end_map + arg);
  int t = len - 1;
  long long k = 0;
  while (t >= 0) {
    int ln = cur;
    if (mode != MODE_LANES)
      ln = (unsigned)cur < (unsigned)M ? __ldg(step_map + cur) : -1;
    if ((unsigned)ln >= (unsigned)L) break;
    const long long entry = pk[(size_t)t * L + ln];
    const long long q = floor_div(entry, pack);
    const long long t_new = entry - q * pack - 1;
    long long tri, next;
    if (mode == MODE_LANES) {
      tri = q;
      next = (q >= 0 && q < M) ? __ldg(step_map + q) : -1;
    } else {
      const long long b = cur / P, c = cur % P;    // 0 <= cur < M = P*P
      tri = mode == MODE_BAC ? (b * P + q) * P + c : (q * P + b) * P + c;
      next = q * P + b;
    }
    int* row = out + 3 * k;
    row[0] = (int)(t_new + 1);
    row[1] = t + 1;
    row[2] = (int)tri;
    ++k;
    t = t_new >= t ? -1 : (int)t_new;
    cur = (next >= INT_MIN && next <= INT_MAX) ? (int)next : -1;
  }
  counts[u] = k;
}

}  // namespace

// segs (U, T, 3) int32 and counts (U,) int64 are written whole; packed
// (U, T, L) int32 and end_scores (U, T, E) float32 are read only at rows
// t < lengths[u]. mode: 0 lane map (step_map = triphone -> predecessor
// lane), 1 collapsed 'bac', 2 collapsed 'abc' (step_map = biphone ->
// lane); M entries in step_map. Returns the cudaError_t of the launch.
extern "C" int viterbi_backtrace(const void* packed, const void* end_scores,
                                 const void* lengths, const void* end_map,
                                 const void* step_map, void* segs,
                                 void* counts, int U, int T, int L, int E,
                                 int M, int P, int pack, int mode,
                                 void* stream) {
  if (U == 0) return 0;
  const int blocks = (U + WARPS - 1) / WARPS;
  viterbi_backtrace_kernel<<<blocks, WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<const float*>(end_scores),
      static_cast<const int*>(lengths), static_cast<const int*>(end_map),
      static_cast<const int*>(step_map), static_cast<int*>(segs),
      static_cast<long long*>(counts), U, T, L, E, M, P, pack, mode);
  return (int)cudaGetLastError();
}
