// The weight-gradient contraction of the three training backwards, on the
// tensor cores (sm_90a): one kernel for lstm_train.cu, gated_train.cu and
// peephole_train.cu.
//
// Replaces the dW parts of the TPU kernels in
// nnacousticmodeling_tpu/ops/rnn_pallas.py: _lstm_train_bwd_impl (:485,
// block dW at :575-580), _gated_train_bwd_impl (:785, dW1 / dW2 at
// :886-895) and _peep_train_bwd_impl (:1101, dW_h / dP_i / dP_f / dP_o at
// :1195-1208). Each is, per problem,
//
//     C (H x n) = sum over the M = T*B rows m of A[m, :]^T B[m, :]
//
// with bf16 operands and f32 accumulation. A is a column window of the
// bf16 residuals (row stride lda) -- or, for the gated dW2, bf16(r * h_prev)
// of two such windows, formed as the tile lands in shared memory -- and B
// a window of the bf16 dz (row stride ldb). The problems of one backward
// (1 for the LSTM, 2 for gated, 4 for the peephole) go in one launch: a
// flat grid of output tiles, each problem's tiles after the previous one's.
//
// What bounds it on this card. The LSTM's at T=20, B=128, H=1024 is 21.5
// GFLOP against ~26 MB of operands and 16 MB of f32 result: 0.0217 ms at
// the bf16 tensor rate (operations), 0.013 ms at 3.35 TB/s. The TPU
// kernel keeps the f32 accumulator in VMEM across time blocks; here M is
// the reduction axis of a plain GEMM whose operands are "MN-major" (the
// contraction index is the row index of both). In practice the card's L2
// bandwidth bounds it: every C tile reads its A and B strips over all of
// M, 335 MB for the LSTM's at 128 x 128 tiles, 252 MB at 128 x 256.
//
// What this design does about it. A block owns a 128 x 256 tile of C (128
// x 128 when wide tiles would leave the card under-filled): 3/4 of the
// operand bytes of square 128 x 128 tiles for the same work. One producer
// warpgroup streams the operands in 64-row stages through a 3-4-deep ring:
// one thread issues TMA boxes of 64 columns x 64 rows, which land in the
// 128-byte-swizzled layout wgmma reads (rows past M as zeros); operands
// that TMA cannot take (rows that are no multiple of 16 bytes, as at odd
// H) arrive by 16-byte cp.async or element by element, so every H is
// taken. Two consumer warpgroups issue wgmma m64nBNk16 with the transpose
// bits (f32 accumulators in registers), each keeping one stage in flight;
// mbarriers hand the slots back and forth. Each output is summed by one
// thread in one fixed order: no atomics, no split over M, the same bits on
// every run.

#pragma once

#include <cuda.h>

#include "mma_ptx.cuh"

namespace dw_gemm {

constexpr int BM = 128;         // rows i of C per block (H axis)
constexpr int THREADS = 384;    // 2 consumer warpgroups (64 rows of C each)
                                // and 1 producer warpgroup
constexpr int MAX_PROBLEMS = 4;
constexpr int DESC_WORDS = 8;   // int64 words of one host descriptor

struct Problem {
  const __nv_bfloat16* a;   // A (M x H): element (m, i) at a[m * lda + i]
  const __nv_bfloat16* r;   // null, or A := bf16(r * a), r strided as a
  const __nv_bfloat16* b;   // B (M x n): element (m, j) at b[m * ldb + j]
  float* c;                 // C (H x n), row-major
  long long lda, ldb;
  int n, tile0;             // columns of C; its first flat tile
};

// tma: the operands arrive by TMA through the tensor maps (A, r, B of
// problem p at maps[3p + 0..2]); else by cp.async from the pointers
struct Problems {
  CUtensorMap maps[3 * MAX_PROBLEMS];
  Problem p[MAX_PROBLEMS];
  int count, M, H, tma;
};

__host__ __device__ inline int tiles_of(int H, int n, int bn) {
  return ((H + BM - 1) / BM) * ((n + bn - 1) / bn);
}

// the ring (A, r when set, B) and 1 KB to align it to the swizzle atom
inline size_t smem_bytes(int bn, int bk, int stages, bool has_r) {
  return (size_t)stages * bk * ((has_r ? 2 : 1) * BM + bn) * 2 + 1024;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- wgmma (Hopper's warpgroup MMA) on the 128-byte-swizzled layout -----
//
// Both operands stay MN-major in shared memory, in wgmma's canonical
// 128-byte-swizzled layout: atoms of 8 rows (m) x 64 columns (128 bytes),
// the 16-byte chunk c of row r stored at chunk c ^ r; atoms along m follow
// each other (SBO = 1024 bytes), atoms along the columns every LBO = BK / 8
// * 1024 bytes. wgmma reads both with the transpose bits set.

__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;   // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// generic-proxy writes (cp.async, stores) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t addr, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(addr), "r"(bytes) : "memory");
}

// Wait for phase `parity` of the barrier to complete; a wait longer than
// 10 s means a copy never landed: trap rather than spin for ever.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  unsigned long long start = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    const unsigned long long now = mma_ptx::global_ns();
    if (tries == 0) start = now;
    else if (now - start > 10000000000ull) __trap();
  }
}

// box {64 columns, rows} of a 2-D tensor map at (column c0, row c1) into
// 128-byte-swizzled shared memory, completing on the barrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint32_t mbar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(mma_ptx::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(mbar), "r"(c0), "r"(c1) : "memory");
}

// byte offset of chunk c (8 elements) of row r in a swizzled tile
__device__ __forceinline__ int sw128(int r, int c, int lbo) {
  return (c >> 3) * lbo + (r >> 3) * 1024 + (r & 7) * 128 +
         (((c & 7) ^ (r & 7)) << 4);
}

// d (64 x 128 f32, the m64n128 accumulator layout) += A B for one k16
// step, A (64 x 16) and B (16 x 128) both MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                           uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256 f32, the m64n256 accumulator layout) += A B for one k16
// step, A (64 x 16) and B (16 x 256) both MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                           uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128k16(d, da, db);
  else wgmma_m64n256k16(d, da, db);
}

// One C tile of BM x BN per block, warp-specialized: warpgroup 2 is the
// producer -- one thread issues the TMA boxes of each BK-row stage into a
// STAGES-deep ring (or, for operands TMA cannot take, all its threads
// copy by cp.async) -- and warpgroups 0 and 1 consume, each issuing BK /
// 16 wgmmas a stage for its 64 rows of C. "full" barriers hand a slot to
// the consumers, "empty" barriers hand it back once both warpgroups'
// wgmmas on it have retired; each consumer keeps one stage's wgmmas in
// flight while it issues the next.
template <int BN, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
dw_gemm_kernel(const __grid_constant__ Problems P) {
  using namespace mma_ptx;
  constexpr int TA = BK * BM * 2, TB = BK * BN * 2;   // bytes of a tile
  constexpr uint32_t LBO = BK / 8 * 1024, SBO = 1024;
  extern __shared__ unsigned char dw_raw[];
  unsigned char* As = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dw_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Bs = As + STAGES * TA;
  unsigned char* Rs = Bs + STAGES * TB;   // staged r, when pr.r is set
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  // this block's problem: the last one whose tiles start at or before it
  const int tile = (int)blockIdx.x;
  Problem pr = P.p[0];
  int pi = 0;
#pragma unroll
  for (int q = 1; q < MAX_PROBLEMS; ++q)
    if (q < P.count && tile >= P.p[q].tile0) {
      pr = P.p[q];
      pi = q;
    }
  const int M = P.M, H = P.H;
  const int tiles_n = (pr.n + BN - 1) / BN;
  const int local = tile - pr.tile0;
  const int i0 = (local / tiles_n) * BM;
  const int j0 = (local % tiles_n) * BN;
  const bool has_r = pr.r != nullptr;
  const bool tma = P.tma != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4;
  const int KT = (M + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), tma ? 1 : 128);
      mbar_init(smem_addr(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    const int pt = tid - 256;
    const bool vec_a = aligned16(pr.a) && pr.lda % 8 == 0 &&
                       (!has_r || aligned16(pr.r));
    const bool vec_b = aligned16(pr.b) && pr.ldb % 8 == 0;
    // boxes wholly past H or n are skipped: they only feed outputs that
    // are never written; rows past M arrive as zeros
    const int boxes_a = ((H - i0 < BM ? H - i0 : BM) + 63) / 64;
    const int boxes_b = ((pr.n - j0 < BN ? pr.n - j0 : BN) + 63) / 64;
    if (tma && pt != 0) return;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(smem_addr(&empty[s]), (kt / STAGES - 1) & 1);
      const int m0 = kt * BK;
      const uint32_t mb = smem_addr(&full[s]);
      if (tma) {
        mbar_expect_tx(mb, (uint32_t)(boxes_a * (has_r ? 2 : 1) + boxes_b) *
                               BK * 128);
        for (int cb = 0; cb < boxes_a; ++cb) {
          tma_load_2d(As + s * TA + cb * LBO, &P.maps[3 * pi], mb,
                      i0 + cb * 64, m0);
          if (has_r)
            tma_load_2d(Rs + s * TA + cb * LBO, &P.maps[3 * pi + 1], mb,
                        i0 + cb * 64, m0);
        }
        for (int cb = 0; cb < boxes_b; ++cb)
          tma_load_2d(Bs + s * TB + cb * LBO, &P.maps[3 * pi + 2], mb,
                      j0 + cb * 64, m0);
        continue;
      }
      // cp.async: eight-element chunks, zero-filled past the edges
      for (int e = pt; e < BK * (BM / 8); e += 128) {
        const int row = e / (BM / 8), c = e % (BM / 8);
        const int m = m0 + row;
        const int off = s * TA + sw128(row, c, LBO);
        const int av = (m < M) ? H - (i0 + c * 8) : 0;
        const size_t ga = (size_t)m * pr.lda + i0 + c * 8;
        copy8(reinterpret_cast<__nv_bfloat16*>(As + off), pr.a + ga, av,
              vec_a);
        if (has_r)
          copy8(reinterpret_cast<__nv_bfloat16*>(Rs + off), pr.r + ga, av,
                vec_a);
      }
      for (int e = pt; e < BK * (BN / 8); e += 128) {
        const int row = e / (BN / 8), c = e % (BN / 8);
        const int m = m0 + row;
        const int bv = (m < M) ? pr.n - (j0 + c * 8) : 0;
        copy8(reinterpret_cast<__nv_bfloat16*>(Bs + s * TB +
                                               sw128(row, c, LBO)),
              pr.b + (size_t)m * pr.ldb + j0 + c * 8, bv, vec_b);
      }
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();   // for wgmma's reads
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(mb) : "memory");
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of C, the
  // column atom wg of every staged A (and r) tile
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
  const int ct = tid - 128 * wg;
  for (int k = 0; k < KT; ++k) {
    const int s = k % STAGES;
    mbar_wait(smem_addr(&full[s]), (k / STAGES) & 1);
    if (has_r) {
      // the gated dW2 operand, bf16(r * h_prev) (gated_train.cu's forward
      // rounding point), on this warpgroup's half of the tile
#pragma unroll
      for (int it = 0; it < BK * 8 / 128; ++it) {
        const int e = ct + it * 128;
        const int off = s * TA + wg * LBO + sw128(e / 8, e % 8, LBO);
        uint4 av = *reinterpret_cast<const uint4*>(As + off);
        const uint4 rv = *reinterpret_cast<const uint4*>(Rs + off);
        __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(&av);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 af = __bfloat1622float2(a2[x]);
          const float2 rf = __bfloat1622float2(r2[x]);
          a2[x] = __floats2bfloat162_rn(__fmul_rn(rf.x, af.x),
                                        __fmul_rn(rf.y, af.y));
        }
        *reinterpret_cast<uint4*>(As + off) = av;
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    }
    const uint32_t a0 = smem_addr(As + s * TA) + wg * LBO;
    const uint32_t b0 = smem_addr(Bs + s * TB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_k16<BN>(acc, gmma_desc(a0 + 2 * kk * SBO, LBO, SBO),
                    gmma_desc(b0 + 2 * kk * SBO, LBO, SBO));
    wgmma_commit();
    wgmma_wait<1>();
    // stage k - 1's wgmmas have retired: hand its slot back
    if (k > 0 && ct == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(smem_addr(&empty[(k - 1) % STAGES])) : "memory");
  }
  wgmma_wait<0>();

  // accumulator layout of m64nBN: warp w of the warpgroup holds rows
  // 16w + g and 16w + g + 8, columns 8jj + 2q and 8jj + 2q + 1
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + wg * 64 + (warp % 4) * 16 + g + half * 8;
    if (i >= H) continue;
    float* crow = pr.c + (size_t)i * pr.n;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int j = j0 + jj * 8 + 2 * q;
      if (j < pr.n) crow[j] = acc[jj * 4 + 2 * half];
      if (j + 1 < pr.n) crow[j + 1] = acc[jj * 4 + 2 * half + 1];
    }
  }
}

template <int BN, int BK, int STAGES>
int launch_config(const Problems& P, int tiles, bool has_r,
                  cudaStream_t stream) {
  auto kern = dw_gemm_kernel<BN, BK, STAGES>;
  const size_t smem = smem_bytes(BN, BK, STAGES, has_r);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<tiles, THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 matrix of rows x cols (row stride ld elements) as boxes of 64
// columns x bk rows into 128-byte-swizzled shared memory
inline bool encode_map(CUtensorMap* map, const void* base, long long rows,
                       long long cols, long long ld, int bk) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)bk};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool tma_ok(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && ld % 8 == 0;
}

// Launch the problems described by desc (count x DESC_WORDS int64: a, lda,
// r or 0, b, ldb, c, n, tile0 -- pointers as integers), all with M rows
// and A's H columns, as one grid of BM x bn tiles of C, bk operand rows a
// stage, a ring of the given depth. Returns a cudaError_t: invalid value
// for a tiling this file does not build, or descriptors that do not chain
// their tiles as that tiling says.
inline int launch(const long long* desc, int count, int M, int H, int bn,
                  int bk, int stages, cudaStream_t stream) {
  if (count < 1 || count > MAX_PROBLEMS || M < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Problems P;
  P.count = count;
  P.M = M;
  P.H = H;
  int tiles = 0;
  bool has_r = false;
  for (int i = 0; i < MAX_PROBLEMS; ++i) {
    const long long* d = desc + (size_t)(i < count ? i : 0) * DESC_WORDS;
    Problem& p = P.p[i];
    p.a = reinterpret_cast<const __nv_bfloat16*>(d[0]);
    p.lda = d[1];
    p.r = reinterpret_cast<const __nv_bfloat16*>(d[2]);
    p.b = reinterpret_cast<const __nv_bfloat16*>(d[3]);
    p.ldb = d[4];
    p.c = reinterpret_cast<float*>(d[5]);
    p.n = (int)d[6];
    p.tile0 = (int)d[7];
    if (i >= count) continue;
    if (p.tile0 != tiles || p.n < 1 || p.a == nullptr || p.b == nullptr ||
        p.c == nullptr)
      return (int)cudaErrorInvalidValue;
    tiles += tiles_of(H, p.n, bn);
    has_r = has_r || p.r != nullptr;
  }
  // TMA where every operand allows it (16-byte aligned base and rows)
  bool tma = true;
  for (int i = 0; i < count; ++i) {
    const Problem& p = P.p[i];
    tma = tma && tma_ok(p.a, p.lda) && tma_ok(p.b, p.ldb) &&
          (p.r == nullptr || tma_ok(p.r, p.lda));
  }
  for (int i = 0; tma && i < count; ++i) {
    const Problem& p = P.p[i];
    tma = encode_map(&P.maps[3 * i], p.a, M, H, p.lda, bk) &&
          (p.r == nullptr ||
           encode_map(&P.maps[3 * i + 1], p.r, M, H, p.lda, bk)) &&
          encode_map(&P.maps[3 * i + 2], p.b, M, p.n, p.ldb, bk);
  }
  P.tma = tma ? 1 : 0;
#define DW_GEMM_CONFIG(BN_, BK_, ST_)                                     \
  if (bn == BN_ && bk == BK_ && stages == ST_)                            \
    return launch_config<BN_, BK_, ST_>(P, tiles, has_r, stream);
  DW_GEMM_CONFIG(128, 64, 4)
  DW_GEMM_CONFIG(256, 64, 3)
  DW_GEMM_CONFIG(256, 64, 4)
#undef DW_GEMM_CONFIG
  return (int)cudaErrorInvalidValue;
}

}  // namespace dw_gemm
