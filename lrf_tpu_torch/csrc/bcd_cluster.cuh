// Fused QMF block-coordinate-descent loop for Hopper (sm_90a): one
// thread-block cluster per image, X held in shared memory across sweeps.
//
// Replaces the three Pallas TPU kernels of lrf_tpu/ops/bcd_pallas.py at the
// codec's patch width (N = 64 columns, rank 1 <= R <= 32):
//   K1  _bcd_resident_kernel (launched by bcd_pallas, X resident in VMEM)
//   K2  _bcd_stream_kernel   (launched by bcd_pallas, X streamed in M-tiles)
//   K3  _legacy_bcd_kernel   (launched by _bcd_pallas_legacy, M >= 16384)
// This header holds the kernel template. Two sources instantiate it, so that
// nvcc builds them in parallel: bcd_cluster.cu for R = 1..16 and
// bcd_cluster_wide.cu for R = 17..32 (quality 27-50 at 8x8 patches). Other
// shapes (N != 64 or R > 32) run the one-block-per-image kernel of bcd.cu;
// ops/bcd_kernel.py::launch_plan picks by shape.
//
// Function (the same as bcd.cu). For image b with X (M, 64), U (M, R),
// V (64, R), each of `num_iters` sweeps does
//   B = V^T V;  for every row m of U, with a = X[m, :] V, for r = 0..R-1:
//     u_r <- clip(rint(((a_r - (U[m,:] B[:, r] - u_r B[r, r])) + 1e-16)
//                      / (B[r, r] + 1e-16)), lo, hi)
//   then the same rule for every row n of V with a = (X^T U)[n, :], B = U^T U.
// rintf rounds half to even; the division is IEEE; everything is f32 on the
// CUDA cores (no tensor cores: TF32 would change the numbers).
//
// What bounds it on an H100. Per sweep an image costs 4*M*64*R flops for
// the two products X V and X^T U; X is the only large input. At the codec's
// shapes the f32 FMA rate (67 TFLOP/s) bounds the work once X stays on
// chip. The one-block-per-image kernel of bcd.cu re-reads X from device
// memory every sweep, uses one SM per image, and spends one or two
// shared-memory loads per FMA.
//
// Design.
// - A cluster of C CTAs per image splits M: CTA k owns rows
//   [k*S, min(M, (k+1)*S)). Resident mode (S <= T): the CTA's X slice and U
//   slice are copied into shared memory once (cp.async) and stay there for
//   all sweeps, so X is read from device memory once per launch. Streamed
//   mode (S > T, T <= 256): X goes through a two-stage cp.async ring of
//   T-row tiles, the next tile loading while the current one is computed; U
//   stays in the output buffer. C depends on the shape only, never on the
//   batch, so image b's result depends only on image b's inputs.
// - X rows sit in shared memory with their 16 float4 chunks XOR-swizzled by
//   (row & 7), so both the row-per-thread reads of step 1 and the
//   column-per-lane reads of step 2 are free of bank conflicts.
// - Step 1 (A = X V, then the Gauss-Seidel chain of each row): a thread
//   owns up to three rows (t, t + 256, t + 512; two at R > 16, where three
//   rows' A and U would not fit in registers), holds their A and U rows in
//   registers, and uses each V value it loads for every row it owns. The
//   chain over r stays serial per row; rows run in parallel.
// - Step 2 (the CTA's partial X^T U and U^T U): each warp owns fixed rows.
//   At R <= 16 a lane owns 8 (R <= 8) or 4 columns of X for all R outputs,
//   so every X value it loads feeds R FMAs, and one row of U^T U; a shuffle
//   reduce-scatter combines a warp's row groups (each lane keeps two of its
//   column sets). At R > 16 a warp takes one row at a time: lane l owns
//   columns 2l and 2l + 1 of X and row l of U^T U (l < R), reads the U row
//   as float4s (U rows at a stride of round4(R) there), and needs no
//   shuffle. Then a fixed tree through shared memory adds the 8 warps, with
//   all 32 lanes storing consecutive words.
// - After cluster.sync(), every CTA reads the C partials through
//   distributed shared memory (mapa + ld.shared::cluster.v4, eight ranks
//   in flight at once) and adds them in rank order 0..C-1, then runs the V
//   update and V^T V itself. All copies of V stay bitwise equal without a
//   broadcast. The partials are double-buffered by sweep parity, so one
//   cluster barrier per sweep suffices. No atomics: every run gives the
//   same bits.
//
// What still bounds it (PERF.md, from lrf_tpu_torch/tools/
// bcd_kernel_phases.py): with one 227 KB CTA per SM there are 8 warps per
// SM, and steps 1 and 2 run at about half their issue rate; the per-sweep
// reduction (warp tree, cluster barrier, cluster sum, V update) is about a
// third of a sweep at the bench shapes; and 15 clusters of 8 fit at once, so
// 64 images take 5 waves. At the q40 Y stack (M = 6144, R = 26, 16 CTAs) the
// per-sweep part is 42% of the cycles: every CTA reads all 16 partials
// (9.4 KB each) for its cluster sum, and 64 threads run the V update's
// R^2-long Gauss-Seidel chains while the rest wait. At most ranks from 20
// up ptxas spills 36-488 bytes at 255 registers.
//
// The including source defines LRF_BCDC_MIN_RANK, LRF_BCDC_MAX_RANK and
// LRF_FOR_EACH_RANK(X) (X applied to every rank of its range) first.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 64;            // columns of X: one 8x8 patch
constexpr int kChunks = kN / 4;   // float4 chunks per row of X
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinRank = LRF_BCDC_MIN_RANK;
constexpr int kMaxRank = LRF_BCDC_MAX_RANK;
constexpr int kMaxCluster = 16;
constexpr float kEps = 1e-16f;
static_assert(1 <= kMinRank && kMinRank <= kMaxRank && kMaxRank <= 32, "ranks 1..32 only");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// Stride of a U row in shared memory: R, or round4(R) at R > 16 so that
// step 2 reads U rows as float4s.
__host__ __device__ constexpr int u_stride(int R) { return R <= 16 ? R : round4(R); }
// Stride of a U^T U row in a partial: the lanes of a row group at R <= 16
// (8 or 16, of which the first R hold a row), R at R > 16.
__host__ __device__ constexpr int g_stride(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : R; }

// Phase timer, compiled in only with -DLRF_BCDC_PROFILE (for
// lrf_tpu_torch/tools/bcd_kernel_phases.py): thread 0 of every CTA adds the
// clock64 cycles of each phase (all threads meet at a barrier at each mark).
#ifdef LRF_BCDC_PROFILE
constexpr int kPhases = 7;  // load, step 1, step 2, warp tree, cluster barrier, cluster sum, V update
__device__ unsigned long long g_phase_cycles[kPhases + 1];
struct PhaseTimer {
  long long last = 0, acc[kPhases] = {};
  __device__ void start() { if (threadIdx.x == 0) last = clock64(); }
  __device__ void mark(int k) {
    if (threadIdx.x == 0) { const long long t = clock64(); acc[k] += t - last; last = t; }
  }
  __device__ void flush() {
    if (threadIdx.x != 0) return;
    for (int k = 0; k < kPhases; ++k) atomicAdd(&g_phase_cycles[k], (unsigned long long)acc[k]);
    atomicAdd(&g_phase_cycles[kPhases], 1ull);
  }
};
#else
struct PhaseTimer {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

// Shared-memory layout in floats; every region starts on 16 bytes. The
// layout depends only on (S, T, R), so it is the same in every CTA of a
// cluster, as distributed shared memory needs. ops/bcd_kernel.py::
// cluster_smem_bytes computes the same total.
struct Layout {
  int rv, ps;
  int xs, us, v, gv, part, slots, total;
  __host__ __device__ Layout(int S, int T, int R) {
    rv = round4(R);                             // V row stride: float4 reads of a V row
    ps = round4(kN * R + R * g_stride(R));      // one partial (see canonical_index)
    const int tile = S <= T ? S : T;
    const int nbuf = S <= T ? 1 : 2;  // X and U tiles
    xs = 0;
    us = xs + nbuf * tile * kN;
    v = us + round4(nbuf * tile * u_stride(R));  // U rows at stride u_stride(R)
    gv = v + kN * rv;
    part = gv + round4(R * R);          // 2 partials, by sweep parity
    slots = part + 2 * ps;              // kWarps/2 tree slots; slot 0 is
    total = slots + (kWarps / 2) * ps;  // also the cluster sum
  }
};

__device__ __forceinline__ float project(float num, float den, float lo, float hi) {
  const float q = rintf((num + kEps) / (den + kEps));
  return fminf(fmaxf(q, lo), hi);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// A float4 of another CTA's shared memory: `addr` is the local
// shared-memory address, `rank` the CTA in the cluster.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// Chunk c of row i of an X tile (swizzled).
__device__ __forceinline__ float4 x_chunk(const float* xs, int i, int c) {
  return reinterpret_cast<const float4*>(xs + i * kN)[c ^ (i & 7)];
}

// Copy `rows` rows of X from global memory into a swizzled tile.
__device__ __forceinline__ void load_x_tile(float* xs, const float* X, int rows) {
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int i = e / kChunks, c = e % kChunks;
    cp_async16(xs + i * kN + 4 * (c ^ (i & 7)), X + (size_t)i * kN + 4 * c);
  }
  cp_async_commit();
}

// The Gauss-Seidel chain of RB rows with the same Gram G (R x R).
template <int R, int RB>
__device__ __forceinline__ void gs_rows(float (&u)[RB][R], const float (&a)[RB][R], const float* G,
                                        float lo, float hi) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) t[j] = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float g = G[k * R + r];
#pragma unroll
      for (int j = 0; j < RB; ++j) t[j] += u[j][k] * g;
    }
    const float grr = G[r * R + r];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      t[j] -= u[j][r] * grr;
      u[j][r] = project(a[j][r] - t[j], grr, lo, hi);
    }
  }
}

// Step 1 for RB rows `rows` of the current tile: A = X V, then the rows'
// Gauss-Seidel chains. U comes from `ug` (global, streamed mode) or from the
// tile's `us`; the result goes to `us` and, when streamed, back to `ug`.
template <int R, int RB>
__device__ __forceinline__ void update_rows(const float* xs, float* us, float* ug, const int (&rows)[RB],
                                            const float* V, const float* G, int rv,
                                            float lo, float hi) {
  constexpr int US = u_stride(R);
  float a[RB][R];
#pragma unroll
  for (int j = 0; j < RB; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) a[j][r] = 0.f;
  // Unrolled twice at R <= 16; at R > 16 the unrolled loop measured slower.
#pragma unroll (R > 16 ? 1 : 2)
  for (int c = 0; c < kChunks; ++c) {
    float4 xv[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) xv[j] = x_chunk(xs, rows[j], c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4* vrow = reinterpret_cast<const float4*>(V + (4 * c + e) * rv);
      float vv[round4(R)];
#pragma unroll
      for (int q = 0; q < round4(R) / 4; ++q) {
        const float4 t = vrow[q];
        vv[4 * q] = t.x; vv[4 * q + 1] = t.y; vv[4 * q + 2] = t.z; vv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const float xe = e == 0 ? xv[j].x : e == 1 ? xv[j].y : e == 2 ? xv[j].z : xv[j].w;
#pragma unroll
        for (int r = 0; r < R; ++r) a[j][r] += xe * vv[r];
      }
    }
  }
  float u[RB][R];
#pragma unroll
  for (int j = 0; j < RB; ++j)
#pragma unroll
    for (int k = 0; k < R; ++k) u[j][k] = ug ? ug[rows[j] * R + k] : us[rows[j] * US + k];
  gs_rows<R, RB>(u, a, G, lo, hi);
#pragma unroll
  for (int j = 0; j < RB; ++j)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      us[rows[j] * US + k] = u[j][k];
      if (ug) ug[rows[j] * R + k] = u[j][k];
    }
}

// Step 2 lane geometry: a lane owns CPL columns of X; LPR lanes cover one
// row; a warp takes RPS rows per step. RB is the most rows a thread takes
// at once in step 1.
template <int R>
struct Cols {
  static constexpr bool kWide = R > 16;
  static constexpr int CPL = R <= 8 ? 8 : R <= 16 ? 4 : 2;
  static constexpr int LPR = kN / CPL;
  static constexpr int RPS = 32 / LPR;
  static constexpr int RB = kWide ? 2 : 3;
};

// Step 2 over the rows of one tile: this warp's rows are added, in order,
// into the lane's X^T U columns (acc) and its U^T U row (gacc).
template <int R>
__device__ __forceinline__ void accumulate(const float* xs, const float* us, int rows, int warp,
                                           int lane, float (&acc)[Cols<R>::CPL][R], float (&gacc)[R]) {
  using L = Cols<R>;
  constexpr int US = u_stride(R);
  if constexpr (L::kWide) {
    // One row per warp step: lane l takes columns 2l, 2l + 1 (half of chunk
    // l / 2) and, for l < R, row l of U^T U.
    const int half = 2 * (lane & 1);
#pragma unroll 2
    for (int m = warp; m < rows; m += kWarps) {
      const float2 x = *reinterpret_cast<const float2*>(xs + m * kN + 4 * ((lane >> 1) ^ (m & 7)) + half);
      const float4* ur = reinterpret_cast<const float4*>(us + m * US);
      float uu[US];
#pragma unroll
      for (int q = 0; q < US / 4; ++q) {
        const float4 t = ur[q];
        uu[4 * q] = t.x; uu[4 * q + 1] = t.y; uu[4 * q + 2] = t.z; uu[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[0][k] += x.x * uu[k];
        acc[1][k] += x.y * uu[k];
      }
      if (lane < R) {
        const float ui = us[m * US + lane];
#pragma unroll
        for (int k = 0; k < R; ++k) gacc[k] += ui * uu[k];
      }
    }
  } else {
    const int q = lane / L::LPR, c = lane % L::LPR;
#pragma unroll 2
    for (int m = warp * L::RPS + q; m < rows; m += kWarps * L::RPS) {
      float x[L::CPL];
#pragma unroll
      for (int h = 0; h < L::CPL / 4; ++h) {
        const float4 t = x_chunk(xs, m, c + h * L::LPR);
        x[4 * h] = t.x; x[4 * h + 1] = t.y; x[4 * h + 2] = t.z; x[4 * h + 3] = t.w;
      }
      const float* ur = us + m * US;
      float uu[R];
#pragma unroll
      for (int k = 0; k < R; ++k) uu[k] = ur[k];
#pragma unroll
      for (int j = 0; j < L::CPL; ++j)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[j][k] += x[j] * uu[k];
      if (c < R) {
        const float ui = ur[c];
#pragma unroll
        for (int k = 0; k < R; ++k) gacc[k] += ui * uu[k];
      }
    }
  }
}

// After a warp's row groups are reduced, lane (q, c) holds two of its
// column group's accumulator sets, j = 2q and 2q + 1 (`reduce_scatter`); at
// R > 16, lane l holds columns 2l and 2l + 1. A partial in shared memory
// stores entry (i, k) of those at (i*R + k)*32 + lane, so a warp's store or
// load touches 32 consecutive words, then U^T U row c at
// 64*R + k*g_stride(R) + c. `canonical_index` maps a position p of a
// partial to the index in X^T U row-major (64, R) followed by U^T U
// row-major (R, R), or -1 where nothing is stored.
template <int R>
__device__ __forceinline__ int canonical_index(int p) {
  using L = Cols<R>;
  constexpr int GS = g_stride(R);
  if (p < 2 * R * 32) {
    const int lane = p % 32, i = (p / 32) / R, k = (p / 32) % R;
    if constexpr (L::kWide) return (2 * lane + i) * R + k;
    const int q = lane / L::LPR, c = lane % L::LPR, j = 2 * q + i;
    return (4 * (c + (j / 4) * L::LPR) + j % 4) * R + k;
  }
  const int k = (p - 2 * R * 32) / GS, c = (p - 2 * R * 32) % GS;
  return (c < R && k < R) ? kN * R + c * R + k : -1;
}

// Sums the lane's X^T U accumulators over the warp's row groups, leaving
// lane (q, c) the sums of j = 2q + i (i = 0, 1) in h, and every lane the
// sum of its U^T U row. Each add pairs the same two values in both lanes,
// so all lanes agree bit for bit. At R > 16 a warp has one row group, so
// there is nothing to add.
template <int R>
__device__ __forceinline__ void reduce_scatter(const float (&acc)[Cols<R>::CPL][R], float (&gacc)[R],
                                               float (&h)[2][R], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (Cols<R>::kWide) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) h[i][k] = acc[i][k];
  } else if constexpr (Cols<R>::CPL == 8) {  // four row groups: q = lane / 8
    const bool hi16 = lane & 16, hi8 = lane & 8;
    float h4[4][R];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float keep = hi16 ? acc[jj + 4][k] : acc[jj][k];
        const float send = hi16 ? acc[jj][k] : acc[jj + 4][k];
        h4[jj][k] = keep + __shfl_xor_sync(kAll, send, 16);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float keep = hi8 ? h4[i + 2][k] : h4[i][k];
        const float send = hi8 ? h4[i][k] : h4[i + 2][k];
        h[i][k] = keep + __shfl_xor_sync(kAll, send, 8);
      }
  } else {  // two row groups: q = lane / 16
    const bool hi16 = lane & 16;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float keep = hi16 ? acc[i + 2][k] : acc[i][k];
        const float send = hi16 ? acc[i][k] : acc[i + 2][k];
        h[i][k] = keep + __shfl_xor_sync(kAll, send, 16);
      }
  }
  if constexpr (!Cols<R>::kWide) {
#pragma unroll
    for (int off = Cols<R>::LPR; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < R; ++k) gacc[k] += __shfl_xor_sync(kAll, gacc[k], off);
  }
}

template <int R>
__device__ __forceinline__ void store_partial(float* dst, int lane, const float (&h)[2][R],
                                              const float (&gacc)[R]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) dst[(i * R + k) * 32 + lane] = h[i][k];
  if (lane < R) {
#pragma unroll
    for (int k = 0; k < R; ++k) dst[2 * R * 32 + k * g_stride(R) + lane] = gacc[k];
  }
}

template <int R>
__device__ __forceinline__ void add_partial(const float* src, int lane, float (&h)[2][R], float (&gacc)[R]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) h[i][k] += src[(i * R + k) * 32 + lane];
  if (lane < R) {
#pragma unroll
    for (int k = 0; k < R; ++k) gacc[k] += src[2 * R * 32 + k * g_stride(R) + lane];
  }
}

// V^T V (R x R) into G, from V (64 rows at stride rv), one entry per thread
// in turn. With `split`, four chains over n mod 4, added as
// (s0 + s1) + (s2 + s3): a quarter of the latency. The caller splits only
// where the order cannot matter: V integer (after a V update) within bounds
// of magnitude <= 2^9, so that every partial sum of 64 products stays an
// integer below 2^24 and is exact in f32.
template <int R>
__device__ __forceinline__ void gram_v(float* G, const float* V, int rv, bool split) {
  for (int e = threadIdx.x; e < R * R; e += kThreads) {
    const int i = e / R, j = e % R;
    if (!split) {
      float s = 0.f;
      for (int n = 0; n < kN; ++n) s += V[n * rv + i] * V[n * rv + j];
      G[e] = s;
      continue;
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int n = 0; n < kN; n += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += V[(n + q) * rv + i] * V[(n + q) * rv + j];
    }
    G[e] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// Step 1 over the rows of one tile: thread t takes rows t, t + kThreads,
// ... RBMax at a time while that many exist, then fewer.
template <int R, int RBMax>
__device__ __forceinline__ void step1_tile(const float* xt, float* ut, float* ug, int rows, const float* V,
                                           const float* Gv, int rv, float lo, float hi) {
  static_assert(RBMax >= 1 && RBMax <= 3, "one to three rows per thread");
  int m = threadIdx.x;
  if constexpr (RBMax == 3) {
    for (; m + 2 * kThreads < rows; m += 3 * kThreads) {
      const int rr[3] = {m, m + kThreads, m + 2 * kThreads};
      update_rows<R, 3>(xt, ut, ug, rr, V, Gv, rv, lo, hi);
    }
  }
  if constexpr (RBMax >= 2) {
    for (; m + kThreads < rows; m += 2 * kThreads) {
      const int rr[2] = {m, m + kThreads};
      update_rows<R, 2>(xt, ut, ug, rr, V, Gv, rv, lo, hi);
    }
  }
  for (; m < rows; m += kThreads) {
    const int rr[1] = {m};
    update_rows<R, 1>(xt, ut, ug, rr, V, Gv, rv, lo, hi);
  }
}

// The end of a sweep: the CTA's partial from the lanes' accumulators, the
// cluster's sum of the partials, the V update and V^T V for the next sweep.
template <int R>
__device__ __forceinline__ void finish_sweep(cg::cluster_group& cluster, int C, int it,
                                             const float (&acc)[Cols<R>::CPL][R], float (&gacc)[R],
                                             float* part, float* slots, float* V, float* Gv, int ps, int rv,
                                             float lo, float hi, PhaseTimer& prof) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // ---- the row groups of a warp, then the warps by a fixed tree ----
  float h[2][R];
  reduce_scatter<R>(acc, gacc, h, lane);
  for (int n = kWarps; n > 1;) {
    const int half = (n + 1) / 2;
    if (warp >= half && warp < n) store_partial<R>(slots + (warp - half) * ps, lane, h, gacc);
    __syncthreads();
    if (warp < n - half) add_partial<R>(slots + warp * ps, lane, h, gacc);
    __syncthreads();
    n = half;
  }
  float* mine = part + (it & 1) * ps;
  if (warp == 0) store_partial<R>(mine, lane, h, gacc);
  __syncthreads();
  prof.mark(3);

  // ---- the cluster's sum, in rank order, in every CTA ----
  cluster.sync();
  prof.mark(4);
  float* AG = slots;  // reuses tree slot 0
  const uint32_t mine_addr = static_cast<uint32_t>(__cvta_generic_to_shared(mine));
  for (int g = tid; g < ps / 4; g += kThreads) {
    // Eight remote loads in flight at once; the sum runs in rank order.
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < C; k0 += 8) {
      float4 val[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k0 + k < C) val[k] = ld_cluster4(mine_addr + 16 * g, k0 + k);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k0 + k < C) {
          if (k0 + k == 0) {
            sum = val[0];
          } else {
            sum.x += val[k].x; sum.y += val[k].y; sum.z += val[k].z; sum.w += val[k].w;
          }
        }
    }
    const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = canonical_index<R>(4 * g + e);
      if (i >= 0) AG[i] = sv[e];
    }
  }
  __syncthreads();
  prof.mark(5);

  // ---- step 3: V rows, then V^T V for the next sweep ----
  if (tid < kN) {
    float vr[1][R], av[1][R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      vr[0][k] = V[tid * rv + k];
      av[0][k] = AG[tid * R + k];
    }
    gs_rows<R, 1>(vr, av, AG + kN * R, lo, hi);
#pragma unroll
    for (int k = 0; k < R; ++k) V[tid * rv + k] = vr[0][k];
  }
  __syncthreads();
  gram_v<R>(Gv, V, rv, fmaxf(fabsf(lo), fabsf(hi)) <= 512.f);
  __syncthreads();
  prof.mark(6);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bcd_cluster_kernel(const float* __restrict__ x, float* __restrict__ u, float* __restrict__ v, int M,
                   int S, int T, int num_iters, float lo, float hi) {
  using L = Cols<R>;
  constexpr int US = u_stride(R);
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = rank * S;
  const int rows = max(0, min(S, M - m0));
  const bool resident = S <= T;
  const int tile = resident ? S : T;
  const int nt = (rows + tile - 1) / tile;

  const Layout lay(S, T, R);
  float* xs = smem + lay.xs;
  float* us = smem + lay.us;
  float* V = smem + lay.v;
  float* Gv = smem + lay.gv;
  float* part = smem + lay.part;
  float* slots = smem + lay.slots;
  const int rv = lay.rv, ps = lay.ps;
  const int xbuf = tile * kN, ubuf = tile * US;
  PhaseTimer prof;
  prof.start();

  const float* X = x + (b * M + m0) * kN;
  float* U = u + (b * M + m0) * R;
  float* Vg = v + b * kN * R;

  if (resident && rows > 0) {
    load_x_tile(xs, X, rows);
    for (int e = tid; e < rows * R; e += kThreads) us[(e / R) * US + e % R] = U[e];
  }
  for (int e = tid; e < kN * R; e += kThreads) V[(e / R) * rv + e % R] = Vg[e];
  __syncthreads();
  gram_v<R>(Gv, V, rv, false);  // V0 is real-valued: keep the plain order
  if (resident) cp_async_wait_all();
  __syncthreads();
  prof.mark(0);

  for (int it = 0; it < num_iters; ++it) {
    float acc[L::CPL][R], gacc[R];
    if (resident) {
      step1_tile<R, L::RB>(xs, us, nullptr, rows, V, Gv, rv, lo, hi);
      __syncthreads();
      prof.mark(1);
#pragma unroll
      for (int j = 0; j < L::CPL; ++j)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[j][k] = 0.f;
#pragma unroll
      for (int k = 0; k < R; ++k) gacc[k] = 0.f;
      accumulate<R>(xs, us, rows, warp, lane, acc, gacc);
      __syncthreads();
      prof.mark(2);
    } else {
#pragma unroll
      for (int j = 0; j < L::CPL; ++j)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[j][k] = 0.f;
#pragma unroll
      for (int k = 0; k < R; ++k) gacc[k] = 0.f;
      if (it == 0 && nt > 0) load_x_tile(xs, X, min(tile, rows));
      for (int t = 0; t < nt; ++t) {
        const int bi = t & 1;
        const int rows_t = min(tile, rows - t * tile);
        float* xt = xs + bi * xbuf;
        float* ut = us + bi * ubuf;
        if (t + 1 < nt) {
          load_x_tile(xs + (bi ^ 1) * xbuf, X + (size_t)(t + 1) * tile * kN, min(tile, rows - (t + 1) * tile));
          cp_async_wait_one();
        } else {
          cp_async_wait_all();
        }
        __syncthreads();
        prof.mark(0);
        // A tile has at most kThreads rows (the launch checks T), so one row
        // per thread: the accumulators stay live here, and fewer registers
        // go to step 1.
        step1_tile<R, 1>(xt, ut, U + (size_t)t * tile * R, rows_t, V, Gv, rv, lo, hi);
        __syncthreads();
        prof.mark(1);
        accumulate<R>(xt, ut, rows_t, warp, lane, acc, gacc);
        __syncthreads();
        prof.mark(2);
        // The first tile of the next sweep loads while the partials combine.
        if (t + 1 == nt && it + 1 < num_iters) load_x_tile(xs, X, min(tile, rows));
      }
    }
    finish_sweep<R>(cluster, C, it, acc, gacc, part, slots, V, Gv, ps, rv, lo, hi, prof);
  }
  prof.flush();

  if (resident) {
    for (int e = tid; e < rows * R; e += kThreads) U[e] = us[(e / R) * US + e % R];
  }
  if (rank == 0) {
    for (int e = tid; e < kN * R; e += kThreads) Vg[e] = V[(e / R) * rv + e % R];
  }
  // No CTA leaves while another may still read its partials.
  cluster.sync();
}

template <int R>
cudaError_t configure(int C, size_t smem_bytes, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(bcd_cluster_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(bcd_cluster_kernel<R>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int R>
cudaError_t launch(const float* x, float* u, float* v, int B, int M, int C, int S, int T, int num_iters,
                   float lo, float hi, size_t smem_bytes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<R>(C, smem_bytes, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((unsigned)(B * C), 1, 1);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, bcd_cluster_kernel<R>, x, u, v, M, S, T, num_iters, lo, hi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R>
cudaError_t max_active(int C, size_t smem_bytes, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<R>(C, smem_bytes, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((unsigned)C, 1, 1);
  return cudaOccupancyMaxActiveClusters(out, bcd_cluster_kernel<R>, &cfg);
}

}  // namespace

extern "C" {

int lrf_bcdc_threads() { return kThreads; }
int lrf_bcdc_min_rank() { return kMinRank; }
int lrf_bcdc_max_rank() { return kMaxRank; }
int lrf_bcdc_max_cluster() { return kMaxCluster; }
// Bytes of shared memory a CTA takes for S rows of X, T-row tiles, rank R.
long long lrf_bcdc_smem_bytes(int S, int T, int R) { return 4ll * Layout(S, T, R).total; }

// x (B, M, 64); u (B, M, R) and v (B, 64, R) hold the init and are updated
// in place. C CTAs per image (a cluster), S rows of X per CTA, T rows per
// tile (S <= T: X resident; else T <= kThreads). Returns the CUDA error code
// (0 on success).
int lrf_bcdc_launch(const float* x, float* u, float* v, int B, int M, int R, int C, int S, int T,
                    int num_iters, float lo, float hi, size_t smem_bytes, void* stream) {
  if (R < kMinRank || R > kMaxRank || C < 1 || C > kMaxCluster || (size_t)C * S < (size_t)M ||
      (S > T && (T < 1 || T > kThreads)) || smem_bytes < 4 * (size_t)Layout(S, T, R).total ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
#define LRF_CASE(RR) \
  case RR:           \
    return (int)launch<RR>(x, u, v, B, M, C, S, T, num_iters, lo, hi, smem_bytes, s);
    LRF_FOR_EACH_RANK(LRF_CASE)
#undef LRF_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of C CTAs with this shared memory fit on the device at once.
int lrf_bcdc_max_active_clusters(int R, int C, size_t smem_bytes, int* out) {
  switch (R) {
#define LRF_CASE(RR) \
  case RR:           \
    return (int)max_active<RR>(C, smem_bytes, out);
    LRF_FOR_EACH_RANK(LRF_CASE)
#undef LRF_CASE
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef LRF_BCDC_PROFILE
// Copies the phase cycle sums (kPhases of them, then the CTA count) to
// `out` and resets them.
int lrf_bcdc_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[kPhases + 1] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

const char* lrf_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
