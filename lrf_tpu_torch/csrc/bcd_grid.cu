// QMF block-coordinate-descent sweeps for Hopper (sm_90a), one image split
// over many thread blocks.
//
// Replaces, for every shape the cluster kernels of bcd_cluster.cuh do not
// take (N != 64, or R > 32: RGB patches, the no-patch codec, quality above
// 50), the three Pallas TPU kernels of lrf_tpu/ops/bcd_pallas.py, which all
// compute one function: `num_iters` projected Gauss-Seidel sweeps, each a U
// update followed by a V update.
//   K1  _bcd_resident_kernel (launched by bcd_pallas, X resident in VMEM)
//   K2  _bcd_stream_kernel   (launched by bcd_pallas, X streamed in M-tiles)
//   K3  _legacy_bcd_kernel   (launched by _bcd_pallas_legacy, M >= 16384)
//
// Function (that of bcd.cu). For image b with X (M, N), U (M, R), V (N, R),
// each sweep does
//   B = V^T V;  for every row m of U, with a = X[m, :] V, for r = 0..R-1:
//     u_r <- clip(rint(((a_r - (U[m,:] B[:, r] - u_r B[r, r])) + 1e-16)
//                      / (B[r, r] + 1e-16)), lo, hi)
//   then the same rule for every row n of V with a = (X^T U)[n, :], B = U^T U.
// rintf rounds half to even, like torch.round. The division is IEEE (the
// library must not be built with --use_fast_math).
//
// Design. R is a run-time argument: one instance takes every rank. Each
// half-sweep is a grid-wide phase, and one call of lrf_bcdg_launch issues a
// fixed sequence of four launches per sweep on the caller's stream:
//   1. gram:    V^T V per image, one thread per entry, a sequential sum over n;
//   2. u_phase: a grid over (M tile, image). The tile height T comes from
//      (M, N, R) alone, never from B, so an image's result does not depend
//      on its batch. A CTA holds its X tile in shared memory and computes
//      the residual D = X_tile V - U_tile (V^T V) (V streamed through shared
//      memory in 32 x 64 chunks). It runs the R Gauss-Seidel steps of its U
//      rows, several rows at once with a group of lanes per row: step r
//      reads d_r, projects, and, where u_r moved by delta, the group takes
//      delta * B[r, k] off d_k for k > r. So the R-long dot product of the
//      plain rule is kept up to date instead of summed again each step, no
//      lane reduction is needed, and every thread works. The CTA writes its
//      U rows back and its tile's partials of X^T U (N x R) and U^T U
//      (R x R) to a global scratch;
//   3. reduce:  the partials summed over tiles, in tile order;
//   4. v_phase: 16 V rows per CTA, the same residual and Gauss-Seidel steps
//      from the reduced X^T U rows and U^T U.
// There are no atomics: every sum has a fixed order, so every run gives the
// same bits. On integer X with integer factors every sum is an exact integer
// while its magnitude stays below 2^24, and then the result equals the plain
// version's bit for bit whatever the order. V^T V sits in shared memory when
// it fits beside the tile, else it is read from the scratch (through L1).
// The wrapper allocates the scratch; the kernels allocate nothing.
//
// What bounds it on an H100. Per sweep an image costs about 4(MNR + MR^2 +
// NR^2) f32 flops and one read of X; the all-card bound is the f32 rate at
// every shape the plan gives this kernel. This version spreads an image
// over ceil(M / T) SMs (T = 64 rows, shorter for short stacks so that an
// image fills at least 16 CTAs), reads X from L2/HBM once per sweep and
// pays four launches per sweep, writes and reads its tile partials through
// L2/HBM, and its Gauss-Seidel steps are a chain of R dependent
// projections per row. PERF.md holds its times.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;    // output block of the tile products (4 x 4 per thread)
constexpr int kChunk = 32;    // rows of V staged per step of A = X V
constexpr int kVRows = 16;    // V rows per v_phase CTA, kThreads / kVRows lanes each
constexpr float kEps = 1e-16f;

__device__ __forceinline__ float project(float num, float den, float lo, float hi) {
  const float q = rintf((num + kEps) / (den + kEps));
  return fminf(fmaxf(q, lo), hi);
}

// Lanes per factor row in the Gauss-Seidel steps: the largest power of two
// up to 32 with rows * lanes <= kThreads, so every thread has work.
__device__ inline int group_lanes(int rows) {
  int g = 32;
  while (g > 1 && g * rows > kThreads) g >>= 1;
  return g;
}

// The R Gauss-Seidel steps of up to kThreads / g factor rows at once, g
// lanes per row. Row t holds its factor entries f[t * rs + k] and its
// residual d[t * rs + k] = a_k - sum_j f_j G[j][k] (current f). Step r:
//   f_r <- project(d_r + f_r G[r][r], G[r][r]),
// and with delta = new - old f_r, d_k -= delta G[r][k] for k > r, the g lanes
// taking every g-th k. This is the plain rule's
//   a_r - (f G[:, r] - f_r G[r][r])
// with the dot product kept up to date instead of summed again each step
// (G is symmetric). Every thread of the block calls it.
__device__ void gauss_seidel(float* f, float* d, int rs, int rows, const float* G, int R, float lo,
                             float hi) {
  const int g = group_lanes(rows);
  const int groups = kThreads / g, lig = threadIdx.x % g;
  const int warp_first = (threadIdx.x / 32) * (32 / g);  // first group of this warp
  for (int t0 = 0; t0 < rows; t0 += groups) {
    if (t0 + warp_first >= rows) break;  // warp-uniform: no row of this warp is left
    const int t = t0 + threadIdx.x / g;
    const bool active = t < rows;
    float* fr = f + (size_t)(active ? t : 0) * rs;
    float* dr = d + (size_t)(active ? t : 0) * rs;
    for (int r = 0; r < R; ++r) {
      float q = 0.f;
      if (active) {
        const float* gr = G + (size_t)r * R;
        const float grr = gr[r], old = fr[r];
        q = project(__fadd_rn(dr[r], __fmul_rn(old, grr)), grr, lo, hi);
        const float delta = __fsub_rn(q, old);
        if (delta != 0.f) {
          for (int k = r + 1 + lig; k < R; k += g) dr[k] = fmaf(-delta, gr[k], dr[k]);
        }
      }
      __syncwarp();  // every lane has read f_r and d_r, and d_{r+1} is up to date
      if (active && lig == 0) fr[r] = q;
    }
  }
}

// C(i, j) = sum_k fa(k, i) * fb(k, j) over k = 0..K-1 in order, for i < I,
// j < J, handed to fc(i, j, value). Every thread of the block takes part;
// each owns a 4 x 4 micro-tile of each 64 x 64 output block (the same
// thread for the same (i, j) in every call).
template <class FA, class FB, class FC>
__device__ __forceinline__ void block_product(int I, int J, int K, FA fa, FB fb, FC fc) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int i0 = 0; i0 < I; i0 += kBlock) {
    for (int j0 = 0; j0 < J; j0 += kBlock) {
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int i = i0 + ty + 16 * p;
          av[p] = i < I ? fa(k, i) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx + 16 * q;
          bv[q] = j < J ? fb(k, j) : 0.f;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + ty + 16 * p, j = j0 + tx + 16 * q;
          if (i < I && j < J) fc(i, j, acc[p][q]);
        }
    }
  }
}

// Shared memory of u_phase, in floats: the X tile (T rows at odd stride
// N | 1), the U and residual tiles (T rows at odd stride R | 1), one staged
// chunk of V, and V^T V when it sits in shared memory.
__host__ __device__ inline size_t u_smem_floats(int T, int N, int R, int g_smem) {
  return (size_t)T * (N | 1) + 2 * (size_t)T * (R | 1) + kChunk * kBlock + (g_smem ? (size_t)R * R : 0);
}

// Rows of V per staged chunk of gram_kernel: kGramFloats floats at most.
constexpr int kGramFloats = 8192;
__host__ __device__ inline int gram_chunk(int R) { return R >= kGramFloats ? 1 : min(64, kGramFloats / R); }

// V^T V, one thread per entry, each a sequential sum over n in order (the
// order of the plain version's product at these depths, which the float
// init's first sweep is sensitive to); V is staged through shared memory in
// chunks of rows so the loads of a chunk are in flight together.
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ v, float* __restrict__ g, int N, int R) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int i = min(e, R * R - 1) / R, j = min(e, R * R - 1) % R;
  const float* V = v + b * N * R;
  const int kc = gram_chunk(R);
  float s = 0.f;
  for (int n0 = 0; n0 < N; n0 += kc) {
    const int rows = min(kc, N - n0);
    __syncthreads();
    for (int t = threadIdx.x; t < rows * R; t += kThreads) smem[t] = V[(size_t)n0 * R + t];
    __syncthreads();
    for (int n = 0; n < rows; ++n) s = fmaf(smem[n * R + i], smem[n * R + j], s);
  }
  if (e < R * R) g[b * R * R + e] = s;
}

__global__ void __launch_bounds__(kThreads)
u_phase_kernel(const float* __restrict__ x, float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ gv, float* __restrict__ part, int M, int N, int R, int T,
               int tiles, float lo, float hi, int g_smem) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.y;
  const int tile = blockIdx.x;
  const int m0 = tile * T, rows = min(T, M - m0);
  const int xs = N | 1, rs = R | 1;
  const float* X = x + b * M * N + (size_t)m0 * N;
  float* U = u + b * M * R + (size_t)m0 * R;
  const float* V = v + b * N * R;
  float* P = part + (b * tiles + tile) * ((size_t)N * R + (size_t)R * R);

  float* Xs = smem;
  float* Us = Xs + (size_t)T * xs;
  float* Ds = Us + (size_t)T * rs;
  float* Vs = Ds + (size_t)T * rs;
  const float* G = gv + b * R * R;
  if (g_smem) {
    float* Gs = Vs + kChunk * kBlock;
    for (int i = tid; i < R * R; i += kThreads) Gs[i] = G[i];
    G = Gs;
  }
  for (int i = tid; i < rows * N; i += kThreads) Xs[(i / N) * xs + i % N] = X[i];
  for (int i = tid; i < rows * R; i += kThreads) Us[(i / R) * rs + i % R] = U[i];

  // A = X_tile V, V staged through shared memory in kChunk x kBlock pieces.
  {
    const int tx = tid & 15, ty = tid >> 4;
    for (int j0 = 0; j0 < R; j0 += kBlock) {
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
      for (int k0 = 0; k0 < N; k0 += kChunk) {
        __syncthreads();
        for (int i = tid; i < kChunk * kBlock; i += kThreads) {
          const int kk = i / kBlock, jj = i % kBlock;
          Vs[i] = (k0 + kk < N && j0 + jj < R) ? V[(size_t)(k0 + kk) * R + j0 + jj] : 0.f;
        }
        __syncthreads();
        const int kn = min(kChunk, N - k0);
        for (int kk = 0; kk < kn; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int i = ty + 16 * p;
            av[p] = i < rows ? Xs[i * xs + k0 + kk] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Vs[kk * kBlock + tx + 16 * q];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ty + 16 * p, j = j0 + tx + 16 * q;
          if (i < rows && j < R) Ds[i * rs + j] = acc[p][q];
        }
    }
  }
  __syncthreads();
  // The residual D = A - U (V^T V).
  block_product(
      rows, R, R, [&](int k, int i) { return Us[i * rs + k]; }, [&](int k, int j) { return G[(size_t)k * R + j]; },
      [&](int i, int j, float c) { Ds[i * rs + j] = __fsub_rn(Ds[i * rs + j], c); });
  __syncthreads();

  gauss_seidel(Us, Ds, rs, rows, G, R, lo, hi);
  __syncthreads();

  for (int i = tid; i < rows * R; i += kThreads) U[i] = Us[(i / R) * rs + i % R];
  // This tile's partials: X^T U (N x R), then U^T U (R x R).
  block_product(
      N, R, rows, [&](int k, int i) { return Xs[k * xs + i]; }, [&](int k, int j) { return Us[k * rs + j]; },
      [&](int i, int j, float c) { P[(size_t)i * R + j] = c; });
  float* Pu = P + (size_t)N * R;
  block_product(
      R, R, rows, [&](int k, int i) { return Us[k * rs + i]; }, [&](int k, int j) { return Us[k * rs + j]; },
      [&](int i, int j, float c) { Pu[(size_t)i * R + j] = c; });
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ part, float* __restrict__ red, int E, int tiles) {
  const size_t b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const float* p = part + b * tiles * (size_t)E + e;
  float s = 0.f;
#pragma unroll 8
  for (int t = 0; t < tiles; ++t) s += p[(size_t)t * E];
  red[b * E + e] = s;
}

// Shared memory of v_phase, in floats: the V and residual rows (odd stride
// R | 1), and U^T U when it sits there.
__host__ __device__ inline size_t v_smem_floats(int R, int g_smem) {
  return 2 * (size_t)kVRows * (R | 1) + (g_smem ? (size_t)R * R : 0);
}

// kVRows rows of V per CTA: the residual D = (X^T U) - V (U^T U) from the
// reduced sums, then the Gauss-Seidel steps.
__global__ void __launch_bounds__(kThreads)
v_phase_kernel(float* __restrict__ v, const float* __restrict__ red, int N, int R, float lo, float hi,
               int g_smem) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, rs = R | 1;
  const size_t b = blockIdx.y;
  const int n0 = blockIdx.x * kVRows, rows = min(kVRows, N - n0);
  const size_t E = (size_t)N * R + (size_t)R * R;
  const float* A = red + b * E + (size_t)n0 * R;
  const float* G = red + b * E + (size_t)N * R;
  float* Vg = v + b * N * R + (size_t)n0 * R;
  float* Vs = smem;
  float* Ds = Vs + kVRows * rs;
  if (g_smem) {
    float* Gs = Ds + kVRows * rs;
    for (int i = tid; i < R * R; i += kThreads) Gs[i] = G[i];
    G = Gs;
  }
  for (int i = tid; i < rows * R; i += kThreads) Vs[(i / R) * rs + i % R] = Vg[i];
  __syncthreads();
  block_product(
      rows, R, R, [&](int k, int i) { return Vs[i * rs + k]; }, [&](int k, int j) { return G[(size_t)k * R + j]; },
      [&](int i, int j, float c) { Ds[i * rs + j] = __fsub_rn(A[(size_t)i * R + j], c); });
  __syncthreads();
  gauss_seidel(Vs, Ds, rs, rows, G, R, lo, hi);
  __syncthreads();
  for (int i = tid; i < rows * R; i += kThreads) Vg[i] = Vs[(i / R) * rs + i % R];
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

int lrf_bcdg_threads() { return kThreads; }

// Dynamic shared memory of one u_phase CTA, in bytes (the wrapper's
// grid_smem_bytes must agree).
long long lrf_bcdg_smem_bytes(int T, int N, int R, int g_smem) {
  return (long long)(4 * u_smem_floats(T, N, R, g_smem));
}

// Floats of scratch per image: the tiles' partials, their sums, V^T V.
long long lrf_bcdg_scratch_floats(int M, int N, int R, int T) {
  const long long tiles = (M + T - 1) / T, e = (long long)N * R + (long long)R * R;
  return tiles * e + e + (long long)R * R;
}

// Largest dynamic shared memory a block of the current device may opt into.
int lrf_bcdg_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// x (B, M, N); u (B, M, R) and v (B, N, R) hold the init and are updated in
// place; scratch holds B * lrf_bcdg_scratch_floats(M, N, R, T) floats. T is
// the tile height; g_smem says whether V^T V sits in shared memory.
// Returns the first CUDA error of the launches (0 on success).
int lrf_bcdg_launch(const float* x, float* u, float* v, float* scratch, int B, int M, int N, int R,
                    int T, int num_iters, float lo, float hi, int g_smem, void* stream) {
  if (T < 1 || T > kBlock) return (int)cudaErrorInvalidValue;  // A = X V covers one 64-row block
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (M + T - 1) / T;
  const size_t E = (size_t)N * R + (size_t)R * R;
  float* part = scratch;
  float* red = part + (size_t)B * tiles * E;
  float* gv = red + (size_t)B * E;
  const size_t u_smem = 4 * u_smem_floats(T, N, R, g_smem);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // U^T U beside the V rows when it fits (it depends on R alone)
  const int v_g_smem = 4 * v_smem_floats(R, 1) <= (size_t)optin;
  const size_t v_smem = 4 * v_smem_floats(R, v_g_smem);
  const size_t g_smem_bytes = 4 * (size_t)gram_chunk(R) * R;
  err = allow_smem((const void*)u_phase_kernel, u_smem);
  if (err == cudaSuccess) err = allow_smem((const void*)gram_kernel, g_smem_bytes);
  if (err == cudaSuccess) err = allow_smem((const void*)v_phase_kernel, v_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 g_grid((R * R + kThreads - 1) / kThreads, B), u_grid(tiles, B);
  const dim3 r_grid((unsigned)((E + kThreads - 1) / kThreads), B), v_grid((N + kVRows - 1) / kVRows, B);
  for (int it = 0; it < num_iters; ++it) {
    gram_kernel<<<g_grid, kThreads, g_smem_bytes, s>>>(v, gv, N, R);
    u_phase_kernel<<<u_grid, kThreads, u_smem, s>>>(x, u, v, gv, part, M, N, R, T, tiles, lo, hi, g_smem);
    reduce_kernel<<<r_grid, kThreads, 0, s>>>(part, red, (int)E, tiles);
    v_phase_kernel<<<v_grid, kThreads, v_smem, s>>>(v, red, N, R, lo, hi, v_g_smem);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* lrf_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
