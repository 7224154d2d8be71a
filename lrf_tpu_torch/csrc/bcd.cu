// Fused QMF block-coordinate-descent loop for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of lrf_tpu/ops/bcd_pallas.py, which
// all compute one function: `num_iters` projected Gauss-Seidel sweeps, each
// a U update followed by a V update.
//   K1  _bcd_resident_kernel (launched by bcd_pallas, X resident in VMEM)
//   K2  _bcd_stream_kernel   (launched by bcd_pallas, X streamed in M-tiles)
//   K3  _legacy_bcd_kernel   (launched by _bcd_pallas_legacy, M >= 16384)
// The three variants exist only for the TPU's VMEM budget and 8-aligned
// sublane starts; this one kernel covers every shape they covered.
//
// Forced comparison only. ops/bcd_kernel.py::launch_plan plans no shape on
// this kernel: the cluster kernel of bcd_cluster.cuh takes N = 64 with
// R <= 32 (bcd_cluster.cu, bcd_cluster_wide.cu) and bcd_grid.cu every other
// shape. It runs only through KERNEL.launch(..., variant="bcd"), as the
// yardstick that chip_smoke.py times in turns with the planned kernel.
//
// Function. For image b with X (M, N), U (M, R), V (N, R), each sweep does
//   B = V^T V;  for every row m of U, with a = X[m, :] V, for r = 0..R-1:
//     u_r <- clip(rint(((a_r - (U[m,:] B[:, r] - u_r B[r, r])) + 1e-16)
//                      / (B[r, r] + 1e-16)), lo, hi)
//   then the same rule for every row n of V with a = (X^T U)[n, :], B = U^T U.
// rintf rounds half to even, like jnp.round and torch.round. The division is
// IEEE (the library must not be built with --use_fast_math).
//
// Design. One thread block per image runs all sweeps in one launch, so no
// grid-wide synchronisation is needed and image b's result depends only on
// image b's inputs. A sweep computes B = V^T V, then streams X through
// shared memory in tiles of T rows (T <= kThreads), as K2 does:
//   1. each thread takes one row of the tile: the A-row X[m, :] V in
//      register chunks of kChunk columns, then the R Gauss-Seidel steps of
//      that U row. Given A and B, rows are independent;
//   2. the tile's terms of X^T U and U^T U, with the updated U rows: each
//      output element has one owner thread that adds the rows in order, so
//      every output is a sequential sum over m. No atomics: every run gives
//      the same bits;
// and after the last tile
//   3. the V update, one thread per row of V.
// X is read from device memory once per sweep. The X and U tiles live in
// shared memory; V, the Grams and X^T U too when they fit, else in a global
// scratch that the wrapper allocates. U lives in the output buffer.
//
// What bounds it on an H100. Per sweep an image costs about 4*M*N*R flops
// and one read of X. At the codec's bench shape (64 x 6144 x 64, R = 6, plus
// the merged chroma 128 x 1536 x 64, R = 3) the essential work over 10 sweeps
// is about 7.5 GFLOP of f32 FMA (~0.11 ms at 67 TFLOP/s) against 151 MB of X
// read once (~45 us at 3.35 TB/s), so the bound is the f32 rate. This
// kernel uses one SM per image, re-reads X from device memory every sweep
// and, once V and the Grams spill to global scratch (N = 192, 768), reads
// them from there; PERF.md holds its measured times against that bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 8;
constexpr float kEps = 1e-16f;

__device__ __forceinline__ float project(float num, float den, float lo, float hi) {
  const float q = rintf((num + kEps) / (den + kEps));
  return fminf(fmaxf(q, lo), hi);
}

// Gauss-Seidel step r of one factor row `row` (R entries, updated in place).
__device__ __forceinline__ void gs_step(float* row, const float* gram, float a_r,
                                        int r, int R, float lo, float hi) {
  float t = 0.f;
  for (int k = 0; k < R; ++k) t += row[k] * gram[k * R + r];
  const float grr = gram[r * R + r];
  t -= row[r] * grr;
  row[r] = project(a_r - t, grr, lo, hi);
}

__global__ void __launch_bounds__(kThreads)
bcd_kernel(const float* __restrict__ x, float* __restrict__ u, float* __restrict__ v,
           float* __restrict__ scratch, int M, int N, int R, int T, int num_iters,
           float lo, float hi, int smem_mode) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* X = x + b * M * N;
  float* U = u + b * M * R;
  float* Vout = v + b * N * R;

  // Odd row strides keep one-row-per-thread reads free of bank conflicts.
  const int Ns = N | 1, Rs = R | 1;
  float* Xs = smem;         // T x Ns tile of X
  float* Us = Xs + T * Ns;  // T x Rs tile of U
  float *V, *rest;
  if (smem_mode) {
    V = Us + T * Rs;
    rest = V + N * R;
    for (int i = tid; i < N * R; i += kThreads) V[i] = Vout[i];
  } else {
    V = Vout;
    rest = scratch + b * (N * R + 2 * R * R);
  }
  float* Av = rest;         // X^T U, N x R
  float* Gv = Av + N * R;   // V^T V, R x R
  float* Gu = Gv + R * R;   // U^T U, R x R
  __syncthreads();

  const int n_cols = N + R;  // step-2 columns: X's, then U's
  const int n_out = n_cols * R;
  const bool vec4 = (N & 3) == 0;

  for (int it = 0; it < num_iters; ++it) {
    for (int o = tid; o < R * R; o += kThreads) {
      const int i = o / R, j = o % R;
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += V[n * R + i] * V[n * R + j];
      Gv[o] = s;
      Gu[o] = 0.f;
    }
    for (int i = tid; i < N * R; i += kThreads) Av[i] = 0.f;
    __syncthreads();

    for (int m0 = 0; m0 < M; m0 += T) {
      const int rows = min(T, M - m0);
      // ---- load the tile: X rows m0..m0+rows, and their U rows ----
      const float* Xt = X + (size_t)m0 * N;
      if (vec4) {
        const float4* src = reinterpret_cast<const float4*>(Xt);
#pragma unroll 4
        for (int i4 = tid; i4 < rows * N / 4; i4 += kThreads) {
          const float4 q = src[i4];
          const int i = 4 * i4, rr = i / N, c = i % N;
          float* d = Xs + rr * Ns + c;
          d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
        }
      } else {
        for (int i = tid; i < rows * N; i += kThreads) Xs[(i / N) * Ns + i % N] = Xt[i];
      }
      float* Ut = U + (size_t)m0 * R;
      for (int i = tid; i < rows * R; i += kThreads) Us[(i / R) * Rs + i % R] = Ut[i];
      __syncthreads();

      // ---- step 1: one U row per thread ----
      if (tid < rows) {
        const float* xr = Xs + tid * Ns;
        float* ur = Us + tid * Rs;
        for (int r0 = 0; r0 < R; r0 += kChunk) {
          const int rc = min(kChunk, R - r0);
          float a[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) a[c] = 0.f;
          for (int n = 0; n < N; ++n) {
            const float xv = xr[n];
            const float* vr = V + n * R + r0;
#pragma unroll
            for (int c = 0; c < kChunk; ++c)
              if (c < rc) a[c] += xv * vr[c];
          }
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            if (c < rc) gs_step(ur, Gv, a[c], r0 + c, R, lo, hi);
        }
      }
      __syncthreads();

      // ---- step 2: this tile's terms of X^T U and U^T U ----
      // Each output has one owner thread that adds the rows in order, so
      // every output is a sequential sum over m.
      for (int e = tid; e < n_out; e += kThreads) {
        const int r = e / n_cols, c = e % n_cols;
        float* dst = c < N ? &Av[c * R + r] : &Gu[(c - N) * R + r];
        float acc = *dst;
        if (c < N) {
          for (int t = 0; t < rows; ++t) acc += Xs[t * Ns + c] * Us[t * Rs + r];
        } else {
          for (int t = 0; t < rows; ++t) acc += Us[t * Rs + (c - N)] * Us[t * Rs + r];
        }
        *dst = acc;
      }
      for (int i = tid; i < rows * R; i += kThreads) Ut[i] = Us[(i / R) * Rs + i % R];
      __syncthreads();
    }

    // ---- step 3: V rows ----
    for (int n = tid; n < N; n += kThreads) {
      float* vr = V + n * R;
      for (int r = 0; r < R; ++r) gs_step(vr, Gu, Av[n * R + r], r, R, lo, hi);
    }
    __syncthreads();
  }

  if (smem_mode) {
    for (int i = tid; i < N * R; i += kThreads) Vout[i] = V[i];
  }
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes shared memory with it.
int lrf_bcd_threads() { return kThreads; }

// Largest dynamic shared memory a block of the current device may opt into.
int lrf_bcd_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// x (B, M, N); u (B, M, R) and v (B, N, R) hold the init and are updated in
// place. T is the tile height (rows of X per step, at most lrf_bcd_threads()).
// Shared memory holds the X and U tiles, plus V and the Grams when smem_mode
// is 1; when it is 0 those live in scratch, B * (N*R + 2*R*R) floats.
// Returns the CUDA error code of the launch (0 on success).
int lrf_bcd_launch(const float* x, float* u, float* v, float* scratch, int B, int M,
                   int N, int R, int T, int num_iters, float lo, float hi, int smem_mode,
                   size_t smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bcd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  bcd_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      x, u, v, scratch, M, N, R, T, num_iters, lo, hi, smem_mode);
  return (int)cudaGetLastError();
}

const char* lrf_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
