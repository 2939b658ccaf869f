// Dense linear algebra on small row-major matrices in shared memory, run by
// all threads of one block together, used by spd_solve.cu (K2); qnan is
// also fused_stage.cu's. Every function starts and ends with the block in
// step: callers __syncthreads() before reading what one wrote.

#pragma once

#include <cuda_runtime.h>

namespace aligator {

__device__ __forceinline__ float rsqrt_exact(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ double rsqrt_exact(double x) { return 1.0 / sqrt(x); }

// quiet NaN of the scalar type (std::numeric_limits is host-only here)
template <typename S>
__device__ __forceinline__ S qnan();
template <>
__device__ __forceinline__ float qnan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Right-looking Cholesky of the n x n matrix W (leading dimension ld) in
// place: only the lower triangle is read, and on exit it holds L with
// W = L L'. Column k is scaled by 1/sqrt(pivot), as the TPU kernels do
// (pallas_spd._spd_kernel), and copied to the n-word scratch `col`, from
// which the trailing update reads it without bank conflicts. Warps take
// rows and lanes columns, so no index is divided; two barriers per step.
// A pivot that is not positive (or NaN) sets *bad = 1; the caller turns
// that system's result into NaN.
template <typename S>
__device__ void block_cholesky(S* W, int n, int ld, S* col, int* bad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = 0; k < n; ++k) {
    const S d = W[k * ld + k];
    const S rd = rsqrt_exact(d);
    // column k below the diagonal; the diagonal is written in the second
    // phase, when no thread reads it
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x) {
      const S l = W[i * ld + k] * rd;
      col[i] = l;
      W[i * ld + k] = l;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      W[k * ld + k] = d * rd;
      if (!(d > S(0))) *bad = 1;
    }
    for (int i = k + 1 + warp; i < n; i += nwarps) {
      const S li = col[i];
      for (int j = k + 1 + lane; j <= i; j += 32) W[i * ld + j] -= li * col[j];
    }
    __syncthreads();
  }
}

// Solve (L L') X = Y in place for the r columns of Y (n x r, leading
// dimension ldy), L from block_cholesky. Both substitutions are column
// oriented, one barrier per step: step j updates the rows after j with the
// scaled row j, which it computes on the fly and stores one step later,
// when no thread reads it.
template <typename S>
__device__ void block_chol_solve(const S* L, int n, int ldl, S* Y, int r,
                                 int ldy) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = 0; j < n; ++j) {  // L Z = Y
    const S inv = S(1) / L[j * ldl + j];
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const S lij = L[i * ldl + j];
      for (int c = lane; c < r; c += 32) Y[i * ldy + c] -= lij * (Y[j * ldy + c] * inv);
    }
    if (j > 0) {
      const S prev = S(1) / L[(j - 1) * ldl + j - 1];
      for (int c = threadIdx.x; c < r; c += blockDim.x) Y[(j - 1) * ldy + c] *= prev;
    }
    __syncthreads();
  }
  {
    const S last = S(1) / L[(n - 1) * ldl + n - 1];
    for (int c = threadIdx.x; c < r; c += blockDim.x) Y[(n - 1) * ldy + c] *= last;
  }
  __syncthreads();
  for (int i = n - 1; i >= 0; --i) {  // L' X = Z
    const S inv = S(1) / L[i * ldl + i];
    for (int k = warp; k < i; k += nwarps) {
      const S lik = L[i * ldl + k];
      for (int c = lane; c < r; c += 32) Y[k * ldy + c] -= lik * (Y[i * ldy + c] * inv);
    }
    if (i < n - 1) {
      const S prev = S(1) / L[(i + 1) * ldl + i + 1];
      for (int c = threadIdx.x; c < r; c += blockDim.x) Y[(i + 1) * ldy + c] *= prev;
    }
    __syncthreads();
  }
  const S first = S(1) / L[0];
  for (int c = threadIdx.x; c < r; c += blockDim.x) Y[c] *= first;
  __syncthreads();
}

}  // namespace aligator
