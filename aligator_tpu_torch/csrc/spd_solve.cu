// Batched SPD solve A X = R, one thread block per system.
//
// Replaces: aligator_tpu/gar/pallas_spd.py `_spd_kernel` (the Pallas TPU
// kernel K2, entry point `spd_solve_lanes`). Same algorithm: a right-looking
// Cholesky of A in place, then forward and backward substitution of all
// right-hand sides at once. The medium-dim Riccati loop calls it for the
// Schur system I + mu_dyn P (n = nx) and the reduced KKT (n = nu), FDDP for
// its Quu solve; r = nx + 1 there.
//
// Bound on an H100: at the LQR-56 shapes (M = 256, n = 56 or 22, r = 57) the
// call reads A and R and writes X, 3 to 7 MB in fp32, and does n^3/3 + n^2 r
// multiply-adds per system, 8 to 70 MFLOP in all: either bound is a few
// microseconds, so the time is latency: 3n dependent steps per system,
// each a few shared-memory operations and block barriers.
//
// Design: the TPU kernel put 128 systems on the vector lanes; here each
// system gets one block of 256 threads, with A and R copied into shared
// memory (dynamic, n^2 + n r + n words: 65 KB at n = r = 64 in fp64, above
// the 48 KB default, so the launcher opts in). Warps take rows and lanes
// columns of each step's update (csrc/block_linalg.cuh). Global reads and
// writes are contiguous per system and coalesced.
//
// C interface (one function per scalar type): returns -1 for n or r out of
// range, otherwise cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "block_linalg.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 64;

template <typename S>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const int n, const int r, const S* __restrict__ A,
                 const S* __restrict__ R, S* __restrict__ X) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* W = reinterpret_cast<S*>(smem_raw);  // n x n, lower triangle becomes L
  S* Y = W + n * n;                       // n x r, becomes X
  S* col = Y + n * r;                     // n words, Cholesky scratch
  __shared__ int bad;

  const size_t m = blockIdx.x;
  const S* Am = A + m * n * n;
  const S* Rm = R + m * n * r;
  S* Xm = X + m * n * r;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) W[i] = Am[i];
  for (int i = threadIdx.x; i < n * r; i += blockDim.x) Y[i] = Rm[i];
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();

  aligator::block_cholesky(W, n, n, col, &bad);
  aligator::block_chol_solve(W, n, n, Y, r, r);

  const S nan = aligator::qnan<S>();
  for (int i = threadIdx.x; i < n * r; i += blockDim.x) Xm[i] = bad ? nan : Y[i];
}

template <typename S>
int launch(int M, int n, int r, const S* A, const S* R, S* X,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxDim || r < 1 || r > kMaxDim || M < 1) return -1;
  const size_t smem = sizeof(S) * static_cast<size_t>(n * n + n * r + n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spd_solve_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  spd_solve_kernel<S><<<M, kThreads, smem, stream>>>(n, r, A, R, X);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spd_solve_f32(int M, int n, int r, const float* A,
                             const float* R, float* X, cudaStream_t stream) {
  return launch<float>(M, n, r, A, R, X, stream);
}

extern "C" int spd_solve_f64(int M, int n, int r, const double* A,
                             const double* R, double* X, cudaStream_t stream) {
  return launch<double>(M, n, r, A, R, X, stream);
}
