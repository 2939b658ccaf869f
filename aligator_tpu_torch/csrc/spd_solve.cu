// Batched SPD solve A X = R, one thread block per system.
//
// Replaces: aligator_tpu/gar/pallas_spd.py `_spd_kernel` (the Pallas TPU
// kernel K2, entry point `spd_solve_lanes`). Same function: X = A^{-1} R
// from the lower triangle of A, NaN for a system whose Cholesky
// factorization fails. The medium-dim Riccati loop calls it for the Schur
// system I + mu_dyn P (n = nx) and the reduced KKT (n = nu), FDDP for its
// Quu solve; r = nx + 1 there. The contact-dynamics derivatives solve the
// mass matrix (n = nv = 28) and the Delassus matrix (n = nc = 12) against
// the 3 nv = 84 tangent directions at once.
//
// Bound on an H100: at the LQR-56 shapes (M = 256, n = 56 or 22, r = 57) the
// call reads A and R and writes X, 3 to 10 MB in fp32, and does n^3/3 +
// 2 n^2 r flops per system, 15 to 107 MFLOP in all: either bound is a few
// microseconds, so the time is latency, the dependent steps of one system.
// The TPU kernel's right-looking Cholesky and two substitutions take about
// 3n of them, each a few shared-memory operations and a block barrier.
//
// Design: the TPU kernel put 128 systems on the vector lanes; here each
// system gets one block, which solves [W | Y] = [A | R] by block Cholesky
// elimination with the tiles in registers, four pivots a step
// (aligator::block_cholesky_regs, which K3 shares): n/4 forward steps and
// n/4 back-substitution steps of one barrier each. A thread loads its tile
// straight from device memory, mirroring W from A's lower triangle, and
// writes its rows of X at the end; shared memory holds only the published
// pivot rows, multipliers and 4 x 4 pivot-block Cholesky factors
// (reg_buf_words, 6.7 KB at n = 56, r = 57 in fp32).
// Tiles are 4 x 4 where the system then fits 256 threads, else 4 x 8; the
// block has as many warps as the tiles need. With fewer systems than SMs
// (the walk's per-stage loop at batch 16) the columns of Y are split over
// up to (#SMs / M) blocks a system, each eliminating W again, so that 4 x 4
// tiles fit: at M = 16, n = 56 four blocks of 252 tiles, 0.0136 ms against
// 0.0221 ms for one block of 4 x 8 tiles (H100 80GB HBM3, 700 W,
// tools/torch_k2_k5_scan.py); 4 x 8 tiles where 4 x 4 fit measured 1.3 to
// 1.7x slower, a register cap of 128 or 85 no faster. The pivots of an SPD matrix
// are the squares of its Cholesky diagonal, so a pivot that is not > 0 (or
// NaN) fails the system exactly where the Cholesky would. A system whose
// 4 x 8 tiles outnumber 256 threads (e.g. n = 64, r = 65 or 128) takes the
// shared-memory route: [W | Y] copied into shared memory (n (n + r) words,
// opt-in above 48 KB) and eliminated one pivot and one barrier a step
// (aligator::gauss_jordan, K3's route for its large systems).
//
// A block takes at most 128 columns of Y (kMaxR): wider right-hand sides
// (the contact KKT's r = 3 nv past nv = 42) are split over blocks of equal
// width in the same launch, each eliminating W again, as the column split
// does.
//
// Accuracy: the register route's block Cholesky elimination updates in the
// symmetric form and is backward stable as a Cholesky solve is, so it
// needs no refinement step. The eliminations it replaced were not: block
// Gauss-Jordan with explicit 4 x 4 pivot-block inverses lost ~1e-6
// relative in float64 on the Solo jump's Delassus matrix (four redundant
// point feet at mu = 1e-8) and 18x and 138x a Cholesky solve's backward
// error in float32 at condition 1e5 (see block_linalg.cuh). The
// shared-memory route eliminates one pivot a step by Gauss-Jordan, with no
// block inverse, and stays within a few times the Cholesky solve's
// backward error.
//
// C interface (one function per scalar type): returns -1 for n out of
// range (1 <= n <= 64) or an empty system, otherwise cudaGetLastError()
// after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "block_linalg.cuh"

namespace {

constexpr int kThreads = 256;  // most threads a block
constexpr int kMaxN = 64;
constexpr int kMaxR = 128;  // columns of Y a block at most

// [W | Y] in registers, C columns a tile; block (m, s) solves system m for
// the columns s rs .. s rs + rs - 1 of Y
template <int C, typename S>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel_regs(const int n, const int r, const int rs, const S* __restrict__ A,
                      const S* __restrict__ R, S* __restrict__ X) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* buf = reinterpret_cast<S*>(smem_raw);
  __shared__ int bad;

  const size_t m = blockIdx.x;
  const int c0 = blockIdx.y * rs;
  const S* Am = A + m * n * n;
  const S* Rm = R + m * n * r + c0;
  S* Xm = X + m * n * r + c0;
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  const S nan = aligator::qnan<S>();
  const int* failed = &bad;  // final when X is stored
  const int cols = min(rs, r - c0);
  aligator::block_cholesky_regs<C>(
      n, cols, buf, &bad,
      [=](int i, int j) -> S {
        return j >= n ? Rm[i * r + j - n] : i >= j ? Am[i * n + j] : Am[j * n + i];
      },
      [=](int i, int c, S x) { Xm[i * r + c] = *failed ? nan : x; });
}

// [W | Y] in shared memory (W mirrored from A's lower triangle),
// eliminated one pivot a step; block (m, s) solves system m for the
// columns s rs .. s rs + rs - 1 of Y
template <typename S>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel_smem(const int n, const int r, const int rs, const S* __restrict__ A,
                      const S* __restrict__ R, S* __restrict__ X) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* M = reinterpret_cast<S*>(smem_raw);  // n x (n + rs)
  __shared__ int bad;

  const int c0 = blockIdx.y * rs, cols = min(rs, r - c0), w = n + cols;
  const size_t m = blockIdx.x;
  const S* Am = A + m * n * n;
  const S* Rm = R + m * n * r + c0;
  S* Xm = X + m * n * r + c0;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    M[i * w + j] = i >= j ? Am[e] : Am[j * n + i];
  }
  for (int e = threadIdx.x; e < n * cols; e += blockDim.x)
    M[(e / cols) * w + n + e % cols] = Rm[(e / cols) * r + e % cols];
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();

  aligator::gauss_jordan(M, n, cols, w, &bad);
  __syncthreads();

  const S nan = aligator::qnan<S>();
  for (int e = threadIdx.x; e < n * cols; e += blockDim.x)
    Xm[(e / cols) * r + e % cols] = bad ? nan : M[(e / cols) * w + n + e % cols];
}

// rs columns of Y a block
template <int C, typename S>
int launch_regs(int M, int n, int r, int rs, const S* A, const S* R, S* X,
                cudaStream_t stream) {
  const int threads = (aligator::reg_tiles<C>(n, rs) + 31) / 32 * 32;
  const size_t smem = sizeof(S) * static_cast<size_t>(aligator::reg_buf_words<C>(n, rs));
  const cudaError_t e = aligator::opt_in_shared(spd_solve_kernel_regs<C, S>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(M, (r + rs - 1) / rs);
  spd_solve_kernel_regs<C, S><<<grid, threads, smem, stream>>>(n, r, rs, A, R, X);
  return static_cast<int>(cudaGetLastError());
}

// Fewer systems than SMs: the columns of Y split over the fewest blocks
// that make 4 x 4 tiles fit, as long as the blocks find an SM each
int column_split(int M, int n, int r) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return r;
  for (int s = 2; s <= r && M * s <= sms; ++s) {
    const int rs = (r + s - 1) / s;
    if (aligator::reg_tiles<4>(n, rs) <= kThreads) return rs;
  }
  return r;
}

template <typename S>
int launch(int M, int n, int r, const S* A, const S* R, S* X,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxN || r < 1 || M < 1) return -1;
  // a block takes at most kMaxR columns of Y: wider right-hand sides are
  // split over the fewest blocks of equal width rw, in the same launch
  const int groups = (r + kMaxR - 1) / kMaxR, rw = (r + groups - 1) / groups;
  if (aligator::reg_tiles<4>(n, rw) <= kThreads)
    return launch_regs<4>(M, n, r, rw, A, R, X, stream);
  const int rs = column_split(M * groups, n, rw);
  if (rs < rw) return launch_regs<4>(M, n, r, rs, A, R, X, stream);
  if (aligator::reg_tiles<8>(n, rw) <= kThreads)
    return launch_regs<8>(M, n, r, rw, A, R, X, stream);
  const size_t smem = sizeof(S) * static_cast<size_t>(n * (n + rw));
  const cudaError_t e = aligator::opt_in_shared(spd_solve_kernel_smem<S>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(M, (r + rw - 1) / rw);
  spd_solve_kernel_smem<S><<<grid, kThreads, smem, stream>>>(n, r, rw, A, R, X);
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
