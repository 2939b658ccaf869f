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
// NaN) fails the system exactly where the Cholesky would.
//
// A system whose 4 x 8 tiles outnumber 256 threads (n > 64, or n = 64
// with r = 65 or 128) takes a memory route: [W | Y] copied into shared
// memory (n (n + rw) words, opt-in above 48 KB) where it fits the block's
// opt-in maximum, the column groups rw narrowed until it does (n up to
// ~165 in fp64, ~235 in fp32), else into a global-memory workspace, one
// n x (n + rw) slice a block, which the wrapper allocates (its size from
// spd_solve_workspace). Both eliminate by scalar Cholesky in the symmetric
// form (cholesky_solve_inplace below): the register route's block
// Cholesky with 1 x 1 pivot blocks, n forward and n back-substitution
// steps of one barrier each. Simple rather than fast past n = 64.
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
// error in float32 at condition 1e5 (see block_linalg.cuh). The memory
// routes are the same symmetric Cholesky, one pivot a step.
//
// C interface (one function per scalar type): spd_solve_f32/f64 take a
// workspace of spd_solve_workspace(M, n, r, sizeof(S)) bytes (null when
// that is 0) and return -1 for an empty system or a missing workspace,
// otherwise cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "block_linalg.cuh"

namespace {

constexpr int kThreads = 256;  // most threads a block
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

// Solve W X = Y in place on M = [W | Y] (n x (n + r), leading dimension
// ld; W's upper triangle read, Y's r columns become X) by the whole block:
// right-looking Cholesky in the symmetric form, step k taking
// W_ij -= U_ki U_kj (U_kj = W_kj / sqrt(W_kk)) on the upper triangle of
// the trailing rows and Y_ic -= U_ki (Y_kc / sqrt(W_kk)), which leaves row
// k as sqrt(W_kk) [U_k | U^{-T} Y]_k; then back substitution on the
// unscaled rows, Y_i -= W_ik (Y_k / W_kk) for i < k, X_k = Y_k / W_kk at
// the end; one barrier a step. A pivot not > 0 (or NaN) sets *bad = 1, the
// condition under which the Cholesky factorization of W fails. M is in
// shared or global memory: the block's barriers order both.
template <typename S>
__device__ void cholesky_solve_inplace(S* M, int n, int r, int ld, int* bad) {
  const int w = n + r;
  for (int k = 0; k < n; ++k) {
    const S d = M[k * ld + k];
    if (threadIdx.x == 0 && !(d > S(0))) *bad = 1;
    const S s = S(1) / sqrt(d);
    const S* Rk = M + k * ld;
    const int cols = w - k - 1;
    const int work = (n - k - 1) * cols;
    for (int e = threadIdx.x; e < work; e += blockDim.x) {
      const int i = k + 1 + e / cols, j = k + 1 + e % cols;
      if (j >= i) M[i * ld + j] -= (Rk[i] * s) * (Rk[j] * s);
    }
    __syncthreads();
  }
  for (int k = n - 1; k > 0; --k) {
    const S* Yk = M + k * ld + n;
    const S rd = S(1) / M[k * ld + k];
    for (int e = threadIdx.x; e < k * r; e += blockDim.x) {
      const int i = e / r, c = e % r;
      M[i * ld + n + c] -= M[i * ld + k] * (Yk[c] * rd);
    }
    __syncthreads();
  }
}

// [W | Y] in shared memory, or in the workspace `work` (a slice of n x (n +
// rs) a block), W's upper triangle from A's lower triangle; block (m, s)
// solves system m for the columns s rs .. s rs + rs - 1 of Y
template <typename S>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel_mem(const int n, const int r, const int rs, const S* __restrict__ A,
                     const S* __restrict__ R, S* __restrict__ X, S* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;

  const int c0 = blockIdx.y * rs, cols = min(rs, r - c0), ld = n + rs;
  const size_t m = blockIdx.x;
  S* M = work == nullptr
             ? reinterpret_cast<S*>(smem_raw)
             : work + (m * gridDim.y + blockIdx.y) * static_cast<size_t>(n) * ld;
  const S* Am = A + m * n * n;
  const S* Rm = R + m * n * r + c0;
  S* Xm = X + m * n * r + c0;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    if (j >= i) M[i * ld + j] = Am[j * n + i];
  }
  for (int e = threadIdx.x; e < n * cols; e += blockDim.x)
    M[(e / cols) * ld + n + e % cols] = Rm[(e / cols) * r + e % cols];
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();

  cholesky_solve_inplace(M, n, cols, ld, &bad);

  const S nan = aligator::qnan<S>();
  for (int e = threadIdx.x; e < n * cols; e += blockDim.x) {
    const int i = e / cols, c = e % cols;
    Xm[i * r + c] = bad ? nan : M[i * ld + n + c] / M[i * ld + i];
  }
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

// the largest dynamic shared memory a block can opt in to, beside the
// static failure flag
size_t shared_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return aligator::kDefaultDynamicShared;
  return static_cast<size_t>(bytes) - 64;
}

// A launch's route: register tiles of C columns (4 or 8) and rs columns
// of Y a block, or (C = 0) a memory route of rs columns a block with [W |
// Y] in shared memory where n (n + rs) words fit it, else in the workspace
struct Route {
  int C, rs;
  bool shared;
};

Route route(int M, int n, int r, size_t elem) {
  // a block takes at most kMaxR columns of Y: wider right-hand sides are
  // split over the fewest blocks of equal width rw, in the same launch
  const int groups = (r + kMaxR - 1) / kMaxR, rw = (r + groups - 1) / groups;
  if (aligator::reg_tiles<4>(n, rw) <= kThreads) return {4, rw, false};
  const int rs = column_split(M * groups, n, rw);
  if (rs < rw) return {4, rs, false};
  if (aligator::reg_tiles<8>(n, rw) <= kThreads) return {8, rw, false};
  // the widest groups whose [W | Y] fits shared memory, at most kMaxR
  const long long fit = static_cast<long long>(shared_optin() / (elem * n)) - n;
  const int cap = fit >= 1 ? static_cast<int>(fit < kMaxR ? fit : kMaxR) : kMaxR;
  const int g = (r + cap - 1) / cap;
  return {0, (r + g - 1) / g, fit >= 1};
}

// the workspace of a launch in bytes: 0 unless the global-memory route
// takes it
size_t workspace_bytes(int M, int n, int r, size_t elem) {
  if (n < 1 || r < 1 || M < 1) return 0;
  const Route rt = route(M, n, r, elem);
  if (rt.C != 0 || rt.shared) return 0;
  const size_t blocks = static_cast<size_t>(M) * ((r + rt.rs - 1) / rt.rs);
  return blocks * n * (n + rt.rs) * elem;
}

template <typename S>
int launch(int M, int n, int r, const S* A, const S* R, S* X, S* work,
           cudaStream_t stream) {
  if (n < 1 || r < 1 || M < 1) return -1;
  const Route rt = route(M, n, r, sizeof(S));
  if (rt.C == 4) return launch_regs<4>(M, n, r, rt.rs, A, R, X, stream);
  if (rt.C == 8) return launch_regs<8>(M, n, r, rt.rs, A, R, X, stream);
  size_t smem = 0;
  if (rt.shared) {
    smem = sizeof(S) * static_cast<size_t>(n) * (n + rt.rs);
    const cudaError_t e = aligator::opt_in_shared(spd_solve_kernel_mem<S>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    work = nullptr;
  } else if (work == nullptr) {
    return -1;
  }
  const dim3 grid(M, (r + rt.rs - 1) / rt.rs);
  spd_solve_kernel_mem<S><<<grid, kThreads, smem, stream>>>(n, r, rt.rs, A, R, X, work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long spd_solve_workspace(int M, int n, int r, int elem) {
  return static_cast<long long>(workspace_bytes(M, n, r, static_cast<size_t>(elem)));
}

extern "C" int spd_solve_f32(int M, int n, int r, const float* A, const float* R,
                             float* X, float* work, cudaStream_t stream) {
  return launch<float>(M, n, r, A, R, X, work, stream);
}

extern "C" int spd_solve_f64(int M, int n, int r, const double* A, const double* R,
                             double* X, double* work, cudaStream_t stream) {
  return launch<double>(M, n, r, A, R, X, work, stream);
}
