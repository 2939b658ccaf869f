// Medium-dim proximal Riccati sweeps: the fused backward stage (K3), looped
// over the horizon in one launch, and the forward substitution (K4).
//
// Replaces: aligator_tpu/gar/pallas_stage.py `_stage_kernel` (K3, entry
// point `sweep_lanes`) and `_fwd_kernel` (K4, entry point `forward_lanes`).
//
// K3 has the TPU kernel's own arithmetic, term for term: the Schur solve
// (I + mu_dyn P)[Vxx | vx] = [P | p + P f]; [A'V | A'vx] = A'[Vxx | vx] and
// the same with B; Qhat = Q + A'V A, Rhat = R + B'V B, Shat = S + A'V B and,
// formed apart, Shat' = S' + B'V A; the reduced KKT W = Rhat + D'D/mu_eq with
// [kff | K] = -W^{-1}[rhat + D'd/mu_eq | Shat' + D'C/mu_eq]; [zff | Z] =
// (D[kff | K] + [d | C])/mu_eq; lff, L = Vxx A + Vxx B K, yff, Afb; the value
// update Pc = Qhat + Shat K + C'Z, pc = qhat + Shat kff + C'zff. Nothing is
// symmetrized inside a stage; the carried Pc is, after the stage (the TPU
// sweep did it in XLA between kernel calls), and that symmetrized Pc is the
// stored Pmat. Explicit dynamics (E = -I) only.
//
// Bound on an H100 at the humanoid shape (nx = 36, nu = 12, nc = 12, batch
// 1024): per stage the sweep reads about 4.3k knot words and writes 4.9k
// factor words per scenario, 38 MB in fp32 (11 us at 3.35 TB/s), and does
// about 0.4M multiply-adds per scenario, 0.75 GFLOP (11 us at 67 TFLOP/s):
// close to balanced. This first version is far from either: each block is
// latency-bound (alone on an SM a stage takes ~110 us: ~250 block-wide
// barriers of the two factorizations and substitutions, and thread-per-
// output products with both operands in shared memory), and an SM
// saturates at about 4 resident blocks (tools/torch_k3_scan.py).
//
// Design, K3: one block per scenario, looping over the N stages backward in
// ONE launch (the TPU kernel was launched once per stage from a scan). The
// carry (P, p) stays in shared memory from stage to stage, together with
// every intermediate of the stage (Schur factor and [Vxx | vx], [A'V | A'vx],
// B'V, Shat, the reduced-KKT factor and [kff | K], [zff | Z], the B[kff | K]
// and Vxx B[kff | K] panels): (4 n(n+1) + n^2 + 2 n nu + 2 nu (n+1) + nu^2 +
// nc (n+1) + nc n + nc nu + nc + 3n + max(n, nu)) words, 38.8 KB at the
// humanoid shape in fp32, 77 KB in fp64 (the launcher opts in above 48 KB). Knots are read in
// place from the batch-major (B, T, rows, cols) tensors: a transpose is an
// index here, so no transposed copies are made. nc = 0 needs no padding row.
// A failed factorization makes that stage's outputs and all earlier stages'
// NaN, as the plain version's NaN carry does.
//
// Design, K4: one block per scenario loops over the horizon in one launch;
// x is the only sequential dependence and stays in shared memory. Each warp
// takes rows of [K; Z; L; Afb], its lanes read a row's columns (coalesced)
// and reduce with shuffles. Bound: bytes (the gains are read once).
//
// C interface (one function per scalar type and kernel): the pointers come
// as one array; returns -1 for dims the kernel does not take, otherwise
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "block_linalg.cuh"

namespace {

constexpr int kStageThreads = 256;
// at most 64 registers a thread, so that the shared memory (5 blocks of the
// humanoid shape), not the registers, bounds the blocks an SM holds
constexpr int kStageMinBlocks = 4;
constexpr int kForwardThreads = 128;
constexpr size_t kMaxShared = 232448;  // per block on sm_90 (opt-in)
constexpr size_t kDefaultShared = 48 * 1024;

__host__ __device__ inline size_t stage_smem_words(int n, int m, int c) {
  const size_t n1 = n + 1;
  return 4 * n * n1 + static_cast<size_t>(n) * n + 2 * n * m + 2 * m * n1 +
         static_cast<size_t>(m) * m + c * n1 + c * n + c * m + c + 3 * n +
         (n > m ? n : m);
}

template <typename S>
struct SweepArgs {
  // knots, (B, T, rows, cols) contiguous
  const S *Q, *S_, *R, *q, *r, *A, *B, *f, *C, *D, *d;
  // value function after the last stage (B, n, n), (B, n); mu (B,)
  const S *P0, *p0, *mud, *mue;
  // factors, (B, T, rows, cols): stages 0 .. N-1 are written
  S *kff, *K, *zff, *Z, *lff, *L, *yff, *Afb, *Pmat, *pvec;
};

template <typename S>
__global__ void __launch_bounds__(kStageThreads, kStageMinBlocks)
sweep_kernel(const int T, const int N, const int n, const int m, const int c,
             const SweepArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = n + 1;
  S* sp = reinterpret_cast<S*>(smem_raw);
  S* P = sp;    sp += n * n1;  // carry P (ld n); swaps with X2
  S* X2 = sp;   sp += n * n1;  // [A'V | A'vx], then Vxx B[kff | K] (ld n1)
  S* pv = sp;   sp += n;       // carry p, then pc
  S* W1 = sp;   sp += n * n1;  // Schur factor (ld n), then B[kff | K] (ld n1)
  S* SOL = sp;  sp += n * n1;  // [Vxx | vx]
  S* Am = sp;   sp += n * n;
  S* Bm = sp;   sp += n * m;
  S* BtV = sp;  sp += m * n1;  // [B'V | B'vx]
  S* Sh = sp;   sp += n * m;   // Shat
  S* W2 = sp;   sp += m * m;   // reduced-KKT matrix, then its factor
  S* U = sp;    sp += m * n1;  // [kff | K]
  S* Zc = sp;   sp += c * n1;  // [zff | Z]
  S* Cm = sp;   sp += c * n;
  S* Dm = sp;   sp += c * m;
  S* dv = sp;   sp += c;
  S* fv = sp;   sp += n;
  S* qh = sp;   sp += n;       // qhat
  S* col = sp;                 // Cholesky scratch, max(n, m)
  __shared__ int bad;          // sticky: a factorization failed

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const S mud = a.mud[b], mue = a.mue[b];
  const S nan = aligator::qnan<S>();

  for (int i = tid; i < n * n; i += nt) P[i] = a.P0[b * n * n + i];
  for (int i = tid; i < n; i += nt) pv[i] = a.p0[b * n + i];
  if (tid == 0) bad = 0;

  for (int t = N - 1; t >= 0; --t) {
    const size_t bt = b * T + t;
    const S* Q = a.Q + bt * n * n;
    const S* Sg = a.S_ + bt * n * m;
    const S* R = a.R + bt * m * m;
    const S* q = a.q + bt * n;
    const S* r = a.r + bt * m;
    for (int i = tid; i < n * n; i += nt) Am[i] = a.A[bt * n * n + i];
    for (int i = tid; i < n * m; i += nt) Bm[i] = a.B[bt * n * m + i];
    for (int i = tid; i < c * n; i += nt) Cm[i] = a.C[bt * c * n + i];
    for (int i = tid; i < c * m; i += nt) Dm[i] = a.D[bt * c * m + i];
    for (int i = tid; i < c; i += nt) dv[i] = a.d[bt * c + i];
    for (int i = tid; i < n; i += nt) fv[i] = a.f[bt * n + i];
    __syncthreads();

    // Schur system I + mu_dyn P, right-hand sides [P | p + P f]
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      W1[e] = (i == j ? S(1) : S(0)) + mud * P[e];
      SOL[i * n1 + j] = P[e];
    }
    for (int i = tid; i < n; i += nt) {
      S s = S(0);
      for (int k = 0; k < n; ++k) s += P[i * n + k] * fv[k];
      SOL[i * n1 + n] = pv[i] + s;
    }
    __syncthreads();
    aligator::block_cholesky(W1, n, n, col, &bad);
    aligator::block_chol_solve(W1, n, n, SOL, n1, n1);

    // [A'V | A'vx] and [B'V | B'vx]
    for (int e = tid; e < n * n1; e += nt) {
      const int i = e / n1, j = e % n1;
      S s = S(0);
      for (int k = 0; k < n; ++k) s += Am[k * n + i] * SOL[k * n1 + j];
      X2[e] = s;
    }
    for (int e = tid; e < m * n1; e += nt) {
      const int i = e / n1, j = e % n1;
      S s = S(0);
      for (int k = 0; k < n; ++k) s += Bm[k * m + i] * SOL[k * n1 + j];
      BtV[e] = s;
    }
    __syncthreads();

    // Qhat into the carry buffer (P is consumed), qhat, Shat; the reduced
    // KKT matrix Rhat + D'D/mu_eq and its right-hand sides
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      S s = S(0);
      for (int k = 0; k < n; ++k) s += X2[i * n1 + k] * Am[k * n + j];
      P[e] = Q[e] + s;
    }
    for (int i = tid; i < n; i += nt) qh[i] = q[i] + X2[i * n1 + n];
    for (int e = tid; e < n * m; e += nt) {
      const int i = e / m, j = e % m;
      S s = S(0);
      for (int k = 0; k < n; ++k) s += X2[i * n1 + k] * Bm[k * m + j];
      Sh[e] = Sg[e] + s;
    }
    for (int e = tid; e < m * m; e += nt) {
      const int i = e / m, j = e % m;
      S s = S(0), s2 = S(0);
      for (int k = 0; k < n; ++k) s += BtV[i * n1 + k] * Bm[k * m + j];
      for (int l = 0; l < c; ++l) s2 += Dm[l * m + i] * Dm[l * m + j];
      W2[e] = (R[e] + s) + s2 / mue;
    }
    for (int e = tid; e < m * n1; e += nt) {
      const int i = e / n1, j = e % n1;
      S s = S(0), s2 = S(0);
      if (j == 0) {
        for (int l = 0; l < c; ++l) s2 += Dm[l * m + i] * dv[l];
        U[e] = -((r[i] + BtV[i * n1 + n]) + s2 / mue);
      } else {
        for (int k = 0; k < n; ++k) s += BtV[i * n1 + k] * Am[k * n + j - 1];
        for (int l = 0; l < c; ++l) s2 += Dm[l * m + i] * Cm[l * n + j - 1];
        U[e] = -((Sg[(j - 1) * m + i] + s) + s2 / mue);
      }
    }
    __syncthreads();
    aligator::block_cholesky(W2, m, m, col, &bad);
    aligator::block_chol_solve(W2, m, m, U, n1, n1);

    // [zff | Z] and the panel B[kff | K] (in W1's buffer)
    S* PAN1 = W1;
    for (int e = tid; e < c * n1; e += nt) {
      const int l = e / n1, j = e % n1;
      S s = S(0);
      for (int i = 0; i < m; ++i) s += Dm[l * m + i] * U[i * n1 + j];
      Zc[e] = (s + (j == 0 ? dv[l] : Cm[l * n + j - 1])) / mue;
    }
    for (int e = tid; e < n * n1; e += nt) {
      const int i = e / n1, j = e % n1;
      S s = S(0);
      for (int k = 0; k < m; ++k) s += Bm[i * m + k] * U[k * n1 + j];
      PAN1[e] = s;
    }
    __syncthreads();

    // the panel Vxx B[kff | K] (in X2's buffer); value update Pc, pc
    S* PAN2 = X2;
    for (int e = tid; e < n * n1; e += nt) {
      const int i = e / n1, j = e % n1;
      S s = S(0);
      for (int k = 0; k < n; ++k) s += SOL[i * n1 + k] * PAN1[k * n1 + j];
      PAN2[e] = s;
    }
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      S s = S(0), s2 = S(0);
      for (int k = 0; k < m; ++k) s += Sh[i * m + k] * U[k * n1 + 1 + j];
      for (int l = 0; l < c; ++l) s2 += Cm[l * n + i] * Zc[l * n1 + 1 + j];
      P[e] = (P[e] + s) + s2;
    }
    for (int i = tid; i < n; i += nt) {
      S s = S(0), s2 = S(0);
      for (int k = 0; k < m; ++k) s += Sh[i * m + k] * U[k * n1];
      for (int l = 0; l < c; ++l) s2 += Cm[l * n + i] * Zc[l * n1];
      pv[i] = (qh[i] + s) + s2;
    }
    __syncthreads();

    // gains of stage t
    const bool ok = !bad;
    for (int i = tid; i < m; i += nt) a.kff[bt * m + i] = ok ? U[i * n1] : nan;
    for (int e = tid; e < m * n; e += nt)
      a.K[bt * m * n + e] = ok ? U[(e / n) * n1 + 1 + e % n] : nan;
    for (int l = tid; l < c; l += nt) a.zff[bt * c + l] = ok ? Zc[l * n1] : nan;
    for (int e = tid; e < c * n; e += nt)
      a.Z[bt * c * n + e] = ok ? Zc[(e / n) * n1 + 1 + e % n] : nan;
    for (int i = tid; i < n; i += nt) {
      const S lf = SOL[i * n1 + n] + PAN2[i * n1];
      a.lff[bt * n + i] = ok ? lf : nan;
      a.yff[bt * n + i] = ok ? (fv[i] + PAN1[i * n1]) - mud * lf : nan;
    }
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      S s = S(0);
      for (int k = 0; k < n; ++k) s += SOL[i * n1 + k] * Am[k * n + j];
      const S Lv = s + PAN2[i * n1 + 1 + j];
      a.L[bt * n * n + e] = ok ? Lv : nan;
      a.Afb[bt * n * n + e] = ok ? (Am[e] + PAN1[i * n1 + 1 + j]) - mud * Lv : nan;
    }
    __syncthreads();

    // the symmetrized carry goes to the other buffer, which becomes P
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      const S v = S(0.5) * (P[e] + P[j * n + i]);
      X2[e] = v;
      a.Pmat[bt * n * n + e] = ok ? v : nan;
    }
    for (int i = tid; i < n; i += nt) a.pvec[bt * n + i] = ok ? pv[i] : nan;
    S* tmp = P;
    P = X2;
    X2 = tmp;
  }
}

template <typename S>
struct ForwardArgs {
  // gains (B, T, rows, cols) contiguous; x0 (B, n), lam0 (B, n)
  const S *kff, *K, *zff, *Z, *lff, *L, *yff, *Afb, *x0, *lam0;
  // solution (B, T, ·)
  S *xs, *us, *vs, *lams;
};

template <typename S>
__global__ void __launch_bounds__(kForwardThreads)
forward_kernel(const int T, const int n, const int m, const int c,
               const ForwardArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* x = reinterpret_cast<S*>(smem_raw);
  S* xn = x + n;
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = a.x0[b * n + i];
    a.lams[b * T * n + i] = a.lam0[b * n + i];
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const size_t bt = b * T + t;
    for (int i = threadIdx.x; i < n; i += blockDim.x) a.xs[bt * n + i] = x[i];
    // rows of [K; Z; L; Afb]; no dynamics out of the last knot
    const int rows = m + c + (t < T - 1 ? 2 * n : 0);
    for (int row = warp; row < rows; row += nwarps) {
      const S* M;
      S ff;
      S* out;
      if (row < m) {
        M = a.K + (bt * m + row) * n;
        ff = a.kff[bt * m + row];
        out = a.us + bt * m + row;
      } else if (row < m + c) {
        const int l = row - m;
        M = a.Z + (bt * c + l) * n;
        ff = a.zff[bt * c + l];
        out = a.vs + bt * c + l;
      } else if (row < m + c + n) {
        const int i = row - m - c;
        M = a.L + (bt * n + i) * n;
        ff = a.lff[bt * n + i];
        out = a.lams + (bt + 1) * n + i;
      } else {
        const int i = row - m - c - n;
        M = a.Afb + (bt * n + i) * n;
        ff = a.yff[bt * n + i];
        out = xn + i;
      }
      S s = S(0);
      for (int k = lane; k < n; k += 32) s += M[k] * x[k];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) *out = ff + s;
    }
    __syncthreads();
    S* tmp = x;
    x = xn;
    xn = tmp;
  }
}

template <typename S>
int launch_sweep(int Bsz, int T, int N, int n, int m, int c, void* const* p,
                 cudaStream_t stream) {
  if (Bsz < 1 || N < 1 || T < N || n < 1 || m < 1 || c < 0) return -1;
  const size_t smem = sizeof(S) * stage_smem_words(n, m, c);
  if (smem > kMaxShared) return -1;
  if (smem > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  SweepArgs<S> a;
  const S** in[] = {&a.Q, &a.S_, &a.R, &a.q, &a.r, &a.A, &a.B, &a.f,
                    &a.C, &a.D, &a.d, &a.P0, &a.p0, &a.mud, &a.mue};
  S** out[] = {&a.kff, &a.K, &a.zff, &a.Z, &a.lff,
               &a.L, &a.yff, &a.Afb, &a.Pmat, &a.pvec};
  int k = 0;
  for (const S** f : in) *f = static_cast<const S*>(p[k++]);
  for (S** f : out) *f = static_cast<S*>(p[k++]);
  sweep_kernel<S><<<Bsz, kStageThreads, smem, stream>>>(T, N, n, m, c, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_forward(int Bsz, int T, int n, int m, int c, void* const* p,
                   cudaStream_t stream) {
  if (Bsz < 1 || T < 1 || n < 1 || m < 0 || c < 0) return -1;
  ForwardArgs<S> a;
  const S** in[] = {&a.kff, &a.K, &a.zff, &a.Z, &a.lff,
                    &a.L, &a.yff, &a.Afb, &a.x0, &a.lam0};
  S** out[] = {&a.xs, &a.us, &a.vs, &a.lams};
  int k = 0;
  for (const S** f : in) *f = static_cast<const S*>(p[k++]);
  for (S** f : out) *f = static_cast<S*>(p[k++]);
  const size_t smem = sizeof(S) * 2 * n;
  forward_kernel<S><<<Bsz, kForwardThreads, smem, stream>>>(T, n, m, c, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: Q S R q r A B f C D d P0 p0 mudyn mueq, then kff K zff Z lff L yff
// Afb Pmat pvec
extern "C" int fused_sweep_f32(int B, int T, int N, int nx, int nu, int nc,
                               void* const* ptrs, cudaStream_t stream) {
  return launch_sweep<float>(B, T, N, nx, nu, nc, ptrs, stream);
}

extern "C" int fused_sweep_f64(int B, int T, int N, int nx, int nu, int nc,
                               void* const* ptrs, cudaStream_t stream) {
  return launch_sweep<double>(B, T, N, nx, nu, nc, ptrs, stream);
}

// ptrs: kff K zff Z lff L yff Afb x0 lam0, then xs us vs lams
extern "C" int fused_forward_f32(int B, int T, int nx, int nu, int nc,
                                 void* const* ptrs, cudaStream_t stream) {
  return launch_forward<float>(B, T, nx, nu, nc, ptrs, stream);
}

extern "C" int fused_forward_f64(int B, int T, int nx, int nu, int nc,
                                 void* const* ptrs, cudaStream_t stream) {
  return launch_forward<double>(B, T, nx, nu, nc, ptrs, stream);
}
