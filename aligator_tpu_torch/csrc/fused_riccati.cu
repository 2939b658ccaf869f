// Fused batched proximal-Riccati solve (K1): backward sweep, initial-stage
// KKT and forward sweep of one LQ problem per CUDA thread, in one launch.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_kernel` (the Pallas TPU
// kernel K1, entry point `solve`). Same arithmetic, stage by stage: the
// terminal reduced KKT, the Schur system I + mu_dyn * Ptilde, the value
// products, the reduced KKT R^ + D'D/mu_eq with its Cholesky, the gains, the
// value update, the initial KKT with G0/g0 and the forward substitution.
// General E blocks are inverted by unrolled Gauss-Jordan elimination without
// pivoting, as K1 does: the E blocks of the solver's LQ subproblems are
// manifold difference-chart Jacobians, -I + O(dt), strongly diagonally
// dominant, so no pivot can vanish. Ptilde, Vxx and the carried P are
// symmetrized where K1 symmetrizes them. A scenario whose factorization
// fails (a negative pivot under a square root) comes out NaN, and only it.
//
// Bound on an H100: device-memory bytes. Per scenario and stage the solve
// must read F knot words and write G gain and OF solution words (F = 51,
// G = 32, OF = 8 at the SE(2)-car shape nx=3, nu=2, nc=0 with general E);
// its arithmetic, about a thousand flops a stage, would take a seventh of
// the bytes' time at the fp32 rate. The forward sweep reads the gains back,
// G words a stage more than the bound counts (the backward sweep must end
// before x0 is known, and a batch's gains do not fit on chip).
//
// Design. The kernel reads every knot field where the solver leaves it, a
// contiguous (B, T, n) tensor (a pointer each; G0, g0 and the per-scenario
// mu with their strides), and writes xs us vs lams and the eight gains into
// contiguous (B, T, n) tensors: no packing before the launch, no copy after.
// In that layout the 32 scenarios of a warp lie T n words apart, so a block
// of S scenarios (a thread each computes one: the TPU kernel's "batch on
// the lanes") stages kChunk stages of every field into shared memory with
// cp.async: a field seen as (B, T n) gives each scenario one contiguous
// piece of kChunk n words a chunk, which consecutive lanes copy word by
// word. The staging is scenario-minor with an odd pitch (S | 1 words), so
// neither the copy's nor the compute's accesses conflict on a bank. A
// stage's gains are written over its knots once it has read them, and the
// chunk's gains leave in the same pieces; the forward sweep streams the
// gains back in and its solutions out the same way. One buffer: a block
// copies a chunk in, computes it and copies it out in turn, while the SM's
// other blocks fill the gaps. Each thread keeps the running value function
// (P, p) and then (x, lambda) in registers; the kernel is built for one
// shape (NX, NU, NC, explicit E) so that every small loop unrolls.
// Substitutions multiply by the reciprocals of the
// Cholesky diagonal (one division a pivot). Tensor cores do not apply:
// fp32 runs with TF32 off (_precision.py), and the blocks are at most 8 x 8.
//
// What the scan measured (tools/torch_k1_scan.py, NVIDIA H100 80GB HBM3,
// 700 W, SE(2) shape, T = 51, fp32, B = 32768). Device memory serves these
// pieces badly: two stages of Q are 72 bytes, and 32768 scenarios each
// reading such pieces of 12 fields open a DRAM row for every few dozen
// bytes. With chunks of 2 stages the copies alone took 1.24 ms (loads
// 1.08 TB/s, stores 0.41 TB/s); with half the horizon a piece (8 scenarios
// a block, 16 waves), 0.42 ms. Long pieces need shared memory that a
// one-wave batch (248 scenarios an SM) does not have, and each scenario's
// chain of dependent steps (0.09 ms for a block alone) keeps the waves
// few. The balance shipped: chunks of 8 stages, one buffer (as fast as two
// buffers of half the depth), 32 scenarios a block (52 KB in fp32) and
// four threads a scenario, the extra ones only copying (faster even where
// their registers cost blocks): 0.66-0.68 ms, against 1.23 ms for chunks
// of 2 stages in two buffers and 0.48 ms for the kernel that read a packed
// batch-minor copy (1.78 ms with its packing). Copies alone take 0.66 ms,
// the arithmetic alone 0.20 ms. K1_CHUNK, K1_SCEN and K1_COPY_THREADS set
// the shape of the staging; K1_NO_COMPUTE and K1_NO_COPY skip one part to
// time the other.
//
// One shape a library: the build passes -DK1_NX=.. -DK1_NU=.. -DK1_NC=..
// -DK1_EXPLICIT=0|1 (aligator_tpu_torch/_build.py, a variant per shape,
// built at its first launch). K1_PHASES=1 stamps clock64() between the
// steps of a stage in block 0 (tools/torch_k1_scan.py --phases).
//
// C interface (one function per scalar type): returns -1 for a shape other
// than the library's own, otherwise cudaGetLastError() after the launch.

#if !defined(K1_NX) || !defined(K1_NU) || !defined(K1_NC) || !defined(K1_EXPLICIT)
#error "build one shape: -DK1_NX=.. -DK1_NU=.. -DK1_NC=.. -DK1_EXPLICIT=0|1"
#endif
#ifndef K1_CHUNK
#define K1_CHUNK 8
#endif
#ifndef K1_SCEN
#define K1_SCEN 32
#endif
#ifndef K1_COPY_THREADS
#define K1_COPY_THREADS 4
#endif

#include <cuda_runtime.h>

#include <cstddef>

#include "async_copy.cuh"
#include "block_linalg.cuh"

#ifdef K1_PHASES
__device__ unsigned long long g_phase[16];
#define K1_STAMP(i)                                          \
  do {                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) {               \
      const long long now = clock64();                       \
      g_phase[i] += now - k1_clock;                          \
      k1_clock = now;                                        \
    }                                                        \
  } while (0)
#else
#define K1_STAMP(i) (void)k1_clock
#endif

namespace {

constexpr int NX = K1_NX, NU = K1_NU, NC = K1_NC;
constexpr bool kExplicit = K1_EXPLICIT != 0;
constexpr int kChunk = K1_CHUNK;
constexpr int kMaxScen = K1_SCEN;
// threads a block: a warp per 32 scenarios, times K1_COPY_THREADS (the
// extra threads only copy)
constexpr int kCopyThreads = K1_COPY_THREADS;
constexpr int kMaxThreads = (kMaxScen + 31) / 32 * 32 * kCopyThreads;

constexpr size_t kMaxShared = 232448;  // per block on sm_90 (opt-in)
static_assert(NX >= 1 && NX <= 8 && NU >= 1 && NU <= 8 && NC >= 0, "K1's domain");

// C++ has no zero-length arrays: NC = 0 keeps one unused row
__host__ __device__ constexpr int nz(int n) { return n > 0 ? n : 1; }

// knot rows of a stage, in the order of K1's _field_layout
constexpr int oQ = 0, oS = oQ + NX * NX, oR = oS + NX * NU, oq = oR + NU * NU,
              or_ = oq + NX, oA = or_ + NU, oB = oA + NX * NX, of = oB + NX * NU,
              oC = of + NX, oD = oC + NC * NX, od = oD + NC * NU, oE = od + NC,
              F = oE + (kExplicit ? 0 : NX * NX);
// gain rows: kff | K | zff | Z | lff | L | yff | Afb (over the knots)
constexpr int gkff = 0, gK = gkff + NU, gzff = gK + NU * NX, gZ = gzff + NC,
              glff = gZ + NC * NX, gL = glff + NX, gyff = gL + NX * NX,
              gAfb = gyff + NX, G = gAfb + NX * NX;
// solution rows: xs | us | vs | lams (over the gains)
constexpr int oxs = 0, ous = NX, ovs = NX + NU, olam = NX + NU + NC,
              OF = 2 * NX + NU + NC;
// rows a stage slot has in shared memory
constexpr int kRows = F > G ? F : G;
static_assert(OF <= G, "the solution fits over the gains");

template <typename S>
struct Args {
  // knots (B, T, n) contiguous; E is not read with explicit dynamics
  const S *Q, *S_, *R, *q, *r, *A, *B, *f, *C, *D, *d, *E;
  // initial condition and per-scenario mu, any strides (elements): G0's
  // batch, row and column strides, g0's batch and element strides, mu's
  const S *G0, *g0, *mud, *mue;
  long long sG0, sG0r, sG0c, sg0, sg0e, smud, smue;
  // solutions and gains (B, T, n) contiguous
  S *xs, *us, *vs, *lams;
  S *kff, *K, *zff, *Z, *lff, *L, *yff, *Afb;
};

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// Cholesky factor L (lower triangle) of M and the reciprocals of its
// diagonal, which the substitutions multiply by: one division a pivot
// instead of one a pivot and right-hand side.
template <typename S, int N>
__device__ __forceinline__ void chol(const S (&M)[N][N], S (&L)[N][N], S (&inv)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    S s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrt_(s);
    inv[j] = S(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      S v = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv[j];
    }
  }
}

// Solve L L' x = b with L, inv from chol (only the lower triangle is read).
template <typename S, int N>
__device__ __forceinline__ void chol_solve(const S (&L)[N][N], const S (&inv)[N],
                                           const S (&b)[N], S (&x)[N]) {
  S y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    S s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// Gauss-Jordan inverse without pivoting (see the header note).
template <typename S, int N>
__device__ __forceinline__ void inv_gj(const S (&M)[N][N], S (&Inv)[N][N]) {
  S a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = M[i][j];
      Inv[i][j] = i == j ? S(1) : S(0);
    }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const S piv = S(1) / a[k][k];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[k][j] *= piv;
      Inv[k][j] *= piv;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const S fac = a[i][k];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[i][j] -= fac * a[k][j];
        Inv[i][j] -= fac * Inv[k][j];
      }
    }
  }
}

// Reduced KKT of one stage: W = Rhat + D'D/mu_eq, kff = -W^{-1}(rhat + D'd/mu_eq),
// K = -W^{-1}(Shat' + D'C/mu_eq), zff = (D kff + d)/mu_eq, Z = (D K + C)/mu_eq.
template <typename S>
__device__ __forceinline__ void reduced_kkt(
    const S (&Rhat)[NU][NU], const S (&C)[nz(NC)][NX], const S (&D)[nz(NC)][NU],
    const S (&d)[nz(NC)], const S (&rhat)[NU], const S (&ShatT)[NU][NX],
    const S inv_mueq, S (&kff)[NU], S (&K)[NU][NX], S (&zff)[nz(NC)],
    S (&Z)[nz(NC)][NX]) {
  S W[NU][NU];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      S s = Rhat[i][j];
#pragma unroll
      for (int k = 0; k < NC; ++k) s += D[k][i] * D[k][j] * inv_mueq;
      W[i][j] = s;
    }
  S Lw[NU][NU], iw[NU];
  chol<S, NU>(W, Lw, iw);
  S b[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    S s = rhat[i];
#pragma unroll
    for (int k = 0; k < NC; ++k) s += D[k][i] * d[k] * inv_mueq;
    b[i] = -s;
  }
  chol_solve<S, NU>(Lw, iw, b, kff);
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    S col[NU], sol[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      S s = ShatT[i][j];
#pragma unroll
      for (int k = 0; k < NC; ++k) s += D[k][i] * C[k][j] * inv_mueq;
      col[i] = -s;
    }
    chol_solve<S, NU>(Lw, iw, col, sol);
#pragma unroll
    for (int i = 0; i < NU; ++i) K[i][j] = sol[i];
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    S s = d[k];
#pragma unroll
    for (int i = 0; i < NU; ++i) s += D[k][i] * kff[i];
    zff[k] = s * inv_mueq;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      S z = C[k][j];
#pragma unroll
      for (int i = 0; i < NU; ++i) z += D[k][i] * K[i][j];
      Z[k][j] = z * inv_mueq;
    }
  }
}

// One scenario's column of a stage slot in shared memory: row i at x[i * pitch].
template <typename S>
struct Col {
  S* x;
  int pitch;
  __device__ __forceinline__ S& operator[](int i) const { return x[i * pitch]; }
};

template <typename S>
__device__ __forceinline__ void load_CDd(const Col<S>& in, S (&C)[nz(NC)][NX],
                                         S (&D)[nz(NC)][NU], S (&d)[nz(NC)]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    d[k] = in[od + k];
#pragma unroll
    for (int j = 0; j < NX; ++j) C[k][j] = in[oC + k * NX + j];
#pragma unroll
    for (int j = 0; j < NU; ++j) D[k][j] = in[oD + k * NU + j];
  }
}

// the stage's feedback gains, over its knots
template <typename S>
__device__ __forceinline__ void store_feedback(const Col<S>& g, const S (&kff)[NU],
                                               const S (&K)[NU][NX],
                                               const S (&zff)[nz(NC)],
                                               const S (&Z)[nz(NC)][NX]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    g[gkff + i] = kff[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) g[gK + i * NX + j] = K[i][j];
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    g[gzff + k] = zff[k];
#pragma unroll
    for (int j = 0; j < NX; ++j) g[gZ + k * NX + j] = Z[k][j];
  }
}

// Terminal stage: the reduced KKT of the last knot and the value function
// P = Q + C'Z + S K, p = q + C'zff + S kff; zero propagation gains.
template <typename S>
__device__ __forceinline__ void terminal_stage(const Col<S>& io, const S inv_mueq,
                                               S (&P)[NX][NX], S (&p)[NX]) {
  S R[NU][NU], r[NU], St[NU][NX], C[nz(NC)][NX], D[nz(NC)][NU], d[nz(NC)];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    r[i] = io[or_ + i];
#pragma unroll
    for (int j = 0; j < NU; ++j) R[i][j] = io[oR + i * NU + j];
#pragma unroll
    for (int j = 0; j < NX; ++j) St[i][j] = io[oS + j * NU + i];
  }
  load_CDd(io, C, D, d);
  S kff[NU], K[NU][NX], zff[nz(NC)], Z[nz(NC)][NX];
  reduced_kkt<S>(R, C, D, d, r, St, inv_mueq, kff, K, zff, Z);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      S s = io[oQ + i * NX + j];
#pragma unroll
      for (int k = 0; k < NC; ++k) s += C[k][i] * Z[k][j];
#pragma unroll
      for (int k = 0; k < NU; ++k) s += St[k][i] * K[k][j];
      P[i][j] = s;
    }
    S s = io[oq + i];
#pragma unroll
    for (int k = 0; k < NC; ++k) s += C[k][i] * zff[k];
#pragma unroll
    for (int k = 0; k < NU; ++k) s += St[k][i] * kff[k];
    p[i] = s;
  }
  store_feedback(io, kff, K, zff, Z);
  // no dynamics out of the terminal stage: its propagation gains are zero
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    io[glff + i] = S(0);
    io[gyff + i] = S(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      io[gL + i * NX + j] = S(0);
      io[gAfb + i * NX + j] = S(0);
    }
  }
}

// One backward stage from the next stage's value (P, p), which it replaces
// by its own; the gains go over the stage's knots.
template <typename S>
__device__ __forceinline__ void backward_stage(const Col<S>& io, const S mudyn,
                                               const S inv_mueq, S (&P)[NX][NX],
                                               S (&p)[NX], long long& k1_clock) {
  S Pt[NX][NX], pt[NX], Einv[NX][NX];
  if constexpr (kExplicit) {
    // E = -I: Ptilde = P, ptilde = p
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      pt[a] = p[a];
#pragma unroll
      for (int c = 0; c < NX; ++c) Pt[a][c] = P[a][c];
    }
  } else {
    // Ptilde = E^{-T} P E^{-1}, ptilde = -E^{-T} p
    S Em[NX][NX], PE[NX][NX];
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c) Em[a][c] = io[oE + a * NX + c];
    inv_gj<S, NX>(Em, Einv);
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        S s = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += P[a][k] * Einv[k][c];
        PE[a][c] = s;
      }
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        S s = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += Einv[k][a] * PE[k][c];
        Pt[a][c] = s;
      }
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int c = a + 1; c < NX; ++c) {
        const S m = S(0.5) * (Pt[a][c] + Pt[c][a]);
        Pt[a][c] = m;
        Pt[c][a] = m;
      }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Einv[k][a] * p[k];
      pt[a] = -s;
    }
  }

  // Schur system I + mudyn Ptilde: vx = schur^{-1}(ptilde + Ptilde f),
  // Vxx = schur^{-1} Ptilde
  S fv[NX], Sc[NX][NX], Ls[NX][NX], is[NX], rhs[NX], vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) fv[a] = io[of + a];
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) Sc[a][c] = Pt[a][c] * mudyn + (a == c ? S(1) : S(0));
  chol<S, NX>(Sc, Ls, is);
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    S s = pt[a];
#pragma unroll
    for (int c = 0; c < NX; ++c) s += Pt[a][c] * fv[c];
    rhs[a] = s;
  }
  chol_solve<S, NX>(Ls, is, rhs, vx);
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    S col[NX], sol[NX];
#pragma unroll
    for (int a = 0; a < NX; ++a) col[a] = Pt[a][j];
    chol_solve<S, NX>(Ls, is, col, sol);
#pragma unroll
    for (int a = 0; a < NX; ++a) Vxx[a][j] = sol[a];
  }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = a + 1; c < NX; ++c) {
      const S m = S(0.5) * (Vxx[a][c] + Vxx[c][a]);
      Vxx[a][c] = m;
      Vxx[c][a] = m;
    }
  K1_STAMP(1);

  S Am[NX][NX], Bm[NX][NU], C[nz(NC)][NX], D[nz(NC)][NU], d[nz(NC)];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) Am[a][c] = io[oA + a * NX + c];
#pragma unroll
    for (int c = 0; c < NU; ++c) Bm[a][c] = io[oB + a * NU + c];
  }
  load_CDd(io, C, D, d);

  // AtV = A'Vxx, BtV = B'Vxx; Qhat = AtV A + Q, Rhat = BtV B + R,
  // ShatT = BtV A + S', qhat = A'vx + q, rhat = B'vx + r
  S AtV[NX][NX], BtV[NU][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Am[k][a] * Vxx[k][c];
      AtV[a][c] = s;
    }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Bm[k][a] * Vxx[k][c];
      BtV[a][c] = s;
    }
  S Qhat[NX][NX], Rhat[NU][NU], ShatT[NU][NX], qhat[NX], rhat[NU];
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += AtV[a][k] * Am[k][c];
      Qhat[a][c] = s + io[oQ + a * NX + c];
    }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += BtV[a][k] * Bm[k][c];
      Rhat[a][c] = s + io[oR + a * NU + c];
    }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += BtV[a][k] * Am[k][c];
      ShatT[a][c] = s + io[oS + c * NU + a];
    }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    S s = S(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) s += Am[k][a] * vx[k];
    qhat[a] = s + io[oq + a];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    S s = S(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) s += Bm[k][a] * vx[k];
    rhat[a] = s + io[or_ + a];
  }
  K1_STAMP(2);

  S kff[NU], K[NU][NX], zff[nz(NC)], Z[nz(NC)][NX];
  reduced_kkt<S>(Rhat, C, D, d, rhat, ShatT, inv_mueq, kff, K, zff, Z);

  // lff = vx + Vxx B kff ; L = Vxx (A + B K)
  S Bk[NX], lff[NX], ApBK[NX][NX], L[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    S s = S(0);
#pragma unroll
    for (int k = 0; k < NU; ++k) s += Bm[a][k] * kff[k];
    Bk[a] = s;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    S s = S(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) s += Vxx[a][k] * Bk[k];
    lff[a] = vx[a] + s;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NU; ++k) s += Bm[a][k] * K[k][c];
      ApBK[a][c] = Am[a][c] + s;
    }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Vxx[a][k] * ApBK[k][c];
      L[a][c] = s;
    }
  // ytil = f + B kff - mudyn lff ; Atil = A + B K - mudyn L
  // explicit: yff = ytil, Afb = Atil ; general: yff = -E^{-1} ytil, Afb = -E^{-1} Atil
  S ytil[NX], Atil[NX][NX], yff[NX], Afb[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    ytil[a] = fv[a] + Bk[a] - mudyn * lff[a];
#pragma unroll
    for (int c = 0; c < NX; ++c) Atil[a][c] = ApBK[a][c] - mudyn * L[a][c];
  }
  if constexpr (kExplicit) {
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      yff[a] = ytil[a];
#pragma unroll
      for (int c = 0; c < NX; ++c) Afb[a][c] = Atil[a][c];
    }
  } else {
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Einv[a][k] * ytil[k];
      yff[a] = -s;
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        S e = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) e += Einv[a][k] * Atil[k][c];
        Afb[a][c] = -e;
      }
    }
  }
  K1_STAMP(3);

  // value recursion: P = sym(Qhat + Shat K + C'Z), p = qhat + Shat kff + C'zff
  S newP[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      S s = Qhat[a][c];
#pragma unroll
      for (int k = 0; k < NU; ++k) s += ShatT[k][a] * K[k][c];
#pragma unroll
      for (int k = 0; k < NC; ++k) s += C[k][a] * Z[k][c];
      newP[a][c] = s;
    }
    S s = qhat[a];
#pragma unroll
    for (int k = 0; k < NU; ++k) s += ShatT[k][a] * kff[k];
#pragma unroll
    for (int k = 0; k < NC; ++k) s += C[k][a] * zff[k];
    p[a] = s;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) P[a][c] = S(0.5) * (newP[a][c] + newP[c][a]);

  // every knot of the stage has been read: the gains go over them
  store_feedback(io, kff, K, zff, Z);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    io[glff + i] = lff[i];
    io[gyff + i] = yff[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      io[gL + i * NX + j] = L[i][j];
      io[gAfb + i * NX + j] = Afb[i][j];
    }
  }
  K1_STAMP(4);
}

// One forward step at stage t from (x, lam): u = kff + K x, v = zff + Z x,
// then (t < T - 1) lam+ = lff + L x, x+ = yff + Afb x. The solution goes
// over the stage's gains once they have been read.
template <typename S>
__device__ __forceinline__ void forward_step(const Col<S>& io, const bool last,
                                             S (&x)[NX], S (&lam)[NX]) {
  S u[NU], v[nz(NC)], ln[NX], xn[NX];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    S s = io[gkff + i];
#pragma unroll
    for (int j = 0; j < NX; ++j) s += io[gK + i * NX + j] * x[j];
    u[i] = s;
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    S s = io[gzff + k];
#pragma unroll
    for (int j = 0; j < NX; ++j) s += io[gZ + k * NX + j] * x[j];
    v[k] = s;
  }
  if (!last) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      S s = io[glff + i];
      S y = io[gyff + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        s += io[gL + i * NX + j] * x[j];
        y += io[gAfb + i * NX + j] * x[j];
      }
      ln[i] = s;
      xn[i] = y;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    io[oxs + i] = x[i];
    io[olam + i] = lam[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) io[ous + i] = u[i];
#pragma unroll
  for (int k = 0; k < NC; ++k) io[ovs + k] = v[k];
  if (!last) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = xn[i];
      lam[i] = ln[i];
    }
  }
}

// The pieces of one (B, T, N) field for the block's ns scenarios and the
// stages t0 .. t0 + kChunk - 1 (those inside 0 .. T-1): the L = kChunk N
// words of a scenario from stage t0 on, contiguous in device memory, to or
// from the scenario's column of the chunk's stage slots (word tt N + e in
// row row0 + e of slot tt, at buf + tt * kRows * pitch). A warp takes
// 32 / L pieces at a time (one when L > 32, 32 words a pass), lane l word
// l % L of piece l / L: consecutive lanes on consecutive words. A lane's
// word, row and slot are fixed, so a word costs its copy and a few adds.
template <int N, bool kIn, typename S>
__device__ __forceinline__ void copy_field(S* buf, const int pitch, const int row0,
                                           const S* src, S* dst, const int b0,
                                           const int ns, const int T, const int t0) {
#ifdef K1_NO_COPY
  return;
#endif
  if constexpr (N > 0) {
    constexpr int L = kChunk * N, P = L >= 32 ? 1 : 32 / L, R = (L + 31) / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int step = (blockDim.x >> 5) * P;
    const int first = warp * P + (L >= 32 ? 0 : lane / L);
    const int w0 = L >= 32 ? lane : lane % L;
    if (L < 32 && lane >= P * L) return;  // lanes past the warp's last piece
    const long long stride = static_cast<long long>(T) * N;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int w = w0 + 32 * r, tt = w / N, t = t0 + tt;
      if (w >= L || t < 0 || t >= T) continue;
      S* sm = buf + (tt * kRows + row0 + w - tt * N) * pitch;
      const long long g0 = (static_cast<long long>(b0) * T + t0) * N + w;
      for (int s = first; s < ns; s += step) {
        if constexpr (kIn)
          aligator::cp_async_small<sizeof(S)>(sm + s, src + g0 + s * stride);
        else
          dst[g0 + s * stride] = sm[s];
      }
    }
  }
}

template <int N, typename S>
__device__ __forceinline__ void copy_in(S* buf, const int pitch, const int row0,
                                        const S* __restrict__ src, const int b0,
                                        const int ns, const int T, const int t0) {
  copy_field<N, true>(buf, pitch, row0, src, static_cast<S*>(nullptr), b0, ns, T, t0);
}

template <int N, typename S>
__device__ __forceinline__ void copy_out(S* buf, const int pitch, const int row0,
                                         S* __restrict__ dst, const int b0,
                                         const int ns, const int T, const int t0) {
  copy_field<N, false>(buf, pitch, row0, static_cast<const S*>(nullptr), dst, b0, ns,
                       T, t0);
}

template <typename S>
__global__ void __launch_bounds__(kMaxThreads)
fused_riccati_kernel(const int B, const int T, const int scen, const Args<S> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const sm = reinterpret_cast<S*>(smem_raw);
  long long k1_clock = clock64();
  const int pitch = scen | 1;
  const int slot = kRows * pitch;
  const int b0 = blockIdx.x * scen;
  const int ns = min(scen, B - b0);
  const int s = threadIdx.x;
#ifdef K1_NO_COMPUTE
  const bool active = false;
#else
  const bool active = s < ns;
#endif
  const int nch = (T + kChunk - 1) / kChunk;

  S mudyn = S(1), mueq = S(1);
  if (active) {
    mudyn = a.mud[(b0 + s) * a.smud];
    mueq = a.mue[(b0 + s) * a.smue];
  }
  const S inv_mueq = S(1) / mueq;
  const S inv_mudyn = S(1) / mudyn;

  // ---------------- backward sweep, chunks from the end ----------------
  auto knots_in = [&](int t0) {
    copy_in<NX * NX>(sm, pitch, oQ, a.Q, b0, ns, T, t0);
    copy_in<NX * NU>(sm, pitch, oS, a.S_, b0, ns, T, t0);
    copy_in<NU * NU>(sm, pitch, oR, a.R, b0, ns, T, t0);
    copy_in<NX>(sm, pitch, oq, a.q, b0, ns, T, t0);
    copy_in<NU>(sm, pitch, or_, a.r, b0, ns, T, t0);
    copy_in<NX * NX>(sm, pitch, oA, a.A, b0, ns, T, t0);
    copy_in<NX * NU>(sm, pitch, oB, a.B, b0, ns, T, t0);
    copy_in<NX>(sm, pitch, of, a.f, b0, ns, T, t0);
    copy_in<NC * NX>(sm, pitch, oC, a.C, b0, ns, T, t0);
    copy_in<NC * NU>(sm, pitch, oD, a.D, b0, ns, T, t0);
    copy_in<NC>(sm, pitch, od, a.d, b0, ns, T, t0);
    if constexpr (!kExplicit) copy_in<NX * NX>(sm, pitch, oE, a.E, b0, ns, T, t0);
    aligator::cp_async_commit();
  };
  auto gains_out = [&](int t0) {
    copy_out<NU>(sm, pitch, gkff, a.kff, b0, ns, T, t0);
    copy_out<NU * NX>(sm, pitch, gK, a.K, b0, ns, T, t0);
    copy_out<NC>(sm, pitch, gzff, a.zff, b0, ns, T, t0);
    copy_out<NC * NX>(sm, pitch, gZ, a.Z, b0, ns, T, t0);
    copy_out<NX>(sm, pitch, glff, a.lff, b0, ns, T, t0);
    copy_out<NX * NX>(sm, pitch, gL, a.L, b0, ns, T, t0);
    copy_out<NX>(sm, pitch, gyff, a.yff, b0, ns, T, t0);
    copy_out<NX * NX>(sm, pitch, gAfb, a.Afb, b0, ns, T, t0);
  };

  S P[NX][NX], p[NX];
  for (int k = 0; k < nch; ++k) {
    const int t0 = T - (k + 1) * kChunk;
    knots_in(t0);
    aligator::cp_async_wait<0>();
    __syncthreads();  // the chunk has landed
    K1_STAMP(0);
    if (active) {
#pragma unroll 1
      for (int tt = kChunk - 1; tt >= 0 && t0 + tt >= 0; --tt) {
        const Col<S> io{sm + tt * slot + s, pitch};
        if (t0 + tt == T - 1)
          terminal_stage(io, inv_mueq, P, p);
        else
          backward_stage(io, mudyn, inv_mueq, P, p, k1_clock);
      }
    }
    __syncthreads();
    gains_out(t0);
    __syncthreads();  // the stores have read the buffer
    K1_STAMP(5);
  }

  // ---------------- initial stage ----------------
  // W = P + G0'G0/mudyn ; x0 = -W^{-1}(p + G0'g0/mudyn) ; lam0 = (g0 + G0 x0)/mudyn
  S x[NX], lam[NX];
  if (active) {
    const S* G0p = a.G0 + static_cast<long long>(b0 + s) * a.sG0;
    const S* g0p = a.g0 + static_cast<long long>(b0 + s) * a.sg0;
    S G0[NX][NX], g0[NX], W[NX][NX], Lw[NX][NX], iw[NX], bb[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      g0[i] = g0p[i * a.sg0e];
#pragma unroll
      for (int j = 0; j < NX; ++j) G0[i][j] = G0p[i * a.sG0r + j * a.sG0c];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        S acc = P[i][j];
#pragma unroll
        for (int k = 0; k < NX; ++k) acc += G0[k][i] * G0[k][j] * inv_mudyn;
        W[i][j] = acc;
      }
    chol<S, NX>(W, Lw, iw);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      S acc = p[i];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += G0[k][i] * g0[k] * inv_mudyn;
      bb[i] = -acc;
    }
    chol_solve<S, NX>(Lw, iw, bb, x);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      S acc = g0[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += G0[i][j] * x[j];
      lam[i] = acc * inv_mudyn;
    }
  }

  // ---------------- forward sweep, chunks from the start ----------------
  auto gains_in = [&](int t0) {
    copy_in<NU>(sm, pitch, gkff, a.kff, b0, ns, T, t0);
    copy_in<NU * NX>(sm, pitch, gK, a.K, b0, ns, T, t0);
    copy_in<NC>(sm, pitch, gzff, a.zff, b0, ns, T, t0);
    copy_in<NC * NX>(sm, pitch, gZ, a.Z, b0, ns, T, t0);
    copy_in<NX>(sm, pitch, glff, a.lff, b0, ns, T, t0);
    copy_in<NX * NX>(sm, pitch, gL, a.L, b0, ns, T, t0);
    copy_in<NX>(sm, pitch, gyff, a.yff, b0, ns, T, t0);
    copy_in<NX * NX>(sm, pitch, gAfb, a.Afb, b0, ns, T, t0);
    aligator::cp_async_commit();
  };
  auto solution_out = [&](int t0) {
    copy_out<NX>(sm, pitch, oxs, a.xs, b0, ns, T, t0);
    copy_out<NU>(sm, pitch, ous, a.us, b0, ns, T, t0);
    copy_out<NC>(sm, pitch, ovs, a.vs, b0, ns, T, t0);
    copy_out<NX>(sm, pitch, olam, a.lams, b0, ns, T, t0);
  };

  // the block's gain stores before its copies read them back
  __threadfence_block();
  __syncthreads();
  for (int k = 0; k < nch; ++k) {
    const int t0 = k * kChunk;
    gains_in(t0);
    aligator::cp_async_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (int tt = 0; tt < kChunk && t0 + tt < T; ++tt)
        forward_step(Col<S>{sm + tt * slot + s, pitch}, t0 + tt == T - 1, x, lam);
    }
    __syncthreads();
    solution_out(t0);
    __syncthreads();
    K1_STAMP(6);
  }
}

template <typename S>
size_t smem_bytes(int scen) {
  return sizeof(S) * kChunk * static_cast<size_t>(kRows) * (scen | 1);
}

// Scenarios a block: kMaxScen, halved (not below a warp) while the batch
// would leave SMs without a block, and cut to what shared memory holds.
template <typename S>
int scenarios_a_block(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int per_sm = (B + sms - 1) / sms;
  int scen = kMaxScen;
  while (scen > 32 && scen / 2 >= per_sm) scen /= 2;
  while (scen > 1 && smem_bytes<S>(scen) > kMaxShared) --scen;
  return scen;
}

template <typename S>
int launch(int nx, int nu, int nc, int explicit_e, int B, int T, void* const* p,
           const long long* strides, cudaStream_t stream) {
  // this library holds the one shape it was built for
  if (nx != NX || nu != NU || nc != NC || (explicit_e != 0) != kExplicit || B < 1 ||
      T < 1 || smem_bytes<S>(1) > kMaxShared)
    return -1;
  Args<S> a;
  const S** in[] = {&a.Q, &a.S_, &a.R, &a.q, &a.r, &a.A, &a.B, &a.f,
                    &a.C, &a.D, &a.d, &a.E, &a.G0, &a.g0, &a.mud, &a.mue};
  S** out[] = {&a.xs, &a.us, &a.vs, &a.lams, &a.kff, &a.K,
               &a.zff, &a.Z, &a.lff, &a.L, &a.yff, &a.Afb};
  int k = 0;
  for (const S** f : in) *f = static_cast<const S*>(p[k++]);
  for (S** f : out) *f = static_cast<S*>(p[k++]);
  long long* st[] = {&a.sG0, &a.sG0r, &a.sG0c, &a.sg0, &a.sg0e, &a.smud, &a.smue};
  k = 0;
  for (long long* f : st) *f = strides[k++];
  const int scen = scenarios_a_block<S>(B);
  const size_t smem = smem_bytes<S>(scen);
  const cudaError_t e = aligator::opt_in_shared(fused_riccati_kernel<S>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + scen - 1) / scen;
  fused_riccati_kernel<S>
      <<<blocks, (scen + 31) / 32 * 32 * kCopyThreads, smem, stream>>>(B, T, scen, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: Q S R q r A B f C D d E G0 g0 mudyn mueq, then xs us vs lams, then
// kff K zff Z lff L yff Afb; strides: G0's three, g0's two, mudyn's, mueq's
extern "C" int fused_riccati_f32(int nx, int nu, int nc, int explicit_e, int B,
                                 int T, void* const* ptrs, const long long* strides,
                                 cudaStream_t stream) {
  return launch<float>(nx, nu, nc, explicit_e, B, T, ptrs, strides, stream);
}

extern "C" int fused_riccati_f64(int nx, int nu, int nc, int explicit_e, int B,
                                 int T, void* const* ptrs, const long long* strides,
                                 cudaStream_t stream) {
  return launch<double>(nx, nu, nc, explicit_e, B, T, ptrs, strides, stream);
}

#ifdef K1_PHASES
extern "C" int k1_read_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
}
#endif
