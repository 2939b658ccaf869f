// Fused batched proximal-Riccati solve: backward sweep, initial-stage KKT
// and forward sweep of one LQ problem per CUDA thread, in one launch.
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
// symmetrized where K1 symmetrizes them.
//
// Bound on an H100: device-memory bytes. Per scenario and stage the kernel
// reads F knot values and writes G gains and OF solution values (F = 51,
// G = 32, OF = 8 at the SE(2)-car shape nx=3, nu=2, nc=0 with general E);
// the arithmetic is about a thousand flops per stage, far below the fp32
// rate for the bytes it comes with.
//
// Design: one thread per scenario, the TPU kernel's "batch on the lanes"
// carried over to a GPU. The kernel is templated on (NX, NU, NC, explicit
// E) so that every small matrix loop unrolls and the running value function
// (P, p) stays in registers for the whole backward sweep; nothing but the
// gains, which the solver needs anyway, goes back to device memory between
// stages. Inputs and outputs are batch-minor, (T, F, B): the 32 threads of
// a warp read and write 32 neighbouring words for each value, so every
// access is coalesced. The forward sweep keeps x in registers and reads the
// gains back once.
//
// C interface (one function per scalar type): returns -1 for a shape that
// is not instantiated, otherwise cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// C++ has no zero-length arrays: NC = 0 keeps one unused row
__host__ __device__ constexpr int nz(int n) { return n > 0 ? n : 1; }

constexpr int kThreads = 128;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

template <typename S, int N>
__device__ __forceinline__ void chol(const S (&M)[N][N], S (&L)[N][N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    S s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrt_(s);
    const S inv_d = S(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      S v = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv_d;
    }
  }
}

// Solve L L' x = b with L from chol (only the lower triangle is read).
template <typename S, int N>
__device__ __forceinline__ void chol_solve(const S (&L)[N][N], const S (&b)[N],
                                           S (&x)[N]) {
  S y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    S s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
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
template <typename S, int NX, int NU, int NC>
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
  S Lw[NU][NU];
  chol<S, NU>(W, Lw);
  S b[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    S s = rhat[i];
#pragma unroll
    for (int k = 0; k < NC; ++k) s += D[k][i] * d[k] * inv_mueq;
    b[i] = -s;
  }
  chol_solve<S, NU>(Lw, b, kff);
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
    chol_solve<S, NU>(Lw, col, sol);
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

template <typename S, int NX, int NU, int NC, bool EXPLICIT>
__global__ void __launch_bounds__(kThreads)
fused_riccati_kernel(const int B, const int T, const S* __restrict__ in,
                     const S* __restrict__ g0in, const S* __restrict__ mu,
                     S* __restrict__ out, S* __restrict__ gains) {
  // knot features per stage, in the order of K1's _field_layout
  constexpr int oQ = 0, oS = oQ + NX * NX, oR = oS + NX * NU, oq = oR + NU * NU,
                or_ = oq + NX, oA = or_ + NU, oB = oA + NX * NX,
                of = oB + NX * NU, oC = of + NX, oD = oC + NC * NX,
                od = oD + NC * NU, oE = od + NC,
                F = oE + (EXPLICIT ? 0 : NX * NX);
  // gains per stage: kff | K | zff | Z | lff | L | yff | Afb
  constexpr int gkff = 0, gK = gkff + NU, gzff = gK + NU * NX,
                gZ = gzff + NC, glff = gZ + NC * NX, gL = glff + NX,
                gyff = gL + NX * NX, gAfb = gyff + NX, G = gAfb + NX * NX;
  // solution per stage: xs | us | vs | lams
  constexpr int oxs = 0, ous = NX, ovs = NX + NU, olam = NX + NU + NC,
                OF = 2 * NX + NU + NC;

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  auto IN = [&](int t, int f) -> S { return in[(static_cast<size_t>(t) * F + f) * sB + b]; };
  auto GAIN = [&](int t, int g) -> S& { return gains[(static_cast<size_t>(t) * G + g) * sB + b]; };
  auto OUT = [&](int t, int o) -> S& { return out[(static_cast<size_t>(t) * OF + o) * sB + b]; };

  const S mudyn = mu[b];
  const S mueq = mu[sB + b];
  const S inv_mueq = S(1) / mueq;
  const S inv_mudyn = S(1) / mudyn;

  S P[NX][NX], p[NX];

  // ---------------- terminal stage ----------------
  {
    const int t = T - 1;
    S R[NU][NU], r[NU], St[NU][NX], C[nz(NC)][NX], D[nz(NC)][NU], d[nz(NC)];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      r[i] = IN(t, or_ + i);
#pragma unroll
      for (int j = 0; j < NU; ++j) R[i][j] = IN(t, oR + i * NU + j);
#pragma unroll
      for (int j = 0; j < NX; ++j) St[i][j] = IN(t, oS + j * NU + i);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      d[k] = IN(t, od + k);
#pragma unroll
      for (int j = 0; j < NX; ++j) C[k][j] = IN(t, oC + k * NX + j);
#pragma unroll
      for (int j = 0; j < NU; ++j) D[k][j] = IN(t, oD + k * NU + j);
    }
    S kff[NU], K[NU][NX], zff[nz(NC)], Z[nz(NC)][NX];
    reduced_kkt<S, NX, NU, NC>(R, C, D, d, r, St, inv_mueq, kff, K, zff, Z);
    // P = Q + C'Z + S K ; p = q + C'zff + S kff
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        S s = IN(t, oQ + i * NX + j);
#pragma unroll
        for (int k = 0; k < NC; ++k) s += C[k][i] * Z[k][j];
#pragma unroll
        for (int k = 0; k < NU; ++k) s += St[k][i] * K[k][j];
        P[i][j] = s;
      }
      S s = IN(t, oq + i);
#pragma unroll
      for (int k = 0; k < NC; ++k) s += C[k][i] * zff[k];
#pragma unroll
      for (int k = 0; k < NU; ++k) s += St[k][i] * kff[k];
      p[i] = s;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      GAIN(t, gkff + i) = kff[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) GAIN(t, gK + i * NX + j) = K[i][j];
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      GAIN(t, gzff + k) = zff[k];
#pragma unroll
      for (int j = 0; j < NX; ++j) GAIN(t, gZ + k * NX + j) = Z[k][j];
    }
    // no dynamics out of the terminal stage: its propagation gains are zero
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      GAIN(t, glff + i) = S(0);
      GAIN(t, gyff + i) = S(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        GAIN(t, gL + i * NX + j) = S(0);
        GAIN(t, gAfb + i * NX + j) = S(0);
      }
    }
  }

  // ---------------- backward sweep ----------------
  for (int t = T - 2; t >= 0; --t) {
    S Pt[NX][NX], pt[NX], Einv[NX][NX];
    if constexpr (EXPLICIT) {
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
        for (int c = 0; c < NX; ++c) Em[a][c] = IN(t, oE + a * NX + c);
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
    S fv[NX], Sc[NX][NX], Ls[NX][NX], rhs[NX], vx[NX], Vxx[NX][NX];
#pragma unroll
    for (int a = 0; a < NX; ++a) fv[a] = IN(t, of + a);
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c) Sc[a][c] = Pt[a][c] * mudyn + (a == c ? S(1) : S(0));
    chol<S, NX>(Sc, Ls);
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      S s = pt[a];
#pragma unroll
      for (int c = 0; c < NX; ++c) s += Pt[a][c] * fv[c];
      rhs[a] = s;
    }
    chol_solve<S, NX>(Ls, rhs, vx);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      S col[NX], sol[NX];
#pragma unroll
      for (int a = 0; a < NX; ++a) col[a] = Pt[a][j];
      chol_solve<S, NX>(Ls, col, sol);
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

    S Am[NX][NX], Bm[NX][NU], C[nz(NC)][NX], D[nz(NC)][NU], d[nz(NC)];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int c = 0; c < NX; ++c) Am[a][c] = IN(t, oA + a * NX + c);
#pragma unroll
      for (int c = 0; c < NU; ++c) Bm[a][c] = IN(t, oB + a * NU + c);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      d[k] = IN(t, od + k);
#pragma unroll
      for (int j = 0; j < NX; ++j) C[k][j] = IN(t, oC + k * NX + j);
#pragma unroll
      for (int j = 0; j < NU; ++j) D[k][j] = IN(t, oD + k * NU + j);
    }

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
        Qhat[a][c] = s + IN(t, oQ + a * NX + c);
      }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        S s = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += BtV[a][k] * Bm[k][c];
        Rhat[a][c] = s + IN(t, oR + a * NU + c);
      }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        S s = S(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s += BtV[a][k] * Am[k][c];
        ShatT[a][c] = s + IN(t, oS + c * NU + a);
      }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Am[k][a] * vx[k];
      qhat[a] = s + IN(t, oq + a);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      S s = S(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Bm[k][a] * vx[k];
      rhat[a] = s + IN(t, or_ + a);
    }

    S kff[NU], K[NU][NX], zff[nz(NC)], Z[nz(NC)][NX];
    reduced_kkt<S, NX, NU, NC>(Rhat, C, D, d, rhat, ShatT, inv_mueq, kff, K, zff, Z);

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
    if constexpr (EXPLICIT) {
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

#pragma unroll
    for (int i = 0; i < NU; ++i) {
      GAIN(t, gkff + i) = kff[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) GAIN(t, gK + i * NX + j) = K[i][j];
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      GAIN(t, gzff + k) = zff[k];
#pragma unroll
      for (int j = 0; j < NX; ++j) GAIN(t, gZ + k * NX + j) = Z[k][j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      GAIN(t, glff + i) = lff[i];
      GAIN(t, gyff + i) = yff[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        GAIN(t, gL + i * NX + j) = L[i][j];
        GAIN(t, gAfb + i * NX + j) = Afb[i][j];
      }
    }
  }

  // ---------------- initial stage ----------------
  // W = P + G0'G0/mudyn ; x0 = -W^{-1}(p + G0'g0/mudyn) ; lam0 = (g0 + G0 x0)/mudyn
  S x[NX];
  {
    S G0[NX][NX], g0[NX], W[NX][NX], Lw[NX][NX], bb[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      g0[i] = g0in[static_cast<size_t>(NX * NX + i) * sB + b];
#pragma unroll
      for (int j = 0; j < NX; ++j) G0[i][j] = g0in[static_cast<size_t>(i * NX + j) * sB + b];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        S s = P[i][j];
#pragma unroll
        for (int k = 0; k < NX; ++k) s += G0[k][i] * G0[k][j] * inv_mudyn;
        W[i][j] = s;
      }
    chol<S, NX>(W, Lw);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      S s = p[i];
#pragma unroll
      for (int k = 0; k < NX; ++k) s += G0[k][i] * g0[k] * inv_mudyn;
      bb[i] = -s;
    }
    chol_solve<S, NX>(Lw, bb, x);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      S s = g0[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) s += G0[i][j] * x[j];
      OUT(0, olam + i) = s * inv_mudyn;
    }
  }

  // ---------------- forward sweep ----------------
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) OUT(t, oxs + i) = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      S s = GAIN(t, gkff + i);
#pragma unroll
      for (int j = 0; j < NX; ++j) s += GAIN(t, gK + i * NX + j) * x[j];
      OUT(t, ous + i) = s;
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      S s = GAIN(t, gzff + k);
#pragma unroll
      for (int j = 0; j < NX; ++j) s += GAIN(t, gZ + k * NX + j) * x[j];
      OUT(t, ovs + k) = s;
    }
    if (t < T - 1) {
      S xn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        S s = GAIN(t, glff + i);
#pragma unroll
        for (int j = 0; j < NX; ++j) s += GAIN(t, gL + i * NX + j) * x[j];
        OUT(t + 1, olam + i) = s;
        S y = GAIN(t, gyff + i);
#pragma unroll
        for (int j = 0; j < NX; ++j) y += GAIN(t, gAfb + i * NX + j) * x[j];
        xn[i] = y;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
  }
}

template <typename S>
int launch(int nx, int nu, int nc, int explicit_e, int B, int T, const S* in,
           const S* g0, const S* mu, S* out, S* gains, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid((B + kThreads - 1) / kThreads);
#define ALIGATOR_FUSED_RICCATI_CASE(NX, NU, NC, EXPL)                              \
  if (nx == NX && nu == NU && nc == NC && (explicit_e != 0) == EXPL) {            \
    fused_riccati_kernel<S, NX, NU, NC, EXPL>                                     \
        <<<grid, block, 0, stream>>>(B, T, in, g0, mu, out, gains);               \
    return static_cast<int>(cudaGetLastError());                                  \
  }
  // keep in sync with fused_riccati.KERNEL_SHAPES
  ALIGATOR_FUSED_RICCATI_CASE(3, 2, 0, false)  // SE(2) car
  ALIGATOR_FUSED_RICCATI_CASE(3, 2, 2, false)  // SE(2) car with control bounds
  ALIGATOR_FUSED_RICCATI_CASE(3, 2, 1, true)
  ALIGATOR_FUSED_RICCATI_CASE(4, 2, 0, true)
  ALIGATOR_FUSED_RICCATI_CASE(4, 2, 2, false)
#undef ALIGATOR_FUSED_RICCATI_CASE
  return -1;
}

}  // namespace

extern "C" int fused_riccati_f32(int nx, int nu, int nc, int explicit_e, int B,
                                 int T, const float* in, const float* g0,
                                 const float* mu, float* out, float* gains,
                                 cudaStream_t stream) {
  return launch<float>(nx, nu, nc, explicit_e, B, T, in, g0, mu, out, gains, stream);
}

extern "C" int fused_riccati_f64(int nx, int nu, int nc, int explicit_e, int B,
                                 int T, const double* in, const double* g0,
                                 const double* mu, double* out, double* gains,
                                 cudaStream_t stream) {
  return launch<double>(nx, nu, nc, explicit_e, B, T, in, g0, mu, out, gains, stream);
}
