// Contact-dynamics derivative rows, one thread block per instance.
//
// Replaces: aligator_tpu/modelling/multibody/pallas_tensors.py
// `make_fd_rows_kernel` (the Pallas TPU kernel K5, entry point
// `fd_rows_lanes`). For one (scenario x stage) instance at the primal
// solution (a*, lam*) of the contact dynamics it computes
//   ra1_q, ra1_v (nv x nv): d(RNEA + J' lam)/d(q, v),
//   r2_q, r2_v   (nc x nv): d(J a + gamma)/d(q, v), masked by activity,
// by the TPU kernel's algorithm: the pair tables SxS[j,k] = S_j x S_k and
// G[j,k] (the velocity-product bias derivatives), then one pass over the
// bodies that forms each body's force derivatives df_b[j], dfv_b[j] for all
// directions j without materializing dI6, through the identity
//   (dI6/dq_j) w = A[b,j] (S_j x* (I6 w) - I6 (S_j x w)),
// and accumulates d tau[k,j] += A[b,k] S_k . df_b[j]; then the subtree
// force term and, per contact, the acceleration rows and the J' lam
// transport.
//
// Bound on an H100: at the Talos shapes (nv = 28, nb = 23, two 6D contacts,
// K = 512 instances) the call reads about 2,450 and writes 2,240 words per
// instance (9.2 MB in fp32 for K = 512, 2.7 us). The function needs about
// 0.31 MFLOP per instance (0.16 GFLOP, 2.3 us at 67 TFLOP/s): a body moves
// with about 9.5 of the 28 dofs, so most of the 2.1 MFLOP that the dense
// loops below run are products with a zero of the masks A and D. Bytes
// bound it.
//
// Design: the TPU kernel put 128 instances on the vector lanes; here each
// instance gets one block of 256 threads with every input, SxS and G
// (nv^2 x 6 words each) and the two nv x nv accumulators in dynamic shared
// memory (65 KB in fp32, 129 KB in fp64 at the Talos shapes, so the
// launcher opts in above 48 KB). Threads take (j, k) pairs for the pair
// tables and the accumulators, (j, component) pairs for the per-body
// contractions over k, and directions j for the 6-vector algebra of each
// body; each accumulator entry has one owner thread, so no atomics. Two
// block barriers per body. Speed is left for later: the per-direction
// phase keeps only nv of the 256 threads busy.
//
// The contact configuration (body, dim 3 or 6 and offset of each contact,
// kd, kp) is a runtime table, so one build serves every robot. C interface
// (one function per scalar type): returns -1 for dimensions it does not
// take, otherwise cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxContacts = 8;
constexpr int kMaxDim = 64;  // nv, nb and nc
constexpr size_t kMaxSmem = 232448;

struct Table {
  int ncont;
  int body[kMaxContacts];
  int dim[kMaxContacts];
  int off[kMaxContacts];
  double kd, kp;
};

template <typename S>
struct In {
  const S *S_, *v, *Vb, *Vpar, *Vdof, *Ca, *Capar, *Accb, *h, *y, *I6, *lam,
      *pc, *act, *A, *D;
};

template <typename S>
struct Out {
  S *ra1q, *ra1v, *r2q, *r2v;
};

// 3-vector and spatial 6-vector algebra, (linear, angular) ordering
template <typename S>
__device__ __forceinline__ void cr3(const S* a, const S* b, S* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// o = m1 x_m m2 = (w1 x v2 + v1 x w2, w1 x w2)
template <typename S>
__device__ __forceinline__ void mcross(const S* m1, const S* m2, S* o) {
  S t[3];
  cr3(m1 + 3, m2, o);
  cr3(m1, m2 + 3, t);
  o[0] += t[0];
  o[1] += t[1];
  o[2] += t[2];
  cr3(m1 + 3, m2 + 3, o + 3);
}

// o = m x* f = (w x fl, w x tau + v x fl)
template <typename S>
__device__ __forceinline__ void fcross(const S* m, const S* f, S* o) {
  S t[3];
  cr3(m + 3, f, o);
  cr3(m + 3, f + 3, o + 3);
  cr3(m, f, t);
  o[3] += t[0];
  o[4] += t[1];
  o[5] += t[2];
}

// o = I x, I 6 x 6 row-major
template <typename S>
__device__ __forceinline__ void mat6(const S* I, const S* x, S* o) {
  for (int r = 0; r < 6; ++r) {
    S acc = S(0);
    for (int c = 0; c < 6; ++c) acc += I[r * 6 + c] * x[c];
    o[r] = acc;
  }
}

template <typename S>
__device__ __forceinline__ S dot6(const S* a, const S* b) {
  S acc = S(0);
  for (int s = 0; s < 6; ++s) acc += a[s] * b[s];
  return acc;
}

// shared-memory layout, in words of S
struct Layout {
  int S_, v, Vpar, Vdof, Capar, CVS, Vb, Ca, Accb, h, y, I6, A, D, SxS, G, dAG,
      dAvG, DF, DFV, F, ra1q, ra1v, dpxw, Fc, fb, lam, pc, act, total;
  __host__ __device__ static int take(int& o, int n) {
    const int at = o;
    o += n;
    return at;
  }
  __host__ __device__ Layout(int nv, int nb, int nc, int ncont) {
    int o = 0;
    S_ = take(o, nv * 6);
    v = take(o, nv);
    Vpar = take(o, nv * 6);
    Vdof = take(o, nv * 6);
    Capar = take(o, nv * 6);
    CVS = take(o, nv * 6);
    Vb = take(o, nb * 6);
    Ca = take(o, nb * 6);
    Accb = take(o, nb * 6);
    h = take(o, nb * 6);
    y = take(o, nb * 6);
    I6 = take(o, nb * 36);
    A = take(o, nb * nv);
    D = take(o, nv * nv);
    SxS = take(o, nv * nv * 6);
    G = take(o, nv * nv * 6);
    dAG = take(o, nv * 6);
    dAvG = take(o, nv * 6);
    DF = take(o, nv * 6);
    DFV = take(o, nv * 6);
    F = take(o, nv * 6);
    ra1q = take(o, nv * nv);
    ra1v = take(o, nv * nv);
    dpxw = take(o, nv * 3);
    Fc = take(o, 6);
    fb = take(o, 6);
    lam = take(o, nc);
    pc = take(o, ncont * 3);
    act = take(o, ncont);
    total = o;
  }
};

// dAG[j,s] = sum_k ab_k G[j,k,s] and dAvG[j,s] = sum_k SxS[j,k,s] D[k,j]
// ab_k v_k + ab_j CVS[j,s], with ab = A[b, :]: the body's acceleration
// derivative contractions over k
template <typename S>
__device__ void body_contractions(S* sm, const Layout& L, int nv, int b) {
  const S* ab = sm + L.A + b * nv;
  for (int e = threadIdx.x; e < nv * 6; e += blockDim.x) {
    const int j = e / 6, s = e % 6;
    S g = S(0), gv = S(0);
    for (int k = 0; k < nv; ++k) {
      const int jk = (j * nv + k) * 6 + s;
      g += ab[k] * sm[L.G + jk];
      gv += sm[L.SxS + jk] * sm[L.D + k * nv + j] * ab[k] * sm[L.v + k];
    }
    sm[L.dAG + e] = g;
    sm[L.dAvG + e] = gv + ab[j] * sm[L.CVS + e];
  }
}

// direction j's derivatives of body b's velocity and acceleration:
// dV, dAcc (q-direction) and dVv, dAccv (v-direction)
template <typename S>
__device__ void body_derivs(const S* sm, const Layout& L, int nv, int b, int j,
                            S* dV, S* dAcc, S* dVv, S* dAccv) {
  const S abj = sm[L.A + b * nv + j];
  const S* Sj = sm + L.S_ + j * 6;
  S w[6], t[6];
  for (int s = 0; s < 6; ++s) w[s] = sm[L.Vb + b * 6 + s] - sm[L.Vpar + j * 6 + s];
  mcross(Sj, w, t);
  for (int s = 0; s < 6; ++s) dV[s] = abj * t[s];
  for (int s = 0; s < 6; ++s) w[s] = sm[L.Ca + b * 6 + s] - sm[L.Capar + j * 6 + s];
  mcross(Sj, w, t);
  for (int s = 0; s < 6; ++s) {
    dAcc[s] = abj * t[s] + sm[L.dAG + j * 6 + s];
    dVv[s] = abj * Sj[s];
    dAccv[s] = sm[L.dAvG + j * 6 + s];
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
fd_rows_kernel(const int nv, const int nb, const int nc, const Table tab,
               const In<S> in, const Out<S> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const Layout L(nv, nb, nc, tab.ncont);
  const size_t m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ncont = tab.ncont;
  const S kd = static_cast<S>(tab.kd), kp = static_cast<S>(tab.kp);

  // ---- load the instance's inputs and the shared masks (stride 0)
#define LOAD(dst, src, n, stride) \
  for (int i = tid; i < (n); i += nt) sm[(dst) + i] = (src)[m * (stride) + i]
  LOAD(L.S_, in.S_, nv * 6, nv * 6);
  LOAD(L.v, in.v, nv, nv);
  LOAD(L.Vpar, in.Vpar, nv * 6, nv * 6);
  LOAD(L.Vdof, in.Vdof, nv * 6, nv * 6);
  LOAD(L.Capar, in.Capar, nv * 6, nv * 6);
  LOAD(L.Vb, in.Vb, nb * 6, nb * 6);
  LOAD(L.Ca, in.Ca, nb * 6, nb * 6);
  LOAD(L.Accb, in.Accb, nb * 6, nb * 6);
  LOAD(L.h, in.h, nb * 6, nb * 6);
  LOAD(L.y, in.y, nb * 6, nb * 6);
  LOAD(L.I6, in.I6, nb * 36, nb * 36);
  LOAD(L.lam, in.lam, nc, nc);
  LOAD(L.pc, in.pc, ncont * 3, ncont * 3);
  LOAD(L.act, in.act, ncont, ncont);
  LOAD(L.A, in.A, nb * nv, 0);
  LOAD(L.D, in.D, nv * nv, 0);
#undef LOAD
  for (int i = tid; i < nv * nv; i += nt) sm[L.ra1q + i] = sm[L.ra1v + i] = S(0);
  for (int i = tid; i < nv * 6; i += nt) sm[L.F + i] = S(0);
  __syncthreads();

  // ---- pair tables: SxS[j,k] = S_j x S_k, G[j,k] = D[k,j] (X2 + X3) with
  // X1 = S_j x (Vdof_k - Vpar_j), X2 = X1 x (S_k v_k),
  // X3 = Vdof_k x (SxS[j,k] v_k); and CVS_k = Vdof_k x S_k
  for (int e = tid; e < nv * nv; e += nt) {
    const int j = e / nv, k = e % nv;
    const S* Sj = sm + L.S_ + j * 6;
    const S* Sk = sm + L.S_ + k * 6;
    const S* Vdk = sm + L.Vdof + k * 6;
    const S vk = sm[L.v + k];
    S sxs[6], w[6], x1[6], x2[6], x3[6];
    mcross(Sj, Sk, sxs);
    for (int s = 0; s < 6; ++s) w[s] = Vdk[s] - sm[L.Vpar + j * 6 + s];
    mcross(Sj, w, x1);
    for (int s = 0; s < 6; ++s) w[s] = Sk[s] * vk;
    mcross(x1, w, x2);
    for (int s = 0; s < 6; ++s) w[s] = sxs[s] * vk;
    mcross(Vdk, w, x3);
    const S dkj = sm[L.D + k * nv + j];
    for (int s = 0; s < 6; ++s) {
      sm[L.SxS + e * 6 + s] = sxs[s];
      sm[L.G + e * 6 + s] = dkj * (x2[s] + x3[s]);
    }
  }
  for (int k = tid; k < nv; k += nt) {
    mcross(sm + L.Vdof + k * 6, sm + L.S_ + k * 6, sm + L.CVS + k * 6);
  }
  __syncthreads();

  // ---- body pass: force derivatives and the tau-derivative accumulators
  for (int b = 0; b < nb; ++b) {
    body_contractions(sm, L, nv, b);
    __syncthreads();
    const S* I6b = sm + L.I6 + b * 36;
    const S* Vbb = sm + L.Vb + b * 6;
    const S* hb = sm + L.h + b * 6;
    const S* yb = sm + L.y + b * 6;
    for (int j = tid; j < nv; j += nt) {
      S dV[6], dAcc[6], dVv[6], dAccv[6], t1[6], t2[6], t3[6], df[6], dfv[6];
      body_derivs(sm, L, nv, b, j, dV, dAcc, dVv, dAccv);
      const S abj = sm[L.A + b * nv + j];
      const S* Sj = sm + L.S_ + j * 6;
      // dI6con(Accb_b, y_b) = abj (S_j x* y_b - I6_b (S_j x Accb_b))
      fcross(Sj, yb, t1);
      mcross(Sj, sm + L.Accb + b * 6, t2);
      mat6(I6b, t2, t3);
      for (int s = 0; s < 6; ++s) df[s] = abj * (t1[s] - t3[s]);
      mat6(I6b, dAcc, t1);
      fcross(dV, hb, t2);
      for (int s = 0; s < 6; ++s) df[s] += t1[s] + t2[s];
      // Vb x* (dI6con(Vb, h) + I6 dV)
      fcross(Sj, hb, t1);
      mcross(Sj, Vbb, t2);
      mat6(I6b, t2, t3);
      mat6(I6b, dV, t2);
      for (int s = 0; s < 6; ++s) t1[s] = abj * (t1[s] - t3[s]) + t2[s];
      fcross(Vbb, t1, t2);
      for (int s = 0; s < 6; ++s) df[s] += t2[s];
      // dfv = I6 dAccv + dVv x* h + Vb x* (I6 dVv)
      mat6(I6b, dAccv, dfv);
      fcross(dVv, hb, t1);
      mat6(I6b, dVv, t2);
      fcross(Vbb, t2, t3);
      for (int s = 0; s < 6; ++s) {
        sm[L.DF + j * 6 + s] = df[s];
        sm[L.DFV + j * 6 + s] = dfv[s] + t1[s] + t3[s];
      }
    }
    if (tid == nt - 1) {  // f_b = y_b + Vb x* h_b
      S t[6];
      fcross(Vbb, hb, t);
      for (int s = 0; s < 6; ++s) sm[L.fb + s] = yb[s] + t[s];
    }
    __syncthreads();
    const S* ab = sm + L.A + b * nv;
    for (int e = tid; e < nv * nv; e += nt) {
      const int k = e / nv, j = e % nv;
      const S* Sk = sm + L.S_ + k * 6;
      sm[L.ra1q + e] += ab[k] * dot6(Sk, sm + L.DF + j * 6);
      sm[L.ra1v + e] += ab[k] * dot6(Sk, sm + L.DFV + j * 6);
    }
    for (int e = tid; e < nv * 6; e += nt) sm[L.F + e] += ab[e / 6] * sm[L.fb + e % 6];
  }
  __syncthreads();

  // ---- subtree-force term: ra1_q[k,j] += D[k,j] SxS[j,k] . F_k
  for (int e = tid; e < nv * nv; e += nt) {
    const int k = e / nv, j = e % nv;
    sm[L.ra1q + e] +=
        sm[L.D + e] * dot6(sm + L.SxS + (j * nv + k) * 6, sm + L.F + k * 6);
  }

  // ---- contacts: acceleration rows and the J' lam transport
  for (int c = 0; c < ncont; ++c) {
    const int bc = tab.body[c], dim = tab.dim[c], off = tab.off[c];
    __syncthreads();
    body_contractions(sm, L, nv, bc);
    __syncthreads();
    const S* pc = sm + L.pc + c * 3;
    const S* Vbc = sm + L.Vb + bc * 6;
    const S* omega = Vbc + 3;
    const S* AccA = sm + L.Accb + bc * 6 + 3;
    const S* wf = sm + L.lam + off;
    const S act = sm[L.act + c];
    S pdot[3];
    cr3(omega, pc, pdot);
    for (int r = 0; r < 3; ++r) pdot[r] += Vbc[r];
    for (int j = tid; j < nv; j += nt) {
      S dV[6], dAcc[6], dVv[6], dAccv[6], dp[3], t[3], u[3], dpdot[3], dpdotv[3];
      S lq[3], lv[3];
      body_derivs(sm, L, nv, bc, j, dV, dAcc, dVv, dAccv);
      const S abj = sm[L.A + bc * nv + j];
      const S* Sj = sm + L.S_ + j * 6;
      cr3(Sj + 3, pc, t);
      for (int r = 0; r < 3; ++r) dp[r] = abj * (Sj[r] + t[r]);
      // dpdot = dVL + dom x p + omega x dp
      cr3(dV + 3, pc, t);
      cr3(omega, dp, u);
      for (int r = 0; r < 3; ++r) dpdot[r] = dV[r] + t[r] + u[r];
      // dalpha_q = dAccL + dAccA x p + AccA x dp + dom x pdot + omega x dpdot
      for (int r = 0; r < 3; ++r) lq[r] = dAcc[r];
      cr3(dAcc + 3, pc, t);
      for (int r = 0; r < 3; ++r) lq[r] += t[r];
      cr3(AccA, dp, t);
      for (int r = 0; r < 3; ++r) lq[r] += t[r];
      cr3(dV + 3, pdot, t);
      for (int r = 0; r < 3; ++r) lq[r] += t[r];
      cr3(omega, dpdot, t);
      for (int r = 0; r < 3; ++r) lq[r] += t[r] + kd * dpdot[r] + kp * dp[r];
      // dpdotv = dVLv + domv x p
      cr3(dVv + 3, pc, t);
      for (int r = 0; r < 3; ++r) dpdotv[r] = dVv[r] + t[r];
      // dalpha_v = dAccLv + dAccAv x p + domv x pdot + omega x dpdotv
      for (int r = 0; r < 3; ++r) lv[r] = dAccv[r];
      cr3(dAccv + 3, pc, t);
      for (int r = 0; r < 3; ++r) lv[r] += t[r];
      cr3(dVv + 3, pdot, t);
      for (int r = 0; r < 3; ++r) lv[r] += t[r];
      cr3(omega, dpdotv, t);
      for (int r = 0; r < 3; ++r) lv[r] += t[r] + kd * dpdotv[r];
      S* rq = out.r2q + (m * nc + off) * nv + j;
      S* rv = out.r2v + (m * nc + off) * nv + j;
      for (int r = 0; r < 3; ++r) {
        rq[r * nv] = act * lq[r];
        rv[r * nv] = act * lv[r];
      }
      if (dim == 6) {
        for (int r = 0; r < 3; ++r) {
          rq[(3 + r) * nv] = act * (dAcc[3 + r] + kd * dV[3 + r]);
          rv[(3 + r) * nv] = act * (dAccv[3 + r] + kd * dVv[3 + r]);
        }
      }
      cr3(dp, wf, sm + L.dpxw + j * 3);
    }
    if (tid == nt - 1) {  // F_c = (w_f, p x w_f + w_tau)
      S t[3];
      cr3(pc, wf, t);
      for (int r = 0; r < 3; ++r) {
        sm[L.Fc + r] = wf[r];
        sm[L.Fc + 3 + r] = t[r] + (dim == 6 ? wf[3 + r] : S(0));
      }
    }
    __syncthreads();
    const S* ab = sm + L.A + bc * nv;
    for (int e = tid; e < nv * nv; e += nt) {
      const int k = e / nv, j = e % nv;
      const S* Sk = sm + L.S_ + k * 6;
      const S* dpxw = sm + L.dpxw + j * 3;
      const S s1 = dot6(sm + L.SxS + (j * nv + k) * 6, sm + L.Fc);
      sm[L.ra1q + e] += ab[k] * (sm[L.D + e] * s1) +
                        ab[k] * (Sk[3] * dpxw[0] + Sk[4] * dpxw[1] + Sk[5] * dpxw[2]);
    }
  }
  __syncthreads();
  for (int e = tid; e < nv * nv; e += nt) {
    out.ra1q[m * nv * nv + e] = sm[L.ra1q + e];
    out.ra1v[m * nv * nv + e] = sm[L.ra1v + e];
  }
}

template <typename S>
int launch(int K, int nv, int nb, const int* table, const double* gains,
           const In<S>& in, const Out<S>& out, cudaStream_t stream) {
  Table tab{};
  tab.ncont = table[0];
  if (K < 1 || nv < 1 || nv > kMaxDim || nb < 1 || nb > kMaxDim) return -1;
  if (tab.ncont < 1 || tab.ncont > kMaxContacts) return -1;
  int nc = 0;
  for (int c = 0; c < tab.ncont; ++c) {
    tab.body[c] = table[1 + c];
    tab.dim[c] = table[1 + kMaxContacts + c];
    tab.off[c] = nc;
    if (tab.body[c] < 0 || tab.body[c] >= nb) return -1;
    if (tab.dim[c] != 3 && tab.dim[c] != 6) return -1;
    nc += tab.dim[c];
  }
  if (nc > kMaxDim) return -1;
  tab.kd = gains[0];
  tab.kp = gains[1];
  const size_t smem = sizeof(S) * static_cast<size_t>(Layout(nv, nb, nc, tab.ncont).total);
  if (smem > kMaxSmem) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd_rows_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fd_rows_kernel<S><<<K, kThreads, smem, stream>>>(nv, nb, nc, tab, in, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int entry(int K, int nv, int nb, const int* table, const double* gains,
          const S* S_, const S* v, const S* Vb, const S* Vpar, const S* Vdof,
          const S* Ca, const S* Capar, const S* Accb, const S* h, const S* y,
          const S* I6, const S* lam, const S* pc, const S* act, const S* A,
          const S* D, S* ra1q, S* ra1v, S* r2q, S* r2v, cudaStream_t stream) {
  const In<S> in{S_, v, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, lam, pc, act, A, D};
  const Out<S> out{ra1q, ra1v, r2q, r2v};
  return launch<S>(K, nv, nb, table, gains, in, out, stream);
}

}  // namespace

// Arguments: K instances, nv, nb; the host tables `table` (ncont, then
// kMaxContacts body indices, then kMaxContacts dims) and `gains` (kd, kp);
// the per-instance inputs S (K,nv,6), v (K,nv), Vb (K,nb,6), Vpar, Vdof
// (K,nv,6), Ca (K,nb,6), Capar (K,nv,6), Accb, h, y (K,nb,6), I6
// (K,nb,6,6), lam (K,nc), pc (K,ncont,3), act (K,ncont); the masks A (nb,nv)
// and D (nv,nv); the outputs ra1q, ra1v (K,nv,nv), r2q, r2v (K,nc,nv).
#define FD_ROWS_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(int K, int nv, int nb, const int* table,                 \
                      const double* gains, const T* S_, const T* v,            \
                      const T* Vb, const T* Vpar, const T* Vdof, const T* Ca,  \
                      const T* Capar, const T* Accb, const T* h, const T* y,   \
                      const T* I6, const T* lam, const T* pc, const T* act,    \
                      const T* A, const T* D, T* ra1q, T* ra1v, T* r2q,        \
                      T* r2v, cudaStream_t stream) {                           \
    return entry<T>(K, nv, nb, table, gains, S_, v, Vb, Vpar, Vdof, Ca, Capar, \
                    Accb, h, y, I6, lam, pc, act, A, D, ra1q, ra1v, r2q, r2v,  \
                    stream);                                                   \
  }

FD_ROWS_ENTRY(fd_rows_f32, float)
FD_ROWS_ENTRY(fd_rows_f64, double)
