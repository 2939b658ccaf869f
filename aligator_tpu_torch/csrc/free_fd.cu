// Free forward dynamics of a kinematic tree, one thread a scenario.
//
// Computes a = M(q)^{-1} (tau - b(q, v)) for a batch of states: the function
// of aligator_tpu_torch/modelling/multibody/model.py `aba` (the JAX
// package's `model._aba_impl`, aligator_tpu/modelling/multibody/model.py:575,
// which XLA compiles; there is no Pallas kernel for it). The nonlinear
// rollout calls it once a stage for the whole batch, where the PyTorch
// version is ~135-235 small operations (the kinematics, RNEA at a = 0, the
// mass matrix, a Cholesky solve), each a kernel of a few microseconds inside
// the line-search trial's CUDA graph: the rollout's time was the launch
// chain of those kernels, not their arithmetic.
//
// Same formulation as the PyTorch version, every spatial quantity at one
// point, here the first joint's position rather than the world origin (the
// dynamics are invariant under the shift, gravity being uniform, and far
// from the origin the spatial inertias' m c^ c^ terms would cancel to
// garbage: a free-flying base at 5e9 m, which a line search's trial
// rollout can reach, failed the Cholesky factorization where the PyTorch
// version, summing in another order, did not): forward kinematics down the
// tree (joints in topological
// order, parents[i] < i), the dof axes S_k, body velocities V_b = V_parent
// + sum S_k v_k, bias accelerations with gravity, Newton-Euler forces f_b =
// I_b Acc_b + V_b x* (I_b V_b) and their subtree sums F_j, b_k = S_k . F_j;
// the mass matrix from the composite spatial inertias, M_kl = S_k . Ic_j(l)
// S_l for joint(k) an ancestor of (or equal to) joint(l); then a Cholesky
// factor and two substitutions. A factorization that fails gives NaN in its
// own scenario only. The sums run in another order than PyTorch's einsums,
// so results agree to rounding (about 1e-15 relative in float64).
//
// Bound on an H100: a thread reads q, v, tau and writes a (a few hundred
// bytes) and does ~10^4 flops at nv = 20; at the paths' batches (256 to
// 1024) either bound is well under a microsecond, so the time is one
// thread's dependent chain.
//
// Model tables (made once a model by the wrapper):
//   itab: [type (nj) | parent (nj) | q index (nj) | v index (nj)],
//         type 0 revolute, 1 prismatic, 2 free-flyer;
//   ftab: [R0 (nj x 9) | p0 (nj x 3) | axis (nj x 3) | mass (nj) |
//          com (nj x 3) | inertia (nj x 9) | gravity (3) | armature (nv)],
//         R0 the joint placements' rotations (row major), armature the
//         per-dof reflected rotor inertia (zeros for a model without one),
//         added to M's diagonal as the PyTorch version's mass_matrix does
//         (RNEA's armature * a term vanishes in b = RNEA(q, v, 0)).
//
// Models of at most kMaxJ joints and kMaxV dofs keep their arrays in the
// thread (local memory the compiler may hold in registers); a larger model
// takes the same code with its arrays in a global workspace, a slice of
// work_words(nj, nv) a scenario, which the wrapper allocates: no cap on
// joints or dofs, at the cost of the slice's traffic through L1 and L2.
//
// C interface (one function per scalar type): free_fd_f32/f64 take the
// workspace of free_fd_workspace(B, nj, nv) words (null when that is 0),
// return -1 for an empty batch or a missing workspace, otherwise
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxJ = 16;
constexpr int kMaxV = 24;
constexpr int kThreads = 128;

template <typename S>
__device__ inline void cross3(const S* a, const S* b, S* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
__device__ inline void matvec3(const S* R, const S* x, S* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2];
}

template <typename S>
__device__ inline void matmul3(const S* A, const S* B, S* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename S>
__device__ inline void quat_to_matrix(S x, S y, S z, S w, S* R) {
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - z * w);
  R[2] = 2 * (x * z + y * w);
  R[3] = 2 * (x * y + z * w);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - x * w);
  R[6] = 2 * (x * z - y * w);
  R[7] = 2 * (y * z + x * w);
  R[8] = 1 - 2 * (x * x + y * y);
}

// rotation exp(w^) through its quaternion, Taylor-guarded as se3.exp3_quat
template <typename S>
__device__ inline void exp3_matrix(const S* w, S* R) {
  const S eps = S(1e-8);
  const S t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const S t = sqrt(t2 > eps * eps ? t2 : eps * eps);
  const bool small = t2 < eps;
  const S s = small ? S(0.5) - t2 / S(48) : sin(S(0.5) * t) / t;
  const S c = small ? S(1) - t2 / S(8) : cos(S(0.5) * t);
  quat_to_matrix(s * w[0], s * w[1], s * w[2], c, R);
}

// spatial momentum of a body (mass m, com c, inertia I about the com, all
// at the world origin) moving with the motion (v; w): (m (v + w x c);
// I w + c x p)
template <typename S>
__device__ inline void inertia_apply(S m, const S* c, const S* I, const S* mv, S* out) {
  S wc[3], vc[3], Iw[3], cp[3];
  cross3(mv + 3, c, wc);
  for (int i = 0; i < 3; ++i) vc[i] = m * (mv[i] + wc[i]);
  matvec3(I, mv + 3, Iw);
  cross3(c, vc, cp);
  for (int i = 0; i < 3; ++i) {
    out[i] = vc[i];
    out[3 + i] = Iw[i] + cp[i];
  }
}

// m x* f: (w x fl; w x tau + v x fl)
template <typename S>
__device__ inline void cross_force(const S* m, const S* f, S* out) {
  S a[3], b[3], c[3];
  cross3(m + 3, f, a);
  cross3(m + 3, f + 3, b);
  cross3(m, f, c);
  for (int i = 0; i < 3; ++i) {
    out[i] = a[i];
    out[3 + i] = b[i] + c[i];
  }
}

// m1 xm m2: (w1 x v2 + v1 x w2; w1 x w2)
template <typename S>
__device__ inline void cross_motion(const S* m1, const S* m2, S* out) {
  S a[3], b[3], c[3];
  cross3(m1 + 3, m2, a);
  cross3(m1, m2 + 3, b);
  cross3(m1 + 3, m2 + 3, c);
  for (int i = 0; i < 3; ++i) {
    out[i] = a[i] + b[i];
    out[3 + i] = c[i];
  }
}

__device__ inline int joint_nv(int type) { return type == 2 ? 6 : 1; }

// One scenario's forward dynamics with its working arrays at the given
// pointers: thread-local arrays (the register route) or its slice of the
// global workspace; M has leading dimension ld.
template <typename S>
__device__ __forceinline__ void free_fd_one(
    const int sc, const int nj, const int nq, const int nv, const int* __restrict__ itab,
    const S* __restrict__ ftab, const S* __restrict__ q, const S* __restrict__ v,
    const S* __restrict__ tau, S* __restrict__ acc, S (*Rw)[9], S (*pw)[3], S (*Sax)[6],
    S (*V)[6], S (*Acc)[6], S (*F)[6], S (*Ic)[36], S* M, const int ld, S* rhs) {
  const int* type = itab;
  const int* parent = itab + nj;
  const int* qidx = itab + 2 * nj;
  const int* vidx = itab + 3 * nj;
  const S* R0 = ftab;
  const S* p0 = R0 + 9 * nj;
  const S* axis = p0 + 3 * nj;
  const S* mass = axis + 3 * nj;
  const S* com = mass + nj;
  const S* inertia = com + 3 * nj;
  const S* grav = inertia + 9 * nj;
  const S* armature = grav + 3;
  const S* qs = q + static_cast<long long>(sc) * nq;
  const S* vs = v + static_cast<long long>(sc) * nv;
  // Rw, pw: world poses, positions from `origin`; Sax: dof axes at
  // `origin`; V, Acc: body velocities, bias accelerations; F: forces, then
  // their subtree sums; Ic: spatial inertias, then composite
  S origin[3] = {0, 0, 0};  // the first joint's world position

  for (int i = 0; i < nj; ++i) {
    // local transform
    S Rj[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1}, pj[3] = {0, 0, 0};
    const S* a = axis + 3 * i;
    const S* qi = qs + qidx[i];
    if (type[i] == 0) {
      const S w[3] = {a[0] * qi[0], a[1] * qi[0], a[2] * qi[0]};
      exp3_matrix(w, Rj);
    } else if (type[i] == 1) {
      for (int k = 0; k < 3; ++k) pj[k] = a[k] * qi[0];
    } else {
      for (int k = 0; k < 3; ++k) pj[k] = qi[k];
      quat_to_matrix(qi[3], qi[4], qi[5], qi[6], Rj);
    }
    S Rl[9], pl[3];
    matmul3(R0 + 9 * i, Rj, Rl);
    matvec3(R0 + 9 * i, pj, pl);
    for (int k = 0; k < 3; ++k) pl[k] += p0[3 * i + k];
    const int par = parent[i];
    if (par < 0) {
      if (i == 0)
        for (int k = 0; k < 3; ++k) origin[k] = pl[k];
      for (int k = 0; k < 9; ++k) Rw[i][k] = Rl[k];
      for (int k = 0; k < 3; ++k) pw[i][k] = pl[k] - origin[k];
    } else {
      S t[3];
      matmul3(Rw[par], Rl, Rw[i]);
      matvec3(Rw[par], pl, t);
      for (int k = 0; k < 3; ++k) pw[i][k] = pw[par][k] + t[k];
    }
    // dof axes: local (lin; ang) rotated to the world, linear part at
    // `origin`
    for (int c = 0; c < joint_nv(type[i]); ++c) {
      S sl[3] = {0, 0, 0}, sa[3] = {0, 0, 0};
      if (type[i] == 0) {
        for (int k = 0; k < 3; ++k) sa[k] = a[k];
      } else if (type[i] == 1) {
        for (int k = 0; k < 3; ++k) sl[k] = a[k];
      } else if (c < 3) {
        sl[c] = 1;
      } else {
        sa[c - 3] = 1;
      }
      S* s = Sax[vidx[i] + c];
      S wl[3], x[3];
      matvec3(Rw[i], sa, s + 3);
      matvec3(Rw[i], sl, wl);
      cross3(pw[i], s + 3, x);
      for (int k = 0; k < 3; ++k) s[k] = wl[k] + x[k];
    }
    // velocity, then the bias acceleration (joint acceleration zero)
    for (int k = 0; k < 6; ++k) {
      V[i][k] = par < 0 ? S(0) : V[par][k];
      Acc[i][k] = par < 0 ? (k < 3 ? -grav[k] : S(0)) : Acc[par][k];
    }
    for (int c = 0; c < joint_nv(type[i]); ++c) {
      const int d = vidx[i] + c;
      for (int k = 0; k < 6; ++k) V[i][k] += Sax[d][k] * vs[d];
    }
    for (int c = 0; c < joint_nv(type[i]); ++c) {
      const int d = vidx[i] + c;
      S sv[6], beta[6];
      for (int k = 0; k < 6; ++k) sv[k] = Sax[d][k] * vs[d];
      cross_motion(V[i], sv, beta);
      for (int k = 0; k < 6; ++k) Acc[i][k] += beta[k];
    }
    // world inertia: com c = p + R com, I_w = R I R'
    S cw[3], RI[9], Iw[9];
    matvec3(Rw[i], com + 3 * i, cw);
    for (int k = 0; k < 3; ++k) cw[k] += pw[i][k];
    matmul3(Rw[i], inertia + 9 * i, RI);
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc)
        Iw[3 * r + cc] = RI[3 * r] * Rw[i][3 * cc] + RI[3 * r + 1] * Rw[i][3 * cc + 1] +
                         RI[3 * r + 2] * Rw[i][3 * cc + 2];
    const S m = mass[i];
    S h[6], fa[6], vxh[6];
    inertia_apply(m, cw, Iw, V[i], h);
    inertia_apply(m, cw, Iw, Acc[i], fa);
    cross_force(V[i], h, vxh);
    for (int k = 0; k < 6; ++k) F[i][k] = fa[k] + vxh[k];
    // 6x6 spatial inertia at `origin`: [[m I, -m c^], [m c^, I_w - m c^ c^]]
    const S ch[9] = {0, -cw[2], cw[1], cw[2], 0, -cw[0], -cw[1], cw[0], 0};
    S* I6 = Ic[i];
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc) {
        S chch = ch[3 * r] * ch[cc] + ch[3 * r + 1] * ch[3 + cc] + ch[3 * r + 2] * ch[6 + cc];
        I6[6 * r + cc] = r == cc ? m : S(0);
        I6[6 * r + 3 + cc] = -m * ch[3 * r + cc];
        I6[6 * (3 + r) + cc] = m * ch[3 * r + cc];
        I6[6 * (3 + r) + 3 + cc] = Iw[3 * r + cc] - m * chch;
      }
  }
  // subtree sums of the forces and of the spatial inertias
  for (int i = nj - 1; i > 0; --i) {
    const int par = parent[i];
    if (par < 0) continue;
    for (int k = 0; k < 6; ++k) F[par][k] += F[i][k];
    for (int k = 0; k < 36; ++k) Ic[par][k] += Ic[i][k];
  }
  // rhs = tau - b; the mass matrix's entries where joint(k) <= joint(l)
  for (int i = 0; i < nj; ++i)
    for (int c = 0; c < joint_nv(type[i]); ++c) {
      const int l = vidx[i] + c;
      S b = 0;
      for (int k = 0; k < 6; ++k) b += Sax[l][k] * F[i][k];
      rhs[l] = tau[static_cast<long long>(sc) * nv + l] - b;
      S IS[6];
      for (int r = 0; r < 6; ++r) {
        S t = 0;
        for (int k = 0; k < 6; ++k) t += Ic[i][6 * r + k] * Sax[l][k];
        IS[r] = t;
      }
      for (int j = i; j >= 0; j = parent[j])
        for (int cj = 0; cj < joint_nv(type[j]); ++cj) {
          const int k = vidx[j] + cj;
          if (j == i && k > l) continue;
          S t = 0;
          for (int r = 0; r < 6; ++r) t += Sax[k][r] * IS[r];
          M[k * ld + l] = t;
          M[l * ld + k] = t;
        }
    }
  // zero the pairs whose joints lie on different branches
  for (int i = 0; i < nj; ++i)
    for (int j = i + 1; j < nj; ++j) {
      bool related = false;
      for (int a = j; a >= 0; a = parent[a]) related = related || a == i;
      if (related) continue;
      for (int ci = 0; ci < joint_nv(type[i]); ++ci)
        for (int cj = 0; cj < joint_nv(type[j]); ++cj) {
          M[(vidx[i] + ci) * ld + vidx[j] + cj] = 0;
          M[(vidx[j] + cj) * ld + vidx[i] + ci] = 0;
        }
    }
  for (int k = 0; k < nv; ++k) M[k * ld + k] += armature[k];
  // Cholesky M = L L' in the lower triangle, then L y = rhs, L' a = y
  bool ok = true;
  for (int j = 0; j < nv; ++j) {
    S d = M[j * ld + j];
    for (int k = 0; k < j; ++k) d -= M[j * ld + k] * M[j * ld + k];
    ok = ok && d > S(0);
    const S l = sqrt(d);
    M[j * ld + j] = l;
    for (int i = j + 1; i < nv; ++i) {
      S t = M[i * ld + j];
      for (int k = 0; k < j; ++k) t -= M[i * ld + k] * M[j * ld + k];
      M[i * ld + j] = t / l;
    }
  }
  for (int i = 0; i < nv; ++i) {
    S t = rhs[i];
    for (int k = 0; k < i; ++k) t -= M[i * ld + k] * rhs[k];
    rhs[i] = t / M[i * ld + i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    S t = rhs[i];
    for (int k = i + 1; k < nv; ++k) t -= M[k * ld + i] * rhs[k];
    rhs[i] = t / M[i * ld + i];
  }
  S* out = acc + static_cast<long long>(sc) * nv;
  for (int i = 0; i < nv; ++i) out[i] = ok ? rhs[i] : S(NAN);
}


// words of the global workspace a scenario: Rw, pw, V, Acc, F, Ic (nj x
// 66), Sax (nv x 6), M (nv x nv), rhs (nv)
__host__ __device__ inline long long work_words(int nj, int nv) {
  return 66LL * nj + 6LL * nv + static_cast<long long>(nv) * nv + nv;
}

// the register route: thread-local arrays, models of at most kMaxJ joints
// and kMaxV dofs
template <typename S>
__global__ void __launch_bounds__(kThreads)
free_fd_kernel(int B, int nj, int nq, int nv, const int* __restrict__ itab,
               const S* __restrict__ ftab, const S* __restrict__ q,
               const S* __restrict__ v, const S* __restrict__ tau, S* __restrict__ acc) {
  const int sc = blockIdx.x * blockDim.x + threadIdx.x;
  if (sc >= B) return;
  S Rw[kMaxJ][9], pw[kMaxJ][3], Sax[kMaxV][6], V[kMaxJ][6], Acc[kMaxJ][6], F[kMaxJ][6],
      Ic[kMaxJ][36], M[kMaxV * kMaxV], rhs[kMaxV];
  free_fd_one(sc, nj, nq, nv, itab, ftab, q, v, tau, acc, Rw, pw, Sax, V, Acc, F, Ic, M,
              kMaxV, rhs);
}

// larger models: the same arrays in a slice of the global workspace, one
// a scenario
template <typename S>
__global__ void __launch_bounds__(kThreads)
free_fd_kernel_ws(int B, int nj, int nq, int nv, const int* __restrict__ itab,
                  const S* __restrict__ ftab, const S* __restrict__ q,
                  const S* __restrict__ v, const S* __restrict__ tau, S* __restrict__ acc,
                  S* __restrict__ work) {
  const int sc = blockIdx.x * blockDim.x + threadIdx.x;
  if (sc >= B) return;
  S* w = work + sc * work_words(nj, nv);
  S(*Rw)[9] = reinterpret_cast<S(*)[9]>(w);
  S(*pw)[3] = reinterpret_cast<S(*)[3]>(w + 9 * nj);
  S(*V)[6] = reinterpret_cast<S(*)[6]>(w + 12 * nj);
  S(*Acc)[6] = reinterpret_cast<S(*)[6]>(w + 18 * nj);
  S(*F)[6] = reinterpret_cast<S(*)[6]>(w + 24 * nj);
  S(*Ic)[36] = reinterpret_cast<S(*)[36]>(w + 30 * nj);
  S(*Sax)[6] = reinterpret_cast<S(*)[6]>(w + 66 * nj);
  S* M = w + 66 * nj + 6 * nv;
  free_fd_one(sc, nj, nq, nv, itab, ftab, q, v, tau, acc, Rw, pw, Sax, V, Acc, F, Ic, M,
              nv, M + nv * nv);
}

bool in_registers(int nj, int nv) { return nj <= kMaxJ && nv <= kMaxV; }

template <typename S>
int launch(int B, int nj, int nq, int nv, const int* itab, const S* ftab, const S* q,
           const S* v, const S* tau, S* acc, S* work, cudaStream_t stream) {
  if (nj < 1 || nv < 1 || B < 1) return -1;
  const int blocks = (B + kThreads - 1) / kThreads;
  if (in_registers(nj, nv)) {
    free_fd_kernel<S><<<blocks, kThreads, 0, stream>>>(B, nj, nq, nv, itab, ftab, q, v,
                                                        tau, acc);
  } else {
    if (work == nullptr) return -1;
    free_fd_kernel_ws<S><<<blocks, kThreads, 0, stream>>>(B, nj, nq, nv, itab, ftab, q,
                                                           v, tau, acc, work);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// workspace words of a launch: 0 on the register route
extern "C" long long free_fd_workspace(int B, int nj, int nv) {
  return in_registers(nj, nv) ? 0 : static_cast<long long>(B) * work_words(nj, nv);
}

extern "C" int free_fd_f32(int B, int nj, int nq, int nv, const int* itab,
                           const float* ftab, const float* q, const float* v,
                           const float* tau, float* acc, float* work, cudaStream_t stream) {
  return launch<float>(B, nj, nq, nv, itab, ftab, q, v, tau, acc, work, stream);
}

extern "C" int free_fd_f64(int B, int nj, int nq, int nv, const int* itab,
                           const double* ftab, const double* q, const double* v,
                           const double* tau, double* acc, double* work,
                           cudaStream_t stream) {
  return launch<double>(B, nj, nq, nv, itab, ftab, q, v, tau, acc, work, stream);
}
