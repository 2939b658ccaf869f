// Contact-dynamics derivative rows, one thread block per instance.
//
// Replaces: aligator_tpu/modelling/multibody/pallas_tensors.py
// `make_fd_rows_kernel` (the Pallas TPU kernel K5, entry point
// `fd_rows_lanes`). For one (scenario x stage) instance at the primal
// solution (a*, lam*) of the contact dynamics it computes
//   ra1_q, ra1_v (nv x nv): d(RNEA + J' lam)/d(q, v),
//   r2_q, r2_v   (nc x nv): d(J a + gamma)/d(q, v), masked by activity,
// by the TPU kernel's algorithm: the pair tables SxS[j,k] = S_j x S_k and
// G[j,k] (the velocity-product bias derivatives), then each body's force
// derivatives df_b[j], dfv_b[j] for its directions j without
// materializing dI6, through the identity
//   (dI6/dq_j) w = A[b,j] (S_j x* (I6 w) - I6 (S_j x w)),
// summed into d tau[k,j] = sum_b A[b,k] S_k . df_b[j]; then the subtree
// force term and, per contact, the acceleration rows and the J' lam
// transport.
//
// Bound on an H100: at the Talos shapes (nv = 28, nb = 23, two 6D contacts,
// K = 512 instances) the call reads about 2,450 and writes 2,240 words per
// instance (9.2 MB in fp32 for K = 512, 2.7 us). The function needs about
// 0.31 MFLOP per instance (0.16 GFLOP, 2.3 us at 67 TFLOP/s). Bytes bound it.
//
// Design: the TPU kernel put 128 instances on the vector lanes and looped
// densely over all dofs. Every term is a product with the masks A[b,k]
// (dof k moves body b) and D[k,j] (joint(j) is joint(k) or its ancestor),
// and a body moves with about 9.5 of Talos' 28 dofs, so this kernel walks
// only the nonzeros, from index lists the host builds once per model
// (fd_rows.py `support_lists`, layout in Index below): the pairs (j, k)
// with D[k,j] = 1 (249 of 784 at Talos), the slots (b, j) with A[b,j] = 1
// (219 of 644), each slot's pairs, each dof's bodies, and the entries (k,
// j) of ra1 that some body's dofs hold both of (440 of 784), each with the
// slots it sums. Each instance gets one block of 128 threads and four
// phases, one barrier each:
//   1. inputs into shared memory, all copies in flight at once (cp.async);
//   2. a thread a pair: SxS and G (12 words a pair); CVS_k; f_b = y_b +
//      Vb x* h_b; each contact's force F_c and point velocity;
//   3. a thread a slot (b, j): the contractions over the slot's pairs, the
//      6-vector algebra of direction j, df_b[j] and dfv_b[j] (12 words a
//      slot) and, where b holds a contact, that contact's rows for j; then
//      the subtree forces F_k and the zero rows of directions a contact's
//      body does not move with;
//   4. a thread an entry (k, j) of ra1_q and ra1_v, those with the most
//      terms first: the sum over its slots, the subtree force term and the
//      contacts' transport, written straight out; the other entries are 0.
// Slots and bodies are independent, so no thread waits on a body loop and
// each output has one owner thread (no atomics). Shared memory: the inputs,
// 12 words a pair and 12 a slot (34 KB in fp32, 68 KB in fp64 at Talos;
// the launcher opts in above 48 KB); the index lists are read through the
// read-only cache. The sums run in the plain version's order over the
// nonzero terms; the zero terms it adds are skipped. At most 128 registers
// a thread, 4 blocks an SM: against 256 threads a block (with or without a
// cap of 128, 85 or 64 registers) and 128 threads capped at 85 or 64, this
// measured fastest at K = 512 and within 0.4% of the fastest at K = 8192
// (H100 80GB HBM3, 700 W, tools/torch_k2_k5_scan.py, before the loads went
// asynchronous and the entries got their lists).
//
// An instance whose working set exceeds a block's shared memory (a chain
// of ~40 dofs or more: the pairs and slots grow as nv^2) takes the same
// code with the working set in a slice of a global workspace, which the
// wrapper allocates; it then loads with plain copies. nv, nb, nc and the
// number of contacts have no cap.
//
// The contact configuration is runtime data, so one build serves every
// robot: the body, dim (3 or 6) and offset of each contact sit at the end of
// the device index lists (Index: cbody, cdim, coff), which the wrapper
// builds once per (model, contact list), and the kernel reads them through
// the read-only cache; kd and kp are kernel parameters. C interface
// (one function per scalar type): returns -1 for dimensions it does not
// take or a missing workspace, otherwise cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "async_copy.cuh"
#include "block_linalg.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // at most 128 registers a thread
constexpr size_t kMaxSmem = 232448;  // a block's opt-in shared memory on an H100

struct Table {
  int ncont;
  int npair, nslot, nrel, nsp, neb;  // the index lists' lengths (Index)
  double kd, kp;
};

template <typename S>
struct In {
  const S *S_, *v, *Vb, *Vpar, *Vdof, *Ca, *Capar, *Accb, *h, *y, *I6, *lam,
      *pc, *act;
};

template <typename S>
struct Out {
  S *ra1q, *ra1v, *r2q, *r2v;
};

// offsets (ints) of the index lists in the host-built table
// (fd_rows.py `support_lists`): pair p is (pair_j[p], pair_k[p]); slot s is
// (slot_b[s], slot_j[s]), slot_of[b * nv + j] the slot of (b, j) or -1, and
// sp[sp_off[s] .. sp_off[s + 1] - 1] its pairs (j, k) over the dofs k that
// move b (k ascending); the bodies that dof k moves are sub[sub_off[k] ..
// sub_off[k + 1] - 1]; entry e < nrel of ra1 is ent[e] = k nv + j, with
// ent_pair[e] the pair (j, k) or -1 and eb[eb_off[e] .. eb_off[e + 1] - 1]
// the slots (b, j) of the bodies both k and j move (b ascending); entries
// nrel .. nv^2 - 1 are zero. Contact c is on body cbody[c], of dim cdim[c]
// and at offset coff[c] of lambda and the rows.
struct Index {
  int pair_j, pair_k, slot_b, slot_j, slot_of, sp_off, sp, sub_off, sub, ent, ent_pair,
      eb_off, eb, cbody, cdim, coff, total;
  __host__ __device__ Index(int nv, int nb, const Table& t) {
    pair_j = 0;
    pair_k = pair_j + t.npair;
    slot_b = pair_k + t.npair;
    slot_j = slot_b + t.nslot;
    slot_of = slot_j + t.nslot;
    sp_off = slot_of + nb * nv;
    sp = sp_off + t.nslot + 1;
    sub_off = sp + t.nsp;
    sub = sub_off + nv + 1;
    ent = sub + t.nslot;
    ent_pair = ent + nv * nv;
    eb_off = ent_pair + t.nrel;
    eb = eb_off + t.nrel + 1;
    cbody = eb + t.neb;
    cdim = cbody + t.ncont;
    coff = cdim + t.ncont;
    total = coff + t.ncont;
  }
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
  int S_, v, Vpar, Vdof, Capar, CVS, Vb, Ca, Accb, h, y, I6, fb, F, SxS, G, DF,
      DFV, dpxw, Fc, pdot, lam, pc, act, total;
  __host__ __device__ static int take(int& o, int n) {
    const int at = o;
    o += n;
    return at;
  }
  __host__ __device__ Layout(int nv, int nb, int nc, int ncont, int npair, int nslot) {
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
    fb = take(o, nb * 6);
    F = take(o, nv * 6);
    SxS = take(o, npair * 6);
    G = take(o, npair * 6);
    DF = take(o, nslot * 6);
    DFV = take(o, nslot * 6);
    dpxw = take(o, ncont * nv * 3);
    Fc = take(o, ncont * 6);
    pdot = take(o, ncont * 3);
    lam = take(o, nc);
    pc = take(o, ncont * 3);
    act = take(o, ncont);
    total = o;
  }
};

// direction j's derivatives of body b's velocity and acceleration (slot
// e = (b, j), so A[b,j] = 1): dV, dAcc (q-direction) and dVv, dAccv
// (v-direction), with the contractions over b's dofs k
//   dAG[s] = sum_k A[b,k] G[j,k,s],
//   dAvG[s] = sum_k SxS[j,k,s] D[k,j] A[b,k] v_k + CVS[j,s]
// over the slot's pairs
template <typename S>
__device__ void slot_derivs(const S* sm, const int* __restrict__ ix, const Layout& L,
                            const Index& I, int e, int b, int j, S* dV, S* dAcc,
                            S* dVv, S* dAccv) {
  S g[6], gv[6];
  for (int s = 0; s < 6; ++s) g[s] = gv[s] = S(0);
  const int t1 = __ldg(ix + I.sp_off + e + 1);
  for (int t = __ldg(ix + I.sp_off + e); t < t1; ++t) {
    const int p = __ldg(ix + I.sp + t);
    const S vk = sm[L.v + __ldg(ix + I.pair_k + p)];
    for (int s = 0; s < 6; ++s) {
      g[s] += sm[L.G + p * 6 + s];
      gv[s] += sm[L.SxS + p * 6 + s] * vk;
    }
  }
  const S* Sj = sm + L.S_ + j * 6;
  S w[6];
  for (int s = 0; s < 6; ++s) w[s] = sm[L.Vb + b * 6 + s] - sm[L.Vpar + j * 6 + s];
  mcross(Sj, w, dV);
  for (int s = 0; s < 6; ++s) w[s] = sm[L.Ca + b * 6 + s] - sm[L.Capar + j * 6 + s];
  mcross(Sj, w, dAcc);
  for (int s = 0; s < 6; ++s) {
    dAcc[s] += g[s];
    dVv[s] = Sj[s];
    dAccv[s] = gv[s] + sm[L.CVS + j * 6 + s];
  }
}

// kGlobal: the instance's working set (Layout) in its slice of the global
// workspace `work` rather than in shared memory
template <typename S, bool kGlobal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fd_rows_kernel(const int nv, const int nb, const int nc, const Table tab,
               const In<S> in, const int* __restrict__ ix, const Out<S> out, S* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ncont = tab.ncont, npair = tab.npair, nslot = tab.nslot;
  const Layout L(nv, nb, nc, ncont, npair, nslot);
  const Index I(nv, nb, tab);
  const size_t m = blockIdx.x;
  S* sm = kGlobal ? work + m * L.total : reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const S kd = static_cast<S>(tab.kd), kp = static_cast<S>(tab.kp);

  // ---- 1. the instance's inputs (cp.async: every copy in flight at once)
#define LOAD(dst, src, n)                                                      \
  for (int i = tid; i < (n); i += nt) {                                        \
    if (kGlobal)                                                               \
      sm[(dst) + i] = (src)[m * (n) + i];                                      \
    else                                                                       \
      aligator::cp_async_small<sizeof(S)>(sm + (dst) + i, (src) + m * (n) + i); \
  }
  LOAD(L.S_, in.S_, nv * 6);
  LOAD(L.v, in.v, nv);
  LOAD(L.Vpar, in.Vpar, nv * 6);
  LOAD(L.Vdof, in.Vdof, nv * 6);
  LOAD(L.Capar, in.Capar, nv * 6);
  LOAD(L.Vb, in.Vb, nb * 6);
  LOAD(L.Ca, in.Ca, nb * 6);
  LOAD(L.Accb, in.Accb, nb * 6);
  LOAD(L.h, in.h, nb * 6);
  LOAD(L.y, in.y, nb * 6);
  LOAD(L.I6, in.I6, nb * 36);
  LOAD(L.lam, in.lam, nc);
  LOAD(L.pc, in.pc, ncont * 3);
  LOAD(L.act, in.act, ncont);
#undef LOAD
  aligator::cp_async_commit();
  aligator::cp_async_wait<0>();
  __syncthreads();

  // ---- 2. pair tables: SxS[j,k] = S_j x S_k, G[j,k] = X2 + X3 with
  // X1 = S_j x (Vdof_k - Vpar_j), X2 = X1 x (S_k v_k),
  // X3 = Vdof_k x (SxS[j,k] v_k), for the pairs with D[k,j] = 1; CVS_k =
  // Vdof_k x S_k; f_b = y_b + Vb x* h_b; per contact F_c = (w_f, p x w_f +
  // w_tau) and the point velocity pdot = v + omega x p
  for (int e = tid; e < npair + nv + nb + ncont; e += nt) {
    if (e < npair) {
      const int j = __ldg(ix + I.pair_j + e), k = __ldg(ix + I.pair_k + e);
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
      for (int s = 0; s < 6; ++s) {
        sm[L.SxS + e * 6 + s] = sxs[s];
        sm[L.G + e * 6 + s] = x2[s] + x3[s];
      }
    } else if (e < npair + nv) {
      const int k = e - npair;
      mcross(sm + L.Vdof + k * 6, sm + L.S_ + k * 6, sm + L.CVS + k * 6);
    } else if (e < npair + nv + nb) {
      const int b = e - npair - nv;
      S t[6];
      fcross(sm + L.Vb + b * 6, sm + L.h + b * 6, t);
      for (int s = 0; s < 6; ++s) sm[L.fb + b * 6 + s] = sm[L.y + b * 6 + s] + t[s];
    } else {
      const int c = e - npair - nv - nb;
      const S* pc = sm + L.pc + c * 3;
      const S* Vbc = sm + L.Vb + __ldg(ix + I.cbody + c) * 6;
      const S* wf = sm + L.lam + __ldg(ix + I.coff + c);
      S t[3];
      cr3(pc, wf, t);
      for (int r = 0; r < 3; ++r) {
        sm[L.Fc + c * 6 + r] = wf[r];
        sm[L.Fc + c * 6 + 3 + r] = t[r] + (__ldg(ix + I.cdim + c) == 6 ? wf[3 + r] : S(0));
      }
      cr3(Vbc + 3, pc, t);
      for (int r = 0; r < 3; ++r) sm[L.pdot + c * 3 + r] = t[r] + Vbc[r];
    }
  }
  __syncthreads();

  // ---- 3. a thread a slot (b, j): df_b[j], dfv_b[j] and the contact rows;
  // then F_k = sum over the bodies k moves of f_b, and zero contact rows
  for (int e = tid; e < nslot + nv * 6 + ncont * nv; e += nt) {
    if (e < nslot) {
      const int b = __ldg(ix + I.slot_b + e), j = __ldg(ix + I.slot_j + e);
      S dV[6], dAcc[6], dVv[6], dAccv[6], t1[6], t2[6], t3[6], df[6], dfv[6];
      slot_derivs(sm, ix, L, I, e, b, j, dV, dAcc, dVv, dAccv);
      const S* Sj = sm + L.S_ + j * 6;
      const S* I6b = sm + L.I6 + b * 36;
      const S* Vbb = sm + L.Vb + b * 6;
      const S* hb = sm + L.h + b * 6;
      // dI6con(Accb_b, y_b) = S_j x* y_b - I6_b (S_j x Accb_b)
      fcross(Sj, sm + L.y + b * 6, t1);
      mcross(Sj, sm + L.Accb + b * 6, t2);
      mat6(I6b, t2, t3);
      for (int s = 0; s < 6; ++s) df[s] = t1[s] - t3[s];
      mat6(I6b, dAcc, t1);
      fcross(dV, hb, t2);
      for (int s = 0; s < 6; ++s) df[s] += t1[s] + t2[s];
      // Vb x* (dI6con(Vb, h) + I6 dV)
      fcross(Sj, hb, t1);
      mcross(Sj, Vbb, t2);
      mat6(I6b, t2, t3);
      mat6(I6b, dV, t2);
      for (int s = 0; s < 6; ++s) t1[s] = (t1[s] - t3[s]) + t2[s];
      fcross(Vbb, t1, t2);
      for (int s = 0; s < 6; ++s) df[s] += t2[s];
      // dfv = I6 dAccv + dVv x* h + Vb x* (I6 dVv)
      mat6(I6b, dAccv, dfv);
      fcross(dVv, hb, t1);
      mat6(I6b, dVv, t2);
      fcross(Vbb, t2, t3);
      for (int s = 0; s < 6; ++s) {
        sm[L.DF + e * 6 + s] = df[s];
        sm[L.DFV + e * 6 + s] = dfv[s] + t1[s] + t3[s];
      }
      for (int c = 0; c < ncont; ++c) {
        if (__ldg(ix + I.cbody + c) != b) continue;
        const int dim = __ldg(ix + I.cdim + c), off = __ldg(ix + I.coff + c);
        const S* pc = sm + L.pc + c * 3;
        const S* omega = Vbb + 3;
        const S* AccA = sm + L.Accb + b * 6 + 3;
        const S* pdot = sm + L.pdot + c * 3;
        const S act = sm[L.act + c];
        S dp[3], t[3], u[3], dpdot[3], dpdotv[3], lq[3], lv[3];
        cr3(Sj + 3, pc, t);
        for (int r = 0; r < 3; ++r) dp[r] = Sj[r] + t[r];
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
        cr3(dp, sm + L.lam + off, sm + L.dpxw + (c * nv + j) * 3);
      }
    } else if (e < nslot + nv * 6) {
      const int k = (e - nslot) / 6, s = (e - nslot) % 6;
      S f = S(0);
      const int t1 = __ldg(ix + I.sub_off + k + 1);
      for (int t = __ldg(ix + I.sub_off + k); t < t1; ++t)
        f += sm[L.fb + __ldg(ix + I.sub + t) * 6 + s];
      sm[L.F + k * 6 + s] = f;
    } else {
      const int c = (e - nslot - nv * 6) / nv, j = (e - nslot - nv * 6) % nv;
      if (__ldg(ix + I.slot_of + __ldg(ix + I.cbody + c) * nv + j) >= 0) continue;
      const int off = __ldg(ix + I.coff + c), dim = __ldg(ix + I.cdim + c);
      S* rq = out.r2q + (m * nc + off) * nv + j;
      S* rv = out.r2v + (m * nc + off) * nv + j;
      for (int r = 0; r < dim; ++r) rq[r * nv] = rv[r * nv] = S(0);
    }
  }
  __syncthreads();

  // ---- 4. a thread an entry (k, j) of ra1_q and ra1_v, those with the
  // most terms first: ra1_q[k,j] = sum_b A[b,k] S_k . df_b[j] + D[k,j]
  // SxS[j,k] . F_k + the contacts' J' lam transport A[bc,k] (D[k,j]
  // SxS[j,k] . F_c + S_k,ang . (dp_j x w_f)); ra1_v[k,j] = sum_b A[b,k] S_k .
  // dfv_b[j]. The bodies with A[b,k] = A[b,j] = 1 are listed by the host;
  // an entry without any is zero.
  for (int e = tid; e < nv * nv; e += nt) {
    const int kj = __ldg(ix + I.ent + e);
    S q = S(0), v = S(0);
    if (e < tab.nrel) {
      const int k = kj / nv, j = kj % nv;
      const int pkj = __ldg(ix + I.ent_pair + e);  // D[k,j] = 1
      const S* Sk = sm + L.S_ + k * 6;
      const int t1 = __ldg(ix + I.eb_off + e + 1);
      for (int t = __ldg(ix + I.eb_off + e); t < t1; ++t) {
        const int s = __ldg(ix + I.eb + t);
        q += dot6(Sk, sm + L.DF + s * 6);
        v += dot6(Sk, sm + L.DFV + s * 6);
      }
      if (pkj >= 0) q += dot6(sm + L.SxS + pkj * 6, sm + L.F + k * 6);
      for (int c = 0; c < ncont; ++c) {
        const int bc = __ldg(ix + I.cbody + c);
        if (__ldg(ix + I.slot_of + bc * nv + k) < 0 ||
            __ldg(ix + I.slot_of + bc * nv + j) < 0)
          continue;
        const S* dpxw = sm + L.dpxw + (c * nv + j) * 3;
        const S s1 = pkj >= 0 ? dot6(sm + L.SxS + pkj * 6, sm + L.Fc + c * 6) : S(0);
        q += s1 + (Sk[3] * dpxw[0] + Sk[4] * dpxw[1] + Sk[5] * dpxw[2]);
      }
    }
    out.ra1q[m * nv * nv + kj] = q;
    out.ra1v[m * nv * nv + kj] = v;
  }
}

// the table from the host array (ncont, the index lists' lengths, then the
// ncont bodies and the ncont dims, as the device lists end with them);
// false for what the kernel does not take
bool read_table(int nv, int nb, const int* table, const double* gains, Table& tab, int& nc) {
  tab = Table{};
  tab.ncont = table[0];
  const int* lens = table + 1;
  tab.npair = lens[0];
  tab.nslot = lens[1];
  tab.nrel = lens[2];
  tab.nsp = lens[3];
  tab.neb = lens[4];
  if (nv < 1 || nb < 1) return false;
  if (tab.npair < 1 || tab.npair > nv * nv || tab.nslot < 1 || tab.nslot > nb * nv ||
      tab.nrel < 1 || tab.nrel > nv * nv || tab.nsp < 0 || tab.neb < 0)
    return false;
  if (tab.ncont < 1) return false;
  const int* body = table + 6;
  const int* dim = body + tab.ncont;
  nc = 0;
  for (int c = 0; c < tab.ncont; ++c) {
    if (body[c] < 0 || body[c] >= nb) return false;
    if (dim[c] != 3 && dim[c] != 6) return false;
    nc += dim[c];
  }
  tab.kd = gains[0];
  tab.kp = gains[1];
  return true;
}

// words of the global workspace an instance: 0 where its working set
// fits shared memory, -1 for what the kernel does not take
long long workspace_words(int nv, int nb, const int* table, size_t elem) {
  Table tab;
  int nc = 0;
  const double gains[2] = {0, 0};
  if (!read_table(nv, nb, table, gains, tab, nc)) return -1;
  const Layout L(nv, nb, nc, tab.ncont, tab.npair, tab.nslot);
  return elem * static_cast<size_t>(L.total) > kMaxSmem ? L.total : 0;
}

template <typename S>
int launch(int K, int nv, int nb, const int* table, const double* gains, const In<S>& in,
           const int* ix, const Out<S>& out, S* work, cudaStream_t stream) {
  Table tab;
  int nc = 0;
  if (K < 1 || !read_table(nv, nb, table, gains, tab, nc)) return -1;
  const Layout L(nv, nb, nc, tab.ncont, tab.npair, tab.nslot);
  const size_t smem = sizeof(S) * static_cast<size_t>(L.total);
  if (smem > kMaxSmem) {
    if (work == nullptr) return -1;
    fd_rows_kernel<S, true><<<K, kThreads, 0, stream>>>(nv, nb, nc, tab, in, ix, out, work);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e = aligator::opt_in_shared(fd_rows_kernel<S, false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fd_rows_kernel<S, false><<<K, kThreads, smem, stream>>>(nv, nb, nc, tab, in, ix, out,
                                                          nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int entry(int K, int nv, int nb, const int* table, const double* gains, const S* S_,
          const S* v, const S* Vb, const S* Vpar, const S* Vdof, const S* Ca,
          const S* Capar, const S* Accb, const S* h, const S* y, const S* I6, const S* lam,
          const S* pc, const S* act, const int* ix, S* ra1q, S* ra1v, S* r2q, S* r2v,
          S* work, cudaStream_t stream) {
  const In<S> in{S_, v, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, lam, pc, act};
  const Out<S> out{ra1q, ra1v, r2q, r2v};
  return launch<S>(K, nv, nb, table, gains, in, ix, out, work, stream);
}

}  // namespace

// Arguments: K instances, nv, nb; the host tables `table` (ncont, the
// lengths npair, nslot, nrel, nsp, neb of the index lists, then ncont body
// indices and ncont dims) and `gains` (kd, kp); the
// per-instance inputs S (K,nv,6), v (K,nv), Vb (K,nb,6), Vpar, Vdof
// (K,nv,6), Ca (K,nb,6), Capar (K,nv,6), Accb, h, y (K,nb,6), I6
// (K,nb,6,6), lam (K,nc), pc (K,ncont,3), act (K,ncont); the index lists
// and the contacts' bodies, dims and offsets (int32 on the device, laid out
// as Index says); the outputs ra1q, ra1v
// (K,nv,nv), r2q, r2v (K,nc,nv); the workspace, K times
// fd_rows_workspace(nv, nb, table, sizeof(S)) words (null where that is 0).
#define FD_ROWS_ENTRY(NAME, T)                                                       \
  extern "C" int NAME(int K, int nv, int nb, const int* table, const double* gains,  \
                      const T* S_, const T* v, const T* Vb, const T* Vpar,           \
                      const T* Vdof, const T* Ca, const T* Capar, const T* Accb,     \
                      const T* h, const T* y, const T* I6, const T* lam, const T* pc, \
                      const T* act, const int* ix, T* ra1q, T* ra1v, T* r2q, T* r2v, \
                      T* work, cudaStream_t stream) {                                \
    return entry<T>(K, nv, nb, table, gains, S_, v, Vb, Vpar, Vdof, Ca, Capar, Accb, \
                    h, y, I6, lam, pc, act, ix, ra1q, ra1v, r2q, r2v, work, stream); \
  }

extern "C" long long fd_rows_workspace(int nv, int nb, const int* table, int elem) {
  return workspace_words(nv, nb, table, static_cast<size_t>(elem));
}

FD_ROWS_ENTRY(fd_rows_f32, float)
FD_ROWS_ENTRY(fd_rows_f64, double)
