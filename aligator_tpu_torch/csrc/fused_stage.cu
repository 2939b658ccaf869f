// Medium-dim proximal Riccati sweeps: the fused backward stage (K3), looped
// over the horizon in one launch, and the forward substitution (K4).
//
// Replaces: aligator_tpu/gar/pallas_stage.py `_stage_kernel` (K3, entry
// point `sweep_lanes`) and `_fwd_kernel` (K4, entry point `forward_lanes`).
//
// ---- K3, sweep_kernel ----------------------------------------------------
//
// It computes the TPU kernel's function: the Schur solve (I + mu_dyn P)
// [Vxx | vx] = [P | p + P f]; [A'V | A'vx] = A'[Vxx | vx] and the same with
// B; Qhat = Q + A'V A, Rhat = R + B'V B, Shat = S + A'V B and, formed apart,
// Shat' = S' + B'V A; the reduced KKT W = Rhat + D'D/mu_eq with [kff | K] =
// -W^{-1}[rhat + D'd/mu_eq | Shat' + D'C/mu_eq]; [zff | Z] = (D[kff | K] +
// [d | C])/mu_eq; lff, L = Vxx A + Vxx B K, yff, Afb; the value update Pc =
// (Qhat + Shat K) + C'Z, pc = (qhat + Shat kff) + C'zff. The two SPD
// systems are solved from their lower triangles only, as the TPU kernel's
// Cholesky reads them, and a pivot that is not > 0 fails the solve as it
// fails that Cholesky. Nothing is symmetrized inside a stage; the carried
// Pc is, after the stage (the TPU sweep did it in XLA between kernel
// calls), and that symmetrized Pc is the stored Pmat. Explicit dynamics
// (E = -I) only. Sums run in another order than the plain version's, and
// the systems are solved by Gauss-Jordan elimination, not by a Cholesky
// factorization and two substitutions.
//
// Bound on an H100 at the humanoid shape (nx = 36, nu = 12, nc = 12, batch
// 1024, N = 100, fp32): 3.77 GB (1.12 ms at 3.35 TB/s) and 75.2 GFLOP
// (1.12 ms at 67 TFLOP/s), balanced. What holds a block back is the
// instruction rate of its serial parts: one warp alone on its scheduler
// retires about one instruction every 4-5 cycles, so a stage costs the
// instructions on its critical path. A factorization with a step per
// column (two block barriers and a dependent chain each) and products
// computing one output a thread on 64-bit addresses spend most of them;
// barriers themselves are cheap.
//
// Design: one block of 128 threads a scenario loops over the N stages
// backward in ONE launch, with the carry (P, p) in shared memory. A stage:
//   1. [I + mu_dyn P | P | p + P f] (W mirrored from its lower triangle)
//      and D'[D | d | C]/mu_eq, one product;
//   2. the Schur system solved in place by gauss_jordan_regs;
//   3. [A B]'[Vxx | vx], one product;
//   4. X2 [A | B] (Qhat, Shat) and B'V [B | A] (the reduced KKT, mirrored,
//      and its right-hand sides) in one pass;
//   5. the KKT solved by gauss_jordan_regs;
//   6. [D; B][kff | K] (Zc and the panel B[kff | K]) and Qhat + Shat K;
//   7. Vxx [B[kff | K] | A] (lff, L, yff, Afb) and the + C'Z term;
//   8. the symmetrized carry; the next stage's A, f, B, C, D, d copied in
//      (cp.async; all its knots were asked into L2 at the stage's start).
// Each product is register-tiled: a thread owns a 4x4 output tile (4x3 for
// the two-operand product of step 7) with independent accumulators, its
// operands addressed by 32-bit shared-memory offsets that step by their
// stride; the products of a step share the threads out.
// gauss_jordan_regs keeps [W | Y] in registers, a 4x8 tile a thread (4x4
// for the KKT, so that it spreads over 39 threads), and eliminates four
// pivots a step: ~2.2k cycles a step for a block alone, 9 steps for the
// Schur system, 3 for the KKT, one barrier each. A system whose tiles
// outnumber the threads (nx > 36) or whose scratch does not fit takes
// gauss_jordan, the same elimination in shared memory, one pivot and one
// barrier a step. Shared memory: 3 n(n+1) + n^2 + n + max(nu, nc)(n+1) +
// 2 n nu + nu^2 + nu(n+1) + nc(n + nu + 1) words, 31.3 KB at the humanoid
// shape in fp32; at most 128 registers a thread, 4 blocks an SM, so the
// 1024 scenarios run in two waves (fewer registers spill and measured
// slower). Measured (NVIDIA H100 80GB HBM3, 700 W, fp32, B=1024, N=100):
// 12.5 ms, 11x the bound; a block alone ~40 us a stage. Q, S, R, q and r
// are read from L2 where used; knots are read in place from the
// batch-major (B, T, rows, cols) tensors (a transpose is an index). fp64
// needs twice the shared memory (opt-in above 48 KB). A failed solve makes
// that stage's outputs and all earlier stages' NaN, as the plain version's
// NaN carry does.
//
// ---- K4, forward_kernel --------------------------------------------------
//
// For t = 0 .. T-1: u = kff + K x, v = zff + Z x and, before the last knot,
// lam+ = lff + L x, x+ = yff + Afb x. Only x is sequential; every gain can
// be read before x is known. Bound: bytes (each gain read once): 0.4473 ms
// at B = 1024, T = 101, nx = 36 and 0.2380 ms at B = 256, nx = 56 (fp32).
// A warp walking its rows one at a time keeps one row's loads in flight and
// asks for nothing of stage t+1 before stage t ends: latency, not bytes,
// then sets the time.
//
// Design: one block of 128 threads a scenario streams the rows of [K; Z; L;
// Afb] and the four feed-forward vectors of its stages, in tiles of R rows,
// through a ring of 3 tiles in shared memory with cp.async (16 bytes a copy
// where the source allows, else single elements), two tiles ahead of the one
// it computes: one barrier a tile, which is a whole stage where it fits. A
// tile's pieces are placed so that each is congruent to its source mod 16,
// whatever the shape. The launcher sizes R so that the ceil(B / #SMs)
// blocks an SM is to hold fit its shared memory: at B = 1024, nx = 36
// (fp32) a stage is 2 tiles of 48 rows, 22.6 KB a block, 9 blocks an SM
// fit; at B = 256, nx = 56 one tile of 134 rows, 93.2 KB a block, 2 blocks
// an SM. A stage larger than the ring (large nx) streams in several tiles.
// The producer of a tile leaves its layout in a header beside the ring for
// the consumer. Four lanes take a row with two independent accumulators
// each and reduce with two shuffles. Measured (NVIDIA H100 80GB HBM3, 700
// W, fp32): 2.1x the bound at nx = 36 and 2.3x at nx = 56, held by its
// instructions (about 500 a thread a tile) rather than by bytes.
//
// C interface (one function per scalar type and kernel): the pointers come
// as one array; returns -1 for dims the kernel does not take, otherwise
// cudaGetLastError() after the launch. fused_stage_info reports a launch's
// shared memory, resident blocks per SM, registers and threads.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "block_linalg.cuh"

namespace {

constexpr int kStageThreads = 128;
// at most 128 registers a thread: 4 blocks of 128 threads an SM (fewer
// registers spill and measured slower)
constexpr int kStageMinBlocks = 4;
constexpr int kFwdThreads = 128;
constexpr int kFwdDepth = 3;   // tiles in the ring
constexpr int kFwdLanes = 4;   // lanes a row
constexpr int kFwdSlack = 32;  // bytes of alignment slack a piece, 8 a tile
constexpr int kFwdHeader = 256;  // bytes for the ring's tile layouts
constexpr size_t kMaxShared = 232448;  // per block on sm_90 (opt-in)
constexpr size_t kDefaultShared = 48 * 1024;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// ------------------------------------------------------------ products

// Register-tiled product on one block, operands in shared memory (sm): for
// i < M, j < N, epi(i, j, acc) with acc = sum_k A(i, k) B(k, j), where
// A(i, k) = sm[oa + k * sa] for arow(i, oa, sa) and B(k, j) = sm[ob + k *
// sb] for bcol(j, ob, sb). Threads take TM x TN tiles with independent
// accumulators; offsets are 32-bit and step by their stride. `first` is the
// thread that takes tile 0, so that products of one step share the threads
// out. Returns the number of tiles.
template <int TM, int TN, typename S, typename ARow, typename BCol, typename Epi>
__device__ __forceinline__ int gemm(const S* __restrict__ sm, int M, int N, int K,
                                    ARow arow, BCol bcol, Epi epi, int first) {
  const int tn = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tn;
  const int nt = blockDim.x;
  int tile = static_cast<int>(threadIdx.x) - first;
  if (tile < 0) tile += nt;
  for (; tile < tiles; tile += nt) {
    const int i0 = (tile / tn) * TM, j0 = (tile % tn) * TN;
    int oa[TM], sa[TM], ob[TN], sb[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) arow(min(i0 + u, M - 1), oa[u], sa[u]);
#pragma unroll
    for (int v = 0; v < TN; ++v) bcol(min(j0 + v, N - 1), ob[v], sb[v]);
    S acc[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = S(0);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      S x[TM], y[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        x[u] = sm[oa[u]];
        oa[u] += sa[u];
      }
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        y[v] = sm[ob[v]];
        ob[v] += sb[v];
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] += x[u] * y[v];
    }
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        if (i0 + u < M && j0 + v < N) epi(i0 + u, j0 + v, acc[u][v]);
  }
  return tiles;
}

// The same with two right operands sharing the left one: epi(i, j, acc1,
// acc2), bcol(j, ob1, sb1, ob2, sb2).
template <int TM, int TN, typename S, typename ARow, typename BCol, typename Epi>
__device__ __forceinline__ int gemm2(const S* __restrict__ sm, int M, int N, int K,
                                     ARow arow, BCol bcol, Epi epi, int first) {
  const int tn = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tn;
  const int nt = blockDim.x;
  int tile = static_cast<int>(threadIdx.x) - first;
  if (tile < 0) tile += nt;
  for (; tile < tiles; tile += nt) {
    const int i0 = (tile / tn) * TM, j0 = (tile % tn) * TN;
    int oa[TM], sa[TM], ob[TN], sb[TN], oc[TN], sc[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) arow(min(i0 + u, M - 1), oa[u], sa[u]);
#pragma unroll
    for (int v = 0; v < TN; ++v) bcol(min(j0 + v, N - 1), ob[v], sb[v], oc[v], sc[v]);
    S acc[TM][TN], acd[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = acd[u][v] = S(0);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      S x[TM], y[TN], z[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        x[u] = sm[oa[u]];
        oa[u] += sa[u];
      }
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        y[v] = sm[ob[v]];
        ob[v] += sb[v];
        z[v] = sm[oc[v]];
        oc[v] += sc[v];
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          acc[u][v] += x[u] * y[v];
          acd[u][v] += x[u] * z[v];
        }
    }
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        if (i0 + u < M && j0 + v < N) epi(i0 + u, j0 + v, acc[u][v], acd[u][v]);
  }
  return tiles;
}

// ------------------------------------------------------------ factorizations

// Solve W X = Y in place by Gauss-Jordan elimination without pivoting on
// M = [W | Y] (n x (n + r), leading dimension ld; W SPD and stored in full,
// overwritten; Y's r columns become X), by the whole block, one barrier a
// step. Warps take rows and lanes columns; a thread computes its rows'
// offsets, multipliers and scales once a step and loads all of a column's
// rows before it stores any. The pivot row is read unscaled during its own
// step and scaled during the next. A pivot not > 0 (or NaN) sets *bad = 1:
// the condition under which the Cholesky factorization of W fails.
template <typename S>
__device__ void gauss_jordan(S* M, int n, int r, int ld, int* bad) {
  constexpr int RU = 12;  // rows a batch
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int k = 0; k < n; ++k) {
    const S piv = M[k * ld + k];
    const S rp = S(1) / piv;
    const S rq = k > 0 ? S(1) / M[(k - 1) * ld + k - 1] : S(1);
    if (threadIdx.x == 0 && !(piv > S(0))) *bad = 1;
    for (int i0 = warp; i0 < n; i0 += RU * nwarps) {
      int oi[RU];
      S l[RU], sc[RU];
      bool upd[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int i = i0 + u * nwarps;
        upd[u] = i < n && i != k;
        oi[u] = min(i, n - 1) * ld;
        l[u] = upd[u] ? M[oi[u] + k] : S(0);
        sc[u] = i == k - 1 ? rq : S(1);  // the last pivot row's scale
      }
      for (int j = k + 1 + lane; j < n + r; j += 32) {
        const S pj = rp * M[k * ld + j];
        S x[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) x[u] = M[oi[u] + j];
#pragma unroll
        for (int u = 0; u < RU; ++u)
          if (upd[u]) M[oi[u] + j] = sc[u] * (x[u] - l[u] * pj);
      }
    }
    __syncthreads();
  }
  const S rp = S(1) / M[(n - 1) * ld + n - 1];
  for (int j = threadIdx.x; j < r; j += blockDim.x) M[(n - 1) * ld + n + j] *= rp;
}

// Four words of shared memory, 16-byte aligned for float (two 16-byte
// loads for double).
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 v = reinterpret_cast<const double2*>(p)[0];
  const double2 u = reinterpret_cast<const double2*>(p)[1];
  o[0] = v.x; o[1] = v.y; o[2] = u.x; o[3] = u.y;
}

// The same solve with [W | Y] in registers, four pivots at a time: each
// thread holds one tile of kGjB x C words for the whole solve (C = 8, or 4
// for a small system, which then spreads over more threads). Step kb
// eliminates the block K = [4 kb, 4 kb + 4): every row i outside K takes
// x_i -= x_i[K] A_KK^{-1} R_K, where R_K are the rows K and A_KK their
// pivot block. Before it, the threads holding R_K, the columns K and A_KK
// publish R_K, the multipliers x[:, K] and A_KK^{-1} (a 4 x 4 Gauss-Jordan
// in registers, its pivots checked: one not > 0, or NaN, sets *bad = 1,
// the condition under which the Cholesky factorization of W fails) into
// `buf`, double-buffered: one barrier a step. Rows K are not scaled in
// their step: they hold A_KK X_K until the end, where each thread applies
// its block's A_KK^{-1} once (later steps subtract the same products from
// them, the multipliers being their own words). Dimensions past n are
// padded with the identity. gj_in_registers says whether a system takes it.
constexpr int kGjB = 4;

template <int C>
__device__ __forceinline__ bool gj_in_registers(int n, int r, int buf_words) {
  const int wp = (n + r + C - 1) / C * C, np = (n + kGjB - 1) / kGjB * kGjB;
  const int tiles = (np / kGjB) * (wp / C);
  const int words = 2 * (kGjB * wp + np * kGjB + kGjB * kGjB) + np * kGjB;
  return tiles <= static_cast<int>(blockDim.x) && words <= buf_words;
}

template <int C, typename S>
__device__ void gauss_jordan_regs(S* M, int n, int r, int ld, S* buf, int* bad) {
  constexpr int B = kGjB;
  static_assert(C == B || C == 2 * B, "a pivot block sits at column 0 or B of a tile");
  const int w = n + r, wp = (w + C - 1) / C * C, nb = (n + B - 1) / B, np = nb * B;
  const int tcn = wp / C, tiles = nb * tcn;
  const int words = B * wp + np * B + B * B;  // one buffer: R_K, x[:, K], A_KK^{-1}
  S* const saved = buf + 2 * words;           // every block's A_KK^{-1}
  const bool has = static_cast<int>(threadIdx.x) < tiles;
  const int ti = has ? threadIdx.x / tcn : nb, tj = has ? threadIdx.x % tcn : 0;
  const int i0 = ti * B, j0 = tj * C;
  S x[B][C];
#pragma unroll
  for (int u = 0; u < B; ++u)
#pragma unroll
    for (int v = 0; v < C; ++v) {
      const int i = i0 + u, j = j0 + v;
      x[u][v] = i < n && j < w ? M[i * ld + j] : S(0);
    }

  auto publish = [&](int kb) {
    S* R = buf + (kb & 1) * words;
    S* L = R + B * wp;
    S* Ai = L + np * B;
    const int k = kb * B, v0 = k % C;  // K's columns sit at v0 .. v0 + 3 of tile column k / C
    if (has && i0 == k) {
#pragma unroll
      for (int u = 0; u < B; ++u)
#pragma unroll
        for (int v = 0; v < C; ++v) R[u * wp + j0 + v] = x[u][v];
    }
    if (has && tj == k / C) {
      S blk[B][B];
#pragma unroll
      for (int u = 0; u < B; ++u)
#pragma unroll
        for (int q = 0; q < B; ++q) blk[u][q] = C == B || v0 == 0 ? x[u][q] : x[u][(C - B) + q];
#pragma unroll
      for (int u = 0; u < B; ++u)
#pragma unroll
        for (int q = 0; q < B; ++q) L[(i0 + u) * B + q] = blk[u][q];
      if (i0 == k) {  // A_KK^{-1}, padded with the identity past n
        S e[B][B];
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int q = 0; q < B; ++q) {
            if (k + u >= n || k + q >= n) blk[u][q] = u == q ? S(1) : S(0);
            e[u][q] = u == q ? S(1) : S(0);
          }
#pragma unroll
        for (int pv = 0; pv < B; ++pv) {
          const S piv = blk[pv][pv];
          if (!(piv > S(0))) *bad = 1;
          const S rp = S(1) / piv;
#pragma unroll
          for (int q = 0; q < B; ++q) {
            blk[pv][q] *= rp;
            e[pv][q] *= rp;
          }
#pragma unroll
          for (int u = 0; u < B; ++u) {
            if (u != pv) {
              const S f = blk[u][pv];
#pragma unroll
              for (int q = 0; q < B; ++q) {
                blk[u][q] -= f * blk[pv][q];
                e[u][q] -= f * e[pv][q];
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int q = 0; q < B; ++q) {
            Ai[u * B + q] = e[u][q];
            saved[kb * B * B + u * B + q] = e[u][q];
          }
      }
    }
  };

  publish(0);
  __syncthreads();
  for (int kb = 0; kb < nb; ++kb) {
    const S* R = buf + (kb & 1) * words;
    const S* L = R + B * wp;
    const S* Ai = L + np * B;
    if (has && i0 != kb * B) {
      S l[B][B], ai[B][B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        load4(L + (i0 + u) * B, l[u]);
        load4(Ai + u * B, ai[u]);
      }
#pragma unroll
      for (int v4 = 0; v4 < C; v4 += 4) {
        S rk[B][4];
#pragma unroll
        for (int q = 0; q < B; ++q) load4(R + q * wp + j0 + v4, rk[q]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          S pk[B];  // A_KK^{-1} R_K, one column
#pragma unroll
          for (int a = 0; a < B; ++a) {
            S s = S(0);
#pragma unroll
            for (int q = 0; q < B; ++q) s += ai[a][q] * rk[q][v];
            pk[a] = s;
          }
#pragma unroll
          for (int u = 0; u < B; ++u)
#pragma unroll
            for (int a = 0; a < B; ++a) x[u][v4 + v] -= l[u][a] * pk[a];
        }
      }
    }
    if (kb + 1 < nb) publish(kb + 1);
    __syncthreads();
  }
  if (has) {  // rows K hold A_KK X_K
    S ai[B][B];
#pragma unroll
    for (int u = 0; u < B; ++u) load4(saved + ti * B * B + u * B, ai[u]);
#pragma unroll
    for (int v = 0; v < C; ++v) {
      const int j = j0 + v;
#pragma unroll
      for (int a = 0; a < B; ++a) {
        S s = S(0);
#pragma unroll
        for (int q = 0; q < B; ++q) s += ai[a][q] * x[q][v];
        if (i0 + a < n && j >= n && j < w) M[(i0 + a) * ld + j] = s;
      }
    }
  }
}

// ------------------------------------------------------------ K3

__host__ __device__ inline size_t stage_smem_words(int n, int m, int c) {
  const size_t n1 = n + 1, mc = m > c ? m : c;
  return 3 * n * n1 + static_cast<size_t>(n) * n + n + mc * n1 +
         2 * static_cast<size_t>(n) * m + static_cast<size_t>(m) * m + m * n1 +
         static_cast<size_t>(c) * (n + m + 1);
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

// the knots of stage bt that the products read, into shared memory: A, f,
// B, C, D, d
// (cp.async: the caller waits for them before its barrier)
template <typename S>
__device__ __forceinline__ void copy_in(S* dst, const S* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    aligator::cp_async_small<sizeof(S)>(dst + i, src + i);
}

template <typename S>
__device__ __forceinline__ void load_knots(const SweepArgs<S>& a, size_t bt, int n, int m,
                                           int c, S* Am, S* fv, S* Bm, S* Cm, S* Dm, S* dv) {
  copy_in(Am, a.A + bt * n * n, n * n);
  copy_in(fv, a.f + bt * n, n);
  copy_in(Bm, a.B + bt * n * m, n * m);
  copy_in(Cm, a.C + bt * c * n, c * n);
  copy_in(Dm, a.D + bt * c * m, c * m);
  copy_in(dv, a.d + bt * c, c);
  aligator::cp_async_commit();
}

// the knots of stage bt into L2
template <typename S>
__device__ __forceinline__ void prefetch_knots(const SweepArgs<S>& a, size_t bt, int n,
                                               int m, int c) {
  aligator::prefetch_l2(a.Q + bt * n * n, n * n * sizeof(S));
  aligator::prefetch_l2(a.S_ + bt * n * m, n * m * sizeof(S));
  aligator::prefetch_l2(a.R + bt * m * m, m * m * sizeof(S));
  aligator::prefetch_l2(a.q + bt * n, n * sizeof(S));
  aligator::prefetch_l2(a.r + bt * m, m * sizeof(S));
  aligator::prefetch_l2(a.A + bt * n * n, n * n * sizeof(S));
  aligator::prefetch_l2(a.B + bt * n * m, n * m * sizeof(S));
  aligator::prefetch_l2(a.f + bt * n, n * sizeof(S));
  aligator::prefetch_l2(a.C + bt * c * n, c * n * sizeof(S));
  aligator::prefetch_l2(a.D + bt * c * m, c * m * sizeof(S));
  aligator::prefetch_l2(a.d + bt * c, c * sizeof(S));
}

template <typename S>
__global__ void __launch_bounds__(kStageThreads, kStageMinBlocks)
sweep_kernel(const int T, const int N, const int n, const int m, const int c,
             const SweepArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = n + 1, nn = n * n, la = 2 * n + 1, lk = m + n1;
  S* const sm = reinterpret_cast<S*>(smem_raw);
  // offsets (words) of the regions; [W | Y] systems are contiguous
  const int oAG = 0;                // n x (2n + 1): [I + mu_dyn P | carry [P | p]],
                                    // solved to [. | Vxx vx]; Qhat -> Pc in cols < n
  const int oPC = oAG + n * la;     // qhat -> pc (n)
  const int oRC = oPC + n;          // X2 = [A'V | A'vx], then PAN1 = B[kff | K] (ld n1)
  const int oA = oRC + n * n1;      // A (ld n), f, B (ld m), C (ld n), D (ld m)
  const int oF = oA + nn;
  const int oB = oF + n;
  const int oC = oB + n * m;
  const int oD = oC + c * n;
  const int od = oD + c * m;        // d
  const int oBV = od + c;           // [B'V | B'vx], then [zff | Z] (ld n1)
  const int oSh = oBV + (m > c ? m : c) * n1;  // Shat (ld m)
  const int oKK = oSh + n * m;      // m x (m + n1): [Rhat + D'D/mu_eq | rhs], solved to
                                    // [. | kff K]
  const int oSOL = oAG + n, oU = oKK + m;
  S* const AG = sm + oAG;  // AG[i * la + j]: j < n W / Qhat / Pc, then SOL
  S* const SOL = sm + oSOL;
  S* const PC = sm + oPC;
  S* const RC = sm + oRC;
  S* const Am = sm + oA;
  S* const fv = sm + oF;
  S* const Cm = sm + oC;
  S* const Dm = sm + oD;
  S* const dv = sm + od;
  S* const BV = sm + oBV;
  S* const Sh = sm + oSh;
  S* const KK = sm + oKK;
  S* const U = sm + oU;
  __shared__ int bad;  // sticky: a factorization failed

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t b = blockIdx.x;
  const S mud = a.mud[b], mue = a.mue[b], rmue = S(1) / mue;
  const S nan = aligator::qnan<S>();

  for (int i = warp; i < n; i += nwarps) {
    for (int j = lane; j < n; j += 32) SOL[i * la + j] = a.P0[(b * n + i) * n + j];
    if (lane == 0) SOL[i * la + n] = a.p0[b * n + i];
  }
  load_knots(a, b * T + N - 1, n, m, c, Am, fv, sm + oB, Cm, Dm, dv);
  if (tid == 0) bad = 0;
  aligator::cp_async_wait<0>();
  __syncthreads();

  for (int t = N - 1; t >= 0; --t) {
    const size_t bt = b * T + t;
    const S* Qg = a.Q + bt * nn;
    const S* Sg = a.S_ + bt * n * m;
    const S* Rg = a.R + bt * m * m;
    const S* qg = a.q + bt * n;
    const S* rg = a.r + bt * m;
    if (t > 0) prefetch_knots(a, bt - 1, n, m, c);  // while this stage computes

    // 1. the Schur system: W = I + mu_dyn P in full from P's lower
    //    triangle (the Cholesky of the TPU kernel reads no other), right-hand
    //    sides [P | p + P f]; D'D / mu_eq and [D'd | D'C] / mu_eq into KK
    for (int i = warp; i < n; i += nwarps) {
      for (int j = lane; j <= i; j += 32) {
        const S w = (i == j ? S(1) : S(0)) + mud * SOL[i * la + j];
        AG[i * la + j] = w;
        AG[j * la + i] = w;
      }
    }
    for (int i = tid; i < n; i += nt) {
      S s = S(0);
      for (int k = 0; k < n; ++k) s += SOL[i * la + k] * fv[k];
      SOL[i * la + n] += s;
    }
    if (c > 0) {
      gemm<4, 4>(
          sm, m, lk, c,
          [&](int i, int& o, int& s) { o = oD + i; s = m; },
          [&](int j, int& o, int& s) {
            if (j < m) { o = oD + j; s = m; }
            else if (j == m) { o = od; s = 1; }
            else { o = oC + j - m - 1; s = n; }
          },
          [&](int i, int j, S v) { KK[i * lk + j] = v * rmue; },
          64 % nt);  // off warps 0-1, which form p + P f
    } else {
      for (int e = tid; e < m * lk; e += nt) KK[e] = S(0);
    }
    __syncthreads();

    // 2. [Vxx | vx] = W^{-1}[P | p + P f] (RC is free until step 3)
    if (gj_in_registers<8>(n, n1, n * n1)) gauss_jordan_regs<8>(AG, n, n1, la, RC, &bad);
    else gauss_jordan(AG, n, n1, la, &bad);
    __syncthreads();

    // 3. [A B]'[Vxx | vx]: X2 into RC, B'V into BV
    gemm<4, 4>(
        sm, n + m, n1, n,
        [&](int i, int& o, int& s) {
          if (i < n) { o = oA + i; s = n; } else { o = oB + (i - n); s = m; }
        },
        [&](int j, int& o, int& s) { o = oSOL + j; s = la; },
        [&](int i, int j, S v) {
          if (i < n) RC[i * n1 + j] = v; else BV[(i - n) * n1 + j] = v;
        },
        0);
    __syncthreads();

    // 4. X2 [A | B]: Qhat (into AG) and Shat; B'V [B | A]: the reduced KKT
    //    matrix Rhat + D'D/mu_eq (its lower triangle, mirrored) and its
    //    right-hand sides; qhat, rhat
    {
      const int tiles = gemm<4, 4>(
          sm, n, n + m, n,
          [&](int i, int& o, int& s) { o = oRC + i * n1; s = 1; },
          [&](int j, int& o, int& s) {
            if (j < n) { o = oA + j; s = n; } else { o = oB + (j - n); s = m; }
          },
          [&](int i, int j, S v) {
            if (j < n) AG[i * la + j] = Qg[i * n + j] + v;
            else Sh[i * m + j - n] = Sg[i * m + j - n] + v;
          },
          0);
      gemm<4, 4>(
          sm, m, m + n, n,
          [&](int i, int& o, int& s) { o = oBV + i * n1; s = 1; },
          [&](int j, int& o, int& s) {
            if (j < m) { o = oB + j; s = m; } else { o = oA + (j - m); s = n; }
          },
          [&](int i, int j, S v) {
            if (j < m) {
              if (j <= i) {
                const S w = (Rg[i * m + j] + v) + KK[i * lk + j];
                KK[i * lk + j] = w;
                KK[j * lk + i] = w;
              }
            } else {
              const int jj = j - m;
              U[i * lk + 1 + jj] = -((Sg[jj * m + i] + v) + U[i * lk + 1 + jj]);
            }
          },
          tiles % nt);
    }
    for (int i = tid; i < n; i += nt) PC[i] = qg[i] + RC[i * n1 + n];
    for (int i = tid; i < m; i += nt) U[i * lk] = -((rg[i] + BV[i * n1 + n]) + U[i * lk]);
    __syncthreads();

    // 5. [kff | K] = -W^{-1}[...] (X2 in RC is consumed)
    if (gj_in_registers<4>(m, n1, n * n1)) gauss_jordan_regs<4>(KK, m, n1, lk, RC, &bad);
    else if (gj_in_registers<8>(m, n1, n * n1)) gauss_jordan_regs<8>(KK, m, n1, lk, RC, &bad);
    else gauss_jordan(KK, m, n1, lk, &bad);
    __syncthreads();
    const bool ok = !bad;

    // 6. [D; B][kff | K]: [zff | Z] into BV, the panel B[kff | K] into RC;
    //    Qhat + Shat K, qhat + Shat kff; the gains kff, K
    {
      const int tiles = gemm<4, 4>(
          sm, c + n, n1, m,
          [&](int i, int& o, int& s) {
            o = i < c ? oD + i * m : oB + (i - c) * m;
            s = 1;
          },
          [&](int j, int& o, int& s) { o = oU + j; s = lk; },
          [&](int i, int j, S v) {
            if (i < c) BV[i * n1 + j] = (v + (j == 0 ? dv[i] : Cm[i * n + j - 1])) * rmue;
            else RC[(i - c) * n1 + j] = v;
          },
          0);
      gemm<4, 4>(
          sm, n, n1, m,
          [&](int i, int& o, int& s) { o = oSh + i * m; s = 1; },
          [&](int j, int& o, int& s) { o = oU + j; s = lk; },
          [&](int i, int j, S v) {
            if (j == 0) PC[i] = PC[i] + v;
            else AG[i * la + j - 1] = AG[i * la + j - 1] + v;
          },
          tiles % nt);
    }
    for (int i = warp; i < m; i += nwarps) {
      if (lane == 0) a.kff[bt * m + i] = ok ? U[i * lk] : nan;
      for (int j = lane; j < n; j += 32) a.K[(bt * m + i) * n + j] = ok ? U[i * lk + 1 + j] : nan;
    }
    __syncthreads();

    // 7. Vxx [B[kff | K] | A]: lff, L, yff, Afb; + C'[zff | Z]; zff, Z
    {
      const int tiles = gemm2<4, 3>(
          sm, n, n1, n,
          [&](int i, int& o, int& s) { o = oSOL + i * la; s = 1; },
          [&](int j, int& o1, int& s1, int& o2, int& s2) {
            o1 = oRC + j;
            s1 = n1;
            o2 = oA + (j > 0 ? j - 1 : 0);
            s2 = n;
          },
          [&](int i, int j, S pan2, S vxa) {
            if (j == 0) {
              const S lf = SOL[i * la + n] + pan2;
              a.lff[bt * n + i] = ok ? lf : nan;
              a.yff[bt * n + i] = ok ? (fv[i] + RC[i * n1]) - mud * lf : nan;
            } else {
              const S Lv = vxa + pan2;
              const size_t e = (bt * n + i) * n + j - 1;
              a.L[e] = ok ? Lv : nan;
              a.Afb[e] = ok ? (Am[i * n + j - 1] + RC[i * n1 + j]) - mud * Lv : nan;
            }
          },
          0);
      if (c > 0) {
        gemm<4, 4>(
            sm, n, n1, c,
            [&](int i, int& o, int& s) { o = oC + i; s = n; },
            [&](int j, int& o, int& s) { o = oBV + j; s = n1; },
            [&](int i, int j, S v) {
              if (j == 0) PC[i] = PC[i] + v;
              else AG[i * la + j - 1] = AG[i * la + j - 1] + v;
            },
            tiles % nt);
      }
    }
    for (int l = warp; l < c; l += nwarps) {
      if (lane == 0) a.zff[bt * c + l] = ok ? BV[l * n1] : nan;
      for (int j = lane; j < n; j += 32) a.Z[(bt * c + l) * n + j] = ok ? BV[l * n1 + 1 + j] : nan;
    }
    __syncthreads();

    // 8. the symmetrized carry into SOL's place; the next stage's knots
    for (int i = warp; i < n; i += nwarps) {
      for (int j = lane; j < n; j += 32) {
        const S v = S(0.5) * (AG[i * la + j] + AG[j * la + i]);
        SOL[i * la + j] = v;
        a.Pmat[(bt * n + i) * n + j] = ok ? v : nan;
      }
      if (lane == 0) {
        SOL[i * la + n] = PC[i];
        a.pvec[bt * n + i] = ok ? PC[i] : nan;
      }
    }
    if (t > 0) load_knots(a, bt - 1, n, m, c, Am, fv, sm + oB, Cm, Dm, dv);
    aligator::cp_async_wait<0>();
    __syncthreads();
  }
}

// ------------------------------------------------------------ K4

template <typename S>
struct ForwardArgs {
  // gains (B, T, rows, cols) contiguous; x0 (B, n), lam0 (B, n)
  const S *kff, *K, *zff, *Z, *lff, *L, *yff, *Afb, *x0, *lam0;
  // solution (B, T, ·)
  S *xs, *us, *vs, *lams;
};

// rows of stage t: [K; Z; L; Afb], no dynamics rows at the last knot
__host__ __device__ inline int fwd_rows(int t, int T, int n, int m, int c) {
  return m + c + (t < T - 1 ? 2 * n : 0);
}

// Where the rows [r0, r1) of one stage's [K; Z; L; Afb] sit in a ring slot:
// block s (K, Z, L, Afb) holds rows [lo[s], hi[s]) of the stage's list,
// its matrix rows from byte mat[s] and its feed-forward entries from byte
// ff[s]. Each piece starts at an address congruent to its source mod 16.
struct FwdLayout {
  int lo[4], hi[4];
  unsigned mat[4], ff[4];
};
static_assert(kFwdDepth * sizeof(FwdLayout) <= kFwdHeader, "ring layouts do not fit");

template <typename S>
__device__ __forceinline__ void fwd_sources(const ForwardArgs<S>& a, int s,
                                            const S*& M, const S*& F, int& rows,
                                            int n, int m, int c) {
  M = s == 0 ? a.K : s == 1 ? a.Z : s == 2 ? a.L : a.Afb;
  F = s == 0 ? a.kff : s == 1 ? a.zff : s == 2 ? a.lff : a.yff;
  rows = s == 0 ? m : s == 1 ? c : n;
}

template <typename S>
__device__ __forceinline__ void fwd_layout(const ForwardArgs<S>& a, size_t bt,
                                           int r0, int r1, int n, int m, int c,
                                           FwdLayout& Lo) {
  unsigned off = 0;
  int start = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const S *M, *F;
    int rows;
    fwd_sources(a, s, M, F, rows, n, m, c);
    const int lo = max(r0, start), hi = max(lo, min(r1, start + rows));
    Lo.lo[s] = lo;
    Lo.hi[s] = hi;
    const size_t j = bt * rows + (lo - start);
    off = static_cast<unsigned>(align16(off)) +
          static_cast<unsigned>(reinterpret_cast<uintptr_t>(M + j * n) & 15);
    Lo.mat[s] = off;
    off += static_cast<unsigned>((hi - lo) * n * sizeof(S));
    off = static_cast<unsigned>(align16(off)) +
          static_cast<unsigned>(reinterpret_cast<uintptr_t>(F + j) & 15);
    Lo.ff[s] = off;
    off += static_cast<unsigned>((hi - lo) * sizeof(S));
    start += rows;
  }
}

// count elements from src to dst (dst = src mod 16) with cp.async, shared
// out over the block: single elements up to the first 16-byte boundary,
// 16-byte copies, single elements after the last
template <typename S>
__device__ __forceinline__ void fwd_copy(unsigned char* dst, const S* src, int count) {
  if (count <= 0) return;
  constexpr int es = sizeof(S);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(count, ((16 - mis) & 15) / es);
  const int body = (count - head) * es / 16;
  const int tail0 = head + body * (16 / es);
  const int items = head + body + (count - tail0);
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    if (i < head) {
      aligator::cp_async_small<es>(dst + i * es, src + i);
    } else if (i < head + body) {
      const int k = i - head;
      aligator::cp_async16(dst + head * es + k * 16,
                           reinterpret_cast<const unsigned char*>(src + head) + k * 16);
    } else {
      const int e = tail0 + (i - head - body);
      aligator::cp_async_small<es>(dst + e * es, src + e);
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(kFwdThreads)
forward_kernel(const int T, const int n, const int m, const int c, const int R,
               const unsigned slot_bytes, const ForwardArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* xb = reinterpret_cast<S*>(smem_raw);  // x of even and odd stages
  // each slot's layout, written by its producer for its consumer
  FwdLayout* hdr = reinterpret_cast<FwdLayout*>(smem_raw + align16(2 * n * sizeof(S)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(hdr) + kFwdHeader;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  // the next tile to load: stage tp, rows from rp
  int tp = 0, rp = 0;
  auto load_next = [&](int slot) {
    if (tp < T) {
      const int rows = fwd_rows(tp, T, n, m, c);
      const int r1 = min(rp + R, rows);
      const size_t bt = b * T + tp;
      FwdLayout Lo;
      fwd_layout(a, bt, rp, r1, n, m, c, Lo);
      if (tid == 0) hdr[slot] = Lo;
      unsigned char* dst = ring + static_cast<size_t>(slot) * slot_bytes;
      int start = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const S *M, *F;
        int srows;
        fwd_sources(a, s, M, F, srows, n, m, c);
        const size_t j = bt * srows + (Lo.lo[s] - start);
        const int cnt = Lo.hi[s] - Lo.lo[s];
        fwd_copy(dst + Lo.mat[s], M + j * n, cnt * n);
        fwd_copy(dst + Lo.ff[s], F + j, cnt);
        start += srows;
      }
      rp += R;
      if (rp >= rows) {
        ++tp;
        rp = 0;
      }
    }
    aligator::cp_async_commit();
  };

  for (int i = tid; i < n; i += nt) {
    xb[i] = a.x0[b * n + i];
    a.lams[b * T * n + i] = a.lam0[b * n + i];
  }
  for (int s = 0; s < kFwdDepth - 1; ++s) load_next(s);

  const int team = tid / kFwdLanes, sub = tid % kFwdLanes, teams = nt / kFwdLanes;
  int tc = 0, rc = 0;
  for (int k = 0; tc < T; ++k) {
    aligator::cp_async_wait<kFwdDepth - 2>();
    __syncthreads();  // tile k has landed; tile k-1's slot and x are free
    load_next((k + kFwdDepth - 1) % kFwdDepth);

    const unsigned char* slot = ring + static_cast<size_t>(k % kFwdDepth) * slot_bytes;
    const int rows = fwd_rows(tc, T, n, m, c);
    const int r1 = min(rc + R, rows);
    const size_t bt = b * T + tc;
    const S* x = xb + (tc & 1) * n;
    S* xn = xb + ((tc + 1) & 1) * n;
    if (rc == 0)
      for (int i = tid; i < n; i += nt) a.xs[bt * n + i] = x[i];
    const FwdLayout Lo = hdr[k % kFwdDepth];
    for (int base = rc; base < r1; base += teams) {
      const int r = base + team;
      const bool act = r < r1;
      S acc0 = S(0), acc1 = S(0);
      int s = 0;
      if (act) {
        s = (r >= m) + (r >= m + c) + (r >= m + c + n);
        const int lo = s == 0 ? Lo.lo[0] : s == 1 ? Lo.lo[1] : s == 2 ? Lo.lo[2] : Lo.lo[3];
        const unsigned mo = s == 0 ? Lo.mat[0] : s == 1 ? Lo.mat[1] : s == 2 ? Lo.mat[2] : Lo.mat[3];
        const S* row = reinterpret_cast<const S*>(slot + mo) + static_cast<size_t>(r - lo) * n;
        int kk = sub;
        for (; kk + kFwdLanes < n; kk += 2 * kFwdLanes) {
          acc0 += row[kk] * x[kk];
          acc1 += row[kk + kFwdLanes] * x[kk + kFwdLanes];
        }
        if (kk < n) acc0 += row[kk] * x[kk];
      }
      S acc = acc0 + acc1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (act && sub == 0) {
        const int lo = s == 0 ? Lo.lo[0] : s == 1 ? Lo.lo[1] : s == 2 ? Lo.lo[2] : Lo.lo[3];
        const unsigned fo = s == 0 ? Lo.ff[0] : s == 1 ? Lo.ff[1] : s == 2 ? Lo.ff[2] : Lo.ff[3];
        const S v = reinterpret_cast<const S*>(slot + fo)[r - lo] + acc;
        if (s == 0) a.us[bt * m + r] = v;
        else if (s == 1) a.vs[bt * c + (r - m)] = v;
        else if (s == 2) a.lams[(bt + 1) * n + (r - m - c)] = v;
        else xn[r - m - c - n] = v;
      }
    }
    rc += R;
    if (rc >= rows) {
      ++tc;
      rc = 0;
    }
  }
}

// ------------------------------------------------------------ launchers

struct FwdConfig {
  int R;
  unsigned slot_bytes;
  size_t smem;
};

// Rows a tile (R) and shared memory of a K4 launch: as many blocks an SM as
// the batch gives it (ceil(B / #SMs), at most 16) share its shared memory;
// R is the most rows whose ring fits a block's share, at least one, then
// evened out over the tiles of a full stage.
template <typename S>
int forward_config(int Bsz, int n, int m, int c, FwdConfig* cfg) {
  int dev = 0, sms = 0, smem_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int want = (Bsz + sms - 1) / sms;
  want = want < 1 ? 1 : (want > 16 ? 16 : want);
  size_t budget = static_cast<size_t>(smem_sm) / want - reserved;
  if (budget > kMaxShared) budget = kMaxShared;
  const size_t es = sizeof(S), xbytes = align16(2 * n * es) + kFwdHeader;
  const size_t row_bytes = (n + 1) * es;
  const long full = m + c + 2L * n;
  long R = 1;
  if (budget > xbytes + kFwdDepth * (8 * kFwdSlack + row_bytes))
    R = static_cast<long>(((budget - xbytes) / kFwdDepth - 8 * kFwdSlack) / row_bytes);
  if (R > full) R = full;
  const long tiles = (full + R - 1) / R;
  R = (full + tiles - 1) / tiles;
  cfg->R = static_cast<int>(R);
  cfg->slot_bytes = static_cast<unsigned>(align16(R * row_bytes + 8 * kFwdSlack));
  cfg->smem = xbytes + kFwdDepth * static_cast<size_t>(cfg->slot_bytes);
  return cfg->smem > kMaxShared ? -1 : 0;
}

template <typename K>
cudaError_t set_shared(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess && smem > kDefaultShared)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return e;
}

bool sweep_dims_ok(int Bsz, int T, int N, int n, int m, int c) {
  return Bsz >= 1 && N >= 1 && T >= N && n >= 1 && m >= 1 && c >= 0;
}

bool forward_dims_ok(int Bsz, int T, int n, int m, int c) {
  return Bsz >= 1 && T >= 1 && n >= 1 && m >= 0 && c >= 0;
}

template <typename S>
int launch_sweep(int Bsz, int T, int N, int n, int m, int c, void* const* p,
                 cudaStream_t stream) {
  if (!sweep_dims_ok(Bsz, T, N, n, m, c)) return -1;
  const size_t smem = sizeof(S) * stage_smem_words(n, m, c);
  if (smem > kMaxShared) return -1;
  const cudaError_t e = set_shared(sweep_kernel<S>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
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
  if (!forward_dims_ok(Bsz, T, n, m, c)) return -1;
  FwdConfig cfg;
  const int r = forward_config<S>(Bsz, n, m, c, &cfg);
  if (r != 0) return r;
  const cudaError_t e = set_shared(forward_kernel<S>, cfg.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ForwardArgs<S> a;
  const S** in[] = {&a.kff, &a.K, &a.zff, &a.Z, &a.lff,
                    &a.L, &a.yff, &a.Afb, &a.x0, &a.lam0};
  S** out[] = {&a.xs, &a.us, &a.vs, &a.lams};
  int k = 0;
  for (const S** f : in) *f = static_cast<const S*>(p[k++]);
  for (S** f : out) *f = static_cast<S*>(p[k++]);
  forward_kernel<S><<<Bsz, kFwdThreads, cfg.smem, stream>>>(T, n, m, c, cfg.R,
                                                            cfg.slot_bytes, a);
  return static_cast<int>(cudaGetLastError());
}

// out: shared memory bytes a block, resident blocks per SM, registers a
// thread, threads a block
template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int* out) {
  cudaError_t e = set_shared(kernel, smem);
  cudaFuncAttributes attr;
  int blocks = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = threads;
  return 0;
}

template <typename S>
int info(int which, int Bsz, int T, int n, int m, int c, int* out) {
  if (which == 0) {
    if (!sweep_dims_ok(Bsz, T, T, n, m, c)) return -1;
    const size_t smem = sizeof(S) * stage_smem_words(n, m, c);
    if (smem > kMaxShared) return -1;
    return kernel_info(sweep_kernel<S>, kStageThreads, smem, out);
  }
  if (!forward_dims_ok(Bsz, T, n, m, c)) return -1;
  FwdConfig cfg;
  const int r = forward_config<S>(Bsz, n, m, c, &cfg);
  if (r != 0) return r;
  return kernel_info(forward_kernel<S>, kFwdThreads, cfg.smem, out);
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

// which: 0 the sweep (K3), 1 the forward substitution (K4); f64: 0 or 1.
// out[4]: shared memory bytes a block, resident blocks per SM, registers a
// thread, threads a block.
extern "C" int fused_stage_info(int which, int f64, int B, int T, int nx, int nu,
                                int nc, int* out) {
  return f64 ? info<double>(which, B, T, nx, nu, nc, out)
             : info<float>(which, B, T, nx, nu, nc, out);
}
