// Dense linear algebra on small row-major matrices, run by all threads of
// one block together: the SPD solves of spd_solve.cu (K2) and of
// fused_stage.cu's backward stage (K3). Every function starts and ends with
// the block in step: callers __syncthreads() before reading what one wrote.
// Also the launchers' shared-memory opt-in, opt_in_shared.

#pragma once

#include <cuda_runtime.h>

namespace aligator {

// Dynamic shared memory a block gets without opting in: 48 KB less the
// kernel's static shared memory, which here is at most a failure flag (a
// launch of exactly 48 KB of dynamic memory beside the flag fails unless
// the kernel opts in).
constexpr size_t kDefaultDynamicShared = 48 * 1024 - 64;

// Opt kernel in to smem bytes of dynamic shared memory where the default
// does not hold them.
template <typename K>
cudaError_t opt_in_shared(K kernel, size_t smem) {
  if (smem <= kDefaultDynamicShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// quiet NaN of the scalar type (std::numeric_limits is host-only here)
template <typename S>
__device__ __forceinline__ S qnan();
template <>
__device__ __forceinline__ float qnan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

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

// The same solve with [W | Y] in registers by block Cholesky, four pivots
// at a time: each thread holds one tile of kTile x C words for the whole
// solve (C = 8, or 4 for a small system, which then spreads over more
// threads); the reg_* helpers below size the tiles and the scratch. Forward
// step kb takes the block K = [4 kb, 4 kb + 4): the threads holding rows
// K, the columns K and the pivot block A_KK publish the rows R_K, the
// multipliers x[:, K] and the factor F_K of A_KK (chol4; a pivot not > 0,
// or NaN, sets *bad = 1, the condition under which the Cholesky
// factorization of W fails) into `buf`, double-buffered, one barrier a
// step; every row i below K then takes x_i -= (F_K^{-1} x_i[K]')'
// (F_K^{-1} R_K), the symmetric (Cholesky) form of the Schur-complement
// update. After the last step each thread scales its rows by its block's
// F^{-1}: [W | Y] is then [L' | L^{-1} Y] for W = L L'. The block back
// substitution takes nb steps: in step K the threads of rows K solve F_K'
// X_K = (their Y columns) and publish X_K, and the rows above take x_i[Y]
// -= x_i[K] X_K, one barrier a step. Dimensions past n are padded with the
// identity. The tiles are read with load(i, j), the element (i, j) of [W |
// Y] for i < n, j < n + r, and X is written with store(i, c, x_ic) once
// `bad` is final; reg_tiles and reg_buf_words give the threads and the words
// of `buf` a system needs, fits_registers whether it fits.
//
// Stability: the update in the symmetric form is backward stable as a
// Cholesky solve is. Block LU with the same pivot factors, which forms
// A_KK^{-1} R_K and multiplies it by the unscaled x_i[K], is not: its
// backward error grows with the square root of W's condition (15x a
// Cholesky solve's on a reduced KKT matrix of condition ~1e5 in float32,
// 68x on a system of condition 1e10 in float64), and block Gauss-Jordan
// with explicit 4 x 4 pivot-block inverses failed outright there.
constexpr int kTile = 4;

template <int C>
__host__ __device__ inline int reg_tiles(int n, int r) {
  return (n + kTile - 1) / kTile * ((n + r + C - 1) / C);
}

template <int C>
__host__ __device__ inline int reg_buf_words(int n, int r) {
  const int wp = (n + r + C - 1) / C * C, np = (n + kTile - 1) / kTile * kTile;
  return 2 * (kTile * wp + np * kTile + kTile * kTile) + np * kTile;
}

template <int C>
__device__ __forceinline__ bool fits_registers(int n, int r, int buf_words) {
  return reg_tiles<C>(n, r) <= static_cast<int>(blockDim.x) &&
         reg_buf_words<C>(n, r) <= buf_words;
}

// The 4 x 4 Cholesky factor of a pivot block, lower triangle read, the
// reciprocals of its diagonal on the diagonal (f[u][q], q <= u); a pivot
// not > 0 (or NaN) sets *bad = 1.
template <typename S>
__device__ __forceinline__ void chol4(const S (&a)[kTile][kTile], S (&f)[kTile][kTile], int* bad) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    S d = a[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) d -= f[j][q] * f[j][q];
    if (!(d > S(0))) *bad = 1;
    const S rl = S(1) / sqrt(d);
    f[j][j] = rl;
#pragma unroll
    for (int i = j + 1; i < kTile; ++i) {
      S s = a[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s -= f[i][q] * f[j][q];
      f[i][j] = s * rl;
    }
#pragma unroll
    for (int q = j + 1; q < kTile; ++q) f[j][q] = S(0);
  }
}

// x <- F^{-1} x for a factor of chol4 (forward substitution)
template <typename S>
__device__ __forceinline__ void chol4_fwd(const S (&f)[kTile][kTile], S (&x)[kTile]) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int q = 0; q < a; ++q) x[a] -= f[a][q] * x[q];
    x[a] *= f[a][a];
  }
}

// x <- F'^{-1} x for a factor of chol4 (back substitution)
template <typename S>
__device__ __forceinline__ void chol4_bwd(const S (&f)[kTile][kTile], S (&x)[kTile]) {
#pragma unroll
  for (int a = kTile - 1; a >= 0; --a) {
#pragma unroll
    for (int q = a + 1; q < kTile; ++q) x[a] -= f[q][a] * x[q];
    x[a] *= f[a][a];
  }
}

template <int C, typename S, typename Load, typename Store>
__device__ void block_cholesky_regs(int n, int r, S* buf, int* bad, Load load, Store store) {
  constexpr int B = kTile;
  static_assert(C == B || C == 2 * B, "a pivot block sits at column 0 or B of a tile");
  const int w = n + r, wp = (w + C - 1) / C * C, nb = (n + B - 1) / B, np = nb * B;
  const int tcn = wp / C, tiles = nb * tcn;
  const int words = B * wp + np * B + B * B;  // one buffer: R_K, x[:, K], F_K
  S* const saved = buf + 2 * words;           // every block's factor F_K
  const bool has = static_cast<int>(threadIdx.x) < tiles;
  const int ti = has ? threadIdx.x / tcn : nb, tj = has ? threadIdx.x % tcn : 0;
  const int i0 = ti * B, j0 = tj * C;
  S x[B][C];
#pragma unroll
  for (int u = 0; u < B; ++u)
#pragma unroll
    for (int v = 0; v < C; ++v) {
      const int i = i0 + u, j = j0 + v;
      x[u][v] = i < n && j < w ? load(i, j) : S(0);
    }

  // the columns K of this thread's rows, for the threads of tile column k / C
  auto publish_multipliers = [&](S* L, int k) {
    const int v0 = k % C;
#pragma unroll
    for (int u = 0; u < B; ++u)
#pragma unroll
      for (int q = 0; q < B; ++q)
        L[(i0 + u) * B + q] = C == B || v0 == 0 ? x[u][q] : x[u][(C - B) + q];
  };

  // forward step kb: R_K, the multipliers and the factor of A_KK
  auto publish = [&](int kb) {
    S* R = buf + (kb & 1) * words;
    S* L = R + B * wp;
    S* F = L + np * B;
    const int k = kb * B, v0 = k % C;
    if (has && i0 == k) {
#pragma unroll
      for (int u = 0; u < B; ++u)
#pragma unroll
        for (int v = 0; v < C; ++v) R[u * wp + j0 + v] = x[u][v];
    }
    if (has && tj == k / C) {
      publish_multipliers(L, k);
      if (i0 == k) {  // F_K, A_KK padded with the identity past n
        S a[B][B], f[B][B];
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int q = 0; q < B; ++q)
            a[u][q] = k + u >= n || k + q >= n ? (u == q ? S(1) : S(0))
                      : (C == B || v0 == 0 ? x[u][q] : x[u][(C - B) + q]);
        chol4(a, f, bad);
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int q = 0; q < B; ++q) {
            F[u * B + q] = f[u][q];
            saved[kb * B * B + u * B + q] = f[u][q];
          }
      }
    }
  };

  // back step kb: the rows K (scaled) solve F_K' X_K = their columns of Y
  // and publish X_K, zero in the columns of W, with the multipliers of the
  // rows above
  auto publish_back = [&](int kb, int parity) {
    S* R = buf + parity * words;
    S* L = R + B * wp;
    const int k = kb * B;
    if (has && i0 == k) {
      S f[B][B];
#pragma unroll
      for (int u = 0; u < B; ++u) load4(saved + kb * B * B + u * B, f[u]);
#pragma unroll
      for (int v = 0; v < C; ++v) {
        S col[B];
#pragma unroll
        for (int u = 0; u < B; ++u) col[u] = x[u][v];
        chol4_bwd(f, col);
        const bool in_y = j0 + v >= n;
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (in_y) x[u][v] = col[u];
          R[u * wp + j0 + v] = in_y ? col[u] : S(0);
        }
      }
    }
    if (has && tj == k / C) publish_multipliers(L, k);
  };

  // x[u][:] -= sum_a l[u][a] p[a][:] for the published rows p of this
  // step; in the forward steps (F given) l[u] <- F^{-1} l[u] and each
  // column of p <- F^{-1} p first
  auto update = [&](const S* R, const S* L, const S* F) {
    S l[B][B], f[B][B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      load4(L + (i0 + u) * B, l[u]);
      if (F != nullptr) load4(F + u * B, f[u]);
    }
    if (F != nullptr) {
#pragma unroll
      for (int u = 0; u < B; ++u) chol4_fwd(f, l[u]);
    }
#pragma unroll
    for (int v4 = 0; v4 < C; v4 += 4) {
      S rk[B][4];
#pragma unroll
      for (int q = 0; q < B; ++q) load4(R + q * wp + j0 + v4, rk[q]);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        S pk[B];
#pragma unroll
        for (int a = 0; a < B; ++a) pk[a] = rk[a][v];
        if (F != nullptr) chol4_fwd(f, pk);
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int a = 0; a < B; ++a) x[u][v4 + v] -= l[u][a] * pk[a];
      }
    }
  };

  // this thread's rows <- F^{-1} rows, F its row block's factor
  auto scale_rows = [&]() {
    S f[B][B];
#pragma unroll
    for (int u = 0; u < B; ++u) load4(saved + ti * B * B + u * B, f[u]);
#pragma unroll
    for (int v = 0; v < C; ++v) {
      S col[B];
#pragma unroll
      for (int u = 0; u < B; ++u) col[u] = x[u][v];
      chol4_fwd(f, col);
#pragma unroll
      for (int u = 0; u < B; ++u) x[u][v] = col[u];
    }
  };

  publish(0);
  __syncthreads();
  for (int kb = 0; kb < nb; ++kb) {
    const S* R = buf + (kb & 1) * words;
    if (has && i0 > kb * B) update(R, R + B * wp, R + B * wp + np * B);
    if (kb + 1 < nb) {
      publish(kb + 1);
    } else {
      if (has) scale_rows();
      publish_back(nb - 1, nb & 1);
    }
    __syncthreads();
  }
  for (int s = 0; s < nb; ++s) {
    const int kb = nb - 1 - s, parity = (nb + s) & 1;
    const S* R = buf + parity * words;
    if (has && i0 < kb * B) update(R, R + B * wp, nullptr);
    if (kb > 0) publish_back(kb - 1, parity ^ 1);
    __syncthreads();
  }
  if (has) {
#pragma unroll
    for (int u = 0; u < B; ++u)
#pragma unroll
      for (int v = 0; v < C; ++v) {
        const int i = i0 + u, j = j0 + v;
        if (i < n && j >= n && j < w) store(i, j - n, x[u][v]);
      }
  }
}

// The same on M = [W | Y] in shared memory (leading dimension ld), in place.
template <int C, typename S>
__device__ __forceinline__ void block_cholesky_regs(S* M, int n, int r, int ld, S* buf,
                                                    int* bad) {
  block_cholesky_regs<C>(
      n, r, buf, bad, [M, ld](int i, int j) { return M[i * ld + j]; },
      [M, n, ld](int i, int c, S x) { M[i * ld + n + c] = x; });
}

}  // namespace aligator
