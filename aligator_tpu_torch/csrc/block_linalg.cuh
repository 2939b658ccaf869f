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
// padded with the identity. The tiles are read with load(i, j), the element
// (i, j) of [W | Y] for i < n, j < n + r, and X is written with store(i, c,
// x_ic) once `bad` is final; gj_tiles and gj_buf_words give the threads
// and the words of `buf` a system needs, gj_in_registers whether it fits.
constexpr int kGjB = 4;

template <int C>
__host__ __device__ inline int gj_tiles(int n, int r) {
  return (n + kGjB - 1) / kGjB * ((n + r + C - 1) / C);
}

template <int C>
__host__ __device__ inline int gj_buf_words(int n, int r) {
  const int wp = (n + r + C - 1) / C * C, np = (n + kGjB - 1) / kGjB * kGjB;
  return 2 * (kGjB * wp + np * kGjB + kGjB * kGjB) + np * kGjB;
}

template <int C>
__device__ __forceinline__ bool gj_in_registers(int n, int r, int buf_words) {
  return gj_tiles<C>(n, r) <= static_cast<int>(blockDim.x) &&
         gj_buf_words<C>(n, r) <= buf_words;
}

template <int C, typename S, typename Load, typename Store>
__device__ void gauss_jordan_regs(int n, int r, S* buf, int* bad, Load load, Store store) {
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
      x[u][v] = i < n && j < w ? load(i, j) : S(0);
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
        if (i0 + a < n && j >= n && j < w) store(i0 + a, j - n, s);
      }
    }
  }
}

// The same on M = [W | Y] in shared memory (leading dimension ld), in place.
template <int C, typename S>
__device__ __forceinline__ void gauss_jordan_regs(S* M, int n, int r, int ld, S* buf,
                                                  int* bad) {
  gauss_jordan_regs<C>(
      n, r, buf, bad, [M, ld](int i, int j) { return M[i * ld + j]; },
      [M, n, ld](int i, int c, S x) { M[i * ld + n + c] = x; });
}

}  // namespace aligator
