// Shared device routines of K1 (chol_inv_node.cu) and K3 (fac_whole.cu):
// a register-tiled product, and the inverse Cholesky factor of an s x s
// float32 tile in shared memory, s <= 112, by the 2x2 block recursion.
//
// Layout: a tile is padded to sp = s rounded up to a multiple of nb = 16
// and stored with row stride ld = sp + 4. ld is a multiple of 4, so every
// row starts 16-byte aligned for float4 loads, and ld / 4 is odd, so the
// float4 rows that neighbouring lanes read along k fall in distinct banks.
//
// Product (K3's node products): each thread owns a 4 x 4 micro-tile of
// the output and keeps it in registers; one k-step of four reads a 4 x 4
// block of each operand as four float4 loads (along k, or along the output
// index for a transposed operand) and does 64 FMAs: 0.5 scalar shared
// loads per FMA (two before). Triangular zeros are skipped through the
// k-range of each micro-tile.
//
// Inverse Cholesky factor: the recursion of the plain version
// (solver/qp.py chol_inv), split at k = (n + 1) / 2 down to blocks of at
// most nb = 16. One warp factors and inverts each such block in registers
// with shuffles (left-looking, each entry one sum rounded once; pivots by
// a correctly rounded square root and division); the blocks between them
// are four register-tiled products per split (gproduct: any offsets and
// sizes, 0.5 scalar loads per FMA), four block barriers per split: 36 at
// s = 105, where a column-by-column factorization takes about 220. Why the
// recursion and not panels of 16 columns: the KKT blocks the solver
// factors have condition numbers near 3e9, so a float32 factor is fixed
// only to ~1e-3, and the solver's state follows the factor's summation
// structure. A blocked left-looking factorization with 16-column panels,
// as accurate against float64, landed 5e-4 to 1.1e-3 from the
// recursion-based references and failed the 1e-3 agreement gates of
// chip_smoke.py (PERF.md); the recursion keeps their structure.
//
// NaN semantics: a non-positive pivot gives 1 / sqrtf -> NaN (or inf) with
// no clamp, so a failed factorization reaches the caller as NaN.

#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kMaxS = 112;
constexpr int kNb = 16;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int padded(int s) { return (s + kNb - 1) / kNb * kNb; }
__host__ __device__ constexpr int stride(int sp) { return sp + 4; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += sum_{q < 4} A'(r + i, k + q) B'(k + q, c + j cs), where
// A'(r, k) = A[r][k] (TA false) or A[k][r] (TA true) and
// B'(k, c) = B[k][c] (TB false, cs = 1) or B[c][k] (TB true).
template <bool TA, bool TB>
__device__ __forceinline__ void mma4(float (&acc)[4][4], const float* A,
                                     const float* B, int ld, int r, int c,
                                     int cs, int k) {
  float a[4][4], b[4][4];  // a[i][q] = A'(r+i, k+q), b[q][j] = B'(k+q, c_j)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!TA) {
      const float4 v = ld4(A + (r + q) * ld + k);
      a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
    } else {
      const float4 v = ld4(A + (k + q) * ld + r);
      a[0][q] = v.x; a[1][q] = v.y; a[2][q] = v.z; a[3][q] = v.w;
    }
    if (!TB) {
      const float4 v = ld4(B + (k + q) * ld + c);
      b[q][0] = v.x; b[q][1] = v.y; b[q][2] = v.z; b[q][3] = v.w;
    } else {
      const float4 v = ld4(B + (c + q * cs) * ld + k);
      b[0][q] = v.x; b[1][q] = v.y; b[2][q] = v.z; b[3][q] = v.w;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
}

// For every output (r, c) of rows [r0, r0 + nr) x columns [c0, c0 + nc)
// (multiples of 4; LOWER: a square region, only micro-tiles on or below
// its diagonal): store(r, c, sum over k in [k0, k1) of A'(r, k) B'(k, c)),
// with krange(r, c, k0, k1) given the micro-tile's first row and column.
// Lanes run along the columns; with TB a thread's four columns are nc / 4
// apart, so that neighbouring lanes read neighbouring rows of B.
template <int NT, bool TA, bool TB, bool LOWER, class KRange, class Store>
__device__ __forceinline__ void product(const float* A, const float* B, int ld,
                                        int r0, int nr, int c0, int nc,
                                        KRange krange, Store store) {
  static_assert(!(LOWER && TB), "LOWER takes contiguous column ownership");
  const int nti = nr >> 2, ntj = nc >> 2;
  const int n = LOWER ? nti * (nti + 1) / 2 : nti * ntj;
  for (int t = threadIdx.x; t < n; t += NT) {
    int ti, tj;
    if (LOWER) {
      ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      tj = t - ti * (ti + 1) / 2;
    } else {
      ti = t / ntj;
      tj = t - ti * ntj;
    }
    const int r = r0 + 4 * ti;
    const int c = TB ? c0 + tj : c0 + 4 * tj;
    const int cs = TB ? ntj : 1;
    int k0, k1;
    krange(r, c, k0, k1);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = k0; k < k1; k += 4) mma4<TA, TB>(acc, A, B, ld, r, c, cs, k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) store(r + i, c + j * cs, acc[i][j]);
  }
}

// For every output (r, c) of an nr x nc block: store(r, c, sum over
// k in [k0, k1) of a(r, k) b(k, c)), with a(r, k) = A[r * ar + k * ak],
// b(k, c) = B[k * bk + c * bc] and krange(r, c, k0, k1) given a micro-tile's
// first row and column: any offsets, sizes and transposes, for the blocks
// of the 2x2 recursion; the k-range skips exact zeros of a triangular
// operand, which leaves every sum as it is. Each thread keeps a 4 x 4
// micro-tile in registers and reads four values of each operand per k (0.5
// scalar shared loads per FMA). CONTIG: a thread's four columns are
// adjacent (for a row-major B); else nc / 4 apart, so that neighbouring
// lanes read neighbouring rows of a column-major B. LOWER (square block,
// CONTIG): only micro-tiles that reach the diagonal or below. Entries past
// the block's edge are read as zero.
template <int NT, bool CONTIG, bool LOWER, class KRange, class Store>
__device__ __forceinline__ void gproduct(const float* A, int ar, int ak,
                                         const float* B, int bk, int bc,
                                         int nr, int nc, KRange krange,
                                         Store store) {
  static_assert(CONTIG || !LOWER, "LOWER takes adjacent columns");
  const int nti = (nr + 3) >> 2, ntj = (nc + 3) >> 2;
  const int n = LOWER ? nti * (nti + 1) / 2 : nti * ntj;
  for (int t = threadIdx.x; t < n; t += NT) {
    int ti, tj;
    if (LOWER) {
      ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      tj = t - ti * (ti + 1) / 2;
    } else {
      ti = t / ntj;
      tj = t - ti * ntj;
    }
    const int r = 4 * ti;
    const int c = CONTIG ? 4 * tj : tj;
    const int cs = CONTIG ? 1 : ntj;
    bool rok[4], cok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rok[q] = r + q < nr;
      cok[q] = c + q * cs < nc;
    }
    int k0, k1;
    krange(r, c, k0, k1);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = k0; k < k1; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = rok[q] ? A[(r + q) * ar + k * ak] : 0.f;
        b[q] = cok[q] ? B[k * bk + (c + q * cs) * bc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (rok[i] && cok[j]) store(r + i, c + j * cs, acc[i][j]);
  }
}

// One warp: the inverse Cholesky factor of the n x n (n <= nb) SPD block
// at a (lower triangle read), written to x (zero above the diagonal).
// Lane i < n holds row i in registers, lanes past n an identity row; every
// sum is kept in a register and rounded once.
__device__ __forceinline__ void leaf(const float* a, float* x, int ld, int n,
                                     int lane) {
  float row[kNb], acc[kNb], xr[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    row[c] = (lane < n && c < n) ? a[lane * ld + c] : (c == lane ? 1.f : 0.f);
    acc[c] = xr[c] = 0.f;
  }
  // L[i][j] = (S[i][j] - sum_{k<j} L[i][k] L[j][k]) / L[j][j], left-looking
  float dself = 0.f;  // 1 / L[lane][lane]
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < j; ++k)
      sum = fmaf(row[k], __shfl_sync(kFull, row[k], j), sum);
    const float v = row[j] - sum;
    const float piv = __shfl_sync(kFull, v, j);
    const float d = 1.0f / sqrtf(piv);
    row[j] = lane == j ? piv * d : v * d;
    if (lane == j) dself = d;
  }
  // X = L^-1 row by row: X[i][j] = -dinv[i] sum_{j<=k<i} L[i][k] X[k][j]
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    if (lane == i) {
#pragma unroll
      for (int j = 0; j < i; ++j) xr[j] = -dself * acc[j];
      xr[i] = dself;
    }
#pragma unroll
    for (int j = 0; j <= i; ++j)
      acc[j] = fmaf(row[i], __shfl_sync(kFull, xr[j], i), acc[j]);
  }
  if (lane < n) {
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      if (c < n) x[lane * ld + c] = xr[c];
  }
}

// The 2x2 block recursion on the n x n block at (o, o) of A: Li's block at
// (o, o) becomes its L^-1. With k = (n + 1) / 2 and S = [[S11, .], [S21,
// S22]]: L1i = rec(S11); L21 = S21 L1i^T, kept transposed in Li's upper
// block (free until the caller clears it); rec(S22 - L21 L21^T) in place
// gives L2i; (L2i L21) goes to S21's place and L^-1's lower block is
// -(L2i L21) L1i. Leaves n <= nb take one warp. Starts and ends at a block
// barrier; four barriers per split.
template <int NT>
__device__ void rec(float* A, float* Li, int ld, int o, int n) {
  if (n <= kNb) {
    if ((threadIdx.x >> 5) == 0)
      leaf(A + o * ld + o, Li + o * ld + o, ld, n, threadIdx.x & 31);
    __syncthreads();
    return;
  }
  const int k = (n + 1) / 2, n2 = n - k, p = o + k;
  rec<NT>(A, Li, ld, o, k);
  float* L21t = Li + o * ld + p;  // L21^T: L21(r, c) = L21t[c * ld + r]
  // L21 = S21 L1i^T (L1i^T is upper triangular, read along its columns)
  gproduct<NT, false, false>(
      A + p * ld + o, ld, 1, Li + o * ld + o, 1, ld, n2, k,
      [=](int, int, int& k0, int& k1) { k0 = 0; k1 = k; },
      [=](int r, int c, float v) { L21t[c * ld + r] = v; });
  __syncthreads();
  // S22 - L21 L21^T, on and below the diagonal (all the recursion reads)
  gproduct<NT, true, true>(
      L21t, 1, ld, L21t, ld, 1, n2, n2,
      [=](int, int, int& k0, int& k1) { k0 = 0; k1 = k; },
      [=](int r, int c, float v) { A[(p + r) * ld + p + c] -= v; });
  __syncthreads();
  rec<NT>(A, Li, ld, p, n2);
  float* M = A + p * ld + o;
  // M = L2i L21 (L2i lower triangular: k <= r)
  gproduct<NT, false, false>(
      Li + p * ld + p, ld, 1, L21t, 1, ld, n2, k,
      [=](int r, int, int& k0, int& k1) { k0 = 0; k1 = min(r + 4, n2); },
      [=](int r, int c, float v) { M[r * ld + c] = v; });
  __syncthreads();
  // -(M L1i) (L1i lower triangular: k >= c)
  gproduct<NT, true, false>(
      M, ld, 1, Li + o * ld + o, ld, 1, n2, k,
      [=](int, int c, int& k0, int& k1) { k0 = c; k1 = k; },
      [=](int r, int c, float v) { Li[(p + r) * ld + o + c] = -v; });
  // L21^T is spent: the caller reads this block's upper part as zeros
  for (int e = threadIdx.x; e < k * n2; e += NT) {
    const int c = e / n2, r = e - c * n2;
    L21t[c * ld + r] = 0.f;
  }
  __syncthreads();
}

// Li (sp x sp) = L^-1 of the SPD s x s block in A's corner, with zeros
// above the diagonal and on the padding; A is overwritten. Starts and ends
// at a block barrier.
template <int NT>
__device__ void chol_inv(float* A, float* Li, int s, int sp, int ld) {
  rec<NT>(A, Li, ld, 0, s);
  for (int e = threadIdx.x; e < sp * sp; e += NT) {
    const int r = e / sp, c = e - r * sp;
    if (c > r || r >= s) Li[r * ld + c] = 0.f;
  }
  __syncthreads();
}

}  // namespace tile
