// K3: each scenario's whole block-tridiagonal factorization in one launch.
//
// Replaces the TPU kernel factorize_pallas / _factorize_kernel
// (tpu_locoman/solver/pallas_fac.py). For H (Bs, K, s, s) and full-width
// couplings U (Bs, K-1, s, s), float32, s <= 112 read at run time, node by
// node:
//   S_i = H_i - F_{i-1}^T F_{i-1} + 1e-6 I,  Linv_i = chol(S_i)^-1,
//   F_i = Linv_i U_i,  W_i = Linv_i F_{i-1}^T,  V_i = Linv_i^T F_i,
// writing Linv, W, V (Bs, K, s, s) with W_0 = 0 and V_{K-1} = 0.
//
// Bound: ~4.7 s^3 f32 operations per interior node against 2 s^2 floats of
// input, so operations bound it on the card (67 TFLOP/s f32 without tensor
// cores). Design: one CTA per scenario; the TPU kernel's sequential grid
// over nodes becomes a loop inside the block, and the running state (S/L,
// Linv, F_{i-1}, U_i) stays in four s x (s+1) tiles of dynamic shared memory
// (odd row stride against bank conflicts). Only H_i, U_i and the three
// outputs touch device memory. At batch 1 the kernel runs on one SM with a
// serial critical path (K nodes x s Cholesky columns, one barrier each);
// at batch 512 the CTAs fill the card in waves.
//
// Method: a left-looking Cholesky in place (column by column; each entry of
// column j is one warp-wide dot product over the finished columns, so it
// is rounded once instead of once per earlier column as in a right-looking
// update, which measured ~2x the solve error on the flagship's KKT
// blocks), then L^-1 by forward substitution with a group of four lanes
// per column splitting each inner sum. The TPU kernel's recursive 2x2
// split, unrolled one-hot column accumulation and lane padding served
// Mosaic and have no counterpart here. Every product accumulates in f32 on
// the CUDA cores.
//
// NaN semantics are kept: a non-positive pivot gives rsqrt -> NaN (or inf)
// and is not clamped, so a failed factorization reaches the solver as NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // lanes per column in the substitution
constexpr int kMaxS = 112;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
fac_whole_kernel(const float* __restrict__ H, const float* __restrict__ U,
                 float* __restrict__ Linv_out, float* __restrict__ W_out,
                 float* __restrict__ V_out, int K, int s) {
  extern __shared__ float sm[];
  const int ld = s + 1;
  const int tsz = s * ld;
  const int ss = s * s;
  float* A = sm;             // S_i, then its Cholesky factor, then F_i
  float* Li = A + tsz;       // Linv_i
  float* Fp = Li + tsz;      // F_{i-1}
  float* X = Fp + tsz;       // U_i
  float* dinv = X + tsz;     // 1 / diag(L_i)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t blk = (size_t)ss;
  const size_t out0 = (size_t)blockIdx.x * K * blk;
  const float* Hb = H + out0;
  const float* Ub = U + (size_t)blockIdx.x * (K - 1) * blk;

  for (int e = tid; e < tsz; e += kThreads) Fp[e] = 0.f;
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    const bool has_prev = i > 0;
    const bool has_next = i < K - 1;

    // 1. S = H_i - F_{i-1}^T F_{i-1} + 1e-6 I, lower triangle
    const float* Hi = Hb + i * blk;
    for (int e = tid; e < ss; e += kThreads) {
      const int r = e / s, c = e - r * s;
      if (c > r) continue;
      float acc = 0.f;
      if (has_prev)
        for (int k = 0; k < s; ++k) acc += Fp[k * ld + r] * Fp[k * ld + c];
      A[r * ld + c] = Hi[e] - acc + (r == c ? 1e-6f : 0.f);
    }
    __syncthreads();

    // 2. Cholesky, left-looking: below the diagonal A becomes L, the
    // diagonal keeps S (L's is 1 / dinv). Every warp forms the pivot of
    // column j itself, then one warp per row r > j:
    //   L[r][j] = (S[r][j] - sum_{k<j} L[r][k] L[j][k]) * dinv[j]
    for (int j = 0; j < s; ++j) {
      float dd = 0.f;
      for (int k = lane; k < j; k += 32) dd += A[j * ld + k] * A[j * ld + k];
      const float d = rsqrtf(A[j * ld + j] - warp_sum(dd));
      if (tid == 0) dinv[j] = d;
      for (int r = j + 1 + warp; r < s; r += kWarps) {
        float acc = 0.f;
        for (int k = lane; k < j; k += 32) acc += A[r * ld + k] * A[j * ld + k];
        acc = warp_sum(acc);
        if (lane == 0) A[r * ld + j] = (A[r * ld + j] - acc) * d;
      }
      __syncthreads();
    }

    // 3. Linv by forward substitution, kGroup lanes per column j:
    //    Linv[r][j] = -dinv[r] * sum_{j <= k < r} L[r][k] Linv[k][j]
    if (warp * (32 / kGroup) < s) {
      const int j = tid / kGroup, g = tid % kGroup;
      const bool col = j < s;
      if (col && g == 0) {
        for (int r = 0; r < j; ++r) Li[r * ld + j] = 0.f;
        Li[j * ld + j] = dinv[j];
      }
      __syncwarp();
      for (int r = 1; r < s; ++r) {
        float acc = 0.f;
        if (col && r > j)
          for (int k = j + g; k < r; k += kGroup)
            acc += A[r * ld + k] * Li[k * ld + j];
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (col && r > j && g == 0) Li[r * ld + j] = -dinv[r] * acc;
        __syncwarp();
      }
    }
    __syncthreads();

    // 4. store Linv_i; load U_i
    float* Lo = Linv_out + out0 + i * blk;
    const float* Ui = Ub + i * blk;
    for (int e = tid; e < ss; e += kThreads) {
      const int r = e / s, c = e - r * s;
      Lo[e] = Li[r * ld + c];
      if (has_next) X[r * ld + c] = Ui[e];
    }
    __syncthreads();

    // 5. F_i = Linv_i U_i into A (L is spent); W_i = Linv_i F_{i-1}^T out
    float* Wo = W_out + out0 + i * blk;
    for (int e = tid; e < ss; e += kThreads) {
      const int r = e / s, c = e - r * s;
      float f = 0.f, w = 0.f;
      if (has_next)
        for (int k = 0; k <= r; ++k) f += Li[r * ld + k] * X[k * ld + c];
      if (has_prev)
        for (int k = 0; k <= r; ++k) w += Li[r * ld + k] * Fp[c * ld + k];
      A[r * ld + c] = f;
      Wo[e] = w;
    }
    __syncthreads();

    // 6. V_i = Linv_i^T F_i out
    float* Vo = V_out + out0 + i * blk;
    for (int e = tid; e < ss; e += kThreads) {
      const int r = e / s, c = e - r * s;
      float v = 0.f;
      if (has_next)
        for (int k = r; k < s; ++k) v += Li[k * ld + r] * A[k * ld + c];
      Vo[e] = v;
    }
    __syncthreads();

    // F_i becomes F_{i-1}; the old F tile takes the next S
    float* t = Fp;
    Fp = A;
    A = t;
  }
}

}  // namespace

extern "C" int fac_whole_launch(const void* H, const void* U, void* Linv,
                                void* W, void* V, int Bs, int K, int s,
                                void* stream) {
  if (s < 1 || s > kMaxS || K < 1) return (int)cudaErrorInvalidValue;
  if (Bs == 0) return 0;
  const size_t smem = (4 * (size_t)s * (s + 1) + s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fac_whole_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fac_whole_kernel<<<Bs, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)U, (float*)Linv, (float*)W, (float*)V, K,
      s);
  return (int)cudaGetLastError();
}
