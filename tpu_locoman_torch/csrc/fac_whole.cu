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
// Linv, F_{i-1}, U_i) stays in four padded sp x (sp + 4) tiles of dynamic
// shared memory (sp = s rounded up to 16; 203 KB at s = 112). Only H_i,
// U_i and the three outputs touch device memory.
//
// Method (chol_tile.cuh): every product of a node -- the Schur update
// F^T F, F = Linv U, W = Linv F_prev^T and V = Linv^T F -- is the
// register-tiled product (4 x 4 outputs per thread, float4 operands, 0.5
// shared loads per FMA, triangular zeros skipped); Linv_i comes from the
// 2x2 block recursion of K1 (leaves of <= 16 by one warp in registers).
// About 41 block barriers per node at s = 110, where the column-by-column
// design took about 225. 512 threads: the Schur update has 378 micro-tiles
// at s = 110 and the full products 784, so 16 warps keep one or two tiles
// each; the recursion's products have at most 196 micro-tiles and its
// leaves one warp, so they are bound by their dependent chain, not by the
// thread count.
//
// What bounds it now: at batch 1 one SM does all the work of a scenario,
// and the panel steps are short dependent chains between barriers; at
// batch 512 the CTAs fill the card in four waves (one CTA per SM).
// Measured by chip_smoke.py phase 8 on an NVIDIA H100 80GB HBM3 at 700 W
// (device time per launch): 1.89 ms at (K, s) = (14, 110) and 1.99 ms at
// (15, 105) for one scenario, 8.26 and 8.68 ms for 512, where the
// column-by-column design took 3.85, 3.87, 15.59 and 15.65 ms and a
// blocked design with 16-column panels 0.94, 1.00, 4.04 and 4.28 ms (it
// failed the agreement gates; see chol_tile.cuh). The card's bound is
// 0.0012 ms at batch 1 and 0.59-0.63 ms at batch 512.
//
// NaN semantics are kept: a non-positive pivot gives rsqrt -> NaN (or inf)
// and is not clamped, so a failed factorization reaches the solver as NaN.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads, 1)
fac_whole_kernel(const float* __restrict__ H, const float* __restrict__ U,
                 float* __restrict__ Linv_out, float* __restrict__ W_out,
                 float* __restrict__ V_out, int K, int s) {
  extern __shared__ float4 sm4[];
  const int sp = tile::padded(s);
  const int ld = tile::stride(sp);
  const int tsz = sp * ld;
  float* A = reinterpret_cast<float*>(sm4);  // S_i, then L_i, then F_i
  float* Li = A + tsz;                       // Linv_i
  float* Fp = Li + tsz;                      // F_{i-1}
  float* X = Fp + tsz;                       // U_i
  const int tid = threadIdx.x;
  const size_t blk = (size_t)s * s;
  const size_t out0 = (size_t)blockIdx.x * K * blk;
  const float* Hb = H + out0;
  const float* Ub = U + (size_t)blockIdx.x * (K - 1) * blk;
  const int s4 = (s + 3) & ~3;  // rows of F past s4 are zero padding

  for (int e = tid; e < 4 * tsz; e += kThreads) A[e] = 0.f;
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    const bool has_prev = i > 0;
    const bool has_next = i < K - 1;
    const float* Hi = Hb + i * blk;
    float* Lo = Linv_out + out0 + i * blk;
    float* Wo = W_out + out0 + i * blk;
    float* Vo = V_out + out0 + i * blk;

    // 1. S = H_i - F_{i-1}^T F_{i-1} + 1e-6 I (lower triangle), identity on
    // the padding
    const int kS = has_prev ? s4 : 0;
    tile::product<kThreads, true, false, true>(
        Fp, Fp, ld, 0, sp, 0, sp,
        [=](int, int, int& k0, int& k1) { k0 = 0; k1 = kS; },
        [=](int r, int c, float v) {
          A[r * ld + c] = (r < s && c < s)
                              ? Hi[r * s + c] - v + (r == c ? 1e-6f : 0.f)
                              : (r == c ? 1.f : 0.f);
        });
    __syncthreads();

    // 2. L_i and Linv_i
    tile::chol_inv<kThreads>(A, Li, s, sp, ld);

    // 3. store Linv_i; load U_i (zero padding)
    for (int e = tid; e < s * s; e += kThreads) {
      const int r = e / s, c = e - r * s;
      Lo[e] = Li[r * ld + c];
    }
    if (has_next) {
      const float* Ui = Ub + i * blk;
      for (int e = tid; e < sp * sp; e += kThreads) {
        const int r = e / sp, c = e - r * sp;
        X[r * ld + c] = (r < s && c < s) ? Ui[r * s + c] : 0.f;
      }
    }
    __syncthreads();

    // 4. F_i = Linv_i U_i into A (L is spent); W_i = Linv_i F_{i-1}^T out
    if (has_next)
      tile::product<kThreads, false, false, false>(
          Li, X, ld, 0, sp, 0, sp,
          [=](int r, int, int& k0, int& k1) { k0 = 0; k1 = r + 4; },
          [=](int r, int c, float v) { A[r * ld + c] = v; });
    if (has_prev)
      tile::product<kThreads, false, true, false>(
          Li, Fp, ld, 0, sp, 0, sp,
          [=](int r, int, int& k0, int& k1) { k0 = 0; k1 = r + 4; },
          [=](int r, int c, float v) {
            if (r < s && c < s) Wo[r * s + c] = v;
          });
    else
      for (int e = tid; e < s * s; e += kThreads) Wo[e] = 0.f;
    __syncthreads();

    // 5. V_i = Linv_i^T F_i out
    if (has_next)
      tile::product<kThreads, true, false, false>(
          Li, A, ld, 0, sp, 0, sp,
          [=](int r, int, int& k0, int& k1) { k0 = r; k1 = s4; },
          [=](int r, int c, float v) {
            if (r < s && c < s) Vo[r * s + c] = v;
          });
    else
      for (int e = tid; e < s * s; e += kThreads) Vo[e] = 0.f;
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
  if (s < 1 || s > tile::kMaxS || K < 1) return (int)cudaErrorInvalidValue;
  if (Bs == 0) return 0;
  const int sp = tile::padded(s);
  const size_t smem = 4 * (size_t)sp * tile::stride(sp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fac_whole_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fac_whole_kernel<<<Bs, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)U, (float*)Linv, (float*)W, (float*)V, K,
      s);
  return (int)cudaGetLastError();
}
