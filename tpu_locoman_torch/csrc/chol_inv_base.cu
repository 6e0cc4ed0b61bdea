// K1: inverse Cholesky factor L^-1 of a batch of small SPD blocks.
//
// Replaces the TPU kernel chol_inv_base_batched / _base_kernel
// (tpu_locoman/solver/pallas_base.py). S (B, b, b) float32 -> L^-1 (B, b, b)
// with S = L L^T, 1 <= b <= 32, b read at run time.
//
// Bound: launch latency. The factorization calls this once per recursion
// leaf of every node's chol_inv: 8 leaves of b in {13, 14} x 15 nodes = 120
// launches per factorize, each ~100 KB in and out at batch 512 — FLOPs and
// bytes are negligible, so the design keeps each launch one short wave:
// one warp per matrix (4 matrices per 128-thread CTA, 128 CTAs at batch
// 512), everything in shared memory padded to b x (b + 1) against bank
// conflicts, no global scratch.
//
// Method: right-looking Cholesky in which lane i owns row i (the trailing
// update touches only the lower triangle), then L^-1 by forward
// substitution in which lane j owns column j. The TPU kernel's
// nilpotent-doubling inverse only served to avoid sequential steps on the
// TPU; at b <= 32 a warp-level substitution is cheap. Lanes >= b idle in
// place of the TPU kernel's identity padding.
//
// NaN semantics are kept: a non-positive pivot gives rsqrt -> NaN (or inf)
// and is not clamped, so a failed factorization surfaces as NaN in the QP
// step, which the SQP solver turns into status 2.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void chol_inv_base_kernel(const float* __restrict__ S,
                                     float* __restrict__ out, int B, int b) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mat = blockIdx.x * kWarpsPerBlock + warp;
  if (mat >= B) return;  // whole warps exit; no block-level barrier below
  const int ld = b + 1;
  float* Lm = sm + warp * (2 * b * ld + 32);
  float* X = Lm + b * ld;
  float* dinv = X + b * ld;

  const float* src = S + (size_t)mat * b * b;
  for (int e = lane; e < b * b; e += 32) Lm[(e / b) * ld + e % b] = src[e];
  __syncwarp();

  for (int j = 0; j < b; ++j) {
    const float d = rsqrtf(Lm[j * ld + j]);
    __syncwarp();
    if (lane >= j && lane < b) Lm[lane * ld + j] *= d;
    if (lane == 0) dinv[j] = d;
    __syncwarp();
    if (lane > j && lane < b) {
      const float lij = Lm[lane * ld + j];
      for (int c = j + 1; c <= lane; ++c) Lm[lane * ld + c] -= lij * Lm[c * ld + j];
    }
    __syncwarp();
  }

  if (lane < b) {
    const int j = lane;
    for (int i = 0; i < j; ++i) X[i * ld + j] = 0.f;
    X[j * ld + j] = dinv[j];
    for (int i = j + 1; i < b; ++i) {
      float s = 0.f;
      for (int k = j; k < i; ++k) s += Lm[i * ld + k] * X[k * ld + j];
      X[i * ld + j] = -dinv[i] * s;
    }
  }
  __syncwarp();

  float* dst = out + (size_t)mat * b * b;
  for (int e = lane; e < b * b; e += 32) dst[e] = X[(e / b) * ld + e % b];
}

}  // namespace

extern "C" int chol_inv_base_launch(const void* S, void* out, int B, int b,
                                    void* stream) {
  if (b < 1 || b > 32) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * (2 * b * (b + 1) + 32) * sizeof(float);
  chol_inv_base_kernel<<<blocks, 32 * kWarpsPerBlock, smem, (cudaStream_t)stream>>>(
      (const float*)S, (float*)out, B, b);
  return (int)cudaGetLastError();
}
