// K1: inverse Cholesky factor L^-1 of a batch of SPD blocks, a whole node
// block per CTA.
//
// Replaces the TPU kernel chol_inv_base_batched / _base_kernel
// (tpu_locoman/solver/pallas_base.py), and with it the recursion around
// it: the TPU kernel factored the b <= 16 leaves of chol_inv's 2 x 2 block
// recursion, whose panel products and concatenations XLA fused. Here one
// launch takes S (B, s, s) float32, s <= 112 read at run time, to
// L^-1 (B, s, s) with S = L L^T: the node factorizations of factorize,
// factorize_babe and kkt_polish, one launch per node for the whole batch.
//
// Bound: ~2 s^3 / 3 f32 operations per block against 2 s^2 floats moved,
// 9 operations per byte at s = 105, under the card's 20 (67 TFLOP/s f32
// without tensor cores over 3.35 TB/s): bytes bound it, 13.5 us at
// (512, 105). What holds it back is each CTA's dependent chain of
// recursion steps (one warp's leaf blocks between barriers); the ~80
// small kernels per node of the torch recursion are gone.
// Design: one CTA of 256 threads per block, holding S and L^-1 in two
// padded sp x (sp + 4) tiles of shared memory (104 KB at s = 112), so two
// CTAs share an SM; the 2x2 block recursion of chol_tile.cuh runs on them
// with the plain version's split points, and only S and L^-1 touch device
// memory.
//
// NaN semantics are kept: a non-positive pivot gives rsqrt -> NaN (or inf)
// and is not clamped, so a failed factorization surfaces as NaN in the QP
// step, which the SQP solver turns into status 2.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 2)
chol_inv_node_kernel(const float* __restrict__ S, float* __restrict__ out,
                     int s) {
  extern __shared__ float4 sm4[];
  const int sp = tile::padded(s);
  const int ld = tile::stride(sp);
  float* A = reinterpret_cast<float*>(sm4);  // S, then spent
  float* Li = A + sp * ld;                   // L^-1
  const size_t blk = (size_t)s * s;
  const float* src = S + blockIdx.x * blk;
  float* dst = out + blockIdx.x * blk;

  for (int e = threadIdx.x; e < s * s; e += kThreads) {
    const int r = e / s, c = e - r * s;
    A[r * ld + c] = src[e];
  }
  __syncthreads();
  tile::chol_inv<kThreads>(A, Li, s, sp, ld);
  for (int e = threadIdx.x; e < s * s; e += kThreads) {
    const int r = e / s, c = e - r * s;
    dst[e] = Li[r * ld + c];
  }
}

}  // namespace

extern "C" int chol_inv_node_launch(const void* S, void* out, int B, int s,
                                    void* stream) {
  if (s < 1 || s > tile::kMaxS) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int sp = tile::padded(s);
  const size_t smem = 2 * (size_t)sp * tile::stride(sp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  chol_inv_node_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)S, (float*)out, s);
  return (int)cudaGetLastError();
}
