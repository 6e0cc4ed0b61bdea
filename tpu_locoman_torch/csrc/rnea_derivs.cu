// K2: analytic RNEA derivatives, one CTA per flat-batch element.
//
// Replaces the TPU kernel rnea_derivatives_pallas / _rnea_derivs_kernel
// (tpu_locoman/pallas_rbda.py). The forward world-frame quantities arrive
// precomputed (tpu_locoman_torch/rnea_derivs.py:forward_quantities); this
// kernel does the O(n * nv * 6) derivative pass.
//
// Bound: latency and occupancy, not FLOPs or bytes. Every (link, column)
// intermediate of one element (dV_q, df_v / df_q, the per-dof w terms:
// ~11k floats at nv = 24, n = 19) lives in shared memory, so device memory
// sees only the inputs (~3 KB) and the outputs (~8 KB) of each element.
// Threads run over (link, column) or (dof, column) pairs; the ancestry
// contractions are direct masked sums over links or dofs (no tree walk,
// so no serial dependency chain inside a phase).
//
// Layouts (row-major, float32): Sw (B, nv, 6), Iw (B, n, 6, 6), v, a (B, nv),
// sdot (B, nv, 6), Vl, A, Iv, IA, f (B, n, 6), pf (B, nfr, 3),
// fw (B, 3 * nfr); anc (n, nv) 0/1, dof_link (nv,), ee_joint (nfr,).
// Outputs dq, dv, da (B, nv, nv) [row k, column j]; df (B, nv, 3 * nfr).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// motion cross m1 x m2 = [w1 x v2 + v1 x w2, w1 x w2]; o must not alias.
__device__ __forceinline__ void mcross(const float* m1, const float* m2, float* o) {
  float t1[3], t2[3];
  cross3(m1 + 3, m2, t1);
  cross3(m1, m2 + 3, t2);
  o[0] = t1[0] + t2[0];
  o[1] = t1[1] + t2[1];
  o[2] = t1[2] + t2[2];
  cross3(m1 + 3, m2 + 3, o + 3);
}

// force cross m x* f = [w x fl, w x tau + v x fl]; o must not alias.
__device__ __forceinline__ void fcross(const float* m, const float* f, float* o) {
  float t1[3], t2[3];
  cross3(m + 3, f, o);
  cross3(m + 3, f + 3, t1);
  cross3(m, f, t2);
  o[3] = t1[0] + t2[0];
  o[4] = t1[1] + t2[1];
  o[5] = t1[2] + t2[2];
}

__device__ __forceinline__ void imul(const float* I, const float* x, float* o) {
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 6; ++e) s += I[d * 6 + e] * x[e];
    o[d] = s;
  }
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) s += a[d] * b[d];
  return s;
}

__device__ __forceinline__ void copy_in(float* dst, const float* src, int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

__global__ void rnea_derivs_kernel(
    const float* __restrict__ anc_g, const int* __restrict__ dof_link_g,
    const int* __restrict__ ee_joint_g,
    const float* __restrict__ Sw_g, const float* __restrict__ Iw_g,
    const float* __restrict__ v_g, const float* __restrict__ a_g,
    const float* __restrict__ sdot_g, const float* __restrict__ Vl_g,
    const float* __restrict__ A_g, const float* __restrict__ Iv_g,
    const float* __restrict__ IA_g, const float* __restrict__ f_g,
    const float* __restrict__ pf_g, const float* __restrict__ fw_g,
    float* __restrict__ dq_g, float* __restrict__ dv_g,
    float* __restrict__ da_g, float* __restrict__ df_g,
    int n, int nv, int nfr) {
  extern __shared__ float sm[];
  const size_t b = blockIdx.x;
  float* anc = sm;                 // n * nv
  float* S = anc + n * nv;         // nv * 6
  float* I = S + nv * 6;           // n * 36
  float* vv = I + n * 36;          // nv
  float* aa = vv + nv;             // nv
  float* sdot = aa + nv;           // nv * 6
  float* Vl = sdot + nv * 6;       // n * 6
  float* A = Vl + n * 6;           // n * 6
  float* Iv = A + n * 6;           // n * 6
  float* IA = Iv + n * 6;          // n * 6
  float* fb = IA + n * 6;          // n * 6
  float* pf = fb + n * 6;          // nfr * 3
  float* fw = pf + nfr * 3;        // nfr * 3
  float* Fdof = fw + nfr * 3;      // nv * 6
  float* dVq = Fdof + nv * 6;      // n * nv * 6
  float* buf = dVq + n * nv * 6;   // n * nv * 6
  float* w = buf + n * nv * 6;     // nv * nv * 6
  int* link = reinterpret_cast<int*>(w + nv * nv * 6);  // nv
  int* eej = link + nv;            // nfr

  copy_in(anc, anc_g, n * nv);
  copy_in(S, Sw_g + b * nv * 6, nv * 6);
  copy_in(I, Iw_g + b * n * 36, n * 36);
  copy_in(vv, v_g + b * nv, nv);
  copy_in(aa, a_g + b * nv, nv);
  copy_in(sdot, sdot_g + b * nv * 6, nv * 6);
  copy_in(Vl, Vl_g + b * n * 6, n * 6);
  copy_in(A, A_g + b * n * 6, n * 6);
  copy_in(Iv, Iv_g + b * n * 6, n * 6);
  copy_in(IA, IA_g + b * n * 6, n * 6);
  copy_in(fb, f_g + b * n * 6, n * 6);
  copy_in(pf, pf_g + b * nfr * 3, nfr * 3);
  copy_in(fw, fw_g + b * nfr * 3, nfr * 3);
  for (int e = threadIdx.x; e < nv; e += blockDim.x) link[e] = dof_link_g[e];
  for (int e = threadIdx.x; e < nfr; e += blockDim.x) eej[e] = ee_joint_g[e];
  __syncthreads();

  const int nn = n * nv;
  // Phase 1: subtree force sums (external forces included), the d/da
  // products anc[i,m] I_i s_m, and dV_q[i, m] = s_m x Vt[i, m].
  for (int k = threadIdx.x; k < nv; k += blockDim.x) {
    float F[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) {
      float m = anc[i * nv + k];
#pragma unroll
      for (int d = 0; d < 6; ++d) F[d] += m * fb[i * 6 + d];
    }
    for (int e = 0; e < nfr; ++e) {
      if (anc[eej[e] * nv + k] != 0.f) {
        float pxf[3];
        cross3(pf + 3 * e, fw + 3 * e, pxf);
        for (int d = 0; d < 3; ++d) {
          F[d] -= fw[3 * e + d];
          F[3 + d] -= pxf[d];
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 6; ++d) Fdof[k * 6 + d] = F[d];
  }
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    const int i = p / nv, m = p % nv;
    const float am = anc[i * nv + m];
    float y[6];
    imul(I + i * 36, S + m * 6, y);
#pragma unroll
    for (int d = 0; d < 6; ++d) buf[p * 6 + d] = am * y[d];
    float Vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int mm = 0; mm < nv; ++mm) {
      const float c = anc[i * nv + mm] * anc[link[mm] * nv + m] * vv[mm];
      if (c != 0.f) {
#pragma unroll
        for (int d = 0; d < 6; ++d) Vt[d] += c * S[mm * 6 + d];
      }
    }
    mcross(S + m * 6, Vt, dVq + p * 6);
  }
  __syncthreads();

  // Phase 2: dtau/da[k, m] = s_k . sum_i anc[i,k] anc[i,m] I_i s_m.
  for (int p = threadIdx.x; p < nv * nv; p += blockDim.x) {
    const int k = p / nv, m = p % nv;
    float Z[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) {
      if (anc[i * nv + k] != 0.f) {
#pragma unroll
        for (int d = 0; d < 6; ++d) Z[d] += buf[(i * nv + m) * 6 + d];
      }
    }
    da_g[b * nv * nv + p] = dot6(S + k * 6, Z);
  }
  __syncthreads();

  // Phase 3: df_v[i, m] into buf; w[m, j] = dS[m,j] a_m + dsdot[m,j] v_m.
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    const int i = p / nv, m = p % nv;
    const float am = anc[i * nv + m];
    float dVv[6], dAv[6], t1[6], t2[6], t3[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      dVv[d] = am * S[m * 6 + d];
      dAv[d] = dVq[p * 6 + d] + am * sdot[m * 6 + d];
    }
    imul(I + i * 36, dAv, t1);
    fcross(dVv, Iv + i * 6, t2);
    float IdVv[6];
    imul(I + i * 36, dVv, IdVv);
    fcross(Vl + i * 6, IdVv, t3);
#pragma unroll
    for (int d = 0; d < 6; ++d) buf[p * 6 + d] = t1[d] + (t2[d] + t3[d]);
  }
  for (int p = threadIdx.x; p < nv * nv; p += blockDim.x) {
    const int m = p / nv, j = p % nv;
    const int lm = link[m];
    const float dm = anc[lm * nv + j];
    float ss[6], dS[6], t1[6], t2[6];
    mcross(S + j * 6, S + m * 6, ss);
#pragma unroll
    for (int d = 0; d < 6; ++d) dS[d] = dm * ss[d];
    mcross(dVq + (lm * nv + j) * 6, S + m * 6, t1);
    mcross(Vl + lm * 6, dS, t2);
#pragma unroll
    for (int d = 0; d < 6; ++d)
      w[p * 6 + d] = dS[d] * aa[m] + (t1[d] + t2[d]) * vv[m];
  }
  __syncthreads();

  // Phase 4: dtau/dv[k, m] = s_k . sum_i anc[i,k] df_v[i, m].
  for (int p = threadIdx.x; p < nv * nv; p += blockDim.x) {
    const int k = p / nv, m = p % nv;
    float Z[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) {
      if (anc[i * nv + k] != 0.f) {
#pragma unroll
        for (int d = 0; d < 6; ++d) Z[d] += buf[(i * nv + m) * 6 + d];
      }
    }
    dv_g[b * nv * nv + p] = dot6(S + k * 6, Z);
  }
  __syncthreads();

  // Phase 5: df_q[i, j] into buf (inertia conjugation, velocity and
  // acceleration products, external-force moment-arm terms).
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    const int i = p / nv, j = p % nv;
    const float aij = anc[i * nv + j];
    const float* Ii = I + i * 36;
    const float* Sj = S + j * 6;
    float dAq[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int m = 0; m < nv; ++m) {
      if (anc[i * nv + m] != 0.f) {
#pragma unroll
        for (int d = 0; d < 6; ++d) dAq[d] += w[(m * nv + j) * 6 + d];
      }
    }
    float x1[6], x2[6], x3[6], dIA[6], dIv[6];
    fcross(Sj, IA + i * 6, x1);
    mcross(Sj, A + i * 6, x2);
    imul(Ii, x2, x3);
    imul(Ii, dAq, x2);
#pragma unroll
    for (int d = 0; d < 6; ++d) dIA[d] = aij * (x1[d] - x3[d]) + x2[d];
    fcross(Sj, Iv + i * 6, x1);
    mcross(Sj, Vl + i * 6, x2);
    imul(Ii, x2, x3);
    imul(Ii, dVq + p * 6, x2);
#pragma unroll
    for (int d = 0; d < 6; ++d) dIv[d] = aij * (x1[d] - x3[d]) + x2[d];
    fcross(dVq + p * 6, Iv + i * 6, x1);
    fcross(Vl + i * 6, dIv, x2);
    float out[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) out[d] = dIA[d] + (x1[d] + x2[d]);
    if (aij != 0.f) {
      for (int e = 0; e < nfr; ++e) {
        if (eej[e] != i) continue;
        float arm[3], t[3];
        cross3(Sj + 3, pf + 3 * e, t);
        for (int c = 0; c < 3; ++c) arm[c] = Sj[c] + t[c];
        cross3(arm, fw + 3 * e, t);
        for (int c = 0; c < 3; ++c) out[3 + c] -= t[c];
      }
    }
#pragma unroll
    for (int d = 0; d < 6; ++d) buf[p * 6 + d] = out[d];
  }
  __syncthreads();

  // Phase 6: dtau/dq[k, j] = dS[k,j] . F_k + s_k . sum_i anc[i,k] df_q[i,j];
  // dtau/df[k, 3e + c] = -anc[joint_e, k] (s_k,lin + s_k,ang x p_e)[c].
  for (int p = threadIdx.x; p < nv * nv; p += blockDim.x) {
    const int k = p / nv, j = p % nv;
    float Z[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) {
      if (anc[i * nv + k] != 0.f) {
#pragma unroll
        for (int d = 0; d < 6; ++d) Z[d] += buf[(i * nv + j) * 6 + d];
      }
    }
    float ss[6];
    mcross(S + j * 6, S + k * 6, ss);
    const float dm = anc[link[k] * nv + j];
    dq_g[b * nv * nv + p] = dm * dot6(ss, Fdof + k * 6) + dot6(S + k * 6, Z);
  }
  for (int p = threadIdx.x; p < nv * nfr; p += blockDim.x) {
    const int k = p / nfr, e = p % nfr;
    const float ak = anc[eej[e] * nv + k];
    float t[3];
    cross3(S + k * 6 + 3, pf + 3 * e, t);
    for (int c = 0; c < 3; ++c)
      df_g[(b * nv + k) * (3 * nfr) + 3 * e + c] = -ak * (S[k * 6 + c] + t[c]);
  }
}

}  // namespace

extern "C" int rnea_derivs_launch(
    const void* anc, const void* dof_link, const void* ee_joint,
    const void* Sw, const void* Iw, const void* v, const void* a,
    const void* sdot, const void* Vl, const void* A, const void* Iv,
    const void* IA, const void* f, const void* pf, const void* fw,
    void* dq, void* dv, void* da, void* df,
    int B, int n, int nv, int nfr, void* stream) {
  const size_t floats = (size_t)n * nv + nv * 6 + n * 36 + 2 * nv + nv * 6 +
                        5 * n * 6 + 6 * nfr + nv * 6 + 2 * (size_t)n * nv * 6 +
                        (size_t)nv * nv * 6;
  const size_t smem = floats * sizeof(float) + (nv + nfr) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      rnea_derivs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  rnea_derivs_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
      (const float*)anc, (const int*)dof_link, (const int*)ee_joint,
      (const float*)Sw, (const float*)Iw, (const float*)v, (const float*)a,
      (const float*)sdot, (const float*)Vl, (const float*)A,
      (const float*)Iv, (const float*)IA, (const float*)f,
      (const float*)pf, (const float*)fw, (float*)dq, (float*)dv,
      (float*)da, (float*)df, n, nv, nfr);
  return (int)cudaGetLastError();
}
