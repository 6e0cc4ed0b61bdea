// K2: analytic RNEA derivatives as tree recursions over the live
// (link, column) pairs of the kinematic tree.
//
// Replaces the TPU kernel rnea_derivatives_pallas / _rnea_derivs_kernel
// (tpu_locoman/pallas_rbda.py). Same contract as there: the forward
// world-frame quantities (S_w, world inertias, link velocities and
// accelerations, body forces, frame positions) arrive computed outside
// (tpu_locoman_torch/rnea_derivs.py:forward_quantities); this kernel does
// the O(n * nv * 6) derivative pass and writes dtau/dq, dtau/dv, dtau/da and
// dtau/df.
//
// Bound on an H100: at the flagship's flat batch (B = 512 x 14 = 7168) the
// bytes, ~14.8 KB of inputs and outputs per element, ~106 MB in all; at
// accurate batch 1 (B = 14) latency, since 14 elements cannot fill 132 SMs.
// What holds it back on the card: the latency of each element's long
// chain of shared-memory loads and 6-vector algebra, with at most 10
// elements resident per SM (PERF.md §6).
//
// Design, against what held the first design (dense masked sums, one CTA
// of 256 threads per element) back:
// - Live pairs only. Dof j moves link i only when j is an ancestor dof of
//   i, and only those (i, j) pairs carry nonzero intermediates (159 of 456
//   for B2G, 102 of 234 for Go2). The wrapper builds a table of the tree
//   once per robot (rnea_derivs.py:tree_table, pack_table): the live pairs
//   column by column, the live (dof, column) pairs of the velocity-product
//   terms, the live outputs (k, j), those whose two links lie on one root
//   path (324 of 576 for B2G), and the pairs with children. Only those are
//   computed; the rest of each output is written as zeros.
// - Tree recursions instead of masked sums, as the TPU kernel does them.
//   Links are in depth-first order, so each subtree is a range of links
//   and each column's pairs are contiguous. The prefix sums down the
//   parent chain (Vt, dA_q) walk each pair's path from its column's link,
//   in ascending link order (the base dofs' share is summed once per
//   element or column). The subtree sums of the contractions for dtau/dv
//   and dtau/dq run bottom up, level by level, over the pairs that have
//   children, in the TPU kernel's order; dtau/da's and F_dof's run over
//   the subtree's range of links, in the ascending order of the dense
//   masked sums. (The TPU order for dtau/da moved the solver's KKT blocks
//   enough to fail the whole-tick check of the factorizers' solve error,
//   which the dense order passes: PERF.md §6.)
// - Every lane busy at both sizes. One CTA per element: of two warps at
//   large B, up to 10 CTAs per SM as shared memory (21.5 KB per element)
//   allows, and of eight warps at small B (accurate batch 1's 14
//   elements), where each element's pairs spread over a whole SM. The
//   wrapper picks by B against the number of SMs.
// - Layout. Every load of an element is issued before the first wait
//   (cp.async, 16 bytes where the source is aligned); the inputs are then
//   transposed to component-major (structure of arrays), and every
//   intermediate is component-major and indexed by pair, so lanes read
//   consecutive words. Outputs are staged whole and written with 16-byte
//   stores. Device memory sees only the inputs and the outputs.
// - f32 throughout, accumulating in f32 (short 6-vector algebra: no tensor
//   cores).
//
// Layouts (row-major, float32): Sw (B, nv, 6), Iw (B, n, 6, 6), v, a (B, nv),
// sdot (B, nv, 6), Vl, A, Iv, IA, f (B, n, 6), pf (B, nfr, 3),
// fw (B, 3 * nfr); outputs dq, dv, da (B, nv, nv) [row k, column j],
// df (B, nv, 3 * nfr). topo: the int32 table of rnea_derivs.py:pack_table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 8;  // longest root-to-link path, root included

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

// component-major 6-vectors: component d of entry idx at base[d * stride + idx]
__device__ __forceinline__ void ld6(const float* base, int stride, int idx, float* o) {
#pragma unroll
  for (int d = 0; d < 6; ++d) o[d] = base[d * stride + idx];
}

// row-major 6-vectors: entry idx at base[6 * idx .. 6 * idx + 5]
__device__ __forceinline__ void ldrow(const float* base, int idx, float* o) {
#pragma unroll
  for (int d = 0; d < 6; ++d) o[d] = base[6 * idx + d];
}

__device__ __forceinline__ void st6(float* base, int stride, int idx, const float* x) {
#pragma unroll
  for (int d = 0; d < 6; ++d) base[d * stride + idx] = x[d];
}

// Z = the sum of X[., t] over t in [start, start + len), in ascending t.
__device__ __forceinline__ void range_sum(const float* X, int stride, int start,
                                          int len, float* Z) {
#pragma unroll
  for (int d = 0; d < 6; ++d) Z[d] = 0.f;
  for (int t = start; t < start + len; ++t) {
#pragma unroll
    for (int d = 0; d < 6; ++d) Z[d] += X[d * stride + t];
  }
}

// link c of a pair's walk down from its column's link (one byte each)
__device__ __forceinline__ int walk_link(const int4& pr, int c) {
  return ((c < 4 ? pr.y : pr.z) >> (8 * (c & 3))) & 255;
}

// The subtree sums of two pair-indexed buffers, in place and bottom up,
// one depth level at a time (deepest first): after it, entry (i, j) holds
// the sum over link i's subtree of column j, added as the TPU kernel adds
// them: its own term, then each child's sum, children ascending. The
// table lists each live pair that has children (sub: p | count << 16, then
// the children's offsets from p, one byte each), grouped by the depth of
// its link (lvl_off).
template <int T>
__device__ __forceinline__ void subtree_sums(float* X1, float* X2, int np,
                                             const int4* __restrict__ sub,
                                             const int* __restrict__ lvl_off,
                                             int lane) {
  for (int dd = MAXD - 1; dd >= 0; --dd) {
    const int s0 = __ldg(lvl_off + dd), s1 = __ldg(lvl_off + dd + 1);
    if (s0 == s1) continue;
    for (int q = s0 + lane; q < s1; q += T) {
      const int4 r = __ldg(sub + q);
      const int p = r.x & 0xFFFF, nch = r.x >> 16;
      for (int u = 0; u < 2; ++u) {
        float* X = u == 0 ? X1 : X2;
        float acc[6];
        ld6(X, np, p, acc);
        for (int c = 0; c < nch; ++c) {
          const int off = ((c < 4 ? r.y : c < 8 ? r.z : r.w) >> (8 * (c & 3))) & 255;
#pragma unroll
          for (int d = 0; d < 6; ++d) acc[d] += X[d * np + p + off];
        }
        st6(X, np, p, acc);
      }
    }
    __syncthreads();
  }
}

// Asynchronous copies from device to shared memory (cp.async): a group
// issues every load of an element before it waits for any.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// count floats to shared memory (dst 16-byte aligned), 16 bytes at a time
// where src is aligned.
template <int T>
__device__ __forceinline__ void fetch(float* dst, const float* __restrict__ src,
                                      int count, int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (count & 3) == 0) {
    for (int q = lane; q < count / 4; q += T) cp_async16(dst + 4 * q, src + 4 * q);
  } else {
    for (int t = lane; t < count; t += T) cp_async4(dst + t, src + t);
  }
}

// (rows, 6) row-major in device memory -> component-major dst[c * rows + r]
// in shared memory, one asynchronous float at a time
template <int T>
__device__ __forceinline__ void scatter6(float* dst, const float* __restrict__ src,
                                         int rows, int lane) {
  for (int t = lane; t < 6 * rows; t += T) cp_async4(dst + (t % 6) * rows + t / 6, src + t);
}

// (rows, COLS) row-major -> component-major dst[c * rows + r], in shared memory
template <int T, int COLS>
__device__ __forceinline__ void transpose(float* dst, const float* src, int rows,
                                          int lane) {
  for (int t = lane; t < rows * COLS; t += T) dst[(t % COLS) * rows + t / COLS] = src[t];
}

// An output of count floats from shared memory (16-byte aligned) to device
// memory, with the entries whose bit in live is clear written as zeros.
template <int T>
__device__ __forceinline__ void flush(float* __restrict__ dst, const float* src,
                                      int count, const unsigned* __restrict__ live,
                                      int lane) {
  auto keep = [&](int e, float x) {
    return ((__ldg(live + e / 32) >> (e % 32)) & 1u) ? x : 0.f;
  };
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (count & 3) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int q = lane; q < count / 4; q += T) {
      const float4 x = s4[q];
      d4[q] = make_float4(keep(4 * q, x.x), keep(4 * q + 1, x.y),
                          keep(4 * q + 2, x.z), keep(4 * q + 3, x.w));
    }
  } else {
    for (int t = lane; t < count; t += T) dst[t] = keep(t, src[t]);
  }
}

__host__ __device__ __forceinline__ int r4(int x) { return (x + 3) & ~3; }

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Floats of dV_q (later df_q), X and W; Iw lands there first.
__host__ __device__ __forceinline__ int work_floats(int n, int np, int nw) {
  return imax(2 * r4(6 * np) + r4(6 * nw), r4(36 * n));
}

// Shared-memory floats of one element; every section starts 16-byte aligned.
__host__ __device__ __forceinline__ int elem_floats(int n, int nv, int nfr,
                                                    int np, int nw) {
  return 2 * r4(6 * nv) + 2 * r4(nv) + r4(imax(36 * n, nv * nv)) + 6 * r4(6 * n) +
         8 + 2 * r4(3 * nfr) + work_floats(n, np, nw) + r4(nv * nv);
}

// One CTA of T threads per element. N, NV, NP, NW: the robot's links,
// dofs, live pairs and live (dof, column) pairs as compile-time constants
// (B2G, the flagship's robot), or 0 to read them from the arguments (any
// other tree). Constant sizes turn every component-major address into a
// base and an immediate offset, which frees registers; at T = 64 the
// bound of 10 CTAs per SM is what the shared memory allows.
template <int T, int N, int NV, int NP, int NW>
__global__ void __launch_bounds__(T, T == 64 ? 10 : 1) rnea_derivs_kernel(
    const int* __restrict__ topo,
    const float* __restrict__ Sw_g, const float* __restrict__ Iw_g,
    const float* __restrict__ v_g, const float* __restrict__ a_g,
    const float* __restrict__ sdot_g, const float* __restrict__ Vl_g,
    const float* __restrict__ A_g, const float* __restrict__ Iv_g,
    const float* __restrict__ IA_g, const float* __restrict__ f_g,
    const float* __restrict__ pf_g, const float* __restrict__ fw_g,
    float* __restrict__ dq_g, float* __restrict__ dv_g,
    float* __restrict__ da_g, float* __restrict__ df_g,
    int n_, int nv_, int nfr, int np_, int nw_, int no) {
  const int n = N ? N : n_, nv = NV ? NV : nv_, np = NP ? NP : np_;
  const int nw = NW ? NW : nw_;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x;
  const long b = blockIdx.x;

  // the tree's table (rnea_derivs.py:pack_table)
  const int* lo = topo;                  // subtree of link L: [lo[L], hi[L])
  const int* hi = lo + n;
  const int* col_link = hi + n;          // (nv,) link of each dof
  const int* ee_joint = col_link + nv;   // (nfr,)
  const int* lvl_off = ee_joint + nfr;   // (MAXD + 1,) sub by link depth
  const int4* pairs =
      reinterpret_cast<const int4*>(topo + r4(2 * n + nv + nfr + MAXD + 1));
  const int4* sub = pairs + np;
  const int2* wpairs = reinterpret_cast<const int2*>(sub + __ldg(lvl_off + MAXD));
  const int2* outs = wpairs + nw;
  const unsigned* live = reinterpret_cast<const unsigned*>(outs + no);

  float* S = reinterpret_cast<float*>(smem4);  // [nv][6]
  float* sd = S + r4(6 * nv);            // [nv][6] sdot
  float* vv = sd + r4(6 * nv);           // [nv]
  float* aa = vv + r4(nv);               // [nv]
  float* I = aa + r4(nv);                // [36][n]; later the dq staging
  float* Vl = I + r4(imax(36 * n, nv * nv));  // [6][n], then A, Iv, IA, f
  float* A = Vl + r4(6 * n);
  float* Iv = A + r4(6 * n);
  float* IA = Iv + r4(6 * n);
  float* fb = IA + r4(6 * n);
  float* Fl = fb + r4(6 * n);            // [6][n] subtree forces per link
  float* Vb = Fl + r4(6 * n);            // [6] sum of v_m s_m over base dofs
  float* pf = Vb + 8;                    // [nfr][3]
  float* fw = pf + r4(3 * nfr);          // [nfr][3]
  float* dVq = fw + r4(3 * nfr);         // [6][np]: dV_q, then df_q
  float* X = dVq + r4(6 * np);           // [6][np]: I_i s_j, then df_v
  float* W = X + r4(6 * np);             // [6][nw]: w[m, j]
  float* O = dVq + work_floats(n, np, nw);  // [nv][nv]: da, then dv
  float* O2 = I;                         // [nv][nv]: dq, once I is dead

  // Inputs: every load issued before the first wait (cp.async). Sw, sdot,
  // v, a and the forces go in place, row-major, 16 bytes at a time where
  // aligned; Iw lands row-major where dV_q will be and is transposed to
  // component-major; the per-link vectors go to component-major directly.
  fetch<T>(S, Sw_g + b * nv * 6, 6 * nv, lane);
  fetch<T>(sd, sdot_g + b * nv * 6, 6 * nv, lane);
  fetch<T>(vv, v_g + b * nv, nv, lane);
  fetch<T>(aa, a_g + b * nv, nv, lane);
  fetch<T>(pf, pf_g + b * nfr * 3, 3 * nfr, lane);
  fetch<T>(fw, fw_g + b * nfr * 3, 3 * nfr, lane);
  fetch<T>(dVq, Iw_g + b * n * 36, 36 * n, lane);
  scatter6<T>(Vl, Vl_g + b * n * 6, n, lane);
  scatter6<T>(A, A_g + b * n * 6, n, lane);
  scatter6<T>(Iv, Iv_g + b * n * 6, n, lane);
  scatter6<T>(IA, IA_g + b * n * 6, n, lane);
  scatter6<T>(fb, f_g + b * n * 6, n, lane);
  cp_async_wait_all();
  __syncthreads();
  transpose<T, 36>(I, dVq, n, lane);
  if (lane < 6) {  // the base dofs' share of every base column's Vt
    float x = 0.f;
    for (int m = 0; m < 6; ++m) x += vv[m] * S[6 * m + lane];
    Vb[lane] = x;
  }
  __syncthreads();

  // Phase 1. Per live pair (i, j): Vt = sum of v_m s_m down the path from
  // link(j) to i, dV_q = s_j x Vt, and I_i s_j. Per link: the subtree sum
  // of the body forces, less the external forces applied inside it.
  for (int p = lane; p < np; p += T) {
    const int4 pr = __ldg(pairs + p);
    const int i = pr.x & 255, j = (pr.x >> 8) & 255;
    float Sj[6], Vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, o[6];
    ldrow(S, j, Sj);
    if (pr.x >> 24) ld6(Vb, 1, 0, Vt);  // a base column: the base dofs first
    for (int c = 0; c < ((pr.x >> 16) & 255); ++c) {
      const int m = 5 + walk_link(pr, c);
#pragma unroll
      for (int d = 0; d < 6; ++d) Vt[d] += vv[m] * S[6 * m + d];
    }
    mcross(Sj, Vt, o);
    st6(dVq, np, p, o);
    float Ii[36];
#pragma unroll
    for (int e = 0; e < 36; ++e) Ii[e] = I[e * n + i];
    imul(Ii, Sj, o);
    st6(X, np, p, o);
  }
  for (int l = lane; l < n; l += T) {
    const int l0 = __ldg(lo + l), l1 = __ldg(hi + l);
    float F[6];
    range_sum(fb, n, l0, l1 - l0, F);
    for (int e = 0; e < nfr; ++e) {
      const int jid = __ldg(ee_joint + e);
      if (jid < l0 || jid >= l1) continue;
      float pxf[3];
      cross3(pf + 3 * e, fw + 3 * e, pxf);
      for (int c = 0; c < 3; ++c) {
        F[c] -= fw[3 * e + c];
        F[3 + c] -= pxf[c];
      }
    }
    st6(Fl, n, l, F);
  }
  __syncthreads();

  // Phase 2. Per live (dof m, column j): w[m, j] = dS a_m + dsdot v_m, with
  // dS = s_j x s_m and dsdot = dV_q[link(m), j] x s_m + Vl[link(m)] x dS.
  // Per live output dtau/da[k, j] = s_k . the sum of I_i s_j over the
  // deeper link's subtree, in the dense order (PERF.md §6).
  for (int q = lane; q < nw; q += T) {
    const int2 wr = __ldg(wpairs + q);
    const int m = wr.x & 255, j = (wr.x >> 8) & 255, lm = wr.x >> 16;
    float Sj[6], Sm[6], ss[6], t[6], t1[6], t2[6], w[6];
    ldrow(S, j, Sj);
    ldrow(S, m, Sm);
    mcross(Sj, Sm, ss);
    ld6(dVq, np, wr.y, t);  // the pair (link(m), j)
    mcross(t, Sm, t1);
    ld6(Vl, n, lm, t);
    mcross(t, ss, t2);
#pragma unroll
    for (int d = 0; d < 6; ++d) w[d] = ss[d] * aa[m] + (t1[d] + t2[d]) * vv[m];
    st6(W, nw, q, w);
  }
  __syncthreads();
  if (lane < 6) {  // base column j = lane: w[5, j] becomes the base dofs' sum
    const int wj = __ldg(pairs + lane * n).w;
    for (int m = 1; m < 6; ++m) {
#pragma unroll
      for (int d = 0; d < 6; ++d) W[d * nw + wj + m] += W[d * nw + wj + m - 1];
    }
  }
  for (int o = lane; o < no; o += T) {
    const int2 orc = __ldg(outs + o);
    const int k = orc.x & 255, j = (orc.x >> 8) & 255;
    float Sk[6], Z[6];
    ldrow(S, k, Sk);
    range_sum(X, np, orc.y & 0xFFFF, orc.y >> 16, Z);
    O[k * nv + j] = dot6(Sk, Z);
  }
  __syncthreads();

  // Phase 3. dtau/da out. Per live pair (i, j): dA_q = sum of w[., j] down
  // the path from link(j) to i; df_v (over X) and df_q (over dV_q).
  flush<T>(da_g + b * nv * nv, O, nv * nv, live, lane);
  for (int p = lane; p < np; p += T) {
    const int4 pr = __ldg(pairs + p);
    const int i = pr.x & 255, j = (pr.x >> 8) & 255, wj = pr.w;
    float dAq[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (pr.x >> 24) ld6(W, nw, wj + 5, dAq);  // the base dofs' sum
    for (int c = 0; c < ((pr.x >> 16) & 255); ++c) {
      const int m = 5 + walk_link(pr, c);
#pragma unroll
      for (int d = 0; d < 6; ++d) dAq[d] += W[d * nw + wj + m];
    }
    float Ii[36], Sj[6], dV[6], ISj[6], Vli[6], Ivi[6], x1[6], x2[6], x3[6];
#pragma unroll
    for (int e = 0; e < 36; ++e) Ii[e] = I[e * n + i];
    ldrow(S, j, Sj);
    ld6(dVq, np, p, dV);
    ld6(Vl, n, i, Vli);
    ld6(Iv, n, i, Ivi);
    imul(Ii, Sj, ISj);
    // df_v = I (dV_q + sdot_j) + s_j x* Iv + Vl x* (I s_j)
    float dAv[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) dAv[d] = dV[d] + sd[6 * j + d];
    imul(Ii, dAv, x1);
    fcross(Sj, Ivi, x2);
    fcross(Vli, ISj, x3);
#pragma unroll
    for (int d = 0; d < 6; ++d) x1[d] = x1[d] + (x2[d] + x3[d]);
    st6(X, np, p, x1);
    // df_q = dIA + dV_q x* Iv + Vl x* dIv, with
    // dIA = s_j x* IA - I (s_j x A) + I dA_q, dIv = s_j x* Iv - I (s_j x Vl) + I dV_q
    float t[6], dIA[6], dIv[6], out[6];
    ld6(IA, n, i, t);
    fcross(Sj, t, x1);
    ld6(A, n, i, t);
    mcross(Sj, t, x2);
    imul(Ii, x2, x3);
    imul(Ii, dAq, x2);
#pragma unroll
    for (int d = 0; d < 6; ++d) dIA[d] = (x1[d] - x3[d]) + x2[d];
    fcross(Sj, Ivi, x1);
    mcross(Sj, Vli, x2);
    imul(Ii, x2, x3);
    imul(Ii, dV, x2);
#pragma unroll
    for (int d = 0; d < 6; ++d) dIv[d] = (x1[d] - x3[d]) + x2[d];
    fcross(dV, Ivi, x1);
    fcross(Vli, dIv, x2);
#pragma unroll
    for (int d = 0; d < 6; ++d) out[d] = dIA[d] + (x1[d] + x2[d]);
    for (int e = 0; e < nfr; ++e) {
      if (__ldg(ee_joint + e) != i) continue;
      float arm[3], u[3];
      cross3(Sj + 3, pf + 3 * e, u);
      for (int c = 0; c < 3; ++c) arm[c] = Sj[c] + u[c];
      cross3(arm, fw + 3 * e, u);
      for (int c = 0; c < 3; ++c) out[3 + c] -= u[c];
    }
    st6(dVq, np, p, out);  // df_q over this pair's own dV_q
  }
  __syncthreads();

  // Phase 4. The subtree sums of df_v and df_q. Per live output:
  // dtau/dv[k, j] = s_k . (subtree sum of df_v) into O; dtau/dq[k, j] =
  // [dof j moves link(k)] (s_j x s_k) . F_k + s_k . (subtree sum of df_q)
  // into O2 (I is dead).
  // dtau/df[k, 3e + c] = -[k moves frame e's joint] (s_k,lin + s_k,ang x
  // p_e)[c], straight out.
  subtree_sums<T>(X, dVq, np, sub, lvl_off, lane);
  for (int o = lane; o < no; o += T) {
    const int2 orc = __ldg(outs + o);
    const int k = orc.x & 255, j = (orc.x >> 8) & 255, lk = (orc.x >> 16) & 255;
    float Sk[6], Z[6];
    ldrow(S, k, Sk);
    ld6(X, np, orc.y & 0xFFFF, Z);
    O[k * nv + j] = dot6(Sk, Z);
    ld6(dVq, np, orc.y & 0xFFFF, Z);
    float val = dot6(Sk, Z);
    if (orc.x >> 24) {  // dof j moves link(k): the dS . F_k term
      float Sj[6], ss[6], F[6];
      ldrow(S, j, Sj);
      mcross(Sj, Sk, ss);
      ld6(Fl, n, lk, F);
      val = dot6(ss, F) + val;
    }
    O2[k * nv + j] = val;
  }
  for (int t = lane; t < nv * nfr; t += T) {
    const int k = t / nfr, e = t % nfr;
    const int lk = __ldg(col_link + k), jid = __ldg(ee_joint + e);
    const float ak = (__ldg(lo + lk) <= jid && jid < __ldg(hi + lk)) ? 1.f : 0.f;
    float Sk[6], u[3];
    ldrow(S, k, Sk);
    cross3(Sk + 3, pf + 3 * e, u);
    for (int c = 0; c < 3; ++c)
      df_g[(b * nv + k) * (3 * nfr) + 3 * e + c] = -ak * (Sk[c] + u[c]);
  }
  __syncthreads();

  // Phase 5. dtau/dv and dtau/dq out.
  flush<T>(dv_g + b * nv * nv, O, nv * nv, live, lane);
  flush<T>(dq_g + b * nv * nv, O2, nv * nv, live, lane);
}

template <int T, int N, int NV, int NP, int NW>
int launch(const void* topo, const void* Sw, const void* Iw, const void* v,
           const void* a, const void* sdot, const void* Vl, const void* A,
           const void* Iv, const void* IA, const void* f, const void* pf,
           const void* fw, void* dq, void* dv, void* da, void* df, int B,
           int n, int nv, int nfr, int np, int nw, int no, void* stream) {
  auto kernel = rnea_derivs_kernel<T, N, NV, NP, NW>;
  const size_t smem = (size_t)elem_floats(n, nv, nfr, np, nw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  kernel<<<B, T, smem, (cudaStream_t)stream>>>(
      (const int*)topo, (const float*)Sw, (const float*)Iw, (const float*)v,
      (const float*)a, (const float*)sdot, (const float*)Vl, (const float*)A,
      (const float*)Iv, (const float*)IA, (const float*)f, (const float*)pf,
      (const float*)fw, (float*)dq, (float*)dv, (float*)da, (float*)df, n, nv,
      nfr, np, nw, no);
  return (int)cudaGetLastError();
}

template <int T>
int launch_for_tree(const void* topo, const void* Sw, const void* Iw,
                    const void* v, const void* a, const void* sdot,
                    const void* Vl, const void* A, const void* Iv,
                    const void* IA, const void* f, const void* pf,
                    const void* fw, void* dq, void* dv, void* da, void* df,
                    int B, int n, int nv, int nfr, int np, int nw, int no,
                    void* stream) {
  if (n == 19 && nv == 24 && np == 159 && nw == 189)  // B2G
    return launch<T, 19, 24, 159, 189>(topo, Sw, Iw, v, a, sdot, Vl, A, Iv,
                                       IA, f, pf, fw, dq, dv, da, df, B, n,
                                       nv, nfr, np, nw, no, stream);
  return launch<T, 0, 0, 0, 0>(topo, Sw, Iw, v, a, sdot, Vl, A, Iv, IA, f, pf,
                               fw, dq, dv, da, df, B, n, nv, nfr, np, nw, no,
                               stream);
}

}  // namespace

// lanes: threads per element, 64 or 256 (the wrapper picks it from B).
extern "C" int rnea_derivs_launch(
    const void* topo, const void* Sw, const void* Iw, const void* v,
    const void* a, const void* sdot, const void* Vl, const void* A,
    const void* Iv, const void* IA, const void* f, const void* pf,
    const void* fw, void* dq, void* dv, void* da, void* df, int B, int n,
    int nv, int nfr, int np, int nw, int no, int lanes, void* stream) {
  if (lanes == 64)
    return launch_for_tree<64>(topo, Sw, Iw, v, a, sdot, Vl, A, Iv, IA, f, pf,
                               fw, dq, dv, da, df, B, n, nv, nfr, np, nw, no,
                               stream);
  if (lanes == 256)
    return launch_for_tree<256>(topo, Sw, Iw, v, a, sdot, Vl, A, Iv, IA, f, pf,
                                fw, dq, dv, da, df, B, n, nv, nfr, np, nw, no,
                                stream);
  return (int)cudaErrorInvalidValue;
}
