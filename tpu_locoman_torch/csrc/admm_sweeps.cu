// K4: all the ADMM sweeps of one run_iters call, for every scenario, in one
// launch.
//
// No TPU kernel corresponds: in the JAX package XLA fused this loop
// (tpu_locoman/solver/qp.py run_iters), where the port's plain loop issues
// ~100 small launches per sweep (34 batched matrix-vector products and
// the elementwise updates between them). For a BlockTridiagFactor with the
// propagation pattern (the int k of D) each sweep is
//   rhs = sigma x - q + A^T(rho z - y)  (+ the pattern's w_{i-1}[:k] on node
//         i, + the box rows scattered),
//   y_i = (Linv b)_i - W_i y_{i-1},  then  x_i = (Linv^T Y)_i - V_i x_{i+1}[:kv],
//   z_t = A x  (+ x_{i+1}[:k], + the box rows gathered),
//   the alpha relaxation, the clamp to [l, u] and the dual update,
// in float32 with float32 sums; only the order of the sums inside a
// product differs from the plain loop (fused multiply-adds there as here).
//
// Bound: bytes. Per scenario and sweep the blocks are Linv and W (s x s
// each per node), V (s x kv) and A (md x s per node but the last); the
// vectors add ~4%. At 0.5 flop per byte the card's 3.35 TB/s is the limit,
// not its f32 rate: 2.88 ms per sweep at 4096 scenarios of the flagship
// (the plain loop's products read Linv and A twice: 4.38 ms).
// Design: one CTA of 512 threads per scenario. x and the per-node vectors
// (the right-hand sides, then Y's T, then x_t; y_{i-1}; w) stay in shared
// memory across all sweeps; z and y live in the outputs. Each step's
// inputs stream from device memory into a two-slot ring by bulk copies of
// the Tensor Memory Accelerator, one thread issuing them against a
// barrier per slot: the next step's copies are in flight while the
// current step runs (a cp.async ring, a copy per thread, kept too few
// bytes in flight per SM and ran at 41% of the bound). A step is one node
// of one chain:
//   forward  (Linv_i, W_i): a warp per pair of rows forms (Linv b)_r and
//            (W y)_r, each lane keeping its row entries in registers, and
//            adds Linv_i[r, :] y_r into its share of Linv_i^T y_i, so Linv
//            is read once per sweep, not twice;
//   backward (V_i, and A_i with node i's z, y, rho, l, u): x_t_i by row
//            dots with V_i, then a warp per pair of rows of A_i forms z_t,
//            relaxes and clamps it, updates the dual and adds A_i[r, :] w_r
//            into the next sweep's A_i^T w_i, so A too is read once.
// Rows are read along their length (bank-conflict free); columns sum
// across the warps' partials. Tensor cores have nothing to do here
// (matrix-vector products). Measured (chip_smoke.py phase 35, H100 80GB
// HBM3 at 700 W): 3.66 ms per sweep at 4096 scenarios, 78.6% of the bound;
// 0.48 ms at 512 (74.7%). At batch 1 one SM walks the chain: ~3.7 us per
// step, 112 us per sweep.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;          // one CTA per scenario
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;               // columns per lane of a row: s <= 128
constexpr size_t kMaxSmem = 232448;    // what one block may have on sm_90

struct Args {
  const float *Linv, *W, *V, *A;
  const long long* box;
  const float *rho, *q, *l, *u, *x0, *z0, *y0;
  float *x, *z, *y;
  int K, s, kv, md, m, D, nbox, iters;
  float sigma, alpha, beta;  // beta = 1 - alpha, rounded as the loop does
  int stage;                 // floats per ring slot
};

// ---- copies into shared memory (the Tensor Memory Accelerator) -------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on bar, which then waits for ``bytes`` of copies besides.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of ``bytes`` (a multiple of 16) from global to shared
// memory, both 16-byte aligned, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's stores to device memory before the bulk copies
// that a later step issues (they read through the async proxy).
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- the step schedule -------------------------------------------------

// Floats a block of n takes in a ring slot: n, its offset from a 16-byte
// boundary (up to 3) and the rounding to 16 bytes.
__host__ __device__ __forceinline__ int slot_floats(int n) {
  return (n + 6) & ~3;
}

// Where src[0] lands in its 16-byte aligned slot: its own offset from a
// 16-byte boundary, since a bulk copy moves whole aligned 16-byte chunks.
__device__ __forceinline__ int lead(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The 16-byte aligned chunks that hold src[0, n): their start and bytes.
// Their ragged ends (at most 12 bytes before src and after src + n) lie in
// the chunks of src's first and last floats, so in the same allocation
// (whose ends are 16-byte aligned) and the same page; the kernel never
// reads them.
__device__ __forceinline__ const char* chunks(const float* src, int n,
                                              unsigned* bytes) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t g1 =
      (reinterpret_cast<uintptr_t>(src + n) + 15) & ~uintptr_t(15);
  *bytes = static_cast<unsigned>(g1 - g0);
  return reinterpret_cast<const char*>(g0);
}

// Steps in order: P_0 .. P_{K-2} (the first sweep's A^T w, one node each),
// then per sweep the forward chain F_0 .. F_{K-1} and the backward chain
// B_{K-1} .. B_0. A step stages what it reads into its ring slot: the
// node's blocks and, for P and B, the node's constraint vectors, so that
// no step waits on a load from device memory.
enum Kind { kPro, kFwd, kBwd };
constexpr int kSrc = 7;

struct Step {
  int kind, node, sweep, nsrc;
  const float* src[kSrc];  // P: A, z0, y0, rho; F: Linv, W;
  int n[kSrc];             // B: V (, A, z, y, rho, l, u)
};

__device__ Step step_of(const Args& a, int b, int t) {
  const int N = a.K - 1;
  const size_t s = a.s, m = a.m;
  const size_t ablk = (size_t)a.md * s;
  Step st{};
  auto add = [&](const float* p, size_t n) {
    st.src[st.nsrc] = p;
    st.n[st.nsrc++] = (int)n;
  };
  if (t < N) {
    const size_t zb = ((size_t)b * N + t) * m;
    st.kind = kPro;
    st.node = t;
    add(a.A + ((size_t)b * N + t) * ablk, ablk);
    add(a.z0 + zb, m);
    add(a.y0 + zb, m);
    add(a.rho + zb, m);
    return st;
  }
  const int u = t - N, r = u % (2 * a.K);
  st.sweep = u / (2 * a.K);
  if (r < a.K) {
    const size_t o = ((size_t)b * a.K + r) * s * s;
    st.kind = kFwd;
    st.node = r;
    add(a.Linv + o, s * s);
    add(a.W + o, s * s);
  } else {
    const int i = 2 * a.K - 1 - r;
    st.kind = kBwd;
    st.node = i;
    add(a.V + ((size_t)b * a.K + i) * s * a.kv, s * a.kv);
    if (i < N) {
      const size_t zb = ((size_t)b * N + i) * m;
      const bool first = st.sweep == 0;
      add(a.A + ((size_t)b * N + i) * ablk, ablk);
      add((first ? a.z0 : a.z) + zb, m);
      add((first ? a.y0 : a.y) + zb, m);
      add(a.rho + zb, m);
      add(a.l + zb, m);
      add(a.u + zb, m);
    }
  }
  return st;
}

// Where source k of the step lies in its slot.
__device__ __forceinline__ const float* view(const Step& st, float* slot,
                                             int k) {
  int off = 0;
  for (int j = 0; j < k; ++j) off += slot_floats(st.n[j]);
  return slot + off + lead(st.src[k]);
}

// Thread 0 copies step t's sources into slot, completing on bar.
__device__ void issue(const Args& a, int b, int t, float* slot,
                      uint64_t* bar) {
  const Step st = step_of(a, b, t);
  unsigned total = 0, bytes[kSrc];
  const char* g[kSrc];
  for (int k = 0; k < st.nsrc; ++k) {
    g[k] = chunks(st.src[k], st.n[k], &bytes[k]);
    total += bytes[k];
  }
  bar_expect(bar, total);
  for (int k = 0, off = 0; k < st.nsrc; off += slot_floats(st.n[k++]))
    bulk_copy(slot + off, g[k], bytes[k], bar);
}

// ---- pieces of a step --------------------------------------------------

// v[c] for this lane's columns c = lane + 32 j, 0 past n.
__device__ __forceinline__ void lane_vec(float (&r)[kCols], const float* v,
                                         int n, int lane) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    r[j] = c < n ? v[c] : 0.f;
  }
}

// This lane's share of row . v over n columns (v as lane_vec holds it).
__device__ __forceinline__ float lane_dot(const float* row,
                                          const float (&v)[kCols], int n,
                                          int lane) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    if (c < n) acc = fmaf(row[c], v[j], acc);
  }
  return acc;
}

// r . v over this lane's columns (both hold 0 past the row's end).
__device__ __forceinline__ float reg_dot(const float (&r)[kCols],
                                         const float (&v)[kCols]) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc = fmaf(r[j], v[j], acc);
  return acc;
}

// The warps' column partials (this lane's columns of n) into part.
__device__ __forceinline__ void put_part(float* part, const float (&acc)[kCols],
                                         int n, int lane, int warp) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    if (c < n) part[warp * n + c] = acc[j];
  }
}

__device__ __forceinline__ float sum_part(const float* part, int n, int c) {
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += part[w * n + c];
  return t;
}

// sigma x - q + out, as the loop rounds it.
__device__ __forceinline__ float rhs_of(const Args& a, float x, float q,
                                        float out) {
  return __fadd_rn(__fsub_rn(__fmul_rn(a.sigma, x), q), out);
}

// The staged constraint vectors of a node's rows.
struct Rows {
  const float *z, *y, *rho, *l, *u;
};

// Constraint row r of a node given z_t: the relaxation, the clamp to
// [l, u] (NaN kept, as torch.clamp does), the dual update; writes z and y
// at element e and returns the next sweep's w = rho z - y.
__device__ __forceinline__ float relax(const Args& a, const Rows& v, int r,
                                       size_t e, float zt) {
  const float zr = __fadd_rn(__fmul_rn(a.alpha, zt), __fmul_rn(a.beta, v.z[r]));
  const float yo = v.y[r], rh = v.rho[r];
  const float t = __fadd_rn(zr, __fdiv_rn(yo, rh));
  const float zn = isnan(t) ? t : fminf(fmaxf(t, v.l[r]), v.u[r]);
  const float yn = __fadd_rn(yo, __fmul_rn(rh, __fsub_rn(zr, zn)));
  a.z[e] = zn;
  a.y[e] = yn;
  return __fsub_rn(__fmul_rn(rh, zn), yn);
}

// Both sums of a pair of rows over the warp, their shuffles interleaved.
// Every lane ends with the same bits (each butterfly stage commutes), so
// every lane may use the sums.
__device__ __forceinline__ void warp_sum2(float& p, float& q) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    p += __shfl_xor_sync(0xffffffffu, p, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
admm_sweeps_kernel(const Args a) {
  extern __shared__ float4 sm4[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int K = a.K, N = K - 1, s = a.s, kv = a.kv, md = a.md, m = a.m;
  const int D = a.D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm4);  // a barrier per slot
  float* ring = reinterpret_cast<float*>(sm4 + 1);   // two slots of a.stage
  float* rt = ring + 2 * a.stage;  // per node: rhs, then Y's T, then x_t
  float* xs = rt + K * s;          // x
  float* zs = xs + K * s;          // zeros: y_{-1} and x_t past the end
  float* yb = zs + s;              // y_{i-1}, y_i
  float* ob = yb + 2 * s;          // A^T w of the last two nodes
  float* wb = ob + 2 * s;          // w of the last two nodes
  float* part = wb + 2 * m;        // the warps' column partials
  int* binv = reinterpret_cast<int*>(part + kWarps * s);  // slot -> box row
  int* bx = binv + s;                                     // box row -> slot
  const size_t xb = (size_t)b * K * s;   // this scenario's x and q
  const size_t zb0 = (size_t)b * N * m;  // its z, y, l, u, rho

  if (tid == 0) {
    bar_init(bars);
    bar_init(bars + 1);
  }
  for (int e = tid; e < K * s; e += kThreads) xs[e] = a.x0[xb + e];
  for (int c = tid; c < s; c += kThreads) {
    zs[c] = 0.f;
    binv[c] = -1;
  }
  __syncthreads();
  for (int j = tid; j < a.nbox; j += kThreads) {
    const int c = (int)a.box[j];
    bx[j] = c;
    if (0 <= c && c < s) binv[c] = j;
  }
  __syncthreads();

  const int T = N + a.iters * 2 * K;
  if (tid == 0) issue(a, b, 0, ring, bars);
  for (int t = 0; t < T; ++t) {
    if (tid == 0 && t + 1 < T)
      issue(a, b, t + 1, ring + ((t + 1) & 1) * a.stage, bars + ((t + 1) & 1));
    const Step st = step_of(a, b, t);
    const int i = st.node;
    const bool last = st.sweep == a.iters - 1;
    // q of the nodes whose right-hand side this step completes, loaded
    // before the wait so that its latency hides under the copies
    float q0 = 0.f, q1 = 0.f;
    if (tid < s) {
      if (st.kind == kPro) {
        q0 = a.q[xb + (size_t)i * s + tid];
        if (i == N - 1) q1 = a.q[xb + (size_t)N * s + tid];
      } else if (st.kind == kBwd && i < N && !last) {
        q1 = a.q[xb + (size_t)(i + 1) * s + tid];
        if (i == 0) q0 = a.q[xb + tid];
      }
    }
    bar_wait(bars + (t & 1), (t >> 1) & 1);
    float* slot = ring + (t & 1) * a.stage;
    const float* B0 = view(st, slot, 0);

    if (st.kind == kPro) {
      // node i's A^T w, w = rho z0 - y0, then its right-hand side
      const Rows v{view(st, slot, 1), view(st, slot, 2), view(st, slot, 3),
                   nullptr, nullptr};
      float* w = wb + (i & 1) * m;
      const float* wp = wb + ((i + 1) & 1) * m;  // w_{i-1}
      for (int r = tid; r < m; r += kThreads)
        w[r] = __fsub_rn(__fmul_rn(v.rho[r], v.z[r]), v.y[r]);
      __syncthreads();
      float acc[kCols] = {};
      for (int r = warp; r < md; r += kWarps) {
        const float wr = w[r];
        const float* Ar = B0 + r * s;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = lane + 32 * j;
          if (c < s) acc[j] = fmaf(Ar[c], wr, acc[j]);
        }
      }
      put_part(part, acc, s, lane, warp);
      __syncthreads();
      if (tid < s) {
        const int c = tid;
        float o = sum_part(part, s, c);
        if (i > 0 && c < D) o = o + wp[c];
        if (binv[c] >= 0) o = o + w[md + binv[c]];
        rt[i * s + c] = rhs_of(a, xs[i * s + c], q0, o);
        if (i == N - 1) {  // the last node has only the pattern's term
          float o2 = 0.f;
          if (c < D) o2 = o2 + w[c];
          rt[N * s + c] = rhs_of(a, xs[N * s + c], q1, o2);
        }
      }
    } else if (st.kind == kFwd) {
      // y_i = Linv_i b_i - W_i y_{i-1};  T_i = Linv_i^T y_i
      const float* B1 = view(st, slot, 1);
      float* bi = rt + i * s;
      const float* yp = i ? yb + ((i - 1) & 1) * s : zs;
      float* yc = yb + (i & 1) * s;
      float vb[kCols], vy[kCols], acc[kCols] = {};
      lane_vec(vb, bi, s, lane);
      lane_vec(vy, yp, s, lane);
      for (int r0 = warp; r0 < s; r0 += 2 * kWarps) {
        const int r1 = r0 + kWarps;  // a second row, 0 past the end
        const int n1 = r1 < s ? s : 0;
        float L0[kCols], L1[kCols];
        lane_vec(L0, B0 + r0 * s, s, lane);
        lane_vec(L1, B0 + r1 * s, n1, lane);
        float pb0 = reg_dot(L0, vb), pb1 = reg_dot(L1, vb);
        float wy0 = lane_dot(B1 + r0 * s, vy, s, lane);
        float wy1 = lane_dot(B1 + r1 * s, vy, n1, lane);
        warp_sum2(pb0, pb1);
        warp_sum2(wy0, wy1);
        const float y0 = pb0 - wy0, y1 = pb1 - wy1;
        if (lane == 0) yc[r0] = y0;
        if (lane == 1 && n1) yc[r1] = y1;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[j] = fmaf(L1[j], y1, fmaf(L0[j], y0, acc[j]));
      }
      put_part(part, acc, s, lane, warp);
      __syncthreads();
      if (tid < s) bi[tid] = sum_part(part, s, tid);
    } else {
      // x_t_i = T_i - V_i x_t_{i+1}[:kv]; x_i relaxed
      float* xt = rt + i * s;
      const float* xn = i < N ? rt + (i + 1) * s : zs;
      float vx[kCols];
      lane_vec(vx, xn, kv, lane);
      for (int r0 = warp; r0 < s; r0 += 2 * kWarps) {
        const int r1 = r0 + kWarps;
        const int n1 = r1 < s ? kv : 0;
        float d0 = lane_dot(B0 + r0 * kv, vx, kv, lane);
        float d1 = lane_dot(B0 + r1 * kv, vx, n1, lane);
        warp_sum2(d0, d1);
        const int r = lane == 0 ? r0 : r1;
        if (lane == 0 || (lane == 1 && n1)) {
          const float v = xt[r] - (lane == 0 ? d0 : d1);
          const float xr =
              __fadd_rn(__fmul_rn(a.alpha, v), __fmul_rn(a.beta, xs[i * s + r]));
          xt[r] = v;
          xs[i * s + r] = xr;
          if (last) a.x[xb + (size_t)i * s + r] = xr;
        }
      }
      __syncthreads();
      if (i < N) {
        // z_t of node i's rows, relaxed and clamped; the dual update; and,
        // but after the last sweep, the next sweep's A_i^T w_i
        const float* B1 = view(st, slot, 1);
        const Rows v{view(st, slot, 2), view(st, slot, 3), view(st, slot, 4),
                     view(st, slot, 5), view(st, slot, 6)};
        const size_t zb = zb0 + (size_t)i * m;
        float* w = wb + (i & 1) * m;
        float vt[kCols], acc[kCols] = {};
        lane_vec(vt, xt, s, lane);
        for (int r0 = warp; r0 < md; r0 += 2 * kWarps) {
          const int r1 = r0 + kWarps;
          const int n1 = r1 < md ? s : 0;
          float A0[kCols], A1[kCols];
          lane_vec(A0, B1 + r0 * s, s, lane);
          lane_vec(A1, B1 + r1 * s, n1, lane);
          float d0 = reg_dot(A0, vt), d1 = reg_dot(A1, vt);
          warp_sum2(d0, d1);
          // lane 0 takes row r0, lane 1 row r1
          const int r = lane == 0 ? r0 : r1;
          float wr = 0.f;
          if (lane == 0 || (lane == 1 && n1)) {
            float d = lane == 0 ? d0 : d1;
            if (r < D) d = d + xn[r];
            wr = relax(a, v, r, zb + r, d);
            w[r] = wr;
          }
          const float w0 = __shfl_sync(0xffffffffu, wr, 0);
          const float w1 = __shfl_sync(0xffffffffu, wr, 1);
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[j] = fmaf(A1[j], w1, fmaf(A0[j], w0, acc[j]));
        }
        for (int j = tid; j < a.nbox; j += kThreads) {
          const int c = bx[j];
          const float zt =
              (0 <= c && c < s) ? xt[c] : __int_as_float(0x7fc00000);
          w[md + j] = relax(a, v, md + j, zb + md + j, zt);
        }
        if (!last) {
          // the next sweep's copies read the z and y stored here
          fence_async_global();
          put_part(part, acc, s, lane, warp);
          __syncthreads();
          // node i+1's right-hand side is complete now that w_i is known:
          // (A^T w_{i+1} + w_i[:D]) + the box rows of w_{i+1}
          const float* wn = wb + ((i + 1) & 1) * m;
          const float* on = ob + ((i + 1) & 1) * s;
          float* oc = ob + (i & 1) * s;
          if (tid < s) {
            const int c = tid;
            const float t_ = sum_part(part, s, c);
            float o = i + 1 < N ? on[c] : 0.f;
            if (c < D) o = o + w[c];
            if (i + 1 < N && binv[c] >= 0) o = o + wn[md + binv[c]];
            rt[(i + 1) * s + c] = rhs_of(a, xs[(i + 1) * s + c], q1, o);
            oc[c] = t_;
            if (i == 0) {
              float o0 = t_;
              if (binv[c] >= 0) o0 = o0 + w[md + binv[c]];
              rt[c] = rhs_of(a, xs[c], q0, o0);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Shared memory of one CTA, bytes: the ring's two slots and the vectors
// (solver/admm_sweeps.py's smem_bytes computes the same).
static size_t admm_sweeps_smem(int K, int s, int kv, int md, int m, int nbox,
                               int* stage) {
  const int fwd = 2 * slot_floats(s * s);
  const int bwd =
      slot_floats(s * kv) + slot_floats(md * s) + 5 * slot_floats(m);
  const int pro = slot_floats(md * s) + 3 * slot_floats(m);
  *stage = fwd > bwd ? fwd : bwd;
  if (pro > *stage) *stage = pro;
  const size_t floats = 4 + 2 * (size_t)*stage + 2 * (size_t)K * s +
                        5 * (size_t)s + 2 * (size_t)m + (size_t)kWarps * s +
                        s + nbox;
  return floats * sizeof(float);
}

extern "C" int admm_sweeps_launch(
    const void* Linv, const void* W, const void* V, const void* A,
    const void* box, const void* rho, const void* q, const void* l,
    const void* u, const void* x0, const void* z0, const void* y0, void* x,
    void* z, void* y, int Bs, int K, int s, int kv, int md, int m, int D,
    int nbox, int iters, float sigma, float alpha, float beta, void* stream) {
  if (K < 2 || s < 1 || s > 32 * kCols || kv < 1 || kv > s || md < 1 ||
      m != md + nbox || D < 0 || D > md || D > s || iters < 1)
    return (int)cudaErrorInvalidValue;
  if (Bs == 0) return 0;
  int stage = 0;
  const size_t smem = admm_sweeps_smem(K, s, kv, md, m, nbox, &stage);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      admm_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const float*)Linv, (const float*)W, (const float*)V,
               (const float*)A, (const long long*)box, (const float*)rho,
               (const float*)q, (const float*)l, (const float*)u,
               (const float*)x0, (const float*)z0, (const float*)y0,
               (float*)x, (float*)z, (float*)y, K, s, kv, md, m, D, nbox,
               iters, sigma, alpha, beta, stage};
  admm_sweeps_kernel<<<Bs, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
