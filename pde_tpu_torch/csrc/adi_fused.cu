// Fused Douglas ADI march for ONE Heston option on a general (nS, nv) grid,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pde_tpu/ops/adi_fused.py:fused_douglas_march
// (Pallas, the grid and all sweep scratch in VMEM, the v sweep through an
// in-VMEM transpose).  Computes what it computes, in its step order:
//   Y0 = V + dt (A0 V + A1 V + A2 V + lam)      (lam only in IT-LCP mode)
//   Y1 = (I - th dt A1)^-1 (Y0 - th dt A1 V)     S sweep, factored once
//   Y2 = (I - th dt A2)^-1 (Y1 - th dt A2 V)     v sweep, factored once
// then the Ikonen-Toivanen multiplier update, the In 't Hout-Foulon
// Dirichlet rows at tau and the American floor.  A1 comes as row-aligned
// (nS, nv) bands (zero where a shift runs off the grid), A2 as (nv,) bands,
// A0 as a per-column mixed coefficient masked to the interior.  The plain
// PyTorch version with the same arithmetic is
// pde_tpu_torch/ops/adi_fused.py:_fused_douglas_march_plain.
//
// What bounds it on the H100: latency.  At 100 x 50 x 100 the roofline sees
// ~38 flops a node and step (1.9e7 in all, 0.3 us at 67 TFLOP/s float32) and
// ~0.2 MB of bands and result, but each step runs two serial recurrences
// per line, 2 (nS - 1) links along S for each of nv columns and 2 (nv - 1)
// along v for each of nS rows: ~300 dependent links a step, each a load, a
// multiply-add and a store, on ONE option, so only nv or nS threads of one
// SM have work during a sweep.
//
// What this design does about it: one thread block; the S sweep by one
// thread per column j, the v sweep by one thread per row i, the stencil and
// boundary phases by all threads over all nodes, with __syncthreads between
// phases.  Both systems are factored once (c and reciprocal pivots), so a
// link is one load, a multiply-add and a multiply, no division; the running
// value of each recurrence stays in a register.  The state (V, lambda, rhs,
// d, c1, 1/pivot1: 20 KB each at 100 x 50) is device-memory scratch that
// stays in L1/L2.  The v-sweep thread walks its row contiguously while its
// warp's neighbours sit nv floats apart, so those loads do not coalesce;
// shared-memory residency and a coalesced v sweep are later work.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin; expf and division are IEEE.
//
// Layout: row-major and contiguous.  G (7, nS, nv) = payoff, a1L, a1D, a1U,
// i1L, i1D, i1U; W (7, nv) = a2L, a2D, a2U, i2L, i2D, i2U, mix; sg (nS,);
// sc (7,) = dt, r, q, K, is_call, american, it_lcp; V (nS, nv) is the
// output; S (5, nS, nv) = lambda, rhs, d, c1, 1/pivot1 and S2 (2, nv) = c2,
// 1/pivot2 are scratch.  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTheta = 0.5f;  // Douglas parameter

__global__ void __launch_bounds__(kThreads)
douglas_march(const float* __restrict__ G, const float* __restrict__ W,
              const float* __restrict__ sg, const float* __restrict__ sc,
              float* __restrict__ V, float* __restrict__ S, float* __restrict__ S2,
              int nS, int nv, int nT) {
  const int tid = threadIdx.x;
  const int n = nS * nv;
  const float *pay = G, *a1L = G + n, *a1D = G + 2 * n, *a1U = G + 3 * n;
  const float *i1L = G + 4 * n, *i1D = G + 5 * n, *i1U = G + 6 * n;
  const float *a2L = W, *a2D = W + nv, *a2U = W + 2 * nv;
  const float *i2L = W + 3 * nv, *i2D = W + 4 * nv, *i2U = W + 5 * nv;
  const float* mix = W + 6 * nv;
  float *LAM = S, *R = S + n, *D = S + 2 * n, *C1 = S + 3 * n, *INV1 = S + 4 * n;
  float *C2 = S2, *INV2 = S2 + nv;

  const float dt = sc[0], r = sc[1], q = sc[2], K = sc[3];
  const bool is_call = sc[4] > 0.5f;
  const bool american = sc[5] > 0.5f;
  const bool it_lcp = sc[6] > 0.5f;
  const float th_dt = kTheta * dt;

  for (int k = tid; k < n; k += kThreads) {
    V[k] = pay[k];
    LAM[k] = 0.f;
  }
  // both implicit operators are time-independent: factor ONCE.  S system,
  // one thread per column j
  for (int j = tid; j < nv; j += kThreads) {
    float c = i1U[j] / i1D[j];
    C1[j] = c;
    INV1[j] = 1.f / i1D[j];
    for (int i = 1; i < nS; ++i) {
      const int k = i * nv + j;
      const float inv = 1.f / (i1D[k] - i1L[k] * c);
      c = i1U[k] * inv;
      C1[k] = c;
      INV1[k] = inv;
    }
  }
  // v system: one coefficient set for every row
  if (tid == 0) {
    float c = i2U[0] / i2D[0];
    C2[0] = c;
    INV2[0] = 1.f / i2D[0];
    for (int j = 1; j < nv; ++j) {
      const float inv = 1.f / (i2D[j] - i2L[j] * c);
      c = i2U[j] * inv;
      C2[j] = c;
      INV2[j] = inv;
    }
  }
  __syncthreads();

  for (int step = 0; step < nT; ++step) {
    // 1. Y0 = V + dt (A0 V + A1 V + A2 V (+ lam)); rhs1 = Y0 - th dt A1 V
    for (int k = tid; k < n; k += kThreads) {
      const int i = k / nv, j = k - i * nv;
      const float v = V[k];
      const float v_dn = i > 0 ? V[k - nv] : 0.f;
      const float v_up = i < nS - 1 ? V[k + nv] : 0.f;
      const float v_lf = j > 0 ? V[k - 1] : 0.f;
      const float v_rt = j < nv - 1 ? V[k + 1] : 0.f;
      const float a1v = a1D[k] * v + a1L[k] * v_dn + a1U[k] * v_up;
      const float a2v = v * a2D[j] + v_lf * a2L[j] + v_rt * a2U[j];
      float a0v = 0.f;
      if (i > 0 && i < nS - 1 && j > 0 && j < nv - 1) {
        const float vxv = V[k + nv + 1] - V[k + nv - 1] - V[k - nv + 1] + V[k - nv - 1];
        a0v = mix[j] * vxv;
      }
      float s = a0v + a1v;
      s = s + a2v;
      s = s + (it_lcp ? LAM[k] : 0.f);
      const float y0 = v + dt * s;
      R[k] = y0 - th_dt * a1v;
    }
    __syncthreads();

    // 2. implicit S sweep, one thread per column j, serial in i
    for (int j = tid; j < nv; j += kThreads) {
      float d = R[j] * INV1[j];
      D[j] = d;
      for (int i = 1; i < nS; ++i) {
        const int k = i * nv + j;
        d = (R[k] - i1L[k] * d) * INV1[k];
        D[k] = d;
      }
      float y = d;
      R[(nS - 1) * nv + j] = y;
      for (int i = nS - 2; i >= 0; --i) {
        const int k = i * nv + j;
        y = D[k] - C1[k] * y;
        R[k] = y;
      }
    }
    __syncthreads();

    // 3. rhs2 = Y1 - th dt A2 V  (V still holds the step's input)
    for (int k = tid; k < n; k += kThreads) {
      const int j = k % nv;
      const float v_lf = j > 0 ? V[k - 1] : 0.f;
      const float v_rt = j < nv - 1 ? V[k + 1] : 0.f;
      const float a2v = V[k] * a2D[j] + v_lf * a2L[j] + v_rt * a2U[j];
      R[k] = R[k] - th_dt * a2v;
    }
    __syncthreads();

    // 4. implicit v sweep, one thread per row i, serial in j
    for (int i = tid; i < nS; i += kThreads) {
      float* Ri = R + i * nv;
      float* Di = D + i * nv;
      float d = Ri[0] * INV2[0];
      Di[0] = d;
      for (int j = 1; j < nv; ++j) {
        d = (Ri[j] - i2L[j] * d) * INV2[j];
        Di[j] = d;
      }
      float y = d;
      Ri[nv - 1] = y;
      for (int j = nv - 2; j >= 0; --j) {
        y = Di[j] - C2[j] * y;
        Ri[j] = y;
      }
    }
    __syncthreads();

    // 5. Ikonen-Toivanen update, Dirichlet rows (i = 0, i = nS-1, then
    //    j = nv-1) at tau, American floor
    const float tau = dt * static_cast<float>(step + 1);
    const float dfr = expf(-r * tau);
    const float dfq = expf(-q * tau);
    for (int k = tid; k < n; k += kThreads) {
      const int i = k / nv, j = k - i * nv;
      const float g = pay[k];
      float vn = R[k];
      if (it_lcp) {
        // V_new - dt lam_new = Vn - dt lam, V_new >= g, lam_new >= 0
        const float w = vn - dt * LAM[k];
        const float v_it = fmaxf(g, w);
        LAM[k] = (v_it - w) / dt;
        vn = v_it;
      }
      if (i == 0) vn = is_call ? 0.f : K * dfr - sg[0] * dfq;
      if (i == nS - 1) vn = is_call ? sg[nS - 1] * dfq - K * dfr : 0.f;
      if (j == nv - 1) vn = is_call ? sg[i] * dfq : K * dfr;
      // projection: clamp everywhere; IT: the Dirichlet edges are
      // European, floor them at intrinsic
      const bool edge = i == 0 || i == nS - 1 || j == 0 || j == nv - 1;
      if ((american && !it_lcp) || (it_lcp && edge)) vn = fmaxf(vn, g);
      V[k] = vn;
    }
    __syncthreads();
  }
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers of float32
// tensors in the layout above.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int pde_adi_fused(const float* G, const float* W, const float* sg,
                             const float* sc, float* V, float* S, float* S2,
                             int nS, int nv, int nT, void* stream) {
  douglas_march<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      G, W, sg, sc, V, S, S2, nS, nv, nT);
  return static_cast<int>(cudaGetLastError());
}
