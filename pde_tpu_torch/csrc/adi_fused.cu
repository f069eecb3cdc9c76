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
// ~40 flops a node and step (2.0e7 in all, 0.3 us at 67 TFLOP/s float32) and
// ~0.2 MB of bands and result, but each step runs two serial recurrences
// per line, 2 (nS - 1) links along S for each of nv columns and 2 (nv - 1)
// along v for each of nS rows: ~300 dependent links a step on ONE option,
// so one SM works and only nv or nS of its threads have work in a sweep.
// Below the latency, instruction issue on that one SM: the stencil is ~23k
// warp instructions a step at most 4 a cycle, ~3.4 us a step.
//
// What the shared-memory design (douglas_march_smem, the default route)
// does about it:
// * One block of 1024 threads with the march state in dynamic shared
//   memory: V, the right-hand side R, the S-system reciprocal pivots INV1
//   and the multiplier LAM (always: it_lcp is a flag on the device), each
//   nS x ps floats on a row stride ps >= nv that the wrapper picks so that
//   the lanes of a warp spread over the banks in both sweeps; the v bands,
//   mix, the v-system factors and the spot grid (10 nv + nS floats).  The
//   time-independent (nS, nv) bands a1L, a1D, a1U, i1L, i1U and the payoff
//   join them wherever they fit (at 100 x 50, ps = 54: 218.4 KB in all),
//   else they are read in place.  The S factors c1 = i1U inv1 are
//   recomputed from INV1 (the same product the factorisation stores; row 0
//   keeps its own c, a quotient), so C1 takes no room.
// * Each tridiagonal sweep spread over a group of g lanes of one warp as a
//   chunked affine scan, as in K1 (adi_fused_batched.cu): each lane
//   composes the map x -> P x + Q of its chunk of the line, a log2(g)-level
//   shuffle scan gives it the value entering the chunk, and it walks the
//   chunk again with the sequential arithmetic.  At 100 x 50: 16 lanes per
//   S column and 8 per v row, chunks of 7.
// * The step's explicit right-hand side is formed in the S sweep's first
//   pass; the v sweep's in its first pass, and the Ikonen-Toivanen update,
//   the Dirichlet rows and the floor in its last: two barriers a step.
// Grids whose state exceeds a block's 227 KB keep the first design
// (douglas_march): one 256-thread block, the S sweep by one thread per
// column j, the v sweep by one thread per row i, the state in device-memory
// scratch, four barriers a step.
//
// Numerics: both designs factor each system once (c and reciprocal
// pivots), so a link is a multiply-add and a multiply, no division; expf
// and division are IEEE.  Inside a chunk the arithmetic is the plain
// twin's, up to nvcc's FMA contraction (kept: ops/build.py); the
// shared-memory design composes the values entering the chunks in another
// order.
//
// Layout: row-major and contiguous.  G (7, nS, nv) = payoff, a1L, a1D, a1U,
// i1L, i1D, i1U; W (7, nv) = a2L, a2D, a2U, i2L, i2D, i2U, mix; sg (nS,);
// sc (7,) = dt, r, q, K, is_call, american, it_lcp; V (nS, nv) is the
// output; the first design takes S (5, nS, nv) = lambda, rhs, d, c1,
// 1/pivot1 and S2 (2, nv) = c2, 1/pivot2 as scratch.  The kernels allocate
// nothing and do not synchronise; they run on the caller's stream.

#include <cuda_runtime.h>

#include "lane_scan.cuh"

namespace {

constexpr int kThreads = 256;       // first design: one thread per line
constexpr int kSmemThreads = 1024;  // shared-memory design: g lanes per line
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

// kBandsSmem: the (nS, nv) bands and the payoff sit in shared memory on the
// padded stride ps; else they are read in place on their stride nv.
template <bool kBandsSmem>
__global__ void __launch_bounds__(kSmemThreads, 1)
douglas_march_smem(const float* __restrict__ G, const float* __restrict__ W,
                   const float* __restrict__ sg, const float* __restrict__ sc,
                   float* __restrict__ Vout, int nS, int nv, int nT, int ps, int gs,
                   int gv) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int n = nS * nv, np = nS * ps;
  float* V = sm;
  float* R = V + np;
  float* INV1 = R + np;
  float* LAM = INV1 + np;
  float* BND = LAM + np;  // payoff, a1L, a1D, a1U, i1L, i1U with kBandsSmem
  float* VEC = BND + (kBandsSmem ? 6 * np : 0);
  const float *a2L = VEC, *a2D = VEC + nv, *a2U = VEC + 2 * nv;
  const float *i2L = VEC + 3 * nv, *i2D = VEC + 4 * nv, *i2U = VEC + 5 * nv;
  const float* MIX = VEC + 6 * nv;
  float *C2 = VEC + 7 * nv, *IV2 = VEC + 8 * nv;
  float* C10 = VEC + 9 * nv;  // the S system's c at row 0: i1U / i1D
  float* SG = VEC + 10 * nv;
  const int bs = kBandsSmem ? ps : nv;  // row stride of the bands
  const float* PAY = kBandsSmem ? BND : G;
  const float* A1L = kBandsSmem ? BND + np : G + n;
  const float* A1D = kBandsSmem ? BND + 2 * np : G + 2 * n;
  const float* A1U = kBandsSmem ? BND + 3 * np : G + 3 * n;
  const float* I1L = kBandsSmem ? BND + 4 * np : G + 4 * n;
  const float* I1U = kBandsSmem ? BND + 5 * np : G + 6 * n;

  for (int k = tid; k < 7 * nv; k += kSmemThreads) VEC[k] = W[k];
  for (int k = tid; k < nS; k += kSmemThreads) SG[k] = sg[k];
  // V starts at the payoff, lambda at zero; i1D is staged in R (free until
  // the march) for the factorisation
  for (int k = tid; k < n; k += kSmemThreads) {
    const int i = k / nv, j = k - i * nv, s = i * ps + j;
    if (kBandsSmem) {
      BND[s] = G[k];
      BND[np + s] = G[n + k];
      BND[2 * np + s] = G[2 * n + k];
      BND[3 * np + s] = G[3 * n + k];
      BND[4 * np + s] = G[4 * n + k];
      BND[5 * np + s] = G[6 * n + k];
    }
    V[s] = G[k];
    R[s] = G[5 * n + k];
    LAM[s] = 0.f;
  }
  __syncthreads();

  // both implicit operators are time-independent: factor ONCE, with the
  // first design's arithmetic.  S system, one thread per column j
  for (int j = tid; j < nv; j += kSmemThreads) {
    float c = I1U[j] / R[j];
    C10[j] = c;
    INV1[j] = 1.f / R[j];
    for (int i = 1; i < nS; ++i) {
      const float inv = 1.f / (R[i * ps + j] - I1L[i * bs + j] * c);
      c = I1U[i * bs + j] * inv;
      INV1[i * ps + j] = inv;
    }
  }
  // v system: one coefficient set for every row, by a thread of the last warp
  if (tid == kSmemThreads - 32) {
    float c = i2U[0] / i2D[0];
    C2[0] = c;
    IV2[0] = 1.f / i2D[0];
    for (int j = 1; j < nv; ++j) {
      const float inv = 1.f / (i2D[j] - i2L[j] * c);
      c = i2U[j] * inv;
      C2[j] = c;
      IV2[j] = inv;
    }
  }
  __syncthreads();

  const float dt = sc[0], r = sc[1], q = sc[2], K = sc[3];
  const bool is_call = sc[4] > 0.5f;
  const bool american = sc[5] > 0.5f;
  const bool it_lcp = sc[6] > 0.5f;
  const float th_dt = kTheta * dt;
  const int lane_s = tid % gs, lane_v = tid % gv;
  const int cs = (nS + gs - 1) / gs, cv = (nv + gv - 1) / gv;

  for (int step = 0; step < nT; ++step) {
    // 1-2. Y0 = V + dt (A0 V + A1 V + A2 V (+ lam)), rhs1 = Y0 - th dt A1 V
    // and the implicit S sweep, gs lanes per column j
    for (int base = 0; base < nv; base += kSmemThreads / gs) {
      const int j = base + tid / gs;
      const bool act = j < nv;
      const int i_beg = min(nS, lane_s * cs);
      const int i_end = act ? min(nS, i_beg + cs) : i_beg;
      const bool lo_j = j > 0, hi_j = j < nv - 1;
      const float b2L = act ? a2L[j] : 0.f, b2D = act ? a2D[j] : 0.f;
      const float b2U = act ? a2U[j] : 0.f, mj = act ? MIX[j] : 0.f;
      // pass 1: rhs1 into R, and the chunk's forward-sweep map
      float P = 1.f, Q = 0.f;
      for (int i = i_beg; i < i_end; ++i) {
        const int k = i * ps + j, kb = i * bs + j;
        const float v = V[k];
        const float v_dn = i > 0 ? V[k - ps] : 0.f;
        const float v_up = i < nS - 1 ? V[k + ps] : 0.f;
        const float v_lf = lo_j ? V[k - 1] : 0.f;
        const float v_rt = hi_j ? V[k + 1] : 0.f;
        const float a1v = A1D[kb] * v + A1L[kb] * v_dn + A1U[kb] * v_up;
        const float a2v = v * b2D + v_lf * b2L + v_rt * b2U;
        float a0v = 0.f;
        if (i > 0 && i < nS - 1 && lo_j && hi_j) {
          const float vxv = V[k + ps + 1] - V[k + ps - 1] - V[k - ps + 1] + V[k - ps - 1];
          a0v = mj * vxv;
        }
        float s = a0v + a1v;
        s = s + a2v;
        s = s + (it_lcp ? LAM[k] : 0.f);
        const float y0 = v + dt * s;
        const float t = y0 - th_dt * a1v;
        R[k] = t;
        const float li = i > 0 ? I1L[kb] : 0.f;
        const float inv = INV1[k];
        Q = (t - li * Q) * inv;
        P = -(li * P) * inv;
      }
      // pass 2: the forward sweep d_i = (t_i - l_i d_{i-1}) inv_i, in place
      float d = scan_entry(P, Q, gs, lane_s, false);
      for (int i = i_beg; i < i_end; ++i) {
        const int k = i * ps + j;
        const float li = i > 0 ? I1L[i * bs + j] : 0.f;
        d = (R[k] - li * d) * INV1[k];
        R[k] = d;
      }
      // passes 3-4: the back substitution y_i = d_i - c_i y_{i+1}, in place
      P = 1.f;
      Q = 0.f;
      for (int i = i_end - 1; i >= i_beg; --i) {
        const int k = i * ps + j;
        const float ci = i == nS - 1 ? 0.f : i == 0 ? C10[j] : I1U[i * bs + j] * INV1[k];
        Q = R[k] - ci * Q;
        P = -(ci * P);
      }
      float y = scan_entry(P, Q, gs, lane_s, true);
      for (int i = i_end - 1; i >= i_beg; --i) {
        const int k = i * ps + j;
        const float ci = i == nS - 1 ? 0.f : i == 0 ? C10[j] : I1U[i * bs + j] * INV1[k];
        y = R[k] - ci * y;
        R[k] = y;
      }
    }
    __syncthreads();

    // 3-5. rhs2 = Y1 - th dt A2 V (V still holds the step's input), the
    // implicit v sweep, then the Ikonen-Toivanen update, the Dirichlet rows
    // (i = 0, i = nS-1, then j = nv-1) at tau and the American floor, gv
    // lanes per row i
    const float tau = dt * static_cast<float>(step + 1);
    const float dfr = expf(-r * tau);
    const float dfq = expf(-q * tau);
    for (int base = 0; base < nS; base += kSmemThreads / gv) {
      const int i = base + tid / gv;
      const bool act = i < nS;
      const int j_beg = min(nv, lane_v * cv);
      const int j_end = act ? min(nv, j_beg + cv) : j_beg;
      float* Vi = V + i * ps;
      float* Ri = R + i * ps;
      float P = 1.f, Q = 0.f;
      for (int j = j_beg; j < j_end; ++j) {
        const float v_lf = j > 0 ? Vi[j - 1] : 0.f;
        const float v_rt = j < nv - 1 ? Vi[j + 1] : 0.f;
        const float a2v = Vi[j] * a2D[j] + v_lf * a2L[j] + v_rt * a2U[j];
        const float rhs = Ri[j] - th_dt * a2v;
        Ri[j] = rhs;
        const float lj = j > 0 ? i2L[j] : 0.f;
        Q = (rhs - lj * Q) * IV2[j];
        P = -(lj * P) * IV2[j];
      }
      float d = scan_entry(P, Q, gv, lane_v, false);
      for (int j = j_beg; j < j_end; ++j) {
        const float lj = j > 0 ? i2L[j] : 0.f;
        d = (Ri[j] - lj * d) * IV2[j];
        Ri[j] = d;
      }
      P = 1.f;
      Q = 0.f;
      for (int j = j_end - 1; j >= j_beg; --j) {
        const float cj = j < nv - 1 ? C2[j] : 0.f;
        Q = Ri[j] - cj * Q;
        P = -(cj * P);
      }
      float y = scan_entry(P, Q, gv, lane_v, true);
      __syncwarp();  // every lane has read its row's V before any writes it
      for (int j = j_end - 1; j >= j_beg; --j) {
        const float cj = j < nv - 1 ? C2[j] : 0.f;
        y = Ri[j] - cj * y;
        const int k = i * ps + j;
        const float g = PAY[i * bs + j];
        float vn = y;
        if (it_lcp) {
          // V_new - dt lam_new = Vn - dt lam, V_new >= g, lam_new >= 0
          const float w = vn - dt * LAM[k];
          const float v_it = fmaxf(g, w);
          LAM[k] = (v_it - w) / dt;
          vn = v_it;
        }
        if (i == 0) vn = is_call ? 0.f : K * dfr - SG[0] * dfq;
        if (i == nS - 1) vn = is_call ? SG[nS - 1] * dfq - K * dfr : 0.f;
        if (j == nv - 1) vn = is_call ? SG[i] * dfq : K * dfr;
        // projection: clamp everywhere; IT: the Dirichlet edges are
        // European, floor them at intrinsic
        const bool edge = i == 0 || i == nS - 1 || j == 0 || j == nv - 1;
        if ((american && !it_lcp) || (it_lcp && edge)) vn = fmaxf(vn, g);
        Vi[j] = vn;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < n; k += kSmemThreads) {
    const int i = k / nv, j = k - i * nv;
    Vout[k] = V[i * ps + j];
  }
}

template <bool kBandsSmem>
int launch_smem(const float* G, const float* W, const float* sg, const float* sc,
                float* V, int nS, int nv, int nT, int ps, int gs, int gv,
                int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(douglas_march_smem<kBandsSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  douglas_march_smem<kBandsSmem><<<1, kSmemThreads, smem_bytes, stream>>>(
      G, W, sg, sc, V, nS, nv, nT, ps, gs, gv);
  return static_cast<int>(cudaGetLastError());
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

// The shared-memory route: inputs and V as above, no scratch; ps the padded
// row stride, gs and gv the lanes per S column and per v row (powers of two
// up to 32), bands_smem whether the (nS, nv) bands and the payoff go to
// shared memory, smem_bytes the block's dynamic shared memory (at most
// 227 KB).  Returns the first CUDA error of the attribute call or the
// launch (0 = launched).
extern "C" int pde_adi_fused_smem(const float* G, const float* W, const float* sg,
                                  const float* sc, float* V, int nS, int nv, int nT,
                                  int ps, int gs, int gv, int bands_smem,
                                  int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bands_smem
             ? launch_smem<true>(G, W, sg, sc, V, nS, nv, nT, ps, gs, gv, smem_bytes, s)
             : launch_smem<false>(G, W, sg, sc, V, nS, nv, nT, ps, gs, gv, smem_bytes, s);
}
