// Fused Douglas ADI march for a batch of Heston options, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel pde_tpu/ops/adi_fused.py:fused_douglas_march_batched
// (Pallas, batch on the 128 vector lanes).  Computes what it computes: the
// whole time loop of a book in one launch — explicit A0 (mixed derivative),
// A1 and A2 stencils, a Thomas sweep along S and one along v (both factored
// once, before the march), the Ikonen-Toivanen multiplier update or the
// American projection, and the In 't Hout-Foulon Dirichlet rows.  The plain
// PyTorch twin with the same step order is
// pde_tpu_torch/ops/adi_fused.py:_fused_douglas_march_batched_plain.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  Each
// step runs two serial recurrences per line (forward sweep and back
// substitution), nS long along S and nv long along v, and only one thread
// per line works through them: at 100x50 that is 50 busy threads in the
// S-sweep and 100 in the v-sweep, each waiting on a load and an FMA per
// element.  The v-sweep also reads at stride nv (one thread per row i walks
// j), so its loads do not coalesce.
//
// What this design does about it: one thread block per option, so a
// 512-option book puts ~4 independent blocks on each of the 132 SMs and the
// scheduler hides one block's serial chains behind another's; the running
// value of each recurrence stays in a register; the factorisation (c and
// reciprocal pivots) is done once, so each chain element is one load, one
// FMA-and-multiply and one store, with no division.  The option's state
// (V, rhs, d, c1, inv1 and, with use_it, lambda: ~20 KB each at 100x50) is
// device-memory scratch that stays mostly in L1/L2: a v-sweep thread reuses
// each 128-byte line it touches for the next 31 values of j.  Moving the
// state to shared memory (227 KB per block) and coalescing the v-sweep are
// later work.
//
// PCR variants (pcr_v, pcr_s; the reference's adi_fused.py:396-419,
// :438-466, :495-546): a sweep becomes parallel cyclic reduction, log2 n
// levels of whole-grid updates rr = rr + alpha rr[-s] + beta rr[+s] with
// all threads busy and a barrier per level, then one multiply by 1/d.  The
// level coefficients depend only on the time-independent bands, so they
// are computed once before the march: alpha and beta for each level and
// the final 1/d, per (j, option) for v (2 levels_v nv + nv floats, in the
// c2/inv2 slots) and per (i, j, option) for S (2 levels_S nS nv + nS nv:
// the identity rows couple in, so they do not stay i-independent).  The
// level recurrence itself ping-pongs six band arrays through WORK.
//
// Layout: option-major and contiguous, (B, nS, nv) for every grid field,
// (B, 3, nv) for the band triples [lo, di, up], (B, nv) for mix, c2 and
// inv2 (c2: (B, 2 levels_v nv) with pcr_v), (B, nS) for the payoff and the
// spot grid, (B, 8) for the scalars dt, r, q, K, is_call, american;
// SAB (B, 2 levels_S nS nv) and SINVD (B, nS nv) with pcr_s; WORK
// (B, 6 nS nv) with pcr_s, else (B, 6 nv) with pcr_v.  The kernel
// allocates nothing and does not synchronise; it runs on the caller's
// stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTheta = 0.5f;  // Douglas parameter

// PCR levels of an n-long sweep: strides 1, 2, 4, ... below n
__host__ __device__ int pcr_levels(int n) {
  int lev = 1;
  while ((1 << lev) < n) ++lev;
  return lev;
}

// Level coefficients of n_sys independent systems of length n laid out with
// row stride `stride` (S: stride nv, the nv columns are the systems; v:
// stride 1, one system).  lo/di/up hold the row-aligned bands of level 0 in
// W[0..2] and are ping-ponged with W[3..5]; alpha and beta of level lev go
// to AB[2 lev][.] and AB[2 lev + 1][.], the final 1/d to INVD.  Same
// arithmetic as the reference (adi_fused.py:396-419, :438-466).
__device__ void pcr_factor(float* W, int m, int n, int stride, float* AB,
                           float* INVD) {
  const int tid = threadIdx.x;
  float *lo = W, *up = W + m, *di = W + 2 * m;
  float *lo2 = W + 3 * m, *up2 = W + 4 * m, *di2 = W + 5 * m;
  const int levels = pcr_levels(n);
  for (int lev = 0; lev < levels; ++lev) {
    const int s = 1 << lev;
    for (int k = tid; k < m; k += kThreads) {
      const int i = (k / stride) % n;  // row within its system
      const bool has_lo = i >= s, has_hi = i < n - s;
      const float in_lo = has_lo ? 1.f : 0.f, in_hi = has_hi ? 1.f : 0.f;
      const float d_dn = (has_lo ? di[k - s * stride] : 0.f) + (1.f - in_lo);
      const float d_up = (has_hi ? di[k + s * stride] : 0.f) + (1.f - in_hi);
      const float alpha = -(lo[k] * in_lo) / d_dn;
      const float beta = -(up[k] * in_hi) / d_up;
      AB[(2 * lev) * m + k] = alpha;
      AB[(2 * lev + 1) * m + k] = beta;
      lo2[k] = alpha * (has_lo ? lo[k - s * stride] : 0.f);
      up2[k] = beta * (has_hi ? up[k + s * stride] : 0.f);
      di2[k] = di[k] + alpha * (has_lo ? up[k - s * stride] : 0.f) +
               beta * (has_hi ? lo[k + s * stride] : 0.f);
    }
    __syncthreads();
    float* t;
    t = lo; lo = lo2; lo2 = t;
    t = up; up = up2; up2 = t;
    t = di; di = di2; di2 = t;
  }
  for (int k = tid; k < m; k += kThreads) INVD[k] = 1.f / di[k];
  __syncthreads();
}

// One PCR solve in place on R (nS x nv), systems along S (along_s) or v,
// ping-ponging through D; AB/INVD from pcr_factor (per node for S, per
// column j for v).
__device__ void pcr_solve(float* R, float* D, const float* AB, const float* INVD,
                          int nS, int nv, bool along_s) {
  const int tid = threadIdx.x;
  const int n = nS * nv;
  const int len = along_s ? nS : nv;
  const int stride = along_s ? nv : 1;
  const int m = along_s ? n : nv;  // coefficient entries per level
  const int levels = pcr_levels(len);
  float *src = R, *dst = D;
  for (int lev = 0; lev < levels; ++lev) {
    const int s = 1 << lev;
    for (int k = tid; k < n; k += kThreads) {
      const int i = along_s ? k / nv : k % nv;
      const int c = along_s ? k : k % nv;
      const float dn = i >= s ? src[k - s * stride] : 0.f;
      const float up = i < len - s ? src[k + s * stride] : 0.f;
      dst[k] = src[k] + AB[(2 * lev) * m + c] * dn + AB[(2 * lev + 1) * m + c] * up;
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  for (int k = tid; k < n; k += kThreads)
    R[k] = src[k] * INVD[along_s ? k : k % nv];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
douglas_march_batched(const float* __restrict__ pay, const float* __restrict__ sg,
                      const float* __restrict__ a1, const float* __restrict__ i1,
                      const float* __restrict__ a2, const float* __restrict__ i2,
                      const float* __restrict__ mix, const float* __restrict__ sc,
                      float* __restrict__ V, float* __restrict__ R,
                      float* __restrict__ D, float* __restrict__ C1,
                      float* __restrict__ INV1, float* __restrict__ LAM,
                      float* __restrict__ C2, float* __restrict__ INV2,
                      float* __restrict__ SAB, float* __restrict__ SINVD,
                      float* __restrict__ WORK, int nS, int nv, int nT,
                      int use_it, int pcr_v, int pcr_s) {
  const int tid = threadIdx.x;
  const int n = nS * nv;
  const size_t b = blockIdx.x;

  pay += b * nS;
  sg += b * nS;
  a1 += b * 3 * nv;
  i1 += b * 3 * nv;
  a2 += b * 3 * nv;
  i2 += b * 3 * nv;
  mix += b * nv;
  sc += b * 8;
  V += b * n;
  R += b * n;
  D += b * n;
  C1 += b * n;
  INV1 += b * n;
  if (use_it) LAM += b * n;
  C2 += b * (pcr_v ? 2 * pcr_levels(nv) * nv : nv);
  INV2 += b * nv;
  if (pcr_s) {
    SAB += b * 2 * pcr_levels(nS) * n;
    SINVD += b * n;
  }
  if (pcr_s || pcr_v) WORK += b * 6 * (pcr_s ? n : nv);

  const float dt = sc[0], r = sc[1], q = sc[2], K = sc[3];
  const bool is_call = sc[4] > 0.5f;
  const bool amer = sc[5] > 0.5f;
  const float *a1L = a1, *a1D = a1 + nv, *a1U = a1 + 2 * nv;
  const float *i1L = i1, *i1D = i1 + nv, *i1U = i1 + 2 * nv;
  const float *a2L = a2, *a2D = a2 + nv, *a2U = a2 + 2 * nv;
  const float *i2L = i2, *i2D = i2 + nv, *i2U = i2 + 2 * nv;

  // V starts at the payoff (constant along v); lambda at zero
  for (int k = tid; k < n; k += kThreads) {
    V[k] = pay[k / nv];
    if (use_it) LAM[k] = 0.f;
  }

  if (pcr_s) {
    // S-system PCR levels over the full grid; rows 0 and nS-1 are identity
    for (int k = tid; k < n; k += kThreads) {
      const int i = k / nv, j = k - i * nv;
      const float mi = (i > 0 && i < nS - 1) ? 1.f : 0.f;
      WORK[k] = i1L[j] * mi;
      WORK[n + k] = i1U[j] * mi;
      WORK[2 * n + k] = i1D[j] * mi + (1.f - mi);
    }
    __syncthreads();
    pcr_factor(WORK, n, nS, nv, SAB, SINVD);
  } else {
    // S-system Thomas factors, one thread per column j; rows 0 and nS-1
    // are identity (c = 0, inv = 1)
    for (int j = tid; j < nv; j += kThreads) {
      C1[j] = 0.f;
      INV1[j] = 1.f;
      float c = 0.f;
      for (int i = 1; i < nS - 1; ++i) {
        const float inv = 1.f / (i1D[j] - i1L[j] * c);
        c = i1U[j] * inv;
        C1[i * nv + j] = c;
        INV1[i * nv + j] = inv;
      }
      C1[(nS - 1) * nv + j] = 0.f;
      INV1[(nS - 1) * nv + j] = 1.f;
    }
  }
  if (pcr_v) {
    // v-system PCR levels: (nv,) per option
    for (int j = tid; j < nv; j += kThreads) {
      WORK[j] = i2L[j];
      WORK[nv + j] = i2U[j];
      WORK[2 * nv + j] = i2D[j];
    }
    __syncthreads();
    pcr_factor(WORK, nv, nv, 1, C2, INV2);
  } else if (tid == 0) {
    // v-system Thomas factors: (nv,) per option, one thread
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

  const float dt_a1 = (1.f - kTheta) * dt;
  const float th_dt = kTheta * dt;

  for (int step = 0; step < nT; ++step) {
    // 1. explicit rhs: V + dt A0 V + (1-th) dt A1 V + dt A2 V (+ dt lambda)
    for (int k = tid; k < n; k += kThreads) {
      const int i = k / nv, j = k - i * nv;
      const bool lo_j = j > 0, hi_j = j < nv - 1;
      const float v = V[k];
      const float a2v = a2D[j] * v + a2L[j] * (lo_j ? V[k - 1] : 0.f) +
                        a2U[j] * (hi_j ? V[k + 1] : 0.f);
      float a0v = 0.f, a1v = 0.f;
      if (i > 0 && i < nS - 1) {  // A1 and A0 act on interior rows only
        const float* up = V + k + nv;
        const float* dn = V + k - nv;
        const float vxv = (hi_j ? up[1] : 0.f) - (lo_j ? up[-1] : 0.f) -
                          (hi_j ? dn[1] : 0.f) + (lo_j ? dn[-1] : 0.f);
        a0v = mix[j] * vxv;
        a1v = a1D[j] * v + a1L[j] * dn[0] + a1U[j] * up[0];
      }
      float acc = v + dt * a0v;
      acc = acc + dt_a1 * a1v;
      acc = acc + dt * a2v;
      if (use_it) acc = acc + dt * LAM[k];
      R[k] = acc;
    }
    __syncthreads();

    // 2. implicit S sweep: PCR over the grid, or one thread per column j,
    //    serial in i
    if (pcr_s) pcr_solve(R, D, SAB, SINVD, nS, nv, true);
    for (int j = tid; j < nv && !pcr_s; j += kThreads) {
      const float l = i1L[j];
      float d = R[j];
      D[j] = d;
      for (int i = 1; i < nS; ++i) {
        const float li = i < nS - 1 ? l : 0.f;
        d = (R[i * nv + j] - li * d) * INV1[i * nv + j];
        D[i * nv + j] = d;
      }
      float y = d;
      R[(nS - 1) * nv + j] = y;
      for (int i = nS - 2; i >= 0; --i) {
        y = D[i * nv + j] - C1[i * nv + j] * y;
        R[i * nv + j] = y;
      }
    }
    __syncthreads();

    // 3. rhs2 = Y1 - th dt A2 V  (V still holds the step's input)
    for (int k = tid; k < n; k += kThreads) {
      const int j = k % nv;
      const float a2v = a2D[j] * V[k] + a2L[j] * (j > 0 ? V[k - 1] : 0.f) +
                        a2U[j] * (j < nv - 1 ? V[k + 1] : 0.f);
      R[k] = R[k] - th_dt * a2v;
    }
    __syncthreads();

    // 4. implicit v sweep: PCR over the grid, or one thread per row i,
    //    serial in j
    if (pcr_v) pcr_solve(R, D, C2, INV2, nS, nv, false);
    for (int i = tid; i < nS && !pcr_v; i += kThreads) {
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
      const float g = pay[i];
      float vn = R[k];
      if (use_it && amer) {
        // V_new - dt lam_new = Vn - dt lam, V_new >= g, lam_new >= 0
        const float w = vn - dt * LAM[k];
        const float v_it = fmaxf(g, w);
        LAM[k] = (v_it - w) / dt;
        vn = v_it;
      }
      if (i == 0) vn = is_call ? 0.f : K * dfr - sg[0] * dfq;
      if (i == nS - 1) vn = is_call ? sg[nS - 1] * dfq - K * dfr : 0.f;
      if (j == nv - 1) vn = is_call ? sg[i] * dfq : K * dfr;
      // projection: clamp flagged options everywhere; IT: the Dirichlet
      // edges are European, floor flagged options there
      const bool edge = i == 0 || i == nS - 1 || j == 0 || j == nv - 1;
      if (amer && (!use_it || edge)) vn = fmaxf(vn, g);
      V[k] = vn;
    }
    __syncthreads();
  }
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers of
// float32 tensors in the layout above; lam may be null when use_it == 0,
// SAB and SINVD when pcr_s == 0, WORK when neither PCR flag is set.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pde_adi_fused_batched(const float* pay, const float* sg,
                                     const float* a1, const float* i1,
                                     const float* a2, const float* i2,
                                     const float* mix, const float* sc,
                                     float* V, float* R, float* D, float* C1,
                                     float* INV1, float* LAM, float* C2,
                                     float* INV2, float* SAB, float* SINVD,
                                     float* WORK, int B, int nS, int nv, int nT,
                                     int use_it, int pcr_v, int pcr_s,
                                     void* stream) {
  if (B > 0) {
    douglas_march_batched<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pay, sg, a1, i1, a2, i2, mix, sc, V, R, D, C1, INV1, LAM, C2, INV2, SAB,
        SINVD, WORK, nS, nv, nT, use_it, pcr_v, pcr_s);
  }
  return static_cast<int>(cudaGetLastError());
}
