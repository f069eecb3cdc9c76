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
// Its least time on the H100 is 0.145 ms at 100x50x100, B = 512 (float32
// operations; the bytes take less).  Each step runs two serial recurrences
// per line (forward sweep and back substitution), nS long along S and nv
// long along v.  Walked by one thread per line through device memory, as
// the first design does, that is ~300 dependent links a step at ~500 ns
// each: latency bound, ~100x the bound.
//
// What bounds this design instead (an estimate from the source, not
// measured): instruction issue.  The stencils and boundary rows cost ~150
// thread instructions a node and step, ~23k warp instructions a block and
// step, issued by an SM that two blocks share.
//
// What this design does about the latency (douglas_march_smem, the default
// route):
// * One 512-thread block per option, with the march state in dynamic shared
//   memory: V, the right-hand side R, the S-system reciprocal pivots INV1
//   and, with use_it, the multiplier LAM, each nS x ps floats (rows padded
//   to a stride ps >= nv that the wrapper picks so that the lanes of a warp
//   spread over the banks in both sweeps), plus the bands, mix, the
//   v-system factors, the payoff and the spot grid (15 nv + 2 nS floats).
//   At 100x50 (ps = 52) that is 66.2 KB, 87.0 KB with use_it; either way
//   two blocks to an SM, since registers bind first (__launch_bounds__(512,
//   2): 64 registers x 512 threads x 2 blocks fill the 65,536).  The S factors c1 = u inv1 are recomputed from INV1
//   (the same product the factorisation stored), so C1 takes no room.
// * Each tridiagonal sweep spread over a group of g lanes of one warp.  With
//   the factors known, the forward sweep d_i = (R_i - l_i d_{i-1}) inv_i and
//   the back substitution y_i = d_i - c_i y_{i+1} are affine recurrences
//   x_i = A_i x_{i-1} + B_i, and affine maps compose associatively.  Each
//   lane takes a contiguous chunk of the line, composes its chunk's map in
//   registers, a log2(g)-level scan with __shfl_up_sync/__shfl_down_sync
//   (width g) gives each lane the value entering its chunk, and the lane
//   then walks its chunk again with the sequential arithmetic.  At 100x50
//   the S sweep runs 50 columns x 8 lanes (chunks of 13 rows), the v sweep
//   100 rows x 4 lanes (chunks of 13): a chain of ~2 (13 + 3 + 13) links in
//   shared memory and registers per sweep, against ~2 x 99 before.  The
//   systems are diagonally dominant (|A_i| < 1), so the scan is stable;
//   inside a chunk the arithmetic is the twin's, only the values entering
//   the chunks are composed in another order.
// * The explicit right-hand side is formed in the S sweep's first pass, the
//   v sweep's right-hand side in its first pass, and the Ikonen-Toivanen
//   update, the Dirichlet rows and the floor in its last: two barriers a
//   step.
//
// The PCR S sweep on the shared-memory route (douglas_march_smem<true>,
// pcr_s without pcr_v; the reference's adi_fused.py:396-419, :495-504):
// the S sweep becomes parallel cyclic reduction, levels_S (7 at nS = 100)
// levels rr_i += alpha_i rr_{i-s} + beta_i rr_{i+s}, then one multiply by
// 1/d.  The level coefficients depend only on the time-independent bands;
// the identity rows couple in, so they are not i-independent: 2 levels_S
// nS nv floats an option, 300 KB at 100x50, too many for shared memory.
// * Each column's rows belong to one lane group inside a warp (8 lanes,
//   chunks of 13 rows at 100x50), so a level needs only __syncwarp.  R and
//   a ping-pong grid PP hold rr in shared memory, the final 1/d sits in
//   INV1's place.
// * Before the march each lane group computes its column's levels in
//   shared memory (the arithmetic of pcr_factor) and writes alpha and beta
//   to TAB in device memory in the order the march reads them: level,
//   alpha/beta, row of the chunk, S-sweep thread.  A warp's reads of one
//   row then take 32 consecutive floats.
// * During the march each thread streams its own rows of the next level
//   (after the last level, the next step's first) into a double buffer in
//   shared memory with cp.async while the level before runs; a thread
//   reads only what it copied, so the copy needs no barrier.
// * What bounds it: the coefficient stream, 15.4 GB over the march at
//   B = 512, 100x50x100: 4.6 ms at the HBM rate, less where the resident
//   blocks' tables (132 x 291 KB = 38 MB) stay in the 50 MB L2.  The block
//   holds 170.2 KB (191.0 KB with use_it) at 100x50: one block an SM.
//
// The PCR v sweep on the shared-memory route (douglas_march_smem<., true>,
// pcr_v alone or with pcr_s; the reference's adi_fused.py:438-466,
// :536-546): the v sweep becomes levels_v (6 at nv = 50) levels
// rr_j += alpha_j rr_{j-s} + beta_j rr_{j+s}, then one multiply by 1/d.
// * The level coefficients depend on j only: 2 levels_v nv + nv floats an
//   option (2.6 KB at nv = 50).  The block computes them before the march
//   with pcr_factor's arithmetic (lo, up, di ping-pong through V and R, free
//   until then) into shared memory, in the place of the Thomas factors C2
//   and IV2, and keeps them there for the whole march.
// * Each v row's nodes belong to one lane group inside a warp (gv lanes, 4
//   at 100x50, chunks of 13), so a level is a __syncwarp, not a block
//   barrier.  rr ping-pongs between the row of R and a second row: with
//   pcr_s the ping-pong grid PP the S sweep already has; alone, the row of
//   V itself, which no other row reads in the v phase and which is free
//   once the row's right-hand side is formed, so the route needs no fifth
//   field.
// * The right-hand side R - th dt A2 V is formed in a pass of its own into
//   R (the levels read neighbours s rows away, so a level that formed it as
//   it read would let one lane overwrite V or R where its neighbour still
//   reads them); the final multiply by 1/d carries the Ikonen-Toivanen
//   update, the Dirichlet rows and the floor into V, as the Thomas sweep's
//   last pass does.
// * At 100x50 the block holds 68.4 KB (89.2 KB with use_it) alone: two
//   blocks an SM, as the Thomas route; 172.4 KB (193.2 KB) with pcr_s.
//
// The first design (douglas_march_batched: one 128-thread block per option,
// state in device-memory scratch, one thread per line) stays for what the
// shared-memory route does not take, chosen by the wrapper from the
// arguments: grids whose state exceeds the 227 KB a block can have (200x100
// is one: 80 KB a field).  It takes every flag.  It launches from a second
// build of this source without FMA contraction (ops/build.py VARIANTS), so
// that it rounds every product and sum as the plain twin does and equals it
// bit for bit; the shared-memory routes keep nvcc's contraction.
//
// PCR variants of the first design (pcr_v, pcr_s; the reference's
// adi_fused.py:396-419, :438-466, :495-546): a sweep becomes parallel
// cyclic reduction, log2 n levels of whole-grid updates
// rr = rr + alpha rr[-s] + beta rr[+s] with all threads busy and a barrier
// per level, then one multiply by 1/d.  The level coefficients are computed
// once before the march: alpha and beta for each level and the final 1/d,
// per (j, option) for v (2 levels_v nv + nv floats, in the c2/inv2 slots)
// and per (i, j, option) for S (2 levels_S nS nv + nS nv).  The level
// recurrence itself ping-pongs six band arrays through WORK.
//
// Layout: option-major and contiguous, (B, nS, nv) for every grid field,
// (B, 3, nv) for the band triples [lo, di, up], (B, nv) for mix, c2 and
// inv2 (c2: (B, 2 levels_v nv) with pcr_v), (B, nS) for the payoff and the
// spot grid, (B, 8) for the scalars dt, r, q, K, is_call, american;
// SAB (B, 2 levels_S nS nv) and SINVD (B, nS nv) with pcr_s; WORK
// (B, 6 nS nv) with pcr_s, else (B, 6 nv) with pcr_v.  The shared-memory
// route takes the inputs, V and, with pcr_s, TAB.  The kernels allocate
// nothing and do not synchronise; they run on the caller's stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "lane_scan.cuh"

namespace {

constexpr int kThreads = 128;       // first design: one thread per line
constexpr int kSmemThreads = 512;   // shared-memory design: g lanes per line
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
// arithmetic as the reference (adi_fused.py:396-419, :438-466).  Every
// thread of the block calls it (the first design's 128, or the
// shared-memory route's 512 for the v system).
__device__ void pcr_factor(float* W, int m, int n, int stride, float* AB,
                           float* INVD) {
  const int tid = threadIdx.x;
  float *lo = W, *up = W + m, *di = W + 2 * m;
  float *lo2 = W + 3 * m, *up2 = W + 4 * m, *di2 = W + 5 * m;
  const int levels = pcr_levels(n);
  for (int lev = 0; lev < levels; ++lev) {
    const int s = 1 << lev;
    for (int k = tid; k < m; k += blockDim.x) {
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
  for (int k = tid; k < m; k += blockDim.x) INVD[k] = 1.f / di[k];
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

// Floats of the PCR S sweep's coefficient double buffer: two levels of
// alpha and beta for each S-sweep thread's chunk of cs rows, and room for
// the three bands the factorisation ping-pongs before the march (wrapper:
// ops/adi_fused._pcr_buffer).
__device__ __forceinline__ int pcr_buffer_floats(int nS, int ps, int cs, int nthr) {
  return max(4 * cs * nthr, 3 * nS * ps);
}

// Stream this thread's alpha and beta of one level (rows r < rows of its
// chunk) from the table into a slot of the double buffer, 4 bytes a copy;
// a warp's copies of one row read 32 consecutive floats.
__device__ __forceinline__ void fetch_level(float* slot, const float* level, int rows,
                                            int cs, int nthr, int tid) {
  for (int r = 0; r < rows; ++r) {
    __pipeline_memcpy_async(slot + r * nthr + tid, level + r * nthr + tid, sizeof(float));
    __pipeline_memcpy_async(slot + (cs + r) * nthr + tid, level + (cs + r) * nthr + tid,
                            sizeof(float));
  }
}

// kPcrS: the S sweep is PCR (the reference's adi_fused.py:396-419,
// :495-504) on the level coefficients in TAB, else the lane-group Thomas
// scan.  kPcrV: the v sweep is PCR (:438-466, :536-546) on level
// coefficients in shared memory, else the lane-group Thomas scan.  The
// stencil and the boundary update are shared.
template <bool kPcrS, bool kPcrV>
__global__ void __launch_bounds__(kSmemThreads, kPcrS ? 1 : 2)
douglas_march_smem(const float* __restrict__ pay, const float* __restrict__ sg,
                   const float* __restrict__ a1, const float* __restrict__ i1,
                   const float* __restrict__ a2, const float* __restrict__ i2,
                   const float* __restrict__ mix, const float* __restrict__ sc,
                   float* __restrict__ Vout, float* __restrict__ TAB, int nS, int nv,
                   int nT, int ps, int gs, int gv, int use_it) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int np = nS * ps;
  const int cs = (nS + gs - 1) / gs, cv = (nv + gv - 1) / gv;
  const int nthr = nv * gs;  // threads of the S sweep (one round with kPcrS)
  const int levels = pcr_levels(nS);
  const int lev_floats = 2 * cs * nthr;  // alpha and beta of one level
  float* V = sm;
  float* R = V + np;
  float* INV1 = R + np;    // 1/pivot of the S system; with kPcrS the final 1/d
  float* LAM = INV1 + np;  // np floats with use_it, else none
  float* PP = LAM + (use_it ? np : 0);  // kPcrS: the ping-pong grid
  float* CB = PP + (kPcrS ? np : 0);    // kPcrS: the coefficient double buffer
  float* A1 = CB + (kPcrS ? pcr_buffer_floats(nS, ps, cs, nthr) : 0);
  float* I1 = A1 + 3 * nv;
  float* A2 = I1 + 3 * nv;
  float* I2 = A2 + 3 * nv;
  float* MIX = I2 + 3 * nv;
  const int levels_v = pcr_levels(nv);
  float* C2 = MIX + nv;   // kPcrV: alpha, beta of each v level (pcr_factor's AB)
  float* IV2 = C2 + (kPcrV ? 2 * levels_v * nv : nv);  // kPcrV: the final 1/d
  float* PAY = IV2 + nv;
  float* SG = PAY + nS;
  if (kPcrS) TAB += b * levels * lev_floats;

  for (int k = tid; k < 3 * nv; k += kSmemThreads) {
    A1[k] = a1[b * 3 * nv + k];
    I1[k] = i1[b * 3 * nv + k];
    A2[k] = a2[b * 3 * nv + k];
    I2[k] = i2[b * 3 * nv + k];
  }
  for (int k = tid; k < nv; k += kSmemThreads) MIX[k] = mix[b * nv + k];
  for (int k = tid; k < nS; k += kSmemThreads) {
    PAY[k] = pay[b * nS + k];
    SG[k] = sg[b * nS + k];
  }
  const float dt = sc[b * 8 + 0], r = sc[b * 8 + 1], q = sc[b * 8 + 2];
  const float K = sc[b * 8 + 3];
  const bool is_call = sc[b * 8 + 4] > 0.5f;
  const bool amer = sc[b * 8 + 5] > 0.5f;
  const float *a1L = A1, *a1D = A1 + nv, *a1U = A1 + 2 * nv;
  const float *i1L = I1, *i1D = I1 + nv, *i1U = I1 + 2 * nv;
  const float *a2L = A2, *a2D = A2 + nv, *a2U = A2 + 2 * nv;
  const float *i2L = I2, *i2D = I2 + nv, *i2U = I2 + 2 * nv;
  const int lane_s = tid % gs, lane_v = tid % gv;
  __syncthreads();

  if (kPcrS) {
    // S-system PCR levels, each column's by its lane group (the arithmetic
    // of pcr_factor), rows 0 and nS-1 identity.  lo, up, di ping-pong
    // through V, R, PP and CB, free until the march; alpha and beta go to
    // TAB in the order the march streams them, 1/d to INV1.
    const int j = tid / gs;
    const int i_beg = min(nS, lane_s * cs);
    const int i_end = j < nv ? min(nS, i_beg + cs) : i_beg;
    float *lo = V, *up = R, *di = PP, *lo2 = CB, *up2 = CB + np, *di2 = CB + 2 * np;
    for (int i = i_beg; i < i_end; ++i) {
      const float mi = (i > 0 && i < nS - 1) ? 1.f : 0.f;
      lo[i * ps + j] = i1L[j] * mi;
      up[i * ps + j] = i1U[j] * mi;
      di[i * ps + j] = i1D[j] * mi + (1.f - mi);
    }
    __syncwarp();
    for (int lev = 0; lev < levels; ++lev) {
      const int s = 1 << lev, sp = s * ps;
      float* tab = TAB + lev * lev_floats;
      for (int i = i_beg; i < i_end; ++i) {
        const int k = i * ps + j, row = i - i_beg;
        const bool has_lo = i >= s, has_hi = i < nS - s;
        const float in_lo = has_lo ? 1.f : 0.f, in_hi = has_hi ? 1.f : 0.f;
        const float d_dn = (has_lo ? di[k - sp] : 0.f) + (1.f - in_lo);
        const float d_up = (has_hi ? di[k + sp] : 0.f) + (1.f - in_hi);
        const float alpha = -(lo[k] * in_lo) / d_dn;
        const float beta = -(up[k] * in_hi) / d_up;
        tab[row * nthr + tid] = alpha;
        tab[(cs + row) * nthr + tid] = beta;
        lo2[k] = alpha * (has_lo ? lo[k - sp] : 0.f);
        up2[k] = beta * (has_hi ? up[k + sp] : 0.f);
        di2[k] = di[k] + alpha * (has_lo ? up[k - sp] : 0.f) +
                 beta * (has_hi ? lo[k + sp] : 0.f);
      }
      __syncwarp();
      float* t;
      t = lo; lo = lo2; lo2 = t;
      t = up; up = up2; up2 = t;
      t = di; di = di2; di2 = t;
    }
    for (int i = i_beg; i < i_end; ++i) INV1[i * ps + j] = 1.f / di[i * ps + j];
    __syncthreads();  // the scratch is free again; TAB is written
  } else {
    // S-system reciprocal pivots, one thread per column j; rows 0 and nS-1
    // are identity (inv = 1, c = 0).  The arithmetic of the first design.
    for (int j = tid; j < nv; j += kSmemThreads) {
      INV1[j] = 1.f;
      float c = 0.f;
      for (int i = 1; i < nS - 1; ++i) {
        const float inv = 1.f / (i1D[j] - i1L[j] * c);
        c = i1U[j] * inv;
        INV1[i * ps + j] = inv;
      }
      INV1[(nS - 1) * ps + j] = 1.f;
    }
  }

  if (kPcrV) {
    // v-system PCR levels, kept in shared memory for the march; lo, up, di
    // ping-pong through V and R (6 nv floats), free until the march
    for (int j = tid; j < nv; j += kSmemThreads) {
      V[j] = i2L[j];
      V[nv + j] = i2U[j];
      V[2 * nv + j] = i2D[j];
    }
    __syncthreads();
    pcr_factor(V, nv, nv, 1, C2, IV2);
  }

  // V starts at the payoff (constant along v); lambda at zero
  for (int k = tid; k < nS * nv; k += kSmemThreads) {
    const int i = k / nv, j = k - i * nv;
    V[i * ps + j] = PAY[i];
    if (use_it) LAM[i * ps + j] = 0.f;
  }
  // v-system Thomas factors by one thread of the last warp, as the first
  // design
  if (!kPcrV && tid == kSmemThreads - 32) {
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
  // kPcrS: this thread's rows of level 0 on their way to slot 0
  const int s_rows = max(0, min(nS - lane_s * cs, cs));
  const int my_rows = kPcrS && tid < nthr ? s_rows : 0;
  if (kPcrS) {
    fetch_level(CB, TAB, my_rows, cs, nthr, tid);
    __pipeline_commit();
  }
  __syncthreads();

  const float dt_a1 = (1.f - kTheta) * dt;
  const float th_dt = kTheta * dt;
  int seq = 0;  // kPcrS: levels streamed so far; level seq sits in slot seq % 2

  for (int step = 0; step < nT; ++step) {
    // 1-2. explicit rhs and the implicit S sweep, gs lanes per column j
    for (int base = 0; base < nv; base += kSmemThreads / gs) {
      const int j = base + tid / gs;
      const bool act = j < nv;
      const int i_beg = min(nS, lane_s * cs);
      const int i_end = act ? min(nS, i_beg + cs) : i_beg;
      const bool lo_j = j > 0, hi_j = j < nv - 1;
      const float l = act ? i1L[j] : 0.f, u = act ? i1U[j] : 0.f;
      // pass 1: rhs = V + dt A0 V + (1-th) dt A1 V + dt A2 V (+ dt lambda)
      // into R, and (Thomas) the chunk's forward-sweep map
      float P = 1.f, Q = 0.f;
      for (int i = i_beg; i < i_end; ++i) {
        const int k = i * ps + j;
        const float v = V[k];
        const float a2v = a2D[j] * v + a2L[j] * (lo_j ? V[k - 1] : 0.f) +
                          a2U[j] * (hi_j ? V[k + 1] : 0.f);
        float a0v = 0.f, a1v = 0.f;
        const bool inner = i > 0 && i < nS - 1;
        if (inner) {  // A1 and A0 act on interior rows only
          const float* up = V + k + ps;
          const float* dn = V + k - ps;
          const float vxv = (hi_j ? up[1] : 0.f) - (lo_j ? up[-1] : 0.f) -
                            (hi_j ? dn[1] : 0.f) + (lo_j ? dn[-1] : 0.f);
          a0v = MIX[j] * vxv;
          a1v = a1D[j] * v + a1L[j] * dn[0] + a1U[j] * up[0];
        }
        float acc = v + dt * a0v;
        acc = acc + dt_a1 * a1v;
        acc = acc + dt * a2v;
        if (use_it) acc = acc + dt * LAM[k];
        R[k] = acc;
        if (!kPcrS) {
          const float li = inner ? l : 0.f;
          const float inv = INV1[k];
          Q = (acc - li * Q) * inv;
          P = -(li * P) * inv;
        }
      }
      if (kPcrS) {
        // the PCR levels rr_i += alpha_i rr_{i-s} + beta_i rr_{i+s}, R and
        // PP in turns, the lanes of the column in one warp; each level's
        // coefficients arrived while the level before ran, and the next
        // level's (after the last, the next step's first) start now
        __syncwarp();
        float *src = R, *dst = PP;
        for (int lev = 0; lev < levels; ++lev, ++seq) {
          if (seq + 1 < nT * levels) {
            const int nxt = lev + 1 < levels ? lev + 1 : 0;
            fetch_level(CB + ((seq + 1) & 1) * lev_floats, TAB + nxt * lev_floats, my_rows,
                        cs, nthr, tid);
          }
          __pipeline_commit();
          __pipeline_wait_prior(1);
          const float* alpha = CB + (seq & 1) * lev_floats;
          const float* beta = alpha + cs * nthr;
          const int s = 1 << lev, sp = s * ps;
          for (int i = i_beg; i < i_end; ++i) {
            const int k = i * ps + j, e = (i - i_beg) * nthr + tid;
            const float dn = i >= s ? src[k - sp] : 0.f;
            const float up = i < nS - s ? src[k + sp] : 0.f;
            dst[k] = src[k] + alpha[e] * dn + beta[e] * up;
          }
          __syncwarp();
          float* t = src;
          src = dst;
          dst = t;
        }
        for (int i = i_beg; i < i_end; ++i) R[i * ps + j] = src[i * ps + j] * INV1[i * ps + j];
      } else {
        // pass 2: the forward sweep d_i = (R_i - l d_{i-1}) inv_i, in place
        float d = scan_entry(P, Q, gs, lane_s, false);
        for (int i = i_beg; i < i_end; ++i) {
          const int k = i * ps + j;
          const float li = (i > 0 && i < nS - 1) ? l : 0.f;
          d = (R[k] - li * d) * INV1[k];
          R[k] = d;
        }
        // passes 3-4: the back substitution y_i = d_i - c_i y_{i+1}, in place
        P = 1.f;
        Q = 0.f;
        for (int i = i_end - 1; i >= i_beg; --i) {
          const int k = i * ps + j;
          const float ci = (i > 0 && i < nS - 1) ? u * INV1[k] : 0.f;
          Q = R[k] - ci * Q;
          P = -(ci * P);
        }
        float y = scan_entry(P, Q, gs, lane_s, true);
        for (int i = i_end - 1; i >= i_beg; --i) {
          const int k = i * ps + j;
          const float ci = (i > 0 && i < nS - 1) ? u * INV1[k] : 0.f;
          y = R[k] - ci * y;
          R[k] = y;
        }
      }
    }
    __syncthreads();

    // 3-5. rhs2 = Y1 - th dt A2 V, the implicit v sweep, then the
    // Ikonen-Toivanen update, the Dirichlet rows (i = 0, i = nS-1, then
    // j = nv-1) at tau and the American floor, gv lanes per row i
    const float tau = dt * static_cast<float>(step + 1);
    const float dfr = expf(-r * tau);
    const float dfq = expf(-q * tau);
    // V's new value at (i, j) from the sweep's solution y: the
    // Ikonen-Toivanen update, the Dirichlet rows, the American floor
    auto settle = [&](int i, int j, float y) {
      const float g = PAY[i];
      float vn = y;
      if (use_it && amer) {
        // V_new - dt lam_new = Vn - dt lam, V_new >= g, lam_new >= 0
        const float w = vn - dt * LAM[i * ps + j];
        const float v_it = fmaxf(g, w);
        LAM[i * ps + j] = (v_it - w) / dt;
        vn = v_it;
      }
      if (i == 0) vn = is_call ? 0.f : K * dfr - SG[0] * dfq;
      if (i == nS - 1) vn = is_call ? SG[nS - 1] * dfq - K * dfr : 0.f;
      if (j == nv - 1) vn = is_call ? SG[i] * dfq : K * dfr;
      // projection: clamp flagged options everywhere; IT: the Dirichlet
      // edges are European, floor flagged options there
      const bool edge = i == 0 || i == nS - 1 || j == 0 || j == nv - 1;
      if (amer && (!use_it || edge)) vn = fmaxf(vn, g);
      return vn;
    };
    for (int base = 0; base < nS; base += kSmemThreads / gv) {
      const int i = base + tid / gv;
      const bool act = i < nS;
      const int j_beg = min(nv, lane_v * cv);
      const int j_end = act ? min(nv, j_beg + cv) : j_beg;
      float* Vi = V + i * ps;
      float* Ri = R + i * ps;
      if (kPcrV) {
        // the right-hand side into R; then the levels, R and the row of PP
        // (with kPcrS) or of V in turns, the row's lanes in one warp; then
        // 1/d and the boundary update into V
        for (int j = j_beg; j < j_end; ++j) {
          const float a2v = a2D[j] * Vi[j] + a2L[j] * (j > 0 ? Vi[j - 1] : 0.f) +
                            a2U[j] * (j < nv - 1 ? Vi[j + 1] : 0.f);
          Ri[j] = Ri[j] - th_dt * a2v;
        }
        __syncwarp();  // every lane has read its row's V before any writes it
        float* src = Ri;
        float* dst = (kPcrS ? PP : V) + i * ps;
        for (int lev = 0; lev < levels_v; ++lev) {
          const int s = 1 << lev;
          const float* alpha = C2 + 2 * lev * nv;
          const float* beta = alpha + nv;
          for (int j = j_beg; j < j_end; ++j) {
            const float dn = j >= s ? src[j - s] : 0.f;
            const float up = j < nv - s ? src[j + s] : 0.f;
            dst[j] = src[j] + alpha[j] * dn + beta[j] * up;
          }
          __syncwarp();
          float* t = src;
          src = dst;
          dst = t;
        }
        for (int j = j_beg; j < j_end; ++j) Vi[j] = settle(i, j, src[j] * IV2[j]);
        continue;
      }
      float P = 1.f, Q = 0.f;
      for (int j = j_beg; j < j_end; ++j) {
        const float a2v = a2D[j] * Vi[j] + a2L[j] * (j > 0 ? Vi[j - 1] : 0.f) +
                          a2U[j] * (j < nv - 1 ? Vi[j + 1] : 0.f);
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
        Vi[j] = settle(i, j, y);
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < nS * nv; k += kSmemThreads) {
    const int i = k / nv, j = k - i * nv;
    Vout[b * nS * nv + k] = V[i * ps + j];
  }
}

template <bool kPcrS, bool kPcrV>
int launch_smem(const float* pay, const float* sg, const float* a1, const float* i1,
                const float* a2, const float* i2, const float* mix, const float* sc,
                float* V, float* TAB, int B, int nS, int nv, int nT, int ps, int gs,
                int gv, int use_it, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(douglas_march_smem<kPcrS, kPcrV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    douglas_march_smem<kPcrS, kPcrV><<<B, kSmemThreads, smem_bytes, stream>>>(
        pay, sg, a1, i1, a2, i2, mix, sc, V, TAB, nS, nv, nT, ps, gs, gv, use_it);
  }
  return static_cast<int>(cudaGetLastError());
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

// The shared-memory route: inputs as above, V (B, nS, nv) the output; with
// pcr_s the S sweep is PCR and TAB (B, levels_S, 2, cs, nv gs) receives the
// level coefficients (null without pcr_s); with pcr_v the v sweep is PCR;
// ps the padded row stride, gs and gv the lanes per S column and per v row
// (powers of two up to 32; with pcr_s nv gs <= 512), smem_bytes the
// block's dynamic shared memory (at most 227 KB).  Returns the first CUDA
// error of the attribute call or the launch (0 = launched).
extern "C" int pde_adi_fused_batched_smem(const float* pay, const float* sg,
                                          const float* a1, const float* i1,
                                          const float* a2, const float* i2,
                                          const float* mix, const float* sc,
                                          float* V, float* TAB, int B, int nS,
                                          int nv, int nT, int ps, int gs, int gv,
                                          int use_it, int pcr_s, int pcr_v,
                                          int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pcr_s && pcr_v)
    return launch_smem<true, true>(pay, sg, a1, i1, a2, i2, mix, sc, V, TAB, B, nS, nv, nT,
                                   ps, gs, gv, use_it, smem_bytes, s);
  if (pcr_s)
    return launch_smem<true, false>(pay, sg, a1, i1, a2, i2, mix, sc, V, TAB, B, nS, nv, nT,
                                    ps, gs, gv, use_it, smem_bytes, s);
  if (pcr_v)
    return launch_smem<false, true>(pay, sg, a1, i1, a2, i2, mix, sc, V, TAB, B, nS, nv, nT,
                                    ps, gs, gv, use_it, smem_bytes, s);
  return launch_smem<false, false>(pay, sg, a1, i1, a2, i2, mix, sc, V, TAB, B, nS, nv, nT,
                                   ps, gs, gv, use_it, smem_bytes, s);
}
