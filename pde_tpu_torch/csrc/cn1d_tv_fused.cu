// Fused 1D theta-scheme march with time-varying coefficients, for a book of
// options, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pde_tpu/ops/cn1d_tv_fused.py:fused_cn_march_1d_tv
// (Pallas, both its VMEM-resident and its HBM-streamed variants).  Computes
// what it computes: the whole backward march of a local-vol book in one
// launch.  Each step k: the explicit part on interior rows at band level k,
// the implicit operator at level k+1 (boundary rows identity), a Thomas
// factorisation fused with the forward sweep (the operator changes every
// step), the back substitution, the Dirichlet rows at tau = dt (k+1) with
// both discounts, and the American floor.  The plain PyTorch version with the
// same step order is
// pde_tpu_torch/ops/cn1d_tv_fused.py:_fused_cn_march_1d_tv_plain.
//
// What bounds it on the H100: the band lattice, read once.  At 200 x 100 and
// B = 256 it is 101 levels x 600 rows x 256 options x 4 B = 62 MB, which
// takes 19 us at 3.35 TB/s; the arithmetic (~25 flops a node a step, 1.3e8
// in all) takes 2 us at 67 TFLOP/s.  In practice the serial chain binds
// first: each step is 2 (n - 2) dependent links per option (pivot division,
// then multiply-adds), about 40,000 links for the march, and one thread has
// to walk them in order.
//
// What this design does about it: one thread per option, so every row access
// is coalesced across a warp in the batch-last layout (no permute), and each
// step's bands stream through exactly once.  The explicit stencil is fused
// into the forward sweep (rolling V[i-1], V[i], V[i+1] in registers), and the
// Dirichlet rows and the floor into the back substitution, so a step is two
// passes over the rows.  The pivot is a true IEEE reciprocal, not the TPU's
// rsqrt(den)^2, so the reference's M-matrix condition on that trick does not
// apply here.  The scratch (c and d, (n, B) each, 0.4 MB at the bench shape)
// stays in L2.  Trade-off: one warp per block, so a 256-option book fills 8
// warps on 8 of the 132 SMs; spreading one option's chain over a warp
// (cyclic reduction) is later work.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin; the float32 march's own round-off
// is of the size of the kernel-vs-twin gate (see cn1d_fused.cu).
//
// Layout: batch last and contiguous.  pay (n, B); bands (nT+1, 3n, B) with
// rows [L_m; L_c; L_p] per level, level k at calendar time T - k dt; sc
// (8, B) = dt, r, q, K, is_call, american, s_min, s_max; V (n, B) is the
// output; C and D (n, B) are scratch.  The kernel allocates nothing and does
// not synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
cn_march_tv(const float* __restrict__ pay, const float* __restrict__ bands,
            const float* __restrict__ sc, float* __restrict__ V,
            float* __restrict__ C, float* __restrict__ D, int n, int nT, int B,
            float w) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = B;
  pay += b;
  V += b;
  C += b;
  D += b;
  const float dt = sc[0 * sB + b], r = sc[1 * sB + b], q = sc[2 * sB + b];
  const float K = sc[3 * sB + b], call_f = sc[4 * sB + b];
  const float amer_f = sc[5 * sB + b];
  const float s_lo = sc[6 * sB + b], s_hi = sc[7 * sB + b];
  const float wdt = w * dt;
  const float ewdt = (1.f - w) * dt;
  const size_t level = 3 * static_cast<size_t>(n) * sB;

  for (int i = 0; i < n; ++i) V[i * sB] = pay[i * sB];

  for (int k = 0; k < nT; ++k) {
    const float* Lo = bands + k * level + b;  // explicit side, level k
    const float* Ln = Lo + level;             // implicit side, level k+1
    // row 0 is identity: c = 0, d = rhs = V[0] (kept in registers; the
    // back substitution stops at row 1)
    float v_m = V[0];
    float v_c = V[sB];
    float c = 0.f, d = v_m;
    // explicit part fused into the factorisation and forward sweep
#pragma unroll 4
    for (int i = 1; i < n - 1; ++i) {
      const float v_p = V[(i + 1) * sB];
      float lv = Lo[i * sB] * v_m + Lo[(n + i) * sB] * v_c;
      lv = lv + Lo[(2 * n + i) * sB] * v_p;
      const float rhs = v_c + ewdt * lv;
      const float li = -wdt * Ln[i * sB];
      const float di = 1.f - wdt * Ln[(n + i) * sB];
      const float ui = -wdt * Ln[(2 * n + i) * sB];
      const float piv = 1.f / (di - li * c);
      c = ui * piv;
      d = (rhs - li * d) * piv;
      C[i * sB] = c;
      D[i * sB] = d;
      v_m = v_c;
      v_c = v_p;
    }
    // Dirichlet values at tau (both discounts), then the American floor
    const float tau = dt * static_cast<float>(k + 1);
    const float dfr = expf(-r * tau);
    const float dfq = expf(-q * tau);
    const float bc0 = (1.f - call_f) * (K * dfr - s_lo * dfq);
    const float bcN = call_f * (s_hi * dfq - K * dfr);
    // row n-1 is identity: the solution there is rhs = V[n-1]; the back
    // substitution runs on it before the Dirichlet row replaces it
    float y = v_c;
    float g = pay[(n - 1) * sB];
    V[(n - 1) * sB] = bcN + amer_f * (fmaxf(bcN, g) - bcN);
#pragma unroll 4
    for (int i = n - 2; i >= 1; --i) {
      y = D[i * sB] - C[i * sB] * y;
      g = pay[i * sB];
      V[i * sB] = y + amer_f * (fmaxf(y, g) - y);
    }
    g = pay[0];
    V[0] = bc0 + amer_f * (fmaxf(bc0, g) - bc0);
  }
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers of float32
// tensors in the layout above.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int pde_cn1d_tv_fused(const float* pay, const float* bands,
                                 const float* sc, float* V, float* C, float* D,
                                 int B, int n, int nT, float w, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    cn_march_tv<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pay, bands, sc, V, C, D, n, nT, B, w);
  }
  return static_cast<int>(cudaGetLastError());
}
