// Fused 1D theta-scheme march with constant coefficients, for a book of
// options, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pde_tpu/ops/cn1d_fused.py:fused_cn_march_1d
// (Pallas, batch on the 128 vector lanes).  Computes what it computes: the
// whole backward march of a Black-Scholes book in one launch.  In log-spot
// coordinates on K-scaled grids the operator of an option is three scalars
// (L_m, L_c, L_p), so the implicit matrix is factored once, before the march
// (row 0 identity, the last row identity).  Each step then runs the explicit
// part, the factored sweep, the Dirichlet rows at tau = dt (k+1) with both
// discounts, and the American floor.  The plain PyTorch version with the
// same step order is pde_tpu_torch/ops/cn1d_fused.py:_fused_cn_march_1d_plain.
//
// What bounds it on the H100: arithmetic, in the count that the roofline
// sees.  At 200 x 100 and B = 512 the march moves under 1 MB (payoff, scalars
// and the result; 0.25 us at 3.35 TB/s) and does ~15 flops a node a step,
// 1.5e8 in all (2.3 us at 67 TFLOP/s).  In practice the serial chain binds:
// each step is 2 (n - 1) dependent multiply-adds per option, about 40,000
// links for the march, walked in order by one thread.
//
// What this design does about it: one thread per option, coalesced row
// accesses across a warp in the batch-last layout; the factorisation (c and
// the reciprocal pivots) is done once, so each link of the chain is a load,
// a multiply, a subtract and a multiply with no division; the explicit
// stencil rides the forward sweep (V[i-1], V[i], V[i+1] rolling in
// registers) and the Dirichlet rows and the floor ride the back
// substitution.  The scratch (c, 1/pivot and d, (n, B) each, 1.2 MB at the
// bench shape) stays in L2.  Trade-off: one warp per block, so a 512-option
// book fills 16 warps on 16 of the 132 SMs.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin.  With FMA contraction, the only
// arithmetic difference, the kernel sat 1.09x past the kernel-vs-twin gate
// (1e-5 + 1e-4 |plain|) on the bench book at w = 1 on an H100: the float32
// march's own round-off is of the gate's size there.
//
// Layout: batch last and contiguous.  pay (n, B); sc (12, B) = dt, r, q, K,
// is_call, american, L_m, L_c, L_p, s_min, s_max, 0; V (n, B) is the output;
// C, INV and D (n, B) are scratch.  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
cn_march_const(const float* __restrict__ pay, const float* __restrict__ sc,
               float* __restrict__ V, float* __restrict__ C,
               float* __restrict__ INV, float* __restrict__ D, int n, int nT,
               int B, float w) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = B;
  pay += b;
  V += b;
  C += b;
  INV += b;
  D += b;
  const float dt = sc[0 * sB + b], r = sc[1 * sB + b], q = sc[2 * sB + b];
  const float K = sc[3 * sB + b], call_f = sc[4 * sB + b];
  const float amer_f = sc[5 * sB + b];
  const float Lm = sc[6 * sB + b], Lc = sc[7 * sB + b], Lp = sc[8 * sB + b];
  const float s_lo = sc[9 * sB + b], s_hi = sc[10 * sB + b];
  const float wdt = w * dt;
  const float ewdt = (1.f - w) * dt;

  // implicit bands on interior rows; factor ONCE.  Rows 0 and n-1 are
  // identity (c = 0, 1/pivot = 1): the sweeps below handle them without
  // reading their factors
  const float li = -wdt * Lm;
  const float di = 1.f - wdt * Lc;
  const float ui = -wdt * Lp;
  float c = 0.f;
  for (int i = 1; i < n - 1; ++i) {
    const float inv = 1.f / (di - li * c);
    c = ui * inv;
    C[i * sB] = c;
    INV[i * sB] = inv;
  }

  for (int i = 0; i < n; ++i) V[i * sB] = pay[i * sB];

  for (int k = 0; k < nT; ++k) {
    // explicit part fused into the factored forward sweep; row 0 keeps V
    float v_m = V[0];
    float v_c = V[sB];
    float d = v_m;
#pragma unroll 4
    for (int i = 1; i < n - 1; ++i) {
      const float v_p = V[(i + 1) * sB];
      float lv = Lm * v_m + Lc * v_c;
      lv = lv + Lp * v_p;
      const float rhs = v_c + ewdt * lv;
      d = (rhs - li * d) * INV[i * sB];
      D[i * sB] = d;
      v_m = v_c;
      v_c = v_p;
    }
    // the last row is identity: the solution there is rhs = V[n-1]
    float y = v_c;
    const float tau = dt * static_cast<float>(k + 1);
    const float dfr = expf(-r * tau);
    const float dfq = expf(-q * tau);
    const float bc0 = (1.f - call_f) * (K * dfr - s_lo * dfq);
    const float bcN = call_f * (s_hi * dfq - K * dfr);
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
extern "C" int pde_cn1d_fused(const float* pay, const float* sc, float* V,
                              float* C, float* INV, float* D, int B, int n,
                              int nT, float w, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    cn_march_const<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pay, sc, V, C, INV, D, n, nT, B, w);
  }
  return static_cast<int>(cudaGetLastError());
}
