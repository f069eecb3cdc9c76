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
// What this design does about it (cn_march_const_warp, the default route):
// * One warp per option for the whole march, kTile = 4 options (warps) to
//   a block: a 512-option book is 128 blocks, one an SM.  Every warp walks
//   a latency-bound chain, so an SM's issue slots are mostly free: 1, 2 and
//   4 options a block run the book in the same time on an H100, 8 (64
//   blocks, two warps a sub-partition) ~10% slower
//   (scripts/torch_k4_k6_routes.py builds and times each).
// * Lane l holds the contiguous rows [l ch, (l+1) ch), ch = ceil(n / 32)
//   (7 at n = 200; at small n the last lanes hold one row or none), and
//   keeps its rows of V, the payoff, c and 1/pivot in registers for the
//   whole march: no device-memory scratch.  The payoff is read once and
//   V(t=0) written once through a shared-memory tile of the block's
//   options, so the batch-last (n, B) arrays are read and written in place.
// * Factor once, while the payoff's loads are in flight: each lane walks
//   the pivot chain c_i = u / (d - l c_{i-1}) with the twin's serial
//   arithmetic up to its chunk, then factors its own rows, so the factors
//   equal the twin's bit for bit.  The chain is the same float function
//   of c at every interior row and contracts, so it reaches a float fixed
//   point within some tens of rows; once c_i == c_{i-1}, every later c and
//   1/pivot equal these exactly, and the walk stops there.  Walked to the
//   end, the chain took ~10% of the march at n = 200; a Moebius-map scan of
//   it (as in cn1d_tv_fused.cu) cut that too, but left the factors entering
//   each chunk off the twin's, enough to put the march 1.26x past the
//   kernel-vs-twin gate at w = 1 (scripts/torch_k4_k6_routes.py).
// * Each step: the Dirichlet values (off the chain); the explicit stencil
//   on the lane's rows, its two chunk-edge neighbours by one __shfl_up_sync
//   and one __shfl_down_sync; the forward sweep and the back substitution
//   as affine recurrences x_i = A_i x_{i-1} + B_i solved over the warp:
//   each lane composes its chunk's map x -> P x + Q, a 5-level shuffle scan
//   gives it the value entering its chunk, and the lane walks the chunk
//   with the twin's arithmetic.  The operator is constant, so A_i (-l /
//   pivot_i forward, -c_i backward) and with it every P the scans take are
//   the same each step: they are composed once, before the march, and each
//   step scans Q alone (one shuffle a level).  A row's d is alpha_i +
//   beta_i x, x the value entering the chunk, alpha_i the walk from 0 (the
//   forward map's Q on the way) and beta_i constant; so the back map's Q is
//   the back composition of the alphas (formed while the forward scan
//   runs) plus a constant times x, and the back scan starts as soon as x is
//   known, while the forward walk runs beside it.  Then the back walk, the
//   Dirichlet rows and the American floor, in registers.  The chain a step
//   falls from 2 (n - 1) links to about 2 ch links and 2 x 5 scan levels.
// * Every slot runs every loop without a branch: rows past n are slots that
//   pass both sweeps' values through exactly.
//
// The first design (cn_march_const: one thread per option, 32 to a block,
// c, 1/pivot and d in device-memory scratch (n, B) each, every link of the
// serial chain a load, a multiply, a subtract and a multiply) stays for
// lattices whose chunk exceeds the warp route's register chunk (kMaxCh = 16
// rows: n > 512), chosen by the wrapper from n.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin.  With FMA contraction, the only
// arithmetic difference, the first design sat 1.09x past the
// kernel-vs-twin gate (1e-5 + 1e-4 |plain|) on the bench book at w = 1 on
// an H100: the float32 march's own round-off is of the gate's size there.
// The first design equals the twin bit for bit; the warp route's factors
// equal the twin's, and it walks each chunk as the twin does, but composes
// the values entering each chunk in another order.
//
// Layout: batch last and contiguous.  pay (n, B); sc (12, B) = dt, r, q, K,
// is_call, american, L_m, L_c, L_p, s_min, s_max, 0; V (n, B) is the output;
// the first design's C, INV and D (n, B) are scratch.  The kernels allocate
// nothing and do not synchronise; they run on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // first design: one thread per option
constexpr int kTile = 4;      // warp route: options (warps) a block
constexpr int kMaxCh = 16;    // warp route: at most this many rows a lane (n <= 512)
constexpr unsigned kFull = 0xffffffffu;

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


// The P that each level of the warp's inclusive scan of affine maps x -> P x
// + Q takes, in lane order (forward) or in reverse: lev[k] is this lane's P
// before level k.  They depend on the operator alone, so the march composes
// them once.
__device__ __forceinline__ void scan_levels(float P, float (&lev)[5], int lane,
                                            bool reverse) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int off = 1 << k;
    lev[k] = P;
    const float Pn = reverse ? __shfl_down_sync(kFull, P, off)
                             : __shfl_up_sync(kFull, P, off);
    if (reverse ? lane + off < 32 : lane >= off) P = P * Pn;
  }
}

// Value entering this lane's chunk: the scan of the chunks' maps with their
// P known (scan_levels), applied to 0 and taken from the neighbouring lane;
// one shuffle a level.
__device__ __forceinline__ float scan_q(float Q, const float (&lev)[5], int lane,
                                        bool reverse) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int off = 1 << k;
    const float Qn = reverse ? __shfl_down_sync(kFull, Q, off)
                             : __shfl_up_sync(kFull, Q, off);
    if (reverse ? lane + off < 32 : lane >= off) Q = lev[k] * Qn + Q;
  }
  const float x = reverse ? __shfl_down_sync(kFull, Q, 1) : __shfl_up_sync(kFull, Q, 1);
  return (reverse ? lane + 1 < 32 : lane >= 1) ? x : 0.f;
}

// The warp route: one warp per option, CH >= ceil(n / 32) register slots a
// lane; kTile options a block, their payoff and result staged through
// `tile` (kTile x n floats of dynamic shared memory).
template <int CH>
__global__ void __launch_bounds__(kTile * 32)
cn_march_const_warp(const float* __restrict__ pay, const float* __restrict__ sc,
                    float* __restrict__ Vout, int n, int nT, int B, float w) {
  extern __shared__ float tile[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * kTile;
  const int live = min(kTile, B - b0);
  const size_t sB = B;
  const bool on = warp < live;  // this warp has an option
  const int b = b0 + (on ? warp : 0);
  // this lane's rows [i0, i0 + cnt)
  const int ch = (n + 31) / 32;
  const int i0 = min(n, lane * ch);
  const int cnt = min(n, i0 + ch) - i0;
  // the payoff of the block's options, ch values a thread (consecutive
  // threads read one row's consecutive options), loaded now so that the
  // loads are in flight while the pivots are factored
  float st[CH];
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int e = threadIdx.x + m * kTile * 32, row = e / kTile;
    const int t = e - row * kTile;
    st[m] = m < ch && row < n && t < live ? pay[row * sB + b0 + t] : 0.f;
  }

  const float dt = sc[0 * sB + b], r = sc[1 * sB + b], q = sc[2 * sB + b];
  const float K = sc[3 * sB + b], call_f = sc[4 * sB + b];
  const float amer_f = sc[5 * sB + b];
  const float Lm = sc[6 * sB + b], Lc = sc[7 * sB + b], Lp = sc[8 * sB + b];
  const float s_lo = sc[9 * sB + b], s_hi = sc[10 * sB + b];
  const float wdt = w * dt;
  const float ewdt = (1.f - w) * dt;
  const float li = -wdt * Lm;
  const float di = 1.f - wdt * Lc;
  const float ui = -wdt * Lp;

  // V, the payoff, c, 1/pivot and the forward sweep's sub-diagonal l of the
  // lane's rows, in registers.  Rows 0 and n-1 are identity (c = 0, 1/pivot
  // = 1; l = li on row 0, whose entering value is 0, and 0 on row n-1).
  // Unused slots (rows past n) hold V = 0 and pass both sweeps' values
  // through exactly (l = -1, 1/pivot = 1: (0 + x) 1 = x; c = -1: 0 + y = y),
  // so that every loop of the march runs on every slot without a branch
  float v[CH], g[CH], c[CH], inv[CH], lf[CH];
  bool used[CH], inner[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int i = i0 + j;
    used[j] = j < cnt;
    inner[j] = used[j] && i > 0 && i < n - 1;
    c[j] = used[j] ? 0.f : -1.f;
    inv[j] = 1.f;
    lf[j] = !used[j] ? -1.f : i == n - 1 ? 0.f : li;
  }
  // factor once: the twin's chain up to the chunk, left where it reaches a
  // float fixed point (every later factor is that one), then its own rows
  if (on) {
    float cp = 0.f;
    for (int i = 1; i < min(i0, n - 1); ++i) {
      const float cn = ui * (1.f / (di - li * cp));
      if (cn == cp) break;
      cp = cn;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (inner[j]) {
        inv[j] = 1.f / (di - li * cp);
        cp = ui * inv[j];
        c[j] = cp;
      }
  }
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int e = threadIdx.x + m * kTile * 32, row = e / kTile;
    const int t = e - row * kTile;
    if (m < ch && row < n && t < live) tile[t * n + row] = st[m];
  }
  __syncthreads();

  float* mine = tile + warp * n + i0;
  if (on) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      g[j] = used[j] ? mine[j] : 0.f;
      v[j] = g[j];
    }
    // The chunk maps' P: forward d_i = (rhs_i - l d_{i-1}) / pivot_i, back
    // y_i = d_i - c_i y_{i+1}; constant for the march, as is every level's.
    // A used row's d is alpha + beta x, with alpha the chunk's forward walk
    // from 0 and beta the prefix of its P (constant): so the back map's Q
    // is the back composition of the alphas plus Bc x, Bc that of the betas
    float Pf = 1.f, Pb = 1.f, Bc = 0.f, beta[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      Pf = -(lf[j] * Pf) * inv[j];
      beta[j] = used[j] ? Pf : 0.f;
    }
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      Pb = -(c[j] * Pb);
      Bc = beta[j] - c[j] * Bc;
    }
    float lev_f[5], lev_b[5];
    scan_levels(Pf, lev_f, lane, false);
    scan_levels(Pb, lev_b, lane, true);

    // the chunk's last row, for the next lane's stencil
    float last = v[0];
#pragma unroll
    for (int j = 1; j < CH; ++j) last = j == cnt - 1 ? v[j] : last;
    for (int k = 0; k < nT; ++k) {
      // a. the Dirichlet values at tau (both discounts), off the chain
      const float tau = dt * static_cast<float>(k + 1);
      const float dfr = expf(-r * tau);
      const float dfq = expf(-q * tau);
      const float bc0 = (1.f - call_f) * (K * dfr - s_lo * dfq);
      const float bcN = call_f * (s_hi * dfq - K * dfr);
      // b. the explicit part on interior rows (the twin's order); the
      //    neighbours across the chunk's edges from the next lanes
      const float left = __shfl_up_sync(kFull, last, 1);
      const float right = __shfl_down_sync(kFull, v[0], 1);
      float vm = left;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float vc = v[j];
        const float vp = j + 1 < cnt ? v[j + 1 < CH ? j + 1 : j] : right;
        float lv = Lm * vm + Lc * vc;
        lv = lv + Lp * vp;
        const float rhs = vc + ewdt * lv;
        v[j] = inner[j] ? rhs : vc;
        vm = vc;
      }
      // c. the forward sweep's chunk map from 0 (the alphas, the twin's
      //    arithmetic) and the back map of the alphas, then the scan
      float Q = 0.f, A = 0.f, alpha[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        Q = (v[j] - lf[j] * Q) * inv[j];
        alpha[j] = used[j] ? Q : 0.f;
      }
#pragma unroll
      for (int j = CH - 1; j >= 0; --j) A = alpha[j] - c[j] * A;
      float x = scan_q(Q, lev_f, lane, false);
      // d. the back substitution's scan on the chunk's Q = A + Bc x (c = 0
      //    on the identity row n-1, whose value is its rhs), while the
      //    chunk's forward walk runs with the twin's arithmetic
      float y = scan_q(A + Bc * x, lev_b, lane, true);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        x = (v[j] - lf[j] * x) * inv[j];
        v[j] = used[j] ? x : 0.f;
      }
      // e. the back walk, the Dirichlet rows and the American floor; an
      //    unused slot stays 0
#pragma unroll
      for (int j = CH - 1; j >= 0; --j) {
        y = v[j] - c[j] * y;
        const int i = i0 + j;
        const float out = i == 0 ? bc0 : i == n - 1 ? bcN : y;
        v[j] = used[j] ? out + amer_f * (fmaxf(out, g[j]) - out) : 0.f;
        last = j == cnt - 1 ? v[j] : last;
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (j < cnt) mine[j] = v[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * kTile; e += kTile * 32) {
    const int row = e / kTile, t = e - row * kTile;
    if (t < live) Vout[row * sB + b0 + t] = tile[t * n + row];
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

// The warp route: inputs and output as above.  Lattices with more than
// kMaxCh rows a lane (n > 512) are refused (cudaErrorInvalidValue): the
// first design takes them.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int pde_cn1d_fused_warp(const float* pay, const float* sc, float* V,
                                   int B, int n, int nT, float w, void* stream) {
  const int ch = (n + 31) / 32;
  if (ch > kMaxCh) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int blocks = (B + kTile - 1) / kTile;
    const size_t smem = static_cast<size_t>(kTile) * n * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ch <= 4)
      cn_march_const_warp<4><<<blocks, kTile * 32, smem, s>>>(pay, sc, V, n, nT, B, w);
    else if (ch <= 8)
      cn_march_const_warp<8><<<blocks, kTile * 32, smem, s>>>(pay, sc, V, n, nT, B, w);
    else
      cn_march_const_warp<kMaxCh><<<blocks, kTile * 32, smem, s>>>(pay, sc, V, n, nT, B, w);
  }
  return static_cast<int>(cudaGetLastError());
}
