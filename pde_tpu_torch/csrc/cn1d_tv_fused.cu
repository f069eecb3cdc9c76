// Fused 1D theta-scheme march with time-varying coefficients, for a book of
// options, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pde_tpu/ops/cn1d_tv_fused.py:fused_cn_march_1d_tv
// (Pallas, both its VMEM-resident and its HBM-streamed variants).  Computes
// what it computes: the whole backward march of a local-vol book in one
// launch.  Each step k: the explicit part on interior rows at band level k,
// the implicit operator at level k+1 (boundary rows identity), a Thomas
// factorisation and forward sweep (the operator changes every step), the
// back substitution, the Dirichlet rows at tau = dt (k+1) with both
// discounts, and the American floor.  The plain PyTorch version with the
// same step order is
// pde_tpu_torch/ops/cn1d_tv_fused.py:_fused_cn_march_1d_tv_plain.
//
// What bounds it on the H100: the band lattice, read once.  At 200 x 100 and
// B = 256 it is 101 levels x 600 rows x 256 options x 4 B = 62 MB, which
// takes 19 us at 3.35 TB/s; the arithmetic (~25 flops a node a step, 1.3e8
// in all) takes 2 us at 67 TFLOP/s.  In practice the serial chain binds
// first: each step is 2 (n - 2) dependent links per option (pivot division,
// then multiply-adds), about 40,000 links for the march.  Walked by one
// thread per option (the first design, 8 warps on 8 SMs for the 256-book)
// that took ~300 ns a link.
//
// What this design does about it (cn_march_tv_warp, the default route):
// * One warp per option for the whole march, eight options (kTile) to a
//   block, so that each band row the block stages is one 32-byte sector of
//   the batch-last lattice (read in place: no permute in the wrapper).
// * Each step's solve partitioned over the warp: lane l takes the
//   contiguous rows [l ch, (l+1) ch), ch = ceil(n / 32) (7 at n = 200; at
//   small n the last lanes hold one row or none).  The pivot recurrence
//   c_i = u_i / (d_i - l_i c_{i-1}) is a Moebius map, a 2x2 matrix
//   [[0, u], [-l, d]] acting on (c, 1); each lane composes its chunk's
//   matrices (normalised by their largest entry), a 5-level shuffle scan
//   composes them across the warp and gives each lane the c entering its
//   chunk, and the lane then factors its chunk with the twin's arithmetic.
//   With the pivots known, the forward sweep and the back substitution are
//   affine recurrences, solved the same way: compose the chunk, scan,
//   walk the chunk.  The chain per step falls from 396 links to about
//   4 x 7 + 3 x 5.  This was taken over SPIKE with a PCR-solved reduced
//   system because inside a chunk every operation is the twin's own, in
//   its order: besides FMA contraction, kernel and twin differ only through
//   the values entering each chunk, which the scans compose in another
//   order.
// * The bands staged ahead: while step k solves, level k+2 of the block's
//   eight options is copied into a ring of three levels in shared memory
//   with cp.async (4 bytes a copy, so any B and alignment), and a barrier a
//   step hands the slot on.  Per block: 3 x 8 x 3n floats of ring plus
//   V, rhs, c, 1/pivot and the payoff per warp, 8 x 5n: 112 n floats
//   (89.6 KB at n = 200); the 256-book runs as 32 blocks of 8 warps.
//
// The surface route (cn_march_tv_surface), for a book on a bilinear
// local-vol surface: the same warp march (march_step, shared with
// cn_march_tv_warp through a band source), each row's bands built inside
// the march from the surface instead of read from a lattice.  The lattice
// is (nT+1) x 3n x B floats, 993 MB for the 200 x 100 book of 4096, which
// the solver wrote with some 70 ATen kernels for the warp route to read
// once; the problem's input is the surface (24 x 6 vols at the bench) and
// each option's T, K and flags.  What is left to bound the route is the
// serial chain a step and the lookup beside it (the time bracket once a
// warp and level, four vols from shared memory, about 20 operations a row
// and level); the march touches device memory only for its inputs and V.
// What the design does about it:
// * the block copies the surface into shared memory once; each lane finds
//   its rows' strike brackets and weights once, before the march;
// * each step the warp finds level k+1's time bracket (one pair of
//   scalars) and each lane builds its own rows' a and b into its warp's
//   shared memory, replacing level k's once the explicit part has read
//   them; every lane needs only its own rows' bands, so there is no ring,
//   no cp.async and no block barrier a step;
// * the warp keeps a and b (two floats a row) rather than the three bands,
//   and the strike bracket in 16 bits: 8.5 n floats a warp, 55 KB a block
//   at n = 200, so four blocks (32 warps) fit an SM, the launch bound holds
//   registers to 64, and the 4096-book runs in one wave.
//
// The first design (cn_march_tv: one thread per option, 32 to a block, the
// scratch c and d in device memory) stays for lattices whose staging
// exceeds the 227 KB a block can have (n > 518), chosen by the wrapper.
//
// Numerics: built with nvcc's FMA contraction (ops/build.py; measured
// faster than -fmad=false and well inside the kernel-vs-twin gate), so
// neither design rounds exactly as the plain twin does; the warp routes
// also compose the values entering each chunk in another order.  The
// surface route's lookup and bands are written with __fmul_rn and
// __fadd_rn, which nvcc never contracts, so that its brackets and bands
// round as the card's lattice builder rounds them.
//
// Layout: batch last and contiguous.  pay (n, B); bands (nT+1, 3n, B) with
// rows [L_m; L_c; L_p] per level, level k at calendar time T - k dt; sc
// (8, B) = dt, r, q, K, is_call, american, s_min, s_max; V (n, B) is the
// output; the first design's C and D (n, B) are scratch; the surface route
// reads xq (n, B), each node's ln S, and T (B,) in place of the bands.  The
// kernels allocate nothing and do not synchronise; they run on the caller's
// stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // first design: one thread per option
constexpr int kTile = 8;      // warp design: options (warps) per block
constexpr unsigned kFull = 0xffffffffu;

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

// Value entering this lane's chunk: an inclusive scan over the warp's 32
// lanes of the chunks' affine maps x -> P x + Q, in lane order (forward) or
// in reverse, applied to 0 and taken from the neighbouring lane.
__device__ __forceinline__ float scan_entry(float P, float Q, int lane, bool reverse) {
  for (int off = 1; off < 32; off <<= 1) {
    const float Pn = reverse ? __shfl_down_sync(kFull, P, off)
                             : __shfl_up_sync(kFull, P, off);
    const float Qn = reverse ? __shfl_down_sync(kFull, Q, off)
                             : __shfl_up_sync(kFull, Q, off);
    if (reverse ? lane + off < 32 : lane >= off) {
      Q = P * Qn + Q;
      P = P * Pn;
    }
  }
  const float x = reverse ? __shfl_down_sync(kFull, Q, 1) : __shfl_up_sync(kFull, Q, 1);
  return (reverse ? lane + 1 < 32 : lane >= 1) ? x : 0.f;
}

// G <- G / max|G| (a projective map: scaling changes nothing but the size)
__device__ __forceinline__ void normalise(float& a, float& b, float& c, float& d) {
  const float s = 1.f / fmaxf(fmaxf(fabsf(a), fabsf(b)), fmaxf(fabsf(c), fabsf(d)));
  a *= s;
  b *= s;
  c *= s;
  d *= s;
}

// Copy band level `lev` of the block's options into ring slot `slot`
// (option-major: slot, option t, row), 4 bytes a copy, asynchronously.
__device__ __forceinline__ void stage_level(float* ring, const float* bands, int lev,
                                            int slot, int n, int B, int b0, int tile) {
  const size_t level = 3 * static_cast<size_t>(n) * B;
  const float* src = bands + lev * level + b0;
  float* dst = ring + static_cast<size_t>(slot) * kTile * 3 * n;
  for (int e = threadIdx.x; e < 3 * n * kTile; e += kTile * 32) {
    const int row = e / kTile, t = e - row * kTile;
    if (t < tile)
      __pipeline_memcpy_async(dst + t * 3 * n + row, src + static_cast<size_t>(row) * B + t,
                              sizeof(float));
  }
}

// One column of sc and the theta-scheme's weights.
struct Option {
  float dt, r, q, K, call_f, amer_f, s_lo, s_hi, wdt, ewdt;
};

__device__ __forceinline__ Option load_option(const float* sc, size_t sB, int b, float w) {
  Option o;
  o.dt = sc[0 * sB + b];
  o.r = sc[1 * sB + b];
  o.q = sc[2 * sB + b];
  o.K = sc[3 * sB + b];
  o.call_f = sc[4 * sB + b];
  o.amer_f = sc[5 * sB + b];
  o.s_lo = sc[6 * sB + b];
  o.s_hi = sc[7 * sB + b];
  o.wdt = w * o.dt;
  o.ewdt = (1.f - w) * o.dt;
  return o;
}

// Band source of the lattice route: levels k and k+1 of the block's options
// staged in a ring of three levels in shared memory (slot, option, row),
// level k+2 copied in while step k solves; a barrier a step hands the slot on.
struct LatticeBands {
  float* ring;
  const float* bands;
  int n, nT, B, b0, tile, warp;
  const float* Lo;  // level k of this warp's option
  const float* Ln;  // level k+1

  __device__ __forceinline__ void begin(int k) {
    if (k + 2 <= nT) stage_level(ring, bands, k + 2, (k + 2) % 3, n, B, b0, tile);
    __pipeline_commit();
    Lo = ring + ((k % 3) * kTile + warp) * 3 * n;
    Ln = ring + (((k + 1) % 3) * kTile + warp) * 3 * n;
  }
  __device__ __forceinline__ void end() {
    __pipeline_wait_prior(0);  // level k+2 has landed
    __syncthreads();           // ... for every warp; slot k % 3 is free
  }
  __device__ __forceinline__ void old_row(int i, float& m, float& c, float& p) const {
    m = Lo[i];
    c = Lo[n + i];
    p = Lo[2 * n + i];
  }
  __device__ __forceinline__ void next_row(int) const {}
  __device__ __forceinline__ void new_row(int i, float& m, float& c, float& p) const {
    m = Ln[i];
    c = Ln[n + i];
    p = Ln[2 * n + i];
  }
};

// Band source of the surface route: each row's bands built in the march from
// the block's copy of the surface, as the solver's lattice builder
// (local_vol_pde._band_lattice_batch) builds them on the card, rounding for
// rounding (no contraction in the lookup: __fmul_rn, __fadd_rn): the strike
// bracket ix (the count of knots <= x, less one, clipped) and weight wx of
// each row once, then at each level the time bracket, sigma and the
// diffusion and convection coefficients a and b of each row, kept per warp
// and read back as the rows (a - b, -2a - r, a + b).  A row at level k+1
// replaces the same row at level k once the explicit part has read it, so
// a warp keeps one level.
struct SurfaceBands {
  const float* lk;   // ln K knots (nk)
  const float* tt;   // maturity knots (nt)
  const float* vol;  // (nt, nk)
  float* A;          // per row: a and b at the level last built
  float* Bc;
  float* WX;         // per row: strike weight and bracket
  unsigned short* IX;
  int nk, nt;
  float T, dt, r, rq, inv_dx2, inv_2dx;
  int it;            // time bracket and weights of the level being built
  float wt, owt;

  // level j is calendar time min(max(T - j dt, 0), T)
  __device__ __forceinline__ void level(int j) {
    const float t =
        fminf(fmaxf(__fsub_rn(T, __fmul_rn(dt, static_cast<float>(j))), 0.f), T);
    int c = 0;
    for (int m = 0; m < nt; ++m) c += tt[m] <= t;
    it = min(max(c - 1, 0), nt - 2);
    wt = fminf(fmaxf(__fdiv_rn(__fsub_rn(t, tt[it]), __fsub_rn(tt[it + 1], tt[it])), 0.f),
               1.f);
    owt = __fsub_rn(1.f, wt);
  }
  __device__ __forceinline__ void bracket(int i, float x) {
    int c = 0;
    for (int m = 0; m < nk; ++m) c += lk[m] <= x;
    const int ix = min(max(c - 1, 0), nk - 2);
    IX[i] = static_cast<unsigned short>(ix);
    WX[i] = fminf(fmaxf(__fdiv_rn(__fsub_rn(x, lk[ix]), __fsub_rn(lk[ix + 1], lk[ix])), 0.f),
                  1.f);
  }
  // row i at the level of the last level(): vols interpolated in t first,
  // then in ln K; the operator's a and b (the card's torch divides a
  // tensor by a Python number as a product with its float reciprocal)
  __device__ __forceinline__ void build(int i) {
    const int x = IX[i];
    const float w = WX[i];
    const float* v0 = vol + it * nk;
    const float* v1 = v0 + nk;
    const float g0 = __fadd_rn(__fmul_rn(owt, v0[x]), __fmul_rn(wt, v1[x]));
    const float g1 = __fadd_rn(__fmul_rn(owt, v0[x + 1]), __fmul_rn(wt, v1[x + 1]));
    const float sig = __fadd_rn(__fmul_rn(__fsub_rn(1.f, w), g0), __fmul_rn(w, g1));
    const float h = __fmul_rn(0.5f, __fmul_rn(sig, sig));
    A[i] = __fmul_rn(h, inv_dx2);
    Bc[i] = __fmul_rn(__fsub_rn(rq, h), inv_2dx);
  }
  __device__ __forceinline__ void row(int i, float& m, float& c, float& p) const {
    const float a = A[i], b = Bc[i];
    m = a - b;
    c = -2.f * a - r;
    p = a + b;
  }

  __device__ __forceinline__ void begin(int k) { level(k + 1); }
  __device__ __forceinline__ void end() { __syncwarp(); }  // V written, then read across lanes
  __device__ __forceinline__ void old_row(int i, float& m, float& c, float& p) const {
    row(i, m, c, p);
  }
  __device__ __forceinline__ void next_row(int i) { build(i); }
  __device__ __forceinline__ void new_row(int i, float& m, float& c, float& p) const {
    row(i, m, c, p);
  }
};

// Step k of the warp's option: lane `lane` holds rows [i0, i1).  V, RHS (the
// right-hand side, then the forward sweep's d), C (Thomas c), PIV
// (reciprocal pivots) and PAY are the warp's rows in shared memory; `src`
// gives each row's raw bands (L_m, L_c, L_p) at level k (old_row) and, after
// next_row, at level k+1 (new_row).
template <class Src>
__device__ __forceinline__ void march_step(Src& src, int k, const Option& o, float* V,
                                           float* RHS, float* C, float* PIV,
                                           const float* PAY, int n, int i0, int i1,
                                           int lane) {
  // the implicit row i at level k+1; rows 0 and n-1 are identity
  auto row = [&](int i, float& l, float& d, float& u) {
    const bool inner = i > 0 && i < n - 1;
    float m, c, p;
    src.new_row(i, m, c, p);
    l = inner ? -o.wdt * m : 0.f;
    d = inner ? 1.f - o.wdt * c : 1.f;
    u = inner ? -o.wdt * p : 0.f;
  };
  // a. explicit part on interior rows at level k, and the chunk's
  //    pivot map c -> u / (d - l c) as a 2x2 matrix [[0, u], [-l, d]]
  float ga = 1.f, gb = 0.f, gc = 0.f, gd = 1.f;
  for (int i = i0; i < i1; ++i) {
    float rhs = V[i];
    if (i > 0 && i < n - 1) {
      float m, c, p;
      src.old_row(i, m, c, p);
      float lv = m * V[i - 1] + c * V[i];
      lv = lv + p * V[i + 1];
      rhs = V[i] + o.ewdt * lv;
    }
    RHS[i] = rhs;
    src.next_row(i);
    float l, d, u;
    row(i, l, d, u);
    const float na = u * gc, nb = u * gd;
    const float nc = d * gc - l * ga, nd = d * gd - l * gb;
    ga = na;
    gb = nb;
    gc = nc;
    gd = nd;
    normalise(ga, gb, gc, gd);
  }
  // b. scan of the pivot maps: the c entering each chunk
  for (int off = 1; off < 32; off <<= 1) {
    const float ea = __shfl_up_sync(kFull, ga, off), eb = __shfl_up_sync(kFull, gb, off);
    const float ec = __shfl_up_sync(kFull, gc, off), ed = __shfl_up_sync(kFull, gd, off);
    if (lane >= off) {
      const float na = ga * ea + gb * ec, nb = ga * eb + gb * ed;
      const float nc = gc * ea + gd * ec, nd = gc * eb + gd * ed;
      ga = na;
      gb = nb;
      gc = nc;
      gd = nd;
      normalise(ga, gb, gc, gd);
    }
  }
  const float pb = __shfl_up_sync(kFull, gb, 1), pd = __shfl_up_sync(kFull, gd, 1);
  float c = lane >= 1 ? pb / pd : 0.f;
  // c. the Thomas factorisation of the chunk from that c (the twin's
  //    arithmetic), and the chunk's forward-sweep map
  float P = 1.f, Q = 0.f;
  for (int i = i0; i < i1; ++i) {
    float l, d, u;
    row(i, l, d, u);
    const float piv = 1.f / (d - l * c);
    c = u * piv;
    C[i] = c;
    PIV[i] = piv;
    Q = (RHS[i] - l * Q) * piv;
    P = -(l * P) * piv;
  }
  // d. the forward sweep d_i = (rhs_i - l_i d_{i-1}) piv_i, in place
  float x = scan_entry(P, Q, lane, false);
  for (int i = i0; i < i1; ++i) {
    float l, d, u;
    row(i, l, d, u);
    x = (RHS[i] - l * x) * PIV[i];
    RHS[i] = x;
  }
  // e. the back substitution y_i = d_i - c_i y_{i+1} (c = 0 on the
  //    identity row n-1), then the Dirichlet rows at tau (both
  //    discounts) and the American floor
  P = 1.f;
  Q = 0.f;
  for (int i = i1 - 1; i >= i0; --i) {
    Q = RHS[i] - C[i] * Q;
    P = -(C[i] * P);
  }
  float y = scan_entry(P, Q, lane, true);
  const float tau = o.dt * static_cast<float>(k + 1);
  const float dfr = expf(-o.r * tau);
  const float dfq = expf(-o.q * tau);
  const float bc0 = (1.f - o.call_f) * (o.K * dfr - o.s_lo * dfq);
  const float bcN = o.call_f * (o.s_hi * dfq - o.K * dfr);
  __syncwarp();  // every lane has read V for its rhs before any writes it
  for (int i = i1 - 1; i >= i0; --i) {
    y = RHS[i] - C[i] * y;
    const float out = i == 0 ? bc0 : i == n - 1 ? bcN : y;
    V[i] = out + o.amer_f * (fmaxf(out, PAY[i]) - out);
  }
}

// The whole march of a warp's option; `live` false for the warps of a
// ragged block's last tile, which take part only in the source's barriers.
template <class Src>
__device__ __forceinline__ void march(Src& src, bool live, int nT, const Option& o, float* V,
                                      float* RHS, float* C, float* PIV, const float* PAY,
                                      int n, int i0, int i1, int lane) {
  for (int k = 0; k < nT; ++k) {
    src.begin(k);
    if (live) march_step(src, k, o, V, RHS, C, PIV, PAY, n, i0, i1, lane);
    src.end();
  }
}

__global__ void __launch_bounds__(kTile * 32)
cn_march_tv_warp(const float* __restrict__ pay, const float* __restrict__ bands,
                 const float* __restrict__ sc, float* __restrict__ Vout, int n,
                 int nT, int B, float w) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * kTile;
  const int tile = min(kTile, B - b0);
  const int b = b0 + warp;
  const bool live = warp < tile;
  const size_t sB = B;
  float* ring = sm;  // 3 slots x kTile options x 3n rows
  float* V = ring + 3 * kTile * 3 * n + warp * 5 * n;
  float* RHS = V + n;
  float* C = RHS + n;
  float* PIV = C + n;
  float* PAY = PIV + n;

  stage_level(ring, bands, 0, 0, n, B, b0, tile);
  __pipeline_commit();
  stage_level(ring, bands, 1, 1, n, B, b0, tile);
  __pipeline_commit();
  const Option o = load_option(sc, sB, live ? b : b0, w);
  if (live) {
    for (int i = lane; i < n; i += 32) {
      PAY[i] = pay[i * sB + b];
      V[i] = PAY[i];
    }
  }
  const int ch = (n + 31) / 32;
  const int i0 = min(n, lane * ch), i1 = min(n, i0 + ch);
  __pipeline_wait_prior(0);
  __syncthreads();

  LatticeBands src{ring, bands, n, nT, B, b0, tile, warp, nullptr, nullptr};
  march(src, live, nT, o, V, RHS, C, PIV, PAY, n, i0, i1, lane);
  if (live)
    for (int i = lane; i < n; i += 32) Vout[i * sB + b] = V[i];
}

// The surface route: as cn_march_tv_warp, with each row's bands built in the
// march (SurfaceBands) from the surface the block copies into shared memory
// once; no lattice, no ring and no block barrier after the copy.  Per block:
// the surface (nk + nt + nt nk floats), then per warp V, RHS, C, 1/pivot,
// the payoff, a, b and wx (8n floats) and ix (n 16-bit words).  Four blocks
// a card's SM at n = 200 (55 KB each), so that registers (64 a thread, the
// launch bound) decide: 32 warps an SM, the 4096-book in one wave.
__global__ void __launch_bounds__(kTile * 32, 4)
cn_march_tv_surface(const float* __restrict__ pay, const float* __restrict__ xq,
                    const float* __restrict__ sc, const float* __restrict__ Tm,
                    const float* __restrict__ log_k, const float* __restrict__ t_knots,
                    const float* __restrict__ vols, float* __restrict__ Vout, int n, int nT,
                    int B, int nk, int nt, float w, float rq, float inv_dx2,
                    float inv_2dx) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * kTile;
  const int tile = min(kTile, B - b0);
  const int b = b0 + warp;
  const size_t sB = B;
  float* lk = sm;
  float* tt = lk + nk;
  float* vol = tt + nt;
  for (int e = threadIdx.x; e < nk; e += kTile * 32) lk[e] = log_k[e];
  for (int e = threadIdx.x; e < nt; e += kTile * 32) tt[e] = t_knots[e];
  for (int e = threadIdx.x; e < nt * nk; e += kTile * 32) vol[e] = vols[e];
  __syncthreads();
  if (warp >= tile) return;  // no barrier follows

  float* V = vol + nt * nk + warp * (8 * n + (n + 1) / 2);
  float* RHS = V + n;
  float* C = RHS + n;
  float* PIV = C + n;
  float* PAY = PIV + n;
  const Option o = load_option(sc, sB, b, w);
  for (int i = lane; i < n; i += 32) {
    PAY[i] = pay[i * sB + b];
    V[i] = PAY[i];
  }
  const int ch = (n + 31) / 32;
  const int i0 = min(n, lane * ch), i1 = min(n, i0 + ch);

  SurfaceBands src;
  src.lk = lk;
  src.tt = tt;
  src.vol = vol;
  src.A = PAY + n;
  src.Bc = src.A + n;
  src.WX = src.Bc + n;
  src.IX = reinterpret_cast<unsigned short*>(src.WX + n);
  src.nk = nk;
  src.nt = nt;
  src.T = Tm[b];
  src.dt = o.dt;
  src.r = o.r;
  src.rq = rq;
  src.inv_dx2 = inv_dx2;
  src.inv_2dx = inv_2dx;
  src.level(0);
  for (int i = i0; i < i1; ++i) {
    src.bracket(i, xq[i * sB + b]);
    src.build(i);
  }
  __syncwarp();  // V and PAY written across lanes
  march(src, true, nT, o, V, RHS, C, PIV, PAY, n, i0, i1, lane);
  for (int i = lane; i < n; i += 32) Vout[i * sB + b] = V[i];
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

// The warp route: inputs as above, V (n, B) the output, smem_bytes the
// block's dynamic shared memory (112 n floats, at most 227 KB).  Returns the
// first CUDA error of the attribute call or the launch (0 = launched).
extern "C" int pde_cn1d_tv_fused_warp(const float* pay, const float* bands,
                                      const float* sc, float* V, int B, int n,
                                      int nT, float w, int smem_bytes,
                                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cn_march_tv_warp, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const int blocks = (B + kTile - 1) / kTile;
    cn_march_tv_warp<<<blocks, kTile * 32, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(pay, bands, sc, V, n,
                                                            nT, B, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// The surface route: pay, sc and V as above; xq (n, B) each node's ln S;
// T (B,) the maturities; the surface's ln K knots (nk), maturity knots (nt)
// and vols (nt, nk), nk and nt >= 2; rq = float(r - q), inv_dx2 =
// 1 / float(dx^2) and inv_2dx = 1 / float(2 dx), as float32;
// smem_bytes the block's dynamic shared memory (at most 227 KB).  Returns
// the first CUDA error of the attribute calls or the launch (0 = launched).
extern "C" int pde_cn1d_tv_fused_surface(const float* pay, const float* xq,
                                         const float* sc, const float* T,
                                         const float* log_k, const float* t_knots,
                                         const float* vols, float* V, int B, int n,
                                         int nT, int nk, int nt, float w, float rq,
                                         float inv_dx2, float inv_2dx, int smem_bytes,
                                         void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cn_march_tv_surface, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cn_march_tv_surface,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const int blocks = (B + kTile - 1) / kTile;
    cn_march_tv_surface<<<blocks, kTile * 32, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        pay, xq, sc, T, log_k, t_knots, vols, V, n, nT, B, nk, nt, w, rq, inv_dx2, inv_2dx);
  }
  return static_cast<int>(cudaGetLastError());
}
