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
// The first design (cn_march_tv: one thread per option, 32 to a block, the
// scratch c and d in device memory) stays for lattices whose staging
// exceeds the 227 KB a block can have (n > 518), chosen by the wrapper.
//
// Numerics: built with nvcc's FMA contraction (ops/build.py; measured
// faster than -fmad=false and well inside the kernel-vs-twin gate), so
// neither design rounds exactly as the plain twin does; this one also
// composes the values entering each chunk in another order.
//
// Layout: batch last and contiguous.  pay (n, B); bands (nT+1, 3n, B) with
// rows [L_m; L_c; L_p] per level, level k at calendar time T - k dt; sc
// (8, B) = dt, r, q, K, is_call, american, s_min, s_max; V (n, B) is the
// output; the first design's C and D (n, B) are scratch.  The kernels
// allocate nothing and do not synchronise; they run on the caller's stream.

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
  float* RHS = V + n;   // the right-hand side, then the forward sweep's d
  float* C = RHS + n;   // Thomas c
  float* PIV = C + n;   // reciprocal pivots
  float* PAY = PIV + n;

  stage_level(ring, bands, 0, 0, n, B, b0, tile);
  __pipeline_commit();
  stage_level(ring, bands, 1, 1, n, B, b0, tile);
  __pipeline_commit();
  const int bb = live ? b : b0;
  const float dt = sc[0 * sB + bb], r = sc[1 * sB + bb], q = sc[2 * sB + bb];
  const float K = sc[3 * sB + bb], call_f = sc[4 * sB + bb];
  const float amer_f = sc[5 * sB + bb];
  const float s_lo = sc[6 * sB + bb], s_hi = sc[7 * sB + bb];
  const float wdt = w * dt;
  const float ewdt = (1.f - w) * dt;
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

  for (int k = 0; k < nT; ++k) {
    if (k + 2 <= nT) stage_level(ring, bands, k + 2, (k + 2) % 3, n, B, b0, tile);
    __pipeline_commit();
    if (live) {
      const float* Lo = ring + ((k % 3) * kTile + warp) * 3 * n;       // level k
      const float* Ln = ring + (((k + 1) % 3) * kTile + warp) * 3 * n; // level k+1
      // the implicit row i at level k+1; rows 0 and n-1 are identity
      auto row = [&](int i, float& l, float& d, float& u) {
        const bool inner = i > 0 && i < n - 1;
        l = inner ? -wdt * Ln[i] : 0.f;
        d = inner ? 1.f - wdt * Ln[n + i] : 1.f;
        u = inner ? -wdt * Ln[2 * n + i] : 0.f;
      };
      // a. explicit part on interior rows at level k, and the chunk's
      //    pivot map c -> u / (d - l c) as a 2x2 matrix [[0, u], [-l, d]]
      float ga = 1.f, gb = 0.f, gc = 0.f, gd = 1.f;
      for (int i = i0; i < i1; ++i) {
        float rhs = V[i];
        if (i > 0 && i < n - 1) {
          float lv = Lo[i] * V[i - 1] + Lo[n + i] * V[i];
          lv = lv + Lo[2 * n + i] * V[i + 1];
          rhs = V[i] + ewdt * lv;
        }
        RHS[i] = rhs;
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
      const float tau = dt * static_cast<float>(k + 1);
      const float dfr = expf(-r * tau);
      const float dfq = expf(-q * tau);
      const float bc0 = (1.f - call_f) * (K * dfr - s_lo * dfq);
      const float bcN = call_f * (s_hi * dfq - K * dfr);
      __syncwarp();  // every lane has read V for its rhs before any writes it
      for (int i = i1 - 1; i >= i0; --i) {
        y = RHS[i] - C[i] * y;
        const float out = i == 0 ? bc0 : i == n - 1 ? bcN : y;
        V[i] = out + amer_f * (fmaxf(out, PAY[i]) - out);
      }
    }
    __pipeline_wait_prior(0);  // level k+2 has landed
    __syncthreads();           // ... for every warp; slot k % 3 is free
  }
  if (live)
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
