// Red-black projected SOR for a batch of tridiagonal LCPs, all sweeps in one
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pde_tpu/solvers/lcp.py:projected_sor_pallas
// (Pallas, systems on the vector lanes, the iterate in VMEM for every
// sweep).  Computes what it computes: for each system, x = max(b / d, g)
// (or max(x0, g) when a start is given), then n_iter sweeps, each a red
// half-update (even rows) and a black one (odd rows):
//   nb = lo[i] x[i-1] + up[i] x[i+1];  gs = (b[i] - nb) / d[i];
//   x[i] = max(x[i] + omega (gs - x[i]), g[i]).
// Rows of one colour read only the other colour, so each half-update is
// exact Gauss-Seidel done in parallel.  The plain PyTorch version with the
// same arithmetic is pde_tpu_torch/solvers/lcp.py:_projected_sor (float32).
//
// What bounds it on the H100: at B = 512, n = 200 and 60 sweeps the
// roofline sees ~1e8 flops (~8 a row and half-sweep over both colours) and
// 2.5 MB of operands and result, so operations bind (~1.5 us at 67 TFLOP/s
// float32); in practice each system's chain of 2 n_iter dependent
// half-sweeps binds: in the first design each ends in a barrier, in the
// warp route in a shuffle, and each row's division sits on the chain.
//
// What this design does about it (psor_warp, the default route): one warp
// per system for all sweeps, kWarps = 4 systems (warps) to a block, so a
// 512-system batch is 128 blocks, one an SM, and a single system one warp.
// Lane l holds the contiguous rows [l ch, (l+1) ch), ch = 2 ceil(n / 64)
// (8 at n = 200): an even chunk, so every lane's first row is red and a
// row's colour is fixed by its slot, with no divergence.  The iterate and
// the five operands of the lane's rows stay in registers for all sweeps.
// A half-sweep updates the lane's rows of one colour (ch / 2 independent
// rows, the division of each, branch-free, overlapping the others'); the
// one neighbour across the chunk's edge that the colour reads comes by one
// shuffle, and the warp needs no barrier.  The bands are read in place from
// the public
// (B, n-1) layout, each operand at its own batch stride (0 for a band
// shared by every system), so the wrapper pads and copies nothing.  After
// the sweeps each warp computes its system's complementarity residual
// max |min(A x - b, x - g)| with the twin's arithmetic (a max is exact in
// any order); the wrapper reduces the B residuals with one more launch
// when B > 1.
//
// The first design (psor_batched: one 128-thread block per system, the
// iterate in shared memory, rows spread across the threads, each
// half-sweep ending in __syncthreads, the operands read from device memory
// each sweep through the read-only cache, on row-aligned padded bands)
// stays for systems whose chunk exceeds the warp route's register chunk
// (kMaxCh = 8 rows: n > 256), chosen by the wrapper from n.  A 16-row
// chunk (n <= 512) ran 14-16% slower than the first design for one system
// at n = 300-512 and within 3% of it for 512 systems on an H100
// (scripts/torch_k4_k6_routes.py), so the warp route stops at 8.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin; the first design divides with
// IEEE division (no fast math), the warp route with div_rn below, which
// gives the same correctly rounded quotient without IEEE division's
// out-of-line slow path (taken for subnormal values, which the far rows of
// an LCP reach as they decay, and which cost the warp route's serial rows
// more than the rest of a sweep).  Rows of one colour read only the other
// colour, so the order in which a half-sweep updates them is free, and
// both designs agree with the twin bit for bit.
//
// Layout of the first design: row-major (B, n), contiguous, row-aligned
// bands: lo[:, 0] = 0, up[:, n-1] = 0.  lo, d, up, b, g and the optional x0
// (null: start at max(b / d, g)) are inputs; x (B, n) is the output.  The
// warp route takes lower and upper as (B, n-1) and d, b, g, x0 as (B, n),
// each with contiguous rows and its own batch stride, and writes x (B, n)
// and the residual (B,).  The kernels allocate nothing and do not
// synchronise; they run on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // first design: threads a system
constexpr int kWarps = 4;      // warp route: systems (warps) a block
constexpr int kMaxCh = 8;      // warp route: at most this many rows a lane (n <= 256)
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
psor_batched(const float* __restrict__ lo, const float* __restrict__ d,
             const float* __restrict__ up, const float* __restrict__ b,
             const float* __restrict__ g, const float* __restrict__ x0,
             float* __restrict__ out, int n, int n_iter, float omega) {
  extern __shared__ float x[];
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  lo += off;
  d += off;
  up += off;
  b += off;
  g += off;
  out += off;
  if (x0 != nullptr) x0 += off;

  for (int i = tid; i < n; i += kThreads)
    x[i] = fmaxf(x0 != nullptr ? x0[i] : b[i] / d[i], g[i]);
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    for (int colour = 0; colour < 2; ++colour) {
      // rows i = colour, colour + 2, ...; thread t takes every kThreads-th
      for (int i = colour + 2 * tid; i < n; i += 2 * kThreads) {
        const float xm = i > 0 ? x[i - 1] : 0.f;
        const float xp = i < n - 1 ? x[i + 1] : 0.f;
        const float nb = lo[i] * xm + up[i] * xp;
        const float gs = (b[i] - nb) / d[i];
        const float xi = x[i];
        x[i] = fmaxf(xi + omega * (gs - xi), g[i]);
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += kThreads) out[i] = x[i];
}

// 1 / d in double to about 2^-40: the reciprocal estimate refined by one
// Newton step (d is a float, so a double normal).
__device__ __forceinline__ double rcp_refined(float d) {
  const double dd = d;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(dd));
  return fma(r, fma(-dd, r, 1.0), r);
}

// a / d correctly rounded to float, as IEEE division gives it, with no
// branch: q = a r and one Newton correction with the exact remainder give
// the quotient in double to about 2^-53, and the quotient of two floats
// lies at least 2^-49 (relatively) from any midpoint of two floats, so
// the one rounding to float is the correct one, subnormal quotients
// included (a float's subnormals are double normals).  A zero remainder
// means q is exact (and keeps the sign of a zero dividend).  IEEE float
// division instead takes an out-of-line slow path for subnormal operands
// and quotients, which the far rows of an LCP reach as values decay.
__device__ __forceinline__ float div_rn(float a, float d, double r) {
  const double ad = a;
  const double q = ad * r;
  const double rem = fma(-q, static_cast<double>(d), ad);
  return static_cast<float>(rem == 0.0 ? q : fma(rem, r, q));
}

// One row's projected Gauss-Seidel update (psor_batched's arithmetic; r is
// the row's rcp_refined(d)).
__device__ __forceinline__ float gs_update(float x, float lo, float up, float b, float d,
                                           double r, float g, float xm, float xp,
                                           float omega) {
  const float nb = lo * xm + up * xp;
  const float gs = div_rn(b - nb, d, r);
  return fmaxf(x + omega * (gs - x), g);
}

// The last row of a full chunk of ch rows (odd slot ch - 1), for the next
// lane; slots are registers, so the runtime slot is picked by selects.
template <int CH>
__device__ __forceinline__ float chunk_last(const float (&x)[CH], int ch) {
  float last = x[1];
#pragma unroll
  for (int j = 3; j < CH; j += 2)
    if (j == ch - 1) last = x[j];
  return last;
}

// The warp route: one warp per system, CH >= 2 ceil(n / 64) register slots
// a lane.  Operand pointers are advanced by the system's index times their
// batch stride (0 for a band shared by every system).
template <int CH>
__global__ void __launch_bounds__(kWarps * 32)
psor_warp(const float* __restrict__ lower, const float* __restrict__ d,
          const float* __restrict__ upper, const float* __restrict__ b,
          const float* __restrict__ g, const float* __restrict__ x0,
          float* __restrict__ out, float* __restrict__ resid, long long s_lo,
          long long s_d, long long s_up, long long s_b, long long s_g,
          long long s_x0, int B, int n, int n_iter, float omega) {
  const int lane = threadIdx.x % 32;
  const int sys = blockIdx.x * kWarps + threadIdx.x / 32;
  if (sys >= B) return;  // the whole warp
  lower += sys * s_lo;
  d += sys * s_d;
  upper += sys * s_up;
  b += sys * s_b;
  g += sys * s_g;
  if (x0 != nullptr) x0 += sys * s_x0;
  out += static_cast<size_t>(sys) * n;
  // this lane's rows [i0, i0 + cnt); ch is even, so slot j has colour j % 2
  const int ch = 2 * ((n + 63) / 64);
  const int i0 = min(n, lane * ch);
  const int cnt = min(n, i0 + ch) - i0;

  // the row-aligned operands of the lane's rows (lo = 0 on row 0, up = 0 on
  // row n-1) and the start.  Unused slots (rows past n) hold zero bands, b =
  // g = x = 0 and d = 1: their update and residual are exactly 0, so every
  // loop runs on every slot without a branch, and a real row reads them
  // only through a zero band
  float x[CH], lo[CH], up[CH], bb[CH], dd[CH], gg[CH];
  double rd[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int i = i0 + j;
    const bool in = j < cnt;
    lo[j] = in && i > 0 ? lower[i - 1] : 0.f;
    up[j] = in && i < n - 1 ? upper[i] : 0.f;
    bb[j] = in ? b[i] : 0.f;
    dd[j] = in ? d[i] : 1.f;
    gg[j] = in ? g[i] : 0.f;
    rd[j] = rcp_refined(dd[j]);
    x[j] = in ? fmaxf(x0 != nullptr ? x0[i] : div_rn(bb[j], dd[j], rd[j]), gg[j]) : 0.f;
  }
  for (int it = 0; it < n_iter; ++it) {
    // red rows (even slots): the left neighbour of slot 0 is the previous
    // lane's last row
    float left = __shfl_up_sync(kFull, chunk_last(x, ch), 1);
    if (lane == 0) left = 0.f;
#pragma unroll
    for (int j = 0; j < CH; j += 2)
      x[j] = gs_update(x[j], lo[j], up[j], bb[j], dd[j], rd[j], gg[j],
                       j == 0 ? left : x[j > 0 ? j - 1 : 0], x[j + 1], omega);
    // black rows (odd slots): the right neighbour of slot ch - 1 is the
    // next lane's first row
    float right = __shfl_down_sync(kFull, x[0], 1);
    if (lane == 31) right = 0.f;
#pragma unroll
    for (int j = 1; j < CH; j += 2)
      x[j] = gs_update(x[j], lo[j], up[j], bb[j], dd[j], rd[j], gg[j], x[j - 1],
                       j + 1 == ch ? right : x[j + 1 < CH ? j + 1 : j], omega);
  }

  // the residual max |min(A x - b, x - g)| of the system, in _residual's
  // arithmetic: A x = (d x + lo x_{i-1}) + up x_{i+1}
  float left = __shfl_up_sync(kFull, chunk_last(x, ch), 1);
  if (lane == 0) left = 0.f;
  float right = __shfl_down_sync(kFull, x[0], 1);
  if (lane == 31) right = 0.f;
  float worst = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const float xm = j == 0 ? left : x[j > 0 ? j - 1 : 0];
    const float xp = j + 1 == ch ? right : x[j + 1 < CH ? j + 1 : j];
    float ax = dd[j] * x[j] + lo[j] * xm;
    ax = ax + up[j] * xp;
    worst = fmaxf(worst, fabsf(fminf(ax - bb[j], x[j] - gg[j])));
    if (j < cnt) out[i0 + j] = x[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    worst = fmaxf(worst, __shfl_xor_sync(kFull, worst, off));
  if (lane == 0) resid[sys] = worst;
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers of float32
// tensors in the layout above; x0 may be null.  Returns the first CUDA error
// of the set-up or the launch (0 = launched).
extern "C" int pde_psor_batched(const float* lo, const float* d, const float* up,
                                const float* b, const float* g, const float* x0,
                                float* out, int B, int n, int n_iter, float omega,
                                void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        psor_batched, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0) {
    psor_batched<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        lo, d, up, b, g, x0, out, n, n_iter, omega);
  }
  return static_cast<int>(cudaGetLastError());
}

// The warp route: lower, upper (B, n-1) and d, b, g, x0 (B, n) with
// contiguous rows at the given batch strides (in floats; 0 for one row
// shared by every system); x0 may be null.  Writes x (B, n) and each
// system's residual (B,).  Systems with more than kMaxCh rows a lane
// (n > 256) are refused (cudaErrorInvalidValue): the first design takes
// them.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pde_psor_warp(const float* lower, const float* d, const float* upper,
                             const float* b, const float* g, const float* x0, float* out,
                             float* resid, long long s_lo, long long s_d, long long s_up,
                             long long s_b, long long s_g, long long s_x0, int B, int n,
                             int n_iter, float omega, void* stream) {
  const int ch = 2 * ((n + 63) / 64);
  if (ch > kMaxCh || n < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int blocks = (B + kWarps - 1) / kWarps;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto kernel) {
      kernel<<<blocks, kWarps * 32, 0, s>>>(lower, d, upper, b, g, x0, out, resid, s_lo,
                                            s_d, s_up, s_b, s_g, s_x0, B, n, n_iter, omega);
    };
    if (ch <= 2)
      launch(psor_warp<2>);
    else if (ch <= 4)
      launch(psor_warp<4>);
    else
      launch(psor_warp<kMaxCh>);
  }
  return static_cast<int>(cudaGetLastError());
}
