// Batched tridiagonal (Thomas) solve, B independent n-point systems in one
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pde_tpu/ops/tridiag.py:thomas_pallas (Pallas,
// systems on the 128 vector lanes, forward elimination and back
// substitution in one kernel with the state in VMEM).  Computes what it
// computes: for each system, c[0] = up[0] / d[0], dp[0] = b[0] / d[0]; then
// inv_m = 1 / (d[i] - lo[i] c[i-1]), c[i] = up[i] inv_m,
// dp[i] = (b[i] - lo[i] dp[i-1]) inv_m; then x[n-1] = dp[n-1],
// x[i] = dp[i] - c[i] x[i+1].  The plain PyTorch version with the same
// arithmetic is pde_tpu_torch/ops/tridiag.py:_thomas_batched_plain.
//
// What bounds it on the H100: the roofline sees bytes (four (B, n) inputs
// read once and one written: 12 KB at the Heston scan's (50, 100), 0.004 us
// at 3.35 TB/s) over ~9 flops a row.  What binds it in practice is each
// system's serial chain of 2 (n - 1) dependent rows, the forward half with a
// reciprocal at every pivot.  Walked by one thread per system through device
// memory, as the first design does, that took ~125 ns a row (24.7 us at
// n = 100).
//
// What this design does about it (thomas_lanes, the default route):
// * g lanes of one warp per system (a power of two up to 32, chosen by the
//   wrapper so that each lane's chunk holds about four rows: 32 lanes at
//   n = 100 and n = 200, 16 at n = 50), 128 / g systems to a 128-thread
//   block.
// * The block stages its systems' four operands in shared memory with
//   coalesced loads (neighbouring threads on neighbouring rows of the public
//   (B, n) row-major layout, a batch stride per operand, 0 for a band shared
//   by every system), each system's rows chunk by chunk at a padded chunk
//   stride cp (odd), so that the lanes of a warp, each in its own chunk, hit
//   distinct banks.
// * The pivot recurrence c_i = u_i / (d_i - l_i c_{i-1}) is a Moebius map, a
//   2x2 matrix [[0, u], [-l, d]] acting on (c, 1): each lane composes its
//   chunk's matrices (normalised by their largest entry), a log2(g)-level
//   shuffle scan composes them across the lane group and hands each lane
//   the c entering its chunk, and the lane factors its chunk from there with
//   the twin's arithmetic, keeping c in the upper band's place and 1/pivot
//   in the diagonal's.
// * With the pivots known, the forward sweep and the back substitution are
//   affine recurrences, each solved by the lane scan of lane_scan.cuh
//   (shared with K1 and K2): compose the chunk, scan, walk the chunk.  The
//   chain falls from 2 (n - 1) rows to about 3 (ch + log2 g + ch) links in
//   shared memory and registers.
// * The solution overwrites the right-hand side in shared memory and is
//   written back coalesced into out (B, n).  The wrapper's work around the
//   launch is one torch.empty.
//
// The first design (thomas_batched: one thread per system in a batch-last
// (n, B) layout, c and dp in device memory) stays for systems whose staging
// exceeds the 227 KB a block can have (n above ~3600), chosen by the wrapper
// from n, and as the yardstick timed beside the new route.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin; division is IEEE (no fast math).
// The values entering each chunk are composed in another order than the
// twin's, and row 0 multiplies by 1/d where the twin divides, so the new
// route is held to the kernel gate 1e-5 + 1e-4 |plain|; the systems the
// port solves are diagonally dominant (|c| < 1), so the scans are stable.
//
// Layouts.  thomas_lanes: lower (B, n-1), diag (B, n), upper (B, n-1), rhs
// (B, n), each row contiguous, rows sl, sd, su, sb floats apart; out (B, n)
// contiguous.  thomas_batched: batch last and contiguous, lo, d, up, b (n, B)
// row-aligned (lo[0] = 0, up[n-1] = 0); out (n, B); C (n, B) scratch.  The
// kernels allocate nothing and do not synchronise; they run on the caller's
// stream.

#include <cuda_runtime.h>

#include "lane_scan.cuh"

namespace {

constexpr int kThreads = 64;        // first design: one thread per system
constexpr int kLaneThreads = 128;   // lane-group design: g lanes per system
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
thomas_batched(const float* __restrict__ lo, const float* __restrict__ d,
               const float* __restrict__ up, const float* __restrict__ b,
               float* __restrict__ out, float* __restrict__ C, int B, int n) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= B) return;
  const size_t sB = B;
  lo += s;
  d += s;
  up += s;
  b += s;
  out += s;
  C += s;

  float c = up[0] / d[0];
  float dp = b[0] / d[0];
  C[0] = c;
  out[0] = dp;
  for (int i = 1; i < n; ++i) {
    const float li = lo[i * sB];
    const float inv_m = 1.f / (d[i * sB] - li * c);
    c = up[i * sB] * inv_m;
    dp = (b[i * sB] - li * dp) * inv_m;
    C[i * sB] = c;
    out[i * sB] = dp;
  }
  float x = dp;
  for (int i = n - 2; i >= 0; --i) {
    x = out[i * sB] - C[i * sB] * x;
    out[i * sB] = x;
  }
}

// G <- G / max|G| (a projective map: scaling changes nothing but the size)
__device__ __forceinline__ void normalise(float& a, float& b, float& c, float& d) {
  const float s = 1.f / fmaxf(fmaxf(fabsf(a), fabsf(b)), fmaxf(fabsf(c), fabsf(d)));
  a *= s;
  b *= s;
  c *= s;
  d *= s;
}

__global__ void __launch_bounds__(kLaneThreads)
thomas_lanes(const float* __restrict__ lower, const float* __restrict__ diag,
             const float* __restrict__ upper, const float* __restrict__ rhs,
             float* __restrict__ out, long long sl, long long sd, long long su,
             long long sb, int B, int n, int g, int ch, int cp) {
  extern __shared__ float sm[];
  const int per = kLaneThreads / g;  // systems of the block
  const int span = g * cp;           // floats of one system in each array
  float* L = sm;
  float* D = L + per * span;  // the diagonal, then 1/pivot
  float* U = D + per * span;  // the upper band, then c
  float* X = U + per * span;  // the right-hand side, then dp, then x
  const long long b0 = static_cast<long long>(blockIdx.x) * per;
  const int nsys = static_cast<int>(min(static_cast<long long>(per), B - b0));

  // stage: neighbouring threads on neighbouring rows of the (B, n) rows
  for (int e = threadIdx.x; e < nsys * n; e += kLaneThreads) {
    const int s = e / n, i = e - s * n;
    const long long b = b0 + s;
    const int k = s * span + (i / ch) * cp + i % ch;
    L[k] = i > 0 ? lower[b * sl + i - 1] : 0.f;
    D[k] = diag[b * sd + i];
    U[k] = i < n - 1 ? upper[b * su + i] : 0.f;
    X[k] = rhs[b * sb + i];
  }
  __syncthreads();

  const int s = threadIdx.x / g, lane = threadIdx.x % g;
  const int i0 = min(n, lane * ch);
  const int rows = s < nsys ? min(n, i0 + ch) - i0 : 0;
  const int k0 = s * span + lane * cp;  // row i0 of this lane's chunk
  float *l = L + k0, *d = D + k0, *u = U + k0, *x = X + k0;

  // a. the chunk's pivot map c -> u / (d - l c) as a 2x2 matrix
  float ga = 1.f, gb = 0.f, gc = 0.f, gd = 1.f;
  for (int r = 0; r < rows; ++r) {
    const float na = u[r] * gc, nb = u[r] * gd;
    const float nc = d[r] * gc - l[r] * ga, nd = d[r] * gd - l[r] * gb;
    ga = na;
    gb = nb;
    gc = nc;
    gd = nd;
    normalise(ga, gb, gc, gd);
  }
  // b. scan of the pivot maps across the lane group: the c entering each
  //    chunk (c = 0 before row 0)
  for (int off = 1; off < g; off <<= 1) {
    const float ea = __shfl_up_sync(kFull, ga, off, g), eb = __shfl_up_sync(kFull, gb, off, g);
    const float ec = __shfl_up_sync(kFull, gc, off, g), ed = __shfl_up_sync(kFull, gd, off, g);
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
  const float pb = __shfl_up_sync(kFull, gb, 1, g), pd = __shfl_up_sync(kFull, gd, 1, g);
  float c = lane >= 1 ? pb / pd : 0.f;
  // c. the factorisation of the chunk from that c (the twin's arithmetic),
  //    and the chunk's forward-sweep map
  float P = 1.f, Q = 0.f;
  for (int r = 0; r < rows; ++r) {
    const float inv_m = 1.f / (d[r] - l[r] * c);
    c = u[r] * inv_m;
    u[r] = c;
    d[r] = inv_m;
    Q = (x[r] - l[r] * Q) * inv_m;
    P = -(l[r] * P) * inv_m;
  }
  // d. the forward sweep dp_i = (b_i - l_i dp_{i-1}) inv_i, in place
  float y = scan_entry(P, Q, g, lane, false);
  for (int r = 0; r < rows; ++r) {
    y = (x[r] - l[r] * y) * d[r];
    x[r] = y;
  }
  // e. the back substitution x_i = dp_i - c_i x_{i+1}, in place
  P = 1.f;
  Q = 0.f;
  for (int r = rows - 1; r >= 0; --r) {
    Q = x[r] - u[r] * Q;
    P = -(u[r] * P);
  }
  y = scan_entry(P, Q, g, lane, true);
  for (int r = rows - 1; r >= 0; --r) {
    y = x[r] - u[r] * y;
    x[r] = y;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nsys * n; e += kLaneThreads) {
    const int s2 = e / n, i = e - s2 * n;
    out[(b0 + s2) * n + i] = X[s2 * span + (i / ch) * cp + i % ch];
  }
}

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers of float32
// tensors in the layouts above.  Each returns cudaGetLastError() after the
// launch, or the first error of the attribute call (0 = launched).
extern "C" int pde_thomas_batched(const float* lo, const float* d,
                                  const float* up, const float* b, float* out,
                                  float* C, int B, int n, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    thomas_batched<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        lo, d, up, b, out, C, B, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lane-group route: g lanes per system (a power of two up to 32), chunks
// of ch rows at a chunk stride cp >= ch in shared memory, smem_bytes =
// 4 (128 / g) g cp floats (at most 227 KB; the attribute is set only above
// the 48 KB every kernel may have).
extern "C" int pde_thomas_lanes(const float* lower, const float* diag,
                                const float* upper, const float* rhs, float* out,
                                long long sl, long long sd, long long su, long long sb,
                                int B, int n, int g, int ch, int cp, int smem_bytes,
                                void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        thomas_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0) {
    const int per = kLaneThreads / g;
    const int blocks = (B + per - 1) / per;
    thomas_lanes<<<blocks, kLaneThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        lower, diag, upper, rhs, out, sl, sd, su, sb, B, n, g, ch, cp);
  }
  return static_cast<int>(cudaGetLastError());
}
