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
// What bounds it on the H100: the roofline sees bytes (four (n, B) inputs
// read once and one written, 2 MB at B = 512, n = 200: 0.6 us at
// 3.35 TB/s) over ~9 flops a row; what binds it in practice is each
// system's serial chain of 2 (n - 1) dependent rows, the forward half with
// a reciprocal at every pivot, walked by one thread.
//
// What this design does about it: one thread per system in the batch-last
// (n, B) layout, so each row's loads and stores coalesce across a warp;
// the running c and dp stay in registers; dp goes straight into the output
// array and the back substitution overwrites it in place, so the only
// scratch is c (n, B).  Small blocks (64 threads) spread a batch of a few
// hundred systems over as many SMs as it can fill.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin; division is IEEE (no fast math).
//
// Layout: batch last and contiguous.  lo, d, up, b (n, B), row-aligned:
// lo[0] = 0 and up[n-1] = 0; out (n, B) is the solution; C (n, B) is
// scratch.  The kernel allocates nothing and does not synchronise; it runs
// on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

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

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers of float32
// tensors in the layout above.  Returns cudaGetLastError() after the launch
// (0 = launched).
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
