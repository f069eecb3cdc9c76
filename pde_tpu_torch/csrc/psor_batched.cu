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
// float32); in practice the 2 n_iter barriers per system and the division
// per row bind.
//
// What this design does about it: one thread block per system, the
// iterate in shared memory (n floats), rows spread across the threads;
// each half-sweep updates one colour in parallel, then __syncthreads.  The
// operands are read from device memory each sweep through the read-only
// cache (5 n floats per system, L1-resident).  Blocks of different systems
// run on all SMs at once.
//
// Numerics: built with -fmad=false (ops/build.py), so every product and sum
// rounds on its own as in the plain twin, and the two agree bit for bit;
// division is IEEE (no fast math).
//
// Layout: row-major (B, n), contiguous, row-aligned bands: lo[:, 0] = 0,
// up[:, n-1] = 0.  lo, d, up, b, g and the optional x0 (null: start at
// max(b / d, g)) are inputs; x (B, n) is the output.  The kernel allocates
// nothing and does not synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
