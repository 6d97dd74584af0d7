// Union-find root resolution by pointer halving (kernel K4), int32:
//     repeat `steps` times:  p[i] <- p[p[i]]   for every i at once
// With steps = max(bit_length(N), 1) every path of a forest over N nodes is
// fully resolved, since each step halves every path. The step count is the
// caller's, so the result equals the plain version's exactly, on any input
// whose entries lie in [0, N).
//
// Replaces the TPU kernel src/repro/kernels/ops.py `_halving_kernel`
// (driven by `_resolve_pallas`, public entry `resolve_roots`), which keeps
// the array in VMEM and runs the steps as a fori_loop of gathers.
//
// Bound on an H100: the function reads N int32 once and writes N once,
// 8 * N bytes over 3.35 TB/s (1.2 ns at N = 512, 9.8 ns at N = 4096); it
// does no arithmetic worth counting. At the device clustering path's
// capacities (512, 4096) one launch on a few KB is bound by launch latency
// (a few us), not by either; only far larger capacities could show a gain.
//
// Design.
//   halving_resident: one block while the array fits in shared memory
//     (N <= 32768, 128 KB of dynamic shared memory), of N threads rounded up
//     to a warp, at most 1024. Load it, run the steps with a barrier between
//     each step's reads of p[p[i]] (held in registers, up to 32 a thread)
//     and its writes, store it. Nothing leaves the SM between steps. The
//     register loop stops after the entries a thread owns: left to run all
//     32 predicated iterations, dispatching those instructions across 32
//     warps cost far more than the gathers at N = 512.
//   halving_step: above that, one launch per step, ping-ponging between the
//     output and a scratch buffer (the input is never written), arranged so
//     the last step writes the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RESIDENT_MAX = 32768;   // int32 entries held in shared memory
constexpr int THREADS = 1024;
constexpr int PER_THREAD = RESIDENT_MAX / THREADS;
constexpr int STEP_THREADS = 256;

// block (min(round_up(n, 32), THREADS)); per = ceil(n / blockDim.x) <= PER_THREAD
__global__ void __launch_bounds__(THREADS) halving_resident(
    const int* __restrict__ parent, int* __restrict__ out, int n, int steps) {
  extern __shared__ int p[];
  const int nt = blockDim.x;
  const int per = (n + nt - 1) / nt;
  for (int i = threadIdx.x; i < n; i += nt) p[i] = parent[i];
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    int v[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (j >= per) break;
      const int i = threadIdx.x + j * nt;
      if (i < n) v[j] = p[p[i]];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (j >= per) break;
      const int i = threadIdx.x + j * nt;
      if (i < n) p[i] = v[j];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += nt) out[i] = p[i];
}

__global__ void __launch_bounds__(STEP_THREADS) halving_step(
    const int* __restrict__ src, int* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * STEP_THREADS + threadIdx.x;
  if (i < n) dst[i] = src[src[i]];
}

}  // namespace

// parent, out (n,) int32 contiguous; scratch (n,) int32, used (and needed)
// only when n > RESIDENT_MAX. steps >= 1.
extern "C" int resolve_roots_i32(const void* parent, void* out, void* scratch, long long n,
                                 int steps, void* stream) {
  if (n <= 0) return 0;
  if (steps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= RESIDENT_MAX) {
    const size_t smem = (size_t)n * sizeof(int);
    if (smem > 48 * 1024) {
      int err = (int)cudaFuncSetAttribute(halving_resident,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          RESIDENT_MAX * (int)sizeof(int));
      if (err) return err;
    }
    const int threads = n < THREADS ? (int)((n + 31) / 32 * 32) : THREADS;
    halving_resident<<<1, threads, smem, st>>>(static_cast<const int*>(parent),
                                                static_cast<int*>(out), (int)n, steps);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + STEP_THREADS - 1) / STEP_THREADS);
  const int* src = static_cast<const int*>(parent);
  for (int s = 0; s < steps; ++s) {
    int* dst = ((steps - 1 - s) % 2 == 0) ? static_cast<int*>(out) : static_cast<int*>(scratch);
    halving_step<<<blocks, STEP_THREADS, 0, st>>>(src, dst, n);
    int err = (int)cudaGetLastError();
    if (err) return err;
    src = dst;
  }
  return 0;
}
