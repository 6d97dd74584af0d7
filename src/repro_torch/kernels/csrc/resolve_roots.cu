// The union-find layer of the device merge pass, two kernels, int32:
//
// 1. resolve_roots (kernel K4): synchronous pointer halving
//        repeat at most `steps` times:  p[i] <- p[p[i]]   for every i at once
//    With steps = max(bit_length(N), 1) every path of a forest over N nodes
//    is fully resolved, since each step halves every path. The step count is
//    the caller's, so the result equals the plain version's exactly, on any
//    input whose entries lie in [0, N), forest or not.
//
//    Replaces the TPU kernel src/repro/kernels/ops.py `_halving_kernel`
//    (driven by `_resolve_pallas`, public entry `resolve_roots`), which keeps
//    the array in VMEM and runs the steps as a fori_loop of gathers.
//
//    Why it may stop early. A synchronous step is one fixed function F of
//    the whole array. If a step changes no entry, F(p) = p, so every later
//    step changes none either, and F^steps(p0) equals the array after that
//    step. Stopping at the first step that changes nothing therefore gives
//    the fixed-step result exactly. Capping the loop at `steps` keeps inputs
//    that never reach a fixed point (a permutation cycle of length > 1)
//    exact too: they run all `steps` steps, as the plain version does.
//
// 2. component_labels: the merge pass's connected components of K3's fp32
//    0/1 adjacency (k, k), run to its fixed point in one launch. Starting
//    from label = arange(k), each pass sets
//        m_i = min(label_i, min_{j : adj_ij > 0} label_j),  label_i <- m[m_i]
//    (Jacobi: every thread reads the previous pass's labels) and the loop
//    stops after the first pass that changes nothing: pass for pass the
//    plain loop's labels (kernels/ref.py `component_labels_ref`). It takes
//    the place of the reference's jnp `lax.while_loop`
//    (src/repro/core/device_clustering.py `component_labels`), which the
//    port ran as a Python loop with one host sync a pass. It needs no cap:
//    label_i <= i holds throughout, so labels never increase and stay >= 0.
//
// Bounds on an H100. resolve_roots reads N int32 once and writes N once,
// 8 * N bytes over 3.35 TB/s (1.2 ns at N = 512, 9.8 ns at 4096);
// component_labels reads k * k fp32 once and writes k int32, 4k(k + 1)
// bytes (0.31 us at k = 512). Neither does arithmetic worth counting. At
// the device clustering path's sizes both are a few KB to a MB: the launch
// (a few us) and the chain of dependent steps inside it bound them, not
// the bytes. So each keeps its steps inside one block, with the state in
// shared memory, and ends the loop as soon as a block-wide vote says
// nothing moved. The vote is the step's closing barrier,
// __syncthreads_or(changed), and each step has that one barrier only:
// on the card a voting barrier costs more than a plain one (a chain took
// 18-21% longer when the second of two barriers a step voted), so the
// state is double-buffered and the vote replaces the barrier it saves.
//
// Design.
//   halving_resident: one block while the array fits in shared memory
//     (N <= 32768), of N threads rounded up to a warp, at most 1024. The
//     array is held twice, as 16-bit entries (every entry is < N <= 32768),
//     128 KB at most: a step reads p[p[i]] from one copy, writes the other
//     and notes whether the entry moved; the vote closes the step and the
//     copies swap. A barrier per step suffices: a step's writes go to the
//     copy that no thread reads until after the vote. On the path's inputs,
//     which the device clustering state keeps fully compressed, the first
//     step changes nothing and the kernel ends after it; a chain of depth
//     d takes ceil(log2 d) + 1 steps, as many as before.
//   halving_step: above that, one launch per step, ping-ponging between the
//     output and a scratch buffer (the input is never written), arranged so
//     the last step writes the output. It runs every step: stopping early
//     would need a host sync, and no path reaches it.
//   component_labels_kernel: phase 1 spreads the read of adj over up to
//     128 blocks of a few rows each: one SM alone is bound by the rate at
//     which it can dispatch the loads and ballots (a one-block version of this kernel
//     took 0.058 ms at k = 512 on an H100, this one 0.028 ms). Each warp reads 32 words of a row, 8
//     loads in flight, each load 32 consecutive floats (128 bytes,
//     coalesced) whose signs one __ballot_sync packs into a word; lane w
//     keeps word w and the warp stores the 32 words at once, into a global
//     bit matrix of k^2 / 8 bytes (32 KB at k = 512, held in L2). Each block
//     then counts itself in on an arrival counter; the last to arrive
//     (which resets the counter to 0 for the next launch) runs phase 2
//     alone: it copies the bit matrix into shared memory while k <= 1024
//     (at most 128 KB, rows padded to an odd word count so that the rows a
//     warp reads at once sit in different banks) and reads it from L2
//     above that, holds both label arrays in shared memory (in the global
//     scratch above k = 16384), and runs the passes. A pass gives each row
//     T threads (a power of two up to 32: T = 32 on the global matrix, so a
//     warp reads consecutive words; on the shared one as many as the block
//     has threads to spare, up to the row's word count), each walking the
//     set bits of every T-th word with __ffs, their minimum taken by
//     shuffles; a barrier; the jump m[m_i]; the vote. The label and bit
//     pointers are generic, so one body serves both placements.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int RESIDENT_MAX = 32768;   // entries held (twice, 16-bit) in shared memory
constexpr int THREADS = 1024;
constexpr int STEP_THREADS = 256;
constexpr int LABEL_THREADS = 1024;
constexpr int LABEL_BLOCKS = 128;     // most blocks that read adj in phase 1
constexpr int LABEL_LOADS = 8;        // adj loads in flight a lane in phase 1
constexpr int LABELS_MAX = 65536;     // largest k (K3 writes k < 65536)
constexpr unsigned FULL = 0xffffffffu;

// block (min(round_up(n, 32), THREADS)); 4 * n bytes of dynamic shared memory
__global__ void __launch_bounds__(THREADS) halving_resident(
    const int* __restrict__ parent, int* __restrict__ out, int n, int steps) {
  extern __shared__ unsigned short copies[];
  unsigned short* p = copies;
  unsigned short* q = copies + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = (unsigned short)parent[i];
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int old = p[i];
      const int next = p[old];
      q[i] = (unsigned short)next;
      changed |= next != old;
    }
    unsigned short* t = p;
    p = q;
    q = t;
    // a step that moved nothing is a fixed point of every later step
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = p[i];
}

__global__ void __launch_bounds__(STEP_THREADS) halving_step(
    const int* __restrict__ src, int* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * STEP_THREADS + threadIdx.x;
  if (i < n) dst[i] = src[src[i]];
}

// Phase 1 for rows [row0, row1): bit j % 32 of word row * words + j / 32 of
// gbits is adj[row][j] > 0. A warp takes a row's words 32 at a time; every
// branch around a ballot depends only on the warp. k <= LABELS_MAX keeps
// every index but the matrix's own in 32 bits.
__device__ void pack_rows(const float* __restrict__ adj, unsigned* __restrict__ gbits, int k,
                          int words, int row0, int row1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int groups = (words + 31) / 32;
  for (int g = warp; g < (row1 - row0) * groups; g += nwarps) {
    const int row = row0 + g / groups, w0 = (g % groups) * 32;
    const float* a = adj + (size_t)row * k;
    unsigned mine = 0;
    for (int w1 = 0; w1 < 32 && w0 + w1 < words; w1 += LABEL_LOADS) {
      float v[LABEL_LOADS];
#pragma unroll
      for (int u = 0; u < LABEL_LOADS; ++u) {
        const int col = (w0 + w1 + u) * 32 + lane;
        v[u] = col < k ? __ldg(a + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LABEL_LOADS; ++u) {
        const unsigned b = __ballot_sync(FULL, v[u] > 0.f);
        if (lane == w1 + u) mine = b;
      }
    }
    if (w0 + lane < words) gbits[row * words + w0 + lane] = mine;
  }
}

// Smallest label among the set bits of words first, first + step, ... < n.
// from_l2: the row is the global matrix, which other blocks wrote in this
// launch, so it is read past this SM's L1.
__device__ __forceinline__ int row_min(const unsigned* row, int first, int n, int step,
                                       const int* lab, bool from_l2) {
  int m = INT_MAX;
  for (int w = first; w < n; w += step) {
    unsigned b = from_l2 ? __ldcg(row + w) : row[w];
    while (b) {
      m = min(m, lab[(w << 5) + __ffs(b) - 1]);
      b &= b - 1;
    }
  }
  return m;
}

// grid (blocks), block (LABEL_THREADS); block b packs rows b * ceil(k /
// blocks) onwards. gbits: k * words words; glab: 2k
// int32 when !shared_labels; counter: one int32, 0 at launch, left 0.
// Dynamic shared memory: 2k int32 if shared_labels, then k * (words | 1)
// words if shared_bits. row_threads: a power of two <= 32.
__global__ void __launch_bounds__(LABEL_THREADS) component_labels_kernel(
    const float* __restrict__ adj, int* __restrict__ out, unsigned* gbits, int* glab,
    int* counter, int k, int words, int shared_bits, int shared_labels, int row_threads) {
  extern __shared__ unsigned smem[];
  __shared__ int last;
  const int rows = (k + gridDim.x - 1) / gridDim.x;
  const int row0 = min(k, (int)blockIdx.x * rows);
  pack_rows(adj, gbits, k, words, row0, min(k, row0 + rows));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  unsigned* free_smem = smem;
  int* lab = glab;
  if (shared_labels) {
    lab = reinterpret_cast<int*>(smem);
    free_smem += 2 * k;
  }
  int* mn = lab + k;
  const unsigned* bits = gbits;
  int stride = words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (shared_bits) {
    stride = words | 1;
    for (int row = warp; row < k; row += nwarps)
      for (int w = lane; w < words; w += 32) free_smem[row * stride + w] = __ldcg(gbits + row * words + w);
    bits = free_smem;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) lab[i] = i;
  __syncthreads();

  // thread t takes word t % T, t % T + T, ... of row t / T; a warp holds
  // whole rows, so its lanes reach every shuffle together
  const int span = (k * row_threads + 31) / 32 * 32;
  for (;;) {
    // m_i = min(label_i, labels of i's neighbours)
    for (int t = threadIdx.x; t < span; t += blockDim.x) {
      const int row = t / row_threads, sub = t % row_threads;
      int m = row < k ? row_min(bits + row * stride, sub, words, row_threads, lab, !shared_bits)
                      : INT_MAX;
      for (int o = row_threads / 2; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(FULL, m, o));
      if (row < k && sub == 0) mn[row] = min(m, lab[row]);
    }
    __syncthreads();
    // label_i <- m[m_i]
    int changed = 0;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const int next = mn[mn[i]];
      changed |= next != lab[i];
      lab[i] = next;
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = lab[i];
}

}  // namespace

// parent, out (n,) int32 contiguous; scratch (n,) int32, used (and needed)
// only when n > RESIDENT_MAX. steps >= 1 caps the resident route's steps and
// is the step count of the route above it.
extern "C" int resolve_roots_i32(const void* parent, void* out, void* scratch, long long n,
                                 int steps, void* stream) {
  if (n <= 0) return 0;
  if (steps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= RESIDENT_MAX) {
    const size_t smem = (size_t)n * 2 * sizeof(unsigned short);
    if (smem > 48 * 1024) {
      int err = (int)cudaFuncSetAttribute(halving_resident,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          RESIDENT_MAX * 2 * (int)sizeof(unsigned short));
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

// adj (k, k) fp32 contiguous; out (k,) int32; scratch: k * ceil(k / 32)
// uint32 words of bit matrix, then, when !shared_labels, 2k int32 of labels;
// counter: one int32 that is 0, and that the kernel leaves 0.
// 1 <= k <= LABELS_MAX; shared_bits needs k <= 1024, shared_labels
// k <= 16384 (the caller's choice, so a test can take the global routes).
extern "C" int component_labels_f32(const void* adj, void* out, void* scratch, void* counter,
                                    long long k, int shared_bits, int shared_labels,
                                    void* stream) {
  if (k <= 0) return 0;
  if (k > LABELS_MAX || scratch == nullptr || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long words = (k + 31) / 32;
  const long long smem_words = (shared_labels ? 2 * k : 0) + (shared_bits ? k * (words | 1) : 0);
  const size_t smem = (size_t)smem_words * sizeof(unsigned);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(component_labels_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  // threads a row in phase 2: a warp on the global matrix; on the shared one
  // the spare threads of the block, up to the row's word count
  int row_threads = 32;
  if (shared_bits) {
    row_threads = 1;
    while (row_threads < 32 && row_threads * 2 <= words && k * row_threads * 2 <= LABEL_THREADS)
      row_threads *= 2;
  }
  // at least 4 rows a block, at most LABEL_BLOCKS blocks
  const int blocks = (int)((k + 3) / 4 < LABEL_BLOCKS ? (k + 3) / 4 : LABEL_BLOCKS);
  unsigned* gbits = static_cast<unsigned*>(scratch);
  component_labels_kernel<<<blocks, LABEL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<int*>(out), gbits,
      reinterpret_cast<int*>(gbits + k * words), static_cast<int*>(counter), (int)k, (int)words,
      shared_bits, shared_labels, row_threads);
  return (int)cudaGetLastError();
}
