// Pairwise cosine similarity of the rows of x (N, D), fp32 -> (N, N) fp32:
//     out[i, j] = (x_i . x_j) * inv_i * inv_j,   inv = 1 / ||x_i||, 0 where the norm is 0
// so a zero row (the 64-row pad that ClusterState.similarity_matrix adds)
// gives exactly 0, its diagonal included.
//
// Replaces the TPU kernel src/repro/kernels/cosine_sim.py `_cosine_kernel`
// (public entry `cosine_sim`), which accumulates X.X^T over a sequential
// contraction grid axis in its output tile and scales by the inverse norms
// on the last step.
//
// Bound on an H100. The symmetric product needs N(N+1) * D flops in full
// fp32 on the CUDA cores (FFMA, not TF32: TF32 moves cosines by ~1e-3 and
// flips merges near tau), 67 TFLOP/s; the input is read once and the output
// written once, 4 * (N * D + N^2) bytes at 3.35 TB/s. At slice 1's
// (64, 153610): 0.639 GFLOP = 9.5 us against 39 MB = 11.7 us, so bytes.
//
// Design. A GPU has no sequential grid axis to carry a sum, and at the
// slice's shape the output is one 64x64 tile, which alone would occupy one of
// 132 SMs. So the contraction is split (split-K) in two passes with no
// atomics, which keeps the result deterministic:
//   1. cosine_partial: blocks over (column tile, row tile, K split) each
//      compute a 64x64 fp32 partial product over one K chunk (tiles of 32
//      columns staged in shared memory, a 4x4 register tile per thread) and
//      write it to a scratch buffer that the caller allocates;
//   2. cosine_inv_norm: the Gram diagonal summed over the splits gives each
//      row's squared norm, hence its inverse norm (0 for a zero row);
//   3. cosine_finish: sums the splits of each output in a fixed order and
//      applies the inverse-norm epilogue.
// A diagonal tile reads its rows once and uses them as both operands.
//
// merge_candidates_f32 (kernel K3) replaces the TPU kernel
// src/repro/kernels/cosine_sim.py `_candidates_kernel` (public entry
// `merge_candidates`): the same X.X^T, with the last step keeping
//     adj[i, j] = cos(x_i, x_j) >= tau  and  live_i  and  live_j  and  i != j
// as an fp32 0/1 matrix, so the cosine matrix itself is never written.
// It reuses passes 1 and 2 and ends in candidates_finish, which sums the
// splits in the same fixed order and applies the mask, the threshold and
// the zero diagonal in its epilogue (a zero row has cosine 0; the diagonal
// is 0 even for tau <= 1). Because X.X^T is symmetric and each entry of a
// tile and of its mirror is the same FFMA sequence, pass 1 computes only
// the tiles on and above the diagonal and the finish reads entry (i, j)
// from (min, max). The split-K partials still go through device memory
// (30 x 512 x 512 fp32 = 31 MB at the 4096-capacity path's (512, 153610),
// 601 x 64 x 64 = 9.8 MB at (64, 153610)): keeping them on chip is later
// work. The wrapper gives K3 more splits than K2 (kernels/cosine_sim.py
// split_plan) so that its upper tiles keep every SM busy.
// Bound of K3: operations. N(N+1) * D flops for the distinct dot products
// over 67 TFLOP/s against 4 * N * D bytes read and 4 * N^2 written over
// 3.35 TB/s: at (512, 153610) 40.3 GFLOP = 0.60 ms against 316 MB = 0.094 ms;
// at (64, 153610) 0.639 GFLOP = 9.5 us against 39 MB = 11.7 us (bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // output tile edge
constexpr int BK = 32;     // contraction columns staged per step
constexpr int PARTIAL_THREADS = 256;
constexpr int FINISH_LANES = 8;

// grid (tiles, tiles, splits); partial is (splits, np, np), np = tiles * TILE.
// With ``upper`` set only tiles with tj >= ti are written.
__global__ void __launch_bounds__(PARTIAL_THREADS) cosine_partial(
    const float* __restrict__ x, long long n, long long d, long long kchunk,
    float* __restrict__ partial, long long np, int upper) {
  __shared__ float As[TILE][BK + 1];
  __shared__ float Bs[TILE][BK + 1];
  const int tj = blockIdx.x, ti = blockIdx.y;
  if (upper && tj < ti) return;   // the mirror tile (tj, ti) holds the same sums
  const long long s = blockIdx.z;
  const bool diag = ti == tj;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;   // 16 x 16 threads
  const int lk = threadIdx.x & 31, lr = threadIdx.x >> 5;   // loader: 32 cols x 8 rows
  const long long k0 = s * kchunk;
  const long long k1 = k0 + kchunk < d ? k0 + kchunk : d;
  const float* Bsrc = diag ? &As[0][0] : &Bs[0][0];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long kb = k0; kb < k1; kb += BK) {
    const long long k = kb + lk;
    const bool kin = k < k1;
#pragma unroll
    for (int m = 0; m < TILE / 8; ++m) {
      const int r = lr + 8 * m;
      const long long gi = (long long)ti * TILE + r;
      As[r][lk] = (kin && gi < n) ? x[gi * d + k] : 0.f;
      if (!diag) {
        const long long gj = (long long)tj * TILE + r;
        Bs[r][lk] = (kin && gj < n) ? x[gj * d + k] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bsrc[(tx + 16 * j) * (BK + 1) + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* P = partial + s * np * np;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[((long long)ti * TILE + ty + 16 * i) * np + (long long)tj * TILE + tx + 16 * j] = acc[i][j];
}

// grid (n); one block sums row r's Gram diagonal over the splits
__global__ void __launch_bounds__(256) cosine_inv_norm(
    const float* __restrict__ partial, int splits, long long np, float* __restrict__ inv) {
  __shared__ float red[256];
  const long long r = blockIdx.x;
  float sum = 0.f;
  for (int s = threadIdx.x; s < splits; s += 256) sum += partial[s * np * np + r * np + r];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float g = red[0];
    inv[r] = g > 0.f ? 1.0f / sqrtf(g) : 0.f;
  }
}

// grid (ceil(n / 32), n), block (32, FINISH_LANES): lane ty sums splits ty, ty + 8, ...
__global__ void __launch_bounds__(32 * FINISH_LANES) cosine_finish(
    const float* __restrict__ partial, int splits, long long np, long long n,
    const float* __restrict__ inv, float* __restrict__ out) {
  __shared__ float red[FINISH_LANES][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * 32 + tx;
  const long long r = blockIdx.y;
  float sum = 0.f;
  if (c < n)
    for (int s = ty; s < splits; s += FINISH_LANES) sum += partial[s * np * np + r * np + c];
  red[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < n) {
    float t = red[0][tx];
#pragma unroll
    for (int l = 1; l < FINISH_LANES; ++l) t += red[l][tx];
    out[r * n + c] = t * (inv[r] * inv[c]);
  }
}

// grid (ceil(n / 32), n), block (32, FINISH_LANES); partial holds the upper tiles only
__global__ void __launch_bounds__(32 * FINISH_LANES) candidates_finish(
    const float* __restrict__ partial, int splits, long long np, long long n,
    const float* __restrict__ inv, const unsigned char* __restrict__ live, float tau,
    float* __restrict__ out) {
  __shared__ float red[FINISH_LANES][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * 32 + tx;
  const long long r = blockIdx.y;
  const long long lo = r < c ? r : c, hi = r < c ? c : r;
  float sum = 0.f;
  if (c < n)
    for (int s = ty; s < splits; s += FINISH_LANES) sum += partial[s * np * np + lo * np + hi];
  red[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < n) {
    float t = red[0][tx];
#pragma unroll
    for (int l = 1; l < FINISH_LANES; ++l) t += red[l][tx];
    const float cosv = t * (inv[r] * inv[c]);
    const bool ok = cosv >= tau && live[r] != 0 && live[c] != 0 && r != c;
    out[r * n + c] = ok ? 1.f : 0.f;
  }
}

}  // namespace

// x (n, d) fp32 contiguous; partial (splits, np, np) and inv (np,) are scratch;
// out (n, n). kchunk is a multiple of BK and splits = ceil(d / kchunk).
extern "C" int cosine_sim_f32(const void* x, long long n, long long d, long long kchunk,
                              int splits, void* partial, void* inv, void* out, void* stream) {
  if (n <= 0) return 0;
  if (kchunk <= 0 || kchunk % BK != 0 || splits <= 0 || (long long)splits * kchunk < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + TILE - 1) / TILE;
  const long long np = tiles * TILE;
  cosine_partial<<<dim3((unsigned)tiles, (unsigned)tiles, (unsigned)splits), PARTIAL_THREADS, 0, st>>>(
      static_cast<const float*>(x), n, d, kchunk, static_cast<float*>(partial), np, 0);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cosine_inv_norm<<<(unsigned)n, 256, 0, st>>>(static_cast<const float*>(partial), splits, np,
                                               static_cast<float*>(inv));
  err = (int)cudaGetLastError();
  if (err) return err;
  cosine_finish<<<dim3((unsigned)((n + 31) / 32), (unsigned)n), dim3(32, FINISH_LANES), 0, st>>>(
      static_cast<const float*>(partial), splits, np, n, static_cast<const float*>(inv),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// x (n, d) fp32 contiguous, live (n,) bytes (nonzero = live); partial
// (splits, np, np) and inv (np,) are scratch; out (n, n) fp32 0/1.
// kchunk is a multiple of BK and splits = ceil(d / kchunk).
extern "C" int merge_candidates_f32(const void* x, const void* live, long long n, long long d,
                                    long long kchunk, int splits, float tau, void* partial,
                                    void* inv, void* out, void* stream) {
  if (n <= 0) return 0;
  if (kchunk <= 0 || kchunk % BK != 0 || splits <= 0 || (long long)splits * kchunk < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + TILE - 1) / TILE;
  const long long np = tiles * TILE;
  cosine_partial<<<dim3((unsigned)tiles, (unsigned)tiles, (unsigned)splits), PARTIAL_THREADS, 0, st>>>(
      static_cast<const float*>(x), n, d, kchunk, static_cast<float*>(partial), np, 1);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cosine_inv_norm<<<(unsigned)n, 256, 0, st>>>(static_cast<const float*>(partial), splits, np,
                                               static_cast<float*>(inv));
  err = (int)cudaGetLastError();
  if (err) return err;
  candidates_finish<<<dim3((unsigned)((n + 31) / 32), (unsigned)n), dim3(32, FINISH_LANES), 0, st>>>(
      static_cast<const float*>(partial), splits, np, n, static_cast<const float*>(inv),
      static_cast<const unsigned char*>(live), tau, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
