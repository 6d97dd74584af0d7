// Selective scan (the Mamba recurrence), forward and backward:
//     h[t] = dA[t] * h[t-1] + dBx[t]          (elementwise over (d, n), h[-1] = 0)
//     y[t, d] = sum_n h[t, d, n] * C[t, n]
// dA, dBx: (B, S, D, N) fp32; C: (B, S, N) fp32; y: (B, S, D) fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py `_scan_kernel`
// (public entry `ssm_scan`), whose grid walks S in order and keeps h in VMEM
// scratch so the trajectory of h never reaches device memory. That kernel
// has no gradient; here the backward is a kernel too, so that training runs
// through the card's scan both ways.
//
// Bound on an H100: memory. The forward reads dA and dBx once (8 bytes per
// (b, t, d, n)) and does 4 flops there; the backward reads them and writes
// their two gradients (16 bytes) for about 7 flops. Both are far below the
// card's ~20 fp32 flops per byte.
//
// Design. One block of 256 threads owns 16 channels d of one batch row b
// (16 lanes n per channel, so N = 16) and walks S itself; blocks run in
// parallel over (D / 16, B). Each thread keeps its h[d, n] in a register;
// neighbouring threads read neighbouring (d, n), so each step's loads of dA
// and dBx are coalesced 1 KB rows. C[t, :] is staged in shared memory for a
// chunk of 16 steps; y[t, d] is the sum over a channel's 16 lanes by
// __shfl_xor_sync. The S and D tails are masked (a thread past D loads
// zeros and stores nothing) rather than padded.
//
// The forward also writes the state entering every chunk of 16 steps, hs:
// (B, ceil(S/16), D, N), 1/16 of dA's size. The backward walks the chunks
// last first: it recomputes the chunk's 16 states from hs into shared
// memory (with the chunk's dA), then runs the reverse recurrence
//     g_h[t] = g_y[t, d] * C[t, n] + dA[t+1] * g_h[t+1]
// and writes g_dA[t] = g_h[t] * h[t-1] and g_dBx[t] = g_h[t]. The gradient
// of C, g_C[t, n] = sum_d h[t, d, n] * g_y[t, d], is a reduction over all D:
// each block writes its 16 channels' partial sums (shuffles within a warp,
// then the 8 warps added in order), and a second kernel adds the
// ceil(D/16) partials of each (b, t, n) in block order. No atomics: two runs
// give bitwise equal results.
//
// Arithmetic: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), in the order of the plain PyTorch version
// (kernels/ref.py ssm_scan_states_ref, ssm_scan_bwd_ref), so h, g_dA and
// g_dBx equal it exactly; only the sums over n (y) and over d (g_C) are
// taken in another order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;     // steps per staged chunk and per saved state
constexpr int kN = 16;         // state width this build supports

template <int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_fwd_kernel(
    const float* __restrict__ dA, const float* __restrict__ dBx,
    const float* __restrict__ C, float* __restrict__ y, float* __restrict__ hs,
    int S, int D) {
  constexpr int CH = kThreads / N;                 // channels per block
  static_assert(kChunk * N <= kThreads, "one thread per staged C entry");
  __shared__ float c_sm[kChunk][N];
  const int tid = threadIdx.x;
  const int ch = tid / N, n = tid % N;
  const int b = blockIdx.y;
  const int d = blockIdx.x * CH + ch;
  const bool valid = d < D;
  const int nchunks = (S + kChunk - 1) / kChunk;
  float h = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, S - t0);
    if (valid) hs[(((long long)b * nchunks + k) * D + d) * N + n] = h;
    __syncthreads();                               // last chunk's c_sm reads done
    if (tid < kChunk * N) {
      const int tt = tid / N, nn = tid % N;
      c_sm[tt][nn] = tt < steps ? C[((long long)b * S + t0 + tt) * N + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const long long row = (long long)b * S + t0 + tt;
      const long long i = (row * D + d) * N + n;
      const float a = valid ? dA[i] : 0.f;
      const float bx = valid ? dBx[i] : 0.f;
      h = __fadd_rn(__fmul_rn(a, h), bx);
      float v = __fmul_rn(h, c_sm[tt][n]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (valid && n == 0) y[row * D + d] = v;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(
    const float* __restrict__ dA, const float* __restrict__ dBx,
    const float* __restrict__ C, const float* __restrict__ hs,
    const float* __restrict__ gy, float* __restrict__ g_dA,
    float* __restrict__ g_dBx, float* __restrict__ gc_part, int S, int D) {
  constexpr int CH = kThreads / N;
  constexpr int W = kThreads / 32;                 // warps per block
  static_assert(kChunk * N <= kThreads && kChunk * CH <= kThreads, "staging");
  __shared__ float h_sm[kChunk][kThreads];         // the chunk's states h[t]
  __shared__ float a_sm[kChunk][kThreads];         // the chunk's dA[t]
  __shared__ float gc_sm[kChunk][W][N];            // per-warp g_C partials
  __shared__ float c_sm[kChunk][N];
  __shared__ float gy_sm[kChunk][CH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / N, n = tid % N;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH, d = d0 + ch;
  const bool valid = d < D;
  const int nblk = gridDim.x;
  const int nchunks = (S + kChunk - 1) / kChunk;
  float carry = 0.f;                               // dA[t+1] * g_h[t+1]
  for (int k = nchunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, S - t0);
    __syncthreads();                               // last chunk's shared reads done
    if (tid < kChunk * N) {
      const int tt = tid / N, nn = tid % N;
      c_sm[tt][nn] = tt < steps ? C[((long long)b * S + t0 + tt) * N + nn] : 0.f;
    }
    if (tid < kChunk * CH) {
      const int tt = tid / CH, cc = tid % CH;
      gy_sm[tt][cc] = (tt < steps && d0 + cc < D)
                          ? gy[((long long)b * S + t0 + tt) * D + d0 + cc] : 0.f;
    }
    const float h0 = valid ? hs[(((long long)b * nchunks + k) * D + d) * N + n] : 0.f;
    float h = h0;
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const long long i = (((long long)b * S + t0 + tt) * D + d) * N + n;
      const float a = valid ? dA[i] : 0.f;
      const float bx = valid ? dBx[i] : 0.f;
      h = __fadd_rn(__fmul_rn(a, h), bx);
      a_sm[tt][tid] = a;
      h_sm[tt][tid] = h;
    }
    __syncthreads();
    for (int tt = steps - 1; tt >= 0; --tt) {
      const long long i = (((long long)b * S + t0 + tt) * D + d) * N + n;
      const float g = gy_sm[tt][ch];
      const float gh = __fadd_rn(__fmul_rn(g, c_sm[tt][n]), carry);
      const float hp = tt > 0 ? h_sm[tt - 1][tid] : h0;
      if (valid) {
        g_dA[i] = __fmul_rn(gh, hp);
        g_dBx[i] = gh;
      }
      carry = __fmul_rn(a_sm[tt][tid], gh);
      float v = __fmul_rn(h_sm[tt][tid], g);       // 0 past D (g = 0 there)
#pragma unroll
      for (int off = N; off < 32; off <<= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane < N) gc_sm[tt][warp][lane] = v;
    }
    __syncthreads();
    if (tid < steps * N) {
      const int tt = tid / N, nn = tid % N;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s = __fadd_rn(s, gc_sm[tt][w][nn]);
      gc_part[(((long long)b * S + t0 + tt) * nblk + blockIdx.x) * N + nn] = s;
    }
  }
}

// g_C[r, n] = sum over j of gc_part[r, j, n], j in order (r = b * S + t).
__global__ void __launch_bounds__(kThreads) ssm_scan_gc_reduce(
    const float* __restrict__ gc_part, float* __restrict__ gC, long long rows,
    int nblk, int N) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * N) return;
  const long long r = idx / N;
  const int n = (int)(idx % N);
  const float* p = gc_part + r * nblk * N + n;
  float s = 0.f;
  for (int j = 0; j < nblk; ++j) s = __fadd_rn(s, p[(long long)j * N]);
  gC[idx] = s;
}

bool supported(int B, int N, int chunk) {
  return N == kN && chunk == kChunk && B <= 65535;
}

}  // namespace

// y (B, S, D) and hs (B, ceil(S/chunk), D, N) from dA, dBx (B, S, D, N), C (B, S, N).
extern "C" int ssm_scan_fwd_f32(const void* dA, const void* dBx, const void* C, void* y,
                                void* hs, int B, int S, int D, int N, int chunk,
                                void* stream) {
  if (!supported(B, N, chunk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || D == 0) return 0;
  constexpr int CH = kThreads / kN;
  const dim3 grid((D + CH - 1) / CH, B);
  ssm_scan_fwd_kernel<kN><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(hs), S, D);
  return (int)cudaGetLastError();
}

// g_dA, g_dBx (B, S, D, N) and g_C (B, S, N) from the forward's inputs, its
// saved states hs and g_y (B, S, D); gc_part is (B, S, ceil(D/16), N) scratch.
extern "C" int ssm_scan_bwd_f32(const void* dA, const void* dBx, const void* C,
                                const void* hs, const void* gy, void* g_dA, void* g_dBx,
                                void* gc_part, void* gC, int B, int S, int D, int N,
                                int chunk, void* stream) {
  if (!supported(B, N, chunk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int CH = kThreads / kN;
  const int nblk = (D + CH - 1) / CH;
  if (D > 0) {
    ssm_scan_bwd_kernel<kN><<<dim3(nblk, B), kThreads, 0, s>>>(
        static_cast<const float*>(dA), static_cast<const float*>(dBx),
        static_cast<const float*>(C), static_cast<const float*>(hs),
        static_cast<const float*>(gy), static_cast<float*>(g_dA),
        static_cast<float*>(g_dBx), static_cast<float*>(gc_part), S, D);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const long long rows = (long long)B * S;
  const long long blocks = (rows * N + kThreads - 1) / kThreads;
  ssm_scan_gc_reduce<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(gc_part), static_cast<float*>(gC), rows, nblk, N);
  return (int)cudaGetLastError();
}
