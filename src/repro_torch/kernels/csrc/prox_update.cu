// Fused bi-level StoCFL client update (Algorithm 1 lines 21-22), in place:
//     theta <- theta - eta * (g_theta + lam * (theta - omega))
//     omega <- omega - eta * g_omega
//
// Replaces the TPU kernel src/repro/kernels/prox_update.py `_prox_kernel`
// (driven by `_prox_call`, public entry `prox_update_flat`), whose outputs
// alias theta and omega (input_output_aliases={0: 0, 1: 1}).
//
// Bound on an H100: memory. Each element reads four operands and writes two
// and does 7 flops, far below the card's ~20 flops per byte fp32 balance, so
// the least time is 6 * n * sizeof(T) bytes over the 3.35 TB/s of HBM3
// (n = 6.14 M fp32 on the slice's path: 147 MB, 44 us).
//
// Design: one pass over the four operands with 16-byte vector loads and
// stores (4 fp32 or 8 bf16 per access, neighbouring threads on neighbouring
// addresses) in a grid-stride loop, used when all four pointers are 16-byte
// aligned; the ragged tail (n not a multiple of the vector width) is masked
// and done element by element by the first threads of the grid instead of
// padding. Misaligned pointers take the scalar loop. Math is fp32 with each
// operation rounded separately (no FMA contraction), the same sequence of
// roundings as the plain PyTorch version; bf16 results round to nearest even.
//
// Local-SGD form (entry prox_theta_*), the theta output alone with a
// read-only anchor a:
//     theta <- theta - eta * (g + lam * (theta - a))
// This is what the reference's `bilevel.local_sgd` computes through the same
// TPU kernel: it passes its gradient as both g_theta and g_omega, the prox
// anchor (or theta itself, with lam = 0) in omega's slot, and drops the omega
// output. Here the anchor is never written, so it stays constant through the
// E local steps, and `a` may be theta itself (lam = 0): each element reads its
// anchor before its theta is stored, by the same thread. `a` has either
// theta's length or a period P dividing n, broadcast over the n / P rows of a
// cohort's (C, P) buffer (the shared prox anchor, read from L2 after the first
// row). Bound: memory, 12 bytes an fp32 element (theta and g read, theta
// written) plus the anchor read once; theta and g move in 16-byte vectors, a
// broadcast anchor element by element (its rows need not be 16-byte aligned).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float& dst, float v) { dst = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16& dst, float v) { dst = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void prox_one(T& th, T& om, T gt, T go, float eta, float lam) {
  const float t = to_f32(th);
  const float o = to_f32(om);
  const float inner = __fadd_rn(to_f32(gt), __fmul_rn(lam, __fsub_rn(t, o)));
  store_f32(th, __fsub_rn(t, __fmul_rn(eta, inner)));
  store_f32(om, __fsub_rn(o, __fmul_rn(eta, to_f32(go))));
}

// n elements; vector part covers [0, nvec * V), tail [nvec * V, n).
template <typename T>
__global__ void __launch_bounds__(256) prox_update_vec(
    T* __restrict__ th, T* __restrict__ om, const T* __restrict__ gt,
    const T* __restrict__ go, long long n, float eta, float lam) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = n / V;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 a = reinterpret_cast<const uint4*>(th)[i];
    uint4 b = reinterpret_cast<const uint4*>(om)[i];
    const uint4 c = reinterpret_cast<const uint4*>(gt)[i];
    const uint4 e = reinterpret_cast<const uint4*>(go)[i];
    T* ta = reinterpret_cast<T*>(&a);
    T* tb = reinterpret_cast<T*>(&b);
    const T* tc = reinterpret_cast<const T*>(&c);
    const T* te = reinterpret_cast<const T*>(&e);
#pragma unroll
    for (int v = 0; v < V; ++v) prox_one(ta[v], tb[v], tc[v], te[v], eta, lam);
    reinterpret_cast<uint4*>(th)[i] = a;
    reinterpret_cast<uint4*>(om)[i] = b;
  }
  const long long j = nvec * V + tid;
  if (j < n) prox_one(th[j], om[j], gt[j], go[j], eta, lam);
}

template <typename T>
__global__ void __launch_bounds__(256) prox_update_scalar(
    T* __restrict__ th, T* __restrict__ om, const T* __restrict__ gt,
    const T* __restrict__ go, long long n, float eta, float lam) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    prox_one(th[i], om[i], gt[i], go[i], eta, lam);
}

template <typename T>
int launch(void* th, void* om, const void* gt, const void* go, long long n,
           float eta, float lam, void* stream) {
  if (n <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  constexpr int threads = 256;
  const bool aligned = ((reinterpret_cast<uintptr_t>(th) | reinterpret_cast<uintptr_t>(om) |
                         reinterpret_cast<uintptr_t>(gt) | reinterpret_cast<uintptr_t>(go)) & 15) == 0;
  const long long work = aligned ? (n / V > n % V ? n / V : n % V) : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    prox_update_vec<T><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<T*>(th), static_cast<T*>(om), static_cast<const T*>(gt),
        static_cast<const T*>(go), n, eta, lam);
  } else {
    prox_update_scalar<T><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<T*>(th), static_cast<T*>(om), static_cast<const T*>(gt),
        static_cast<const T*>(go), n, eta, lam);
  }
  return (int)cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ void theta_one(T& th, float a, T g, float eta, float lam) {
  const float t = to_f32(th);
  const float inner = __fadd_rn(to_f32(g), __fmul_rn(lam, __fsub_rn(t, a)));
  store_f32(th, __fsub_rn(t, __fmul_rn(eta, inner)));
}

// BCAST: the anchor has period P < n (read as a[j % P]); else it has n
// elements and, on the vector path, is 16-byte aligned like theta and g.
// theta and a are not __restrict__: they are the same array when lam = 0.
template <typename T, bool BCAST>
__global__ void __launch_bounds__(256) prox_theta_vec(
    T* th, const T* a, const T* __restrict__ g, long long n, long long period,
    float eta, float lam) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = n / V;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 t = reinterpret_cast<const uint4*>(th)[i];
    const uint4 c = reinterpret_cast<const uint4*>(g)[i];
    T* tt = reinterpret_cast<T*>(&t);
    const T* tc = reinterpret_cast<const T*>(&c);
    if (BCAST) {
      long long col = (i * V) % period;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        theta_one(tt[v], to_f32(a[col]), tc[v], eta, lam);
        if (++col == period) col = 0;
      }
    } else {
      const uint4 e = reinterpret_cast<const uint4*>(a)[i];
      const T* te = reinterpret_cast<const T*>(&e);
#pragma unroll
      for (int v = 0; v < V; ++v) theta_one(tt[v], to_f32(te[v]), tc[v], eta, lam);
    }
    reinterpret_cast<uint4*>(th)[i] = t;
  }
  const long long j = nvec * V + tid;
  if (j < n) theta_one(th[j], to_f32(a[BCAST ? j % period : j]), g[j], eta, lam);
}

template <typename T>
__global__ void __launch_bounds__(256) prox_theta_scalar(
    T* th, const T* a, const T* __restrict__ g, long long n, long long period,
    float eta, float lam) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    theta_one(th[i], to_f32(a[i % period]), g[i], eta, lam);
}

template <typename T>
int launch_theta(void* th, const void* a, const void* g, long long n, long long period,
                 float eta, float lam, void* stream) {
  if (n <= 0) return 0;
  if (period <= 0 || n % period != 0) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  constexpr int threads = 256;
  const bool bcast = period != n;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(th) | reinterpret_cast<uintptr_t>(g) |
                         (bcast ? 0 : reinterpret_cast<uintptr_t>(a));
  const bool aligned = (addr & 15) == 0;
  const long long work = aligned ? (n / V > n % V ? n / V : n % V) : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* t = static_cast<T*>(th);
  const T* ap = static_cast<const T*>(a);
  const T* gp = static_cast<const T*>(g);
  if (!aligned)
    prox_theta_scalar<T><<<(unsigned)blocks, threads, 0, s>>>(t, ap, gp, n, period, eta, lam);
  else if (bcast)
    prox_theta_vec<T, true><<<(unsigned)blocks, threads, 0, s>>>(t, ap, gp, n, period, eta, lam);
  else
    prox_theta_vec<T, false><<<(unsigned)blocks, threads, 0, s>>>(t, ap, gp, n, period, eta, lam);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prox_theta_f32(void* th, const void* a, const void* g, long long n,
                              long long period, float eta, float lam, void* stream) {
  return launch_theta<float>(th, a, g, n, period, eta, lam, stream);
}

extern "C" int prox_theta_bf16(void* th, const void* a, const void* g, long long n,
                               long long period, float eta, float lam, void* stream) {
  return launch_theta<__nv_bfloat16>(th, a, g, n, period, eta, lam, stream);
}

extern "C" int prox_update_f32(void* th, void* om, const void* gt, const void* go,
                               long long n, float eta, float lam, void* stream) {
  return launch<float>(th, om, gt, go, n, eta, lam, stream);
}

extern "C" int prox_update_bf16(void* th, void* om, const void* gt, const void* go,
                                long long n, float eta, float lam, void* stream) {
  return launch<__nv_bfloat16>(th, om, gt, go, n, eta, lam, stream);
}
