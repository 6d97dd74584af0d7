// Gram-matrix kernels K2 cosine_sim_f32 and K3 merge_candidates_f32: one
// X.X^T over the rows of x (N, D), fp32, with two epilogues:
//   K2  out[i, j] = G[i, j] * (inv_i * inv_j),  inv = 1 / ||x_i||, 0 for a zero row
//   K3  out[i, j] = (G[i, j] * (inv_i * inv_j) >= tau) && live_i && live_j && i != j
// as fp32 (K3 writes 0/1 and never the cosine matrix). A zero row gives
// exactly 0 everywhere, its diagonal included.
//
// Replaces the TPU kernels src/repro/kernels/cosine_sim.py:30 `_cosine_kernel`
// (K2) and src/repro/kernels/cosine_sim.py:79 `_candidates_kernel` (K3),
// which accumulate X.X^T over a sequential contraction grid axis in their
// output tile and apply the epilogue on the last step.
//
// Bounds on an H100 SXM. The symmetric product needs N(N+1) * D operations.
// A fp32-accurate product on the tensor cores is 3xTF32: three TF32 passes
// (lo.hi + hi.lo + hi.hi) at 495 TFLOP/s, 3 * N(N+1) * D / 495e12 s. Single
// TF32 is not enough: it moves cosines by ~1e-5 at (512, 20000), the margin
// the merge decision cos >= tau is checked at. Bytes: x read once and the
// output written once, 4 * (N * D + N^2) at 3.35 TB/s. At (64, 153610):
// 11.7 us by bytes (3.9 us of 3xTF32 operations); at (512, 153610): 0.2445 ms
// by operations (0.094 ms of bytes); at (2048, 153610): 3.91 ms by
// operations. For comparison, the same operations in FFMA at 67 TFLOP/s:
// 9.5 us, 0.6022 ms, 9.6 ms.
//
// Design (one launch, deterministic):
// * Tensor cores, 3xTF32. Each k-step of 32 columns arrives raw in shared
//   memory. The consumers split B (the column tile) into hi =
//   cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), written to
//   double-buffered 128B-swizzled tiles that wgmma reads through
//   descriptors. Off the diagonal, A (the row tile) is loaded into
//   registers in wgmma's fragment layout and split there; a diagonal tile
//   reads A from split B. Per 8 columns a warpgroup issues lo.hi, hi.lo,
//   then hi.hi (m64nTk8, B K-major from shared memory): the small products
//   first. The tensor cores add into their accumulator rounding toward
//   zero, which over one long chain drifts far beyond fp32 rounding, so
//   each k-step sums its 12 products in a fresh stage accumulator that is
//   then added to the running sum in fp32, to nearest. Splitting the next
//   k-step overlaps the tensor cores' work on this one.
// * Bytes: a TMA ring. One tensor map over x (box 64 rows x 32 fp32 = 128 B,
//   SWIZZLE_128B, zero fill beyond N and D), STAGES k-steps in flight on
//   full/empty mbarriers, one producer warpgroup (one thread issuing; the
//   group hands its registers to the consumers with setmaxnreg) and two
//   consumer warpgroups: at T = 128 they split the tile's rows, at T = 64
//   each takes every other k-step and their sums are added at the end. A
//   diagonal tile loads its rows once and uses them as both operands. TMA
//   needs a row stride that is a multiple of 16 bytes: the callers build
//   their matrices with rows D rounded up to 32 floats apart, and the kernel
//   takes the stride as an argument.
// * Work split: only the output tiles on and above the diagonal, each split
//   over the contraction (split-K) so that the grid fills the card; blocks
//   of one K slice are adjacent in the grid, so their rows come from L2. The
//   splits are reduced in the same launch: each block writes its partial
//   tile (a diagonal tile only its upper triangle) and the partial sums of
//   squares of its rows to a workspace and counts itself in on a
//   per-(tile, group) counter; the last block of a group of splits sums the
//   group's partials in split order, and the last group's finisher sums the
//   groups in order and runs the epilogue. The counters decide who sums,
//   never the order, so the result is bitwise repeatable; they are reset by
//   the block that takes them last.
// * Epilogue: the inverse norms come from the rows' own fp32 sums of squares
//   (as the reference computes them); the diagonal tile reads entry (i, j)
//   from (min, max) and off-diagonal tiles write their mirror, so the output
//   is exactly symmetric.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BOX_ROWS = 64;                        // rows of one TMA box
constexpr int KSTEP = 32;                           // fp32 columns per k-step: 128 B
constexpr int BOX_BYTES = BOX_ROWS * KSTEP * 4;     // 8 KB

template <int T>
struct Cfg {
  // Two consumer warpgroups and one producer warpgroup. At T = 128 the
  // consumers split the tile's rows and form one team; at T = 64 each is a
  // team of its own that takes every other k-step, and the two teams' sums
  // are added at the end.
  static constexpr int CONSUMERS = 256;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int TEAMS = T == 64 ? 2 : 1;
  static constexpr int TEAM = CONSUMERS / TEAMS;    // threads of a team: 2 T
  static constexpr int STAGES = T == 64 ? 8 : 4;
  static constexpr int OPERAND = T * KSTEP * 4;     // one operand tile of a k-step
  static constexpr int STAGE = 2 * OPERAND;         // A then B
  static constexpr int SPLIT = 2 * OPERAND;         // B's hi then lo
  static constexpr int REC = T * T + 2 * T;         // partial: tile, sumsq of A rows, of B rows
  static constexpr int LD = T + 1;                  // row stride of the summed tile in smem
  static constexpr size_t SMEM =
      1024 + STAGES * STAGE + 2 * TEAMS * SPLIT + 2 * STAGES * 8 + 16;
  static_assert(TEAM == 2 * T, "a team splits a k-step four 16-byte chunks a thread");
  static_assert((T * LD + 2 * T) * 4 <= STAGES * STAGE, "summed tile must fit in the ring");
  static_assert(TEAMS == 1 || (T / 2 + 6) * TEAM * 4 <= STAGES * STAGE, "team sums must fit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row)
      : "memory");
}

// named barrier ``id`` (1..) among ``threads`` consumer threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128B-swizzled by
// TMA (8-row groups 1024 B apart); the tile's base is 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n64k8(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n128k8(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


// d = a . b + (scale_d ? d : 0) for a 64 x T tile: a (64 x 8) from
// registers, b (T x 8) at desc
template <int T>
__device__ __forceinline__ void wgmma(float (&d)[T / 2], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  if constexpr (T == 64)
    wgmma_m64n64k8(d, a, desc, scale_d);
  else
    wgmma_m64n128k8(d, a, desc, scale_d);
}

// the same with a (64 x 8) K-major in shared memory at desc_a
template <int T>
__device__ __forceinline__ void wgmma_ss(float (&d)[T / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (T == 64)
    wgmma_ss_m64n64k8(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_m64n128k8(d, desc_a, desc_b, scale_d);
}

// The consumer warpgroups of one block: the product over the block's
// k-steps, its partial record, and, in the block that arrives last, the
// split-K reduction and the epilogue.
template <int T, bool CAND, bool DIAG>
__device__ __forceinline__ void consume(uint8_t* ring, uint8_t* split, uint64_t* full,
                                        uint64_t* empty, volatile int* flag, int n, int nsteps,
                                        int splits, int group, int upper, int u, int s, int ti,
                                        int tj, float* __restrict__ work,
                                        int* __restrict__ counters,
                                        const unsigned char* __restrict__ live, float tau,
                                        float* __restrict__ out) {
  using C = Cfg<T>;
  const int c = threadIdx.x;
  const int wg = c >> 7, w = (c >> 5) & 3, lane = c & 31, g = lane >> 2, t = lane & 3;
  const int team = C::TEAMS == 2 ? wg : 0;
  const int tc = c - team * C::TEAM;                  // index within the team
  const int ra = (C::TEAMS == 2 ? 0 : wg * 64) + w * 16 + g;   // A rows ra and ra + 8
  const int team_bar = 2 + team;
  // the team's k-steps: i = j * TEAMS + team for j < nsub
  const int nsub = (nsteps - team + C::TEAMS - 1) / C::TEAMS;

  float acc[T / 2], stage[T / 2];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) acc[i] = stage[i] = 0.f;
  float sqa0 = 0.f, sqa1 = 0.f, sqb[4] = {0.f, 0.f, 0.f, 0.f};

  // A team's k-steps are pipelined: while the tensor cores work on one, the
  // team splits the next. The j-th k-step's B goes to split buffer
  // 2 * team + j % 2, element by element at its swizzled place; off the
  // diagonal its A fragments go to registers ahi/alo[j % 2] (wgmma's layout
  // for tf32 m64k8: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of
  // the warp's 16 rows), read through the 128B swizzle: 16-byte chunk k of
  // row r lies at k ^ (r % 8). A diagonal tile reads A from split B.
  uint32_t ahi[2][4][4], alo[2][4][4];
  auto split_step = [&](auto P, int j) {
    constexpr int p = decltype(P)::value;
    const int i = j * C::TEAMS + team;
    const int st = i % C::STAGES;
    mbar_wait(&full[st], (i / C::STAGES) & 1);
    const uint8_t* b = ring + st * C::STAGE + C::OPERAND;
    if constexpr (!DIAG) {
      const uint8_t* a = b - C::OPERAND;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = ra + (q & 1) * 8;
          const int chunk = (2 * k + (q >> 1)) ^ g;
          const float v = *reinterpret_cast<const float*>(a + r * 128 + chunk * 16 + t * 4);
          const uint32_t hv = to_tf32(v);
          ahi[p][k][q] = hv;
          alo[p][k][q] = to_tf32(v - __uint_as_float(hv));
          if (q & 1)
            sqa1 = fmaf(v, v, sqa1);
          else
            sqa0 = fmaf(v, v, sqa0);
        }
      }
    }
    uint8_t* hi = split + (2 * team + (j & 1)) * C::SPLIT;
    uint8_t* lo = hi + C::OPERAND;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int off = (tc + m * C::TEAM) * 16;        // row off / 128
      const float4 v = *reinterpret_cast<const float4*>(b + off);
      uint4 hv, lv;
      hv.x = to_tf32(v.x);
      hv.y = to_tf32(v.y);
      hv.z = to_tf32(v.z);
      hv.w = to_tf32(v.w);
      lv.x = to_tf32(v.x - __uint_as_float(hv.x));
      lv.y = to_tf32(v.y - __uint_as_float(hv.y));
      lv.z = to_tf32(v.z - __uint_as_float(hv.z));
      lv.w = to_tf32(v.w - __uint_as_float(hv.w));
      *reinterpret_cast<uint4*>(hi + off) = hv;
      *reinterpret_cast<uint4*>(lo + off) = lv;
      sqb[m] = fmaf(v.x, v.x, sqb[m]);
      sqb[m] = fmaf(v.y, v.y, sqb[m]);
      sqb[m] = fmaf(v.z, v.z, sqb[m]);
      sqb[m] = fmaf(v.w, v.w, sqb[m]);
    }
    mbar_arrive(&empty[st]);   // this thread is done with the raw k-step
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  // The tensor cores add into their accumulator rounding toward zero, so a
  // long chain of wgmma additions drifts far beyond fp32 rounding: each
  // k-step sums its 12 products in a fresh stage accumulator, which is then
  // added into acc in fp32, to nearest.
  auto issue_step = [&](auto P, int j) {
    constexpr int p = decltype(P)::value;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    reg_fence(stage);
    const uint64_t dhi = sw128_desc(split + (2 * team + (j & 1)) * C::SPLIT);
    const uint64_t dlo = dhi + C::OPERAND / 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 2 * k;                            // 32 bytes per 8 columns
      if constexpr (DIAG) {   // A: this warpgroup's 64 rows of split B, 8 KB = 512 units apart
        const uint64_t row = (C::TEAMS == 2 ? 0 : wg) * 512;
        wgmma_ss<T>(stage, dlo + row + col, dhi + col, k > 0);
        wgmma_ss<T>(stage, dhi + row + col, dlo + col, 1);
        wgmma_ss<T>(stage, dhi + row + col, dhi + col, 1);
      } else {
        wgmma<T>(stage, alo[p][k], dhi + col, k > 0);
        wgmma<T>(stage, ahi[p][k], dlo + col, 1);
        wgmma<T>(stage, ahi[p][k], dhi + col, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };
  auto retire_step = [&](auto P) {
    constexpr int p = decltype(P)::value;
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    reg_fence(stage);
    if constexpr (!DIAG) {   // the fragments stay put until the products are done
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(ahi[p][k][q]), "+r"(alo[p][k][q]));
    }
#pragma unroll
    for (int j = 0; j < T / 2; ++j) acc[j] += stage[j];
    named_sync(team_bar, C::TEAM);
  };
  using P0 = std::integral_constant<int, 0>;
  using P1 = std::integral_constant<int, 1>;
  if (nsub > 0) {
    split_step(P0{}, 0);
    named_sync(team_bar, C::TEAM);
  }
  for (int j = 0; j < nsub; j += 2) {
    issue_step(P0{}, j);
    if (j + 1 < nsub) split_step(P1{}, j + 1);
    retire_step(P0{});
    if (j + 1 < nsub) {
      issue_step(P1{}, j + 1);
      if (j + 2 < nsub) split_step(P0{}, j + 2);
      retire_step(P1{});
    }
  }

  // at T = 64 the second team hands its sums to the first through shared
  // memory (the ring is free once both are done): team 0's + team 1's
  named_sync(1, C::CONSUMERS);
  if constexpr (C::TEAMS == 2) {
    float* xch = reinterpret_cast<float*>(ring);
    if (team == 1) {
#pragma unroll
      for (int j = 0; j < T / 2; ++j) xch[j * C::TEAM + tc] = acc[j];
      xch[(T / 2) * C::TEAM + tc] = sqa0;
      xch[(T / 2 + 1) * C::TEAM + tc] = sqa1;
#pragma unroll
      for (int m = 0; m < 4; ++m) xch[(T / 2 + 2 + m) * C::TEAM + tc] = sqb[m];
    }
    named_sync(1, C::CONSUMERS);
    if (team == 0) {
#pragma unroll
      for (int j = 0; j < T / 2; ++j) acc[j] += xch[j * C::TEAM + tc];
      sqa0 += xch[(T / 2) * C::TEAM + tc];
      sqa1 += xch[(T / 2 + 1) * C::TEAM + tc];
#pragma unroll
      for (int m = 0; m < 4; ++m) sqb[m] += xch[(T / 2 + 2 + m) * C::TEAM + tc];
    }
  }

  // This block's partial record. Off the diagonal: the tile, row-major,
  // then the sums of squares of the A rows and of the B rows. A diagonal
  // tile keeps its upper triangle (entry (r, c), r <= c, at
  // r (2T - r + 1) / 2 + c - r) and its rows' sums (from B): half the bytes
  // for the reduction to move. Accumulator layout: d[4j + v] at row
  // g + 8 (v >> 1), column 8j + 2t + (v & 1) of the warp's 16 rows.
  constexpr int TRI = T * (T + 1) / 2;
  constexpr int NREC = DIAG ? TRI + T : C::REC;     // floats used of the record
  static_assert(NREC % 4 == 0, "records are summed 16 bytes at a time");
  auto tri = [](int r, int cc) { return r * (2 * T - r + 1) / 2 + cc - r; };
  float* rec = work + ((size_t)u * splits + s) * C::REC;
  if (team == 0) {
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = ra + 8 * (v >> 1), col = 8 * j + 2 * t + (v & 1);
        if constexpr (DIAG) {
          if (r <= col) rec[tri(r, col)] = acc[4 * j + v];
        } else {
          rec[r * T + col] = acc[4 * j + v];
        }
      }
    }
    if constexpr (!DIAG) {
      sqa0 += __shfl_xor_sync(0xffffffffu, sqa0, 1);
      sqa0 += __shfl_xor_sync(0xffffffffu, sqa0, 2);
      sqa1 += __shfl_xor_sync(0xffffffffu, sqa1, 1);
      sqa1 += __shfl_xor_sync(0xffffffffu, sqa1, 2);
      if (t == 0) {
        rec[T * T + ra] = sqa0;
        rec[T * T + ra + 8] = sqa1;
      }
    }
    float* sqb_rec = rec + (DIAG ? TRI : T * T + T);
#pragma unroll
    for (int m = 0; m < 4; ++m) {   // B rows tc / 8 + m * T / 4, 8 lanes a row
      float v = sqb[m];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if ((tc & 7) == 0) sqb_rec[(tc >> 3) + m * (T / 4)] = v;
    }
  }

  // split-K reduction in this launch: the last block of each group of
  // splits sums the group in split order; the last group's finisher sums
  // the groups in order into shared memory (the ring is free by now)
  const int ngroups = (splits + group - 1) / group;
  const int gq = s / group, g0 = gq * group, g1 = min(splits, g0 + group);
  float* base = work + (size_t)u * splits * C::REC;
  __threadfence();
  named_sync(1, C::CONSUMERS);
  if (c == 0) {
    int* cnt = counters + u * ngroups + gq;
    const bool last = atomicAdd(cnt, 1) == g1 - g0 - 1;
    if (last) *cnt = 0;
    *flag = last;
  }
  named_sync(1, C::CONSUMERS);
  if (!*flag) return;
  __threadfence();
  // the summed record in shared memory: a diagonal tile's as it is; off the
  // diagonal the tile with rows LD apart, then the sums of squares
  float* fin = reinterpret_cast<float*>(ring);
  float* fsq = fin + (DIAG ? TRI : T * C::LD);
  // sums ``count`` records ``step`` floats apart from ``first``, in order,
  // into the record at ``slot`` or, when it is null, into fin and fsq. Each
  // thread takes PER 16-byte chunks a pass, with 4 records' loads of all of
  // them in flight; the passes cover the record with no short tail pass.
  auto sum_records = [&](const float* first, size_t step, int count, float* slot) {
    constexpr int NV = NREC / 4;
    constexpr int PASSES = (NV + 8 * C::CONSUMERS - 1) / (8 * C::CONSUMERS);
    constexpr int PER = (NV + PASSES * C::CONSUMERS - 1) / (PASSES * C::CONSUMERS);
#pragma unroll 1
    for (int pass = 0; pass < PASSES; ++pass) {
      float4 v[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = c + (pass * PER + k) * C::CONSUMERS;
        v[k] = e < NV ? __ldcg(reinterpret_cast<const float4*>(first) + e)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 4
      for (int q = 1; q < count; ++q) {
        const float4* src = reinterpret_cast<const float4*>(first + q * step);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int e = c + (pass * PER + k) * C::CONSUMERS;
          if (e < NV) {
            const float4 x = __ldcg(src + e);
            v[k].x += x.x;
            v[k].y += x.y;
            v[k].z += x.z;
            v[k].w += x.w;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = c + (pass * PER + k) * C::CONSUMERS;
        if (e >= NV) continue;
        if (slot != nullptr) {
          __stcg(reinterpret_cast<float4*>(slot) + e, v[k]);
        } else if (DIAG) {
          *reinterpret_cast<float4*>(fin + 4 * e) = v[k];
        } else if (4 * e < T * T) {
          float* q = fin + (4 * e / T) * C::LD + (4 * e % T);
          q[0] = v[k].x;
          q[1] = v[k].y;
          q[2] = v[k].z;
          q[3] = v[k].w;
        } else {
          *reinterpret_cast<float4*>(fsq + 4 * e - T * T) = v[k];
        }
      }
    }
  };
  float* gslot = base + (size_t)g0 * C::REC;
  sum_records(gslot, C::REC, g1 - g0, ngroups > 1 ? gslot : nullptr);
  if (ngroups > 1) {
    __threadfence();
    named_sync(1, C::CONSUMERS);
    if (c == 0) {
      int* cnt = counters + upper * ngroups + u;
      const bool last = atomicAdd(cnt, 1) == ngroups - 1;
      if (last) *cnt = 0;
      *flag = last;
    }
    named_sync(1, C::CONSUMERS);
    if (!*flag) return;
    __threadfence();
    sum_records(base, (size_t)group * C::REC, ngroups, nullptr);
  }
  named_sync(1, C::CONSUMERS);
  for (int r = c; r < (DIAG ? T : 2 * T); r += C::CONSUMERS) {
    const float q = fsq[r];
    fsq[r] = q > 0.f ? 1.0f / sqrtf(q) : 0.f;
  }
  named_sync(1, C::CONSUMERS);

  // epilogue; a diagonal tile takes both norms from its B rows and entry
  // (i, j) from (min, max), so every output is symmetric
  const float* inv_r = fsq;
  const float* inv_c = DIAG ? fsq : fsq + T;
  for (int e = c; e < T * T; e += C::CONSUMERS) {
    const int r = e / T, cc = e % T;
    const int i = ti * T + r, j = tj * T + cc;
    if (i >= n || j >= n) continue;
    const float gv = DIAG ? fin[r <= cc ? tri(r, cc) : tri(cc, r)] : fin[r * C::LD + cc];
    const float v = gv * (inv_r[r] * inv_c[cc]);
    out[(size_t)i * n + j] =
        CAND ? ((v >= tau && live[i] && live[j] && i != j) ? 1.f : 0.f) : v;
  }
  if constexpr (DIAG) return;
  for (int e = c; e < T * T; e += C::CONSUMERS) {   // the mirror, row by row of the output
    const int cc = e / T, r = e % T;
    const int i = ti * T + r, j = tj * T + cc;
    if (i >= n || j >= n) continue;
    const float v = fin[r * C::LD + cc] * (inv_r[r] * inv_c[cc]);
    out[(size_t)j * n + i] = CAND ? ((v >= tau && live[i] && live[j]) ? 1.f : 0.f) : v;
  }
}

// One block of either kernel. Grid: upper * splits blocks, block b
// computing upper tile b % upper over split b / upper. work holds
// upper * splits records of Cfg<T>::REC floats; counters (upper * ngroups +
// upper ints) are 0 at launch and left 0.
template <int T, bool CAND>
__device__ __forceinline__ void gram_block(
    const CUtensorMap* map_ptr, int n, int ksteps, int per_split, int splits, int group,
    int tiles, float* __restrict__ work, int* __restrict__ counters,
    const unsigned char* __restrict__ live, float tau, float* __restrict__ out) {
  const CUtensorMap& map = *map_ptr;
  using C = Cfg<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* split = ring + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(split + 2 * C::TEAMS * C::SPLIT);
  uint64_t* empty = full + C::STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(empty + C::STAGES);

  const int upper = tiles * (tiles + 1) / 2;
  const int u = blockIdx.x % upper, s = blockIdx.x / upper;
  int ti = 0, rem = u;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int kb = s * per_split;
  const int nsteps = max(0, min(ksteps, kb + per_split) - kb);

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::TEAM);    // a k-step is split by one team
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // producer warpgroup: gives its registers to the consumers (the launch
    // gives every thread 168); one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == C::CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&map)) : "memory");
      const uint32_t bytes = (diag ? 1 : 2) * C::OPERAND;
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % C::STAGES;
        mbar_wait(&empty[st], ((i / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        uint8_t* a = ring + st * C::STAGE;
        const int col = (kb + i) * KSTEP;
#pragma unroll
        for (int h = 0; h < T / BOX_ROWS; ++h) {
          if (!diag) tma_load(a + h * BOX_BYTES, &map, &full[st], col, ti * T + h * BOX_ROWS);
          tma_load(a + C::OPERAND + h * BOX_BYTES, &map, &full[st], col, tj * T + h * BOX_ROWS);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    if (diag)
      consume<T, CAND, true>(ring, split, full, empty, flag, n, nsteps, splits, group, upper, u,
                             s, ti, tj, work, counters, live, tau, out);
    else
      consume<T, CAND, false>(ring, split, full, empty, flag, n, nsteps, splits, group, upper, u,
                              s, ti, tj, work, counters, live, tau, out);
  }
}

// K2 and K3 as kernels of their own names (as profilers list them)
template <int T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1) cosine_kernel(
    const __grid_constant__ CUtensorMap map, int n, int ksteps, int per_split, int splits,
    int group, int tiles, float* __restrict__ work, int* __restrict__ counters,
    const unsigned char* __restrict__ live, float tau, float* __restrict__ out) {
  gram_block<T, false>(&map, n, ksteps, per_split, splits, group, tiles, work, counters, live,
                       tau, out);
}

template <int T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1) candidates_kernel(
    const __grid_constant__ CUtensorMap map, int n, int ksteps, int per_split, int splits,
    int group, int tiles, float* __restrict__ work, int* __restrict__ counters,
    const unsigned char* __restrict__ live, float tau, float* __restrict__ out) {
  gram_block<T, true>(&map, n, ksteps, per_split, splits, group, tiles, work, counters, live,
                      tau, out);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ERR_NO_ENCODER = 1000;    // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 2000;        // + the CUresult it returned

template <int T, bool CAND>
int launch(const void* x, long long n, long long d, long long stride, int splits, int group,
           void* work, void* counters, const void* live, float tau, void* out, void* stream) {
  using C = Cfg<T>;
  if (n <= 0) return 0;
  if (d <= 0 || n >= 65536 || stride < d || (stride * 4) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || splits <= 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  const long long ksteps = (d + KSTEP - 1) / KSTEP;
  const long long per = (ksteps + splits - 1) / splits;
  if (ksteps >= (1ll << 31) || (long long)(splits - 1) * per >= ksteps)
    return (int)cudaErrorInvalidValue;   // an empty split
  EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 4};
  const cuuint32_t box[2] = {KSTEP, BOX_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  auto kernel = CAND ? candidates_kernel<T> : cosine_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  int tiles = (int)((n + T - 1) / T);
  const long long blocks = (long long)tiles * (tiles + 1) / 2 * splits;
  int n32 = (int)n, ks32 = (int)ksteps, per32 = (int)per;
  float* work_f = static_cast<float*>(work);
  int* counters_i = static_cast<int*>(counters);
  const unsigned char* live_b = static_cast<const unsigned char*>(live);
  float* out_f = static_cast<float*>(out);
  void* args[] = {&map,  &n32,   &ks32,       &per32,  &splits, &group,
                  &tiles, &work_f, &counters_i, &live_b, &tau,    &out_f};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)blocks),
                       dim3(C::THREADS), args, C::SMEM, static_cast<cudaStream_t>(stream));
  return (int)e;
}

}  // namespace

// x: (n, d) fp32 rows ``stride`` floats apart (stride * 4 a multiple of 16,
// x 16-byte aligned); tile 64 or 128; splits and group from the wrapper's
// plan (no split empty); work: tiles(tiles+1)/2 * splits * (tile^2 + 2 tile)
// floats; counters: tiles(tiles+1)/2 * (ceil(splits / group) + 1) ints, all
// 0 (left 0); out (n, n) fp32.
extern "C" int cosine_sim_f32(const void* x, long long n, long long d, long long stride, int tile,
                              int splits, int group, void* work, void* counters, void* out,
                              void* stream) {
  if (tile == 64)
    return launch<64, false>(x, n, d, stride, splits, group, work, counters, nullptr, 0.f, out,
                             stream);
  if (tile == 128)
    return launch<128, false>(x, n, d, stride, splits, group, work, counters, nullptr, 0.f, out,
                              stream);
  return (int)cudaErrorInvalidValue;
}

// as cosine_sim_f32, with live (n,) bytes (nonzero = live) and tau; out is
// the fp32 0/1 adjacency
extern "C" int merge_candidates_f32(const void* x, const void* live, long long n, long long d,
                                    long long stride, int tile, int splits, int group, float tau,
                                    void* work, void* counters, void* out, void* stream) {
  if (tile == 64)
    return launch<64, true>(x, n, d, stride, splits, group, work, counters, live, tau, out,
                            stream);
  if (tile == 128)
    return launch<128, true>(x, n, d, stride, splits, group, work, counters, live, tau, out,
                             stream);
  return (int)cudaErrorInvalidValue;
}
