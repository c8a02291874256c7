// The y-line factorization and solve of the line multigrid
// (cmfem_tpu_torch/solvers/linemg.py, StripLineMG), redesigned for the
// H100.
//
// No TPU kernel stands behind these: the JAX package runs line_factor and
// line_solve (cmfem_tpu/solvers/linemg.py:157 and :192) as lax.scans of
// small batched products that XLA compiles into loops.  Their torch
// counterparts (kernels/linemg.py::line_factor_plain, line_solve_plain) are
// Python loops over the NY rows of tiny batched ops, launch-bound on the
// card.  StripLineMG semicoarsens in x, so every level keeps all NY rows
// while its NX columns halve (45 -> 1 at 86,130 DOFs): a design with one
// thread per column runs each level as long as the finest.
//
// line_solve: a parallel forward sweep, a sequential backward sweep over
// shared memory.
//   Each column is one cluster of `cluster` blocks of 128 threads
//   (solve_geometry; kernels/linemg.py::solve_geometry repeats the rule).
//   Block k of the cluster owns the rows [k seg, (k+1) seg) of the column
//   and thread t of it the run [t run, (t+1) run) of those.  The block
//   stages its rows of R, C1 and E in shared memory once, by bulk
//   asynchronous copies (cp.async.bulk) completing on one mbarrier, while
//   the forward sweep runs on Q from device memory; a row's record is 16
//   elements (R, C1, E, r, Z), and a thread's records are padded by 16
//   bytes so that neighbouring threads' records fall in different banks.
//   Forward, zc_{y+1} = P_y zc_y + S_y r_{y+1} with P_y = Q_y[0:2, 2:4]^T
//   and S_y = Q_y[2:4, 2:4]^T, an affine map of a 2-vector: each thread
//   composes its run's maps, the run maps are scanned across the warp by
//   shuffles (log steps), the warps' totals in order by every thread, and
//   the blocks' totals across the cluster through distributed shared
//   memory; then each thread replays its run from its incoming zc and
//   parks Z_y = (Q_y^T [zc_y; r_{y+1}])[0:2] in the record.  The P_y are
//   blocks of orthogonal matrices, so the composed maps stay bounded.
//   Backward, x_y = R_y^{-1} (Z_y - C1_y x_{y+1} - E_y x_{y+2}): the same
//   affine scan over the state (x_y, x_{y+1}) composes blocks of the
//   inverse upper factor, which grow with the line systems' conditioning;
//   on case 1's first Newton system (5,760 DOFs) the scanned solve's line
//   residual is 6,200 times the sequential one's (2.6e-9 against 4.2e-13;
//   tests/test_torch_linemg.py::test_backward_sweep_is_a_walk_not_a_scan,
//   in numpy).  So the backward sweep stays a recurrence: one thread walks
//   the cluster's blocks from the top, each over its shared-memory rows,
//   and hands (x_{y+1}, x_{y+2}) down through distributed shared memory.
//   Its chain per row is two dependent multiply-adds: the forward replay
//   scales each row of R, C1, E and Z by R's reciprocal diagonal, in
//   parallel; the walk keeps three rows in flight, loaded two rows ahead,
//   forms each row's E x_{y+2} term a row early beside the chain, and
//   parks each x_y in its record, which the block's threads store once the
//   walk has passed the block.
//   What bounds the kernel is that walk, NY rows long on every level:
//   ~57 ns a row on the H100 (the slope of the device time between NY =
//   240 and 957 at NX = 1, `python -m cmfem_tpu_torch.profiling --sections
//   linemg_levels`), against a byte bound of ~3 ns a row at NX = 45.
//   Blocks per column: the fewest that hold the column's rows (at most 4
//   rows a thread in float64, 8 in float32: 71,680 bytes of shared memory,
//   three blocks an SM, so that NY = 1,913 at NX = 89 runs in one wave),
//   raised to one block an SM when NX is small, but never beyond one row a
//   thread or 8 blocks (the portable cluster size).  Columns are never
//   split between clusters; no atomics, and every combine has a fixed
//   order, so two calls give the same bits.
//   A column that 8 blocks do not stage (NY > 4,097 in float64, 8,193 in
//   float32) takes as many blocks as one wave of the card holds (three an
//   SM, at most 8), and runs longer than shared memory holds (SPILL): a
//   thread's first rows stay staged, the rest in device memory.  Their
//   forward replay parks Z_y in x_y's place in `out`; the walk asks L2 for
//   the spilled rows AHEAD rows below it, and reads and scales each when it
//   reaches it, so each costs about an L2 round trip on the chain.  The
//   arithmetic, and its order, is the staged rows'.
//
// line_factor: the chain alone on the recurrence.
//   The block-QR elimination is a nonlinear recurrence in (Dc, Cc), so a
//   column stays one sequential chain (one thread), and its latency bounds
//   the kernel: per row two square roots, two dependent divisions and ~30
//   chained multiply-adds, ~0.53 us a row on the H100 (the same slope).
//   A block of two warps per column keeps everything else off that
//   thread: warp 1 streams the column's rows of A_l, A_d, A_u into a
//   four-stage shared-memory ring, 32 rows a stage, by bulk asynchronous
//   copies on an mbarrier per stage; the chain thread reads them from
//   there a row ahead, computes the two reflectors, R's off-diagonal and
//   the rows of H2 H1 W that carry (Dc, Cc), and parks each row's scalars
//   in a two-stage ring; warp 1 then forms Q, R, C1 and E of 32 rows at
//   once, one row a lane, and stores them.
//
// Layouts (all contiguous, element type T = float or double), as
// solvers/linemg.py keeps them:
//   A_l, A_d, A_u (NY, NX, 2, 2)  the ox = 0 stencil blocks SS[0,1], SS[1,1],
//                                 SS[2,1] (coupling y-1, y, y+1)
//   R, C1, E      (NY-1, NX, 2, 2) the block-pentadiagonal upper factor
//   Q             (NY-1, NX, 4, 4) the level's orthogonal factors
//   Qf, Rf        (NX, 2, 2)       the last level's QR
//   r, x          (NY, NX, 2)      rhs and solution
// The QR is Householder's with LAPACK's conventions (dlarfg: beta =
// -sign(alpha) |(alpha, x)|, tau = (beta - alpha) / beta, and no reflector
// where x = 0), so the factors equal geqrf's up to rounding; the solves are
// what the tests compare.  Every pointer must be 16-byte aligned (the
// wrappers check).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// ---- mbarriers and bulk copies (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more of bulk copies before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- the QR pieces ----------------------------------------------------------

// LAPACK dlarfg on (alpha, x[0..n-1]): beta, tau and v = (1, x / (alpha -
// beta)); tau = 0 (H = I) where x = 0.
template <typename T, int N>
__device__ __forceinline__ void householder(T alpha, const T (&x)[N],
                                            T& beta, T& tau, T (&v)[N]) {
  T xn2 = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) xn2 += x[i] * x[i];
  if (xn2 == T(0)) {
    beta = alpha;
    tau = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = T(0);
    return;
  }
  const T norm = sqrt(alpha * alpha + xn2);
  beta = alpha >= T(0) ? -norm : norm;
  tau = (beta - alpha) / beta;
  const T s = T(1) / (alpha - beta);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = x[i] * s;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, T a, T b, T c, T d) {
  p[0] = a; p[1] = b; p[2] = c; p[3] = d;
}

// The complete QR of the 2x2 block Dc: Qf, Rf (geqrf on a 2 x 2: one
// reflector on column 0, none on the last).
template <typename T>
__device__ void qr2(const T (&D)[2][2], T* Qf, T* Rf) {
  T beta, tau, v[1];
  householder<T, 1>(D[0][0], {D[1][0]}, beta, tau, v);
  // H = I - tau u u^T, u = (1, v0); applied to column 1
  const T w = D[0][1] + v[0] * D[1][1];
  store4(Rf, beta, D[0][1] - tau * w, T(0), D[1][1] - tau * v[0] * w);
  store4(Qf, T(1) - tau, -tau * v[0], -tau * v[0], T(1) - tau * v[0] * v[0]);
}

// x = R^{-1} b for an upper-triangular 2 x 2 R (as solve_triangular)
template <typename T>
__device__ __forceinline__ void upper_solve(const T* Rm, T b0, T b1,
                                            T& x0, T& x1) {
  x1 = b1 / Rm[3];
  x0 = (b0 - Rm[1] * x1) / Rm[0];
}

// ---- line_factor ------------------------------------------------------------

constexpr int FACTOR_THREADS = 64;  // warp 0: the chain (lane 0); warp 1:
                                    // the row stream and the outputs
constexpr int CHUNK = 32;           // rows a ring stage holds
constexpr int IN_STAGES = 4;
constexpr int PARK_STAGES = 2;
constexpr int PARKED = 14;  // b1 t1 v1[3] M01 b2 t2 v2[2] Cc[4] of a row

template <typename T>
struct FactorSmem {
  uint64_t full[IN_STAGES];      // a stage's rows have landed
  uint64_t parked[PARK_STAGES];  // the chain has parked a stage's rows
  uint64_t freed[PARK_STAGES];   // warp 1 has read them
  alignas(16) T in[IN_STAGES][CHUNK * 12];  // a row: A_l, A_d, A_u blocks
  T park[PARK_STAGES][CHUNK * PARKED];
};

// warp 1: the rows of chunk c (output rows 32c.., input rows 32c + 1..)
// into stage c % IN_STAGES
template <typename T>
__device__ __forceinline__ void load_chunk(FactorSmem<T>& sm, const T* Al,
                                           const T* Ad, const T* Au, int c,
                                           int NY, int NX, int x, int lane) {
  const int s = c % IN_STAGES;
  const int rows = min(CHUNK, NY - 1 - c * CHUNK);
  if (lane == 0)
    mbar_expect(&sm.full[s], uint32_t(rows * 12 * sizeof(T)));
  __syncwarp();
  if (lane < rows) {
    const long long o = ((long long)(c * CHUNK + lane + 1) * NX + x) * 4;
    T* d = sm.in[s] + lane * 12;
    bulk_load(d, Al + o, 4 * sizeof(T), &sm.full[s]);
    bulk_load(d + 4, Ad + o, 4 * sizeof(T), &sm.full[s]);
    bulk_load(d + 8, Au + o, 4 * sizeof(T), &sm.full[s]);
  }
}

template <typename T>
__global__ void __launch_bounds__(FACTOR_THREADS)
line_factor_kernel(const T* __restrict__ Al, const T* __restrict__ Ad,
                   const T* __restrict__ Au, T* __restrict__ R,
                   T* __restrict__ C1, T* __restrict__ E, T* __restrict__ Q,
                   T* __restrict__ Qf, T* __restrict__ Rf, int NY, int NX) {
  __shared__ FactorSmem<T> sm;
  const int x = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int nch = (NY - 1 + CHUNK - 1) / CHUNK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < IN_STAGES; ++s) mbar_init(&sm.full[s], 1);
    for (int s = 0; s < PARK_STAGES; ++s) {
      mbar_init(&sm.parked[s], 1);
      mbar_init(&sm.freed[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // ---- warp 1: the row stream ahead of the chain, then the outputs ----
    for (int c = 0; c < min(IN_STAGES, nch); ++c)
      load_chunk(sm, Al, Ad, Au, c, NY, NX, x, lane);
    for (int c = 0; c < nch; ++c) {
      const int s = c % IN_STAGES, ps = c % PARK_STAGES;
      mbar_wait(&sm.parked[ps], (c / PARK_STAGES) & 1);
      const int y = c * CHUNK + lane + 1;  // input row; output row y - 1
      if (y < NY) {
        const T* pk = sm.park[ps] + lane * PARKED;
        const T* in = sm.in[s] + lane * 12;
        const T b1 = pk[0], t1 = pk[1], b2 = pk[6], t2 = pk[7];
        const T u1[4] = {T(1), pk[2], pk[3], pk[4]};
        const T u2[4] = {T(0), T(1), pk[8], pk[9]};
        T W[4][4] = {{pk[10], pk[11], T(0), T(0)},
                     {pk[12], pk[13], T(0), T(0)},
                     {in[4], in[5], in[8], in[9]},
                     {in[6], in[7], in[10], in[11]}};
        // H2 H1 W, column by column, as the chain does its lower rows
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T w = T(0);
#pragma unroll
          for (int i = 0; i < 4; ++i) w += u1[i] * W[i][j];
#pragma unroll
          for (int i = 0; i < 4; ++i) W[i][j] -= t1 * u1[i] * w;
          w = T(0);
#pragma unroll
          for (int i = 1; i < 4; ++i) w += u2[i] * W[i][j];
#pragma unroll
          for (int i = 1; i < 4; ++i) W[i][j] -= t2 * u2[i] * w;
        }
        const long long p = (long long)(y - 1) * NX + x;
        // Q = H1 H2: row i of H1 times H2
        T* q = Q + p * 16;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          T h1[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            h1[k] = (i == k ? T(1) : T(0)) - t1 * u1[i] * u1[k];
          T sdot = T(0);
#pragma unroll
          for (int k = 0; k < 4; ++k) sdot += h1[k] * u2[k];
#pragma unroll
          for (int j = 0; j < 4; ++j) q[4 * i + j] = h1[j] - t2 * sdot * u2[j];
        }
        store4(R + p * 4, b1, pk[5], T(0), b2);
        store4(C1 + p * 4, W[0][0], W[0][1], W[1][0], W[1][1]);
        store4(E + p * 4, W[0][2], W[0][3], W[1][2], W[1][3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.freed[ps]);
      if (c + IN_STAGES < nch) {
        // the chain is past chunk c (it parked it): refill its stage
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_chunk(sm, Al, Ad, Au, c + IN_STAGES, NY, NX, x, lane);
      }
    }
    return;
  }
  if (threadIdx.x != 0) return;

  // ---- the chain (thread 0) ----
  T Dc[2][2], Cc[2][2];  // the current top row: (diagonal, coupling y+1)
  Dc[0][0] = Ad[4 * x]; Dc[0][1] = Ad[4 * x + 1];
  Dc[1][0] = Ad[4 * x + 2]; Dc[1][1] = Ad[4 * x + 3];
  Cc[0][0] = Au[4 * x]; Cc[0][1] = Au[4 * x + 1];
  Cc[1][0] = Au[4 * x + 2]; Cc[1][1] = Au[4 * x + 3];
  for (int c = 0; c < nch; ++c) {
    const int s = c % IN_STAGES, ps = c % PARK_STAGES;
    const int rows = min(CHUNK, NY - 1 - c * CHUNK);
    mbar_wait(&sm.full[s], (c / IN_STAGES) & 1);
    if (c >= PARK_STAGES) mbar_wait(&sm.freed[ps], (c / PARK_STAGES - 1) & 1);
    const T* in = sm.in[s];
    T* park = sm.park[ps];
    // the row's B (A_l) and the A_d, A_u it needs, one row ahead
    T nB[4], nA[4], nC[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nB[k] = in[k]; nA[k] = in[4 + k]; nC[k] = in[8 + k];
    }
#pragma unroll 1
    for (int i = 0; i < rows; ++i) {
      T B[4], A[4], C[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        B[k] = nB[k]; A[k] = nA[k]; C[k] = nC[k];
      }
      if (i + 1 < rows) {
        const T* nx = in + (i + 1) * 12;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          nB[k] = nx[k]; nA[k] = nx[4 + k]; nC[k] = nx[8 + k];
        }
      }
      // M = [Dc; B] (4 x 2); reflector 1 on column 0: u1 = (1, v1)
      T M[4][2] = {{Dc[0][0], Dc[0][1]}, {Dc[1][0], Dc[1][1]},
                   {B[0], B[1]}, {B[2], B[3]}};
      T b1, t1, v1[3];
      householder<T, 3>(M[0][0], {M[1][0], M[2][0], M[3][0]}, b1, t1, v1);
      const T u1[4] = {T(1), v1[0], v1[1], v1[2]};
      {
        T w = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) w += u1[k] * M[k][1];
#pragma unroll
        for (int k = 0; k < 4; ++k) M[k][1] -= t1 * u1[k] * w;
      }
      // reflector 2 on column 1, rows 1-3: u2 = (0, 1, v2)
      T b2, t2, v2[2];
      householder<T, 2>(M[1][1], {M[2][1], M[3][1]}, b2, t2, v2);
      // the rows 2-3 of H2 H1 W, W = [[Cc, 0], [A, C]]: the next (Dc, Cc)
      T W[4][4] = {{Cc[0][0], Cc[0][1], T(0), T(0)},
                   {Cc[1][0], Cc[1][1], T(0), T(0)},
                   {A[0], A[1], C[0], C[1]},
                   {A[2], A[3], C[2], C[3]}};
      T* pk = park + i * PARKED;
      pk[0] = b1; pk[1] = t1; pk[2] = v1[0]; pk[3] = v1[1]; pk[4] = v1[2];
      pk[5] = M[0][1]; pk[6] = b2; pk[7] = t2; pk[8] = v2[0]; pk[9] = v2[1];
      pk[10] = Cc[0][0]; pk[11] = Cc[0][1]; pk[12] = Cc[1][0];
      pk[13] = Cc[1][1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T w = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) w += u1[k] * W[k][j];
#pragma unroll
        for (int k = 1; k < 4; ++k) W[k][j] -= t1 * u1[k] * w;
        w = W[1][j] + v2[0] * W[2][j] + v2[1] * W[3][j];
        W[2][j] -= t2 * v2[0] * w;
        W[3][j] -= t2 * v2[1] * w;
      }
      Dc[0][0] = W[2][0]; Dc[0][1] = W[2][1];
      Dc[1][0] = W[3][0]; Dc[1][1] = W[3][1];
      Cc[0][0] = W[2][2]; Cc[0][1] = W[2][3];
      Cc[1][0] = W[3][2]; Cc[1][1] = W[3][3];
    }
    mbar_arrive(&sm.parked[ps]);
  }
  qr2(Dc, Qf + 4 * x, Rf + 4 * x);
}

// ---- line_solve -------------------------------------------------------------

constexpr int SOLVE_THREADS = 128;
constexpr int SOLVE_WARPS = SOLVE_THREADS / 32;
constexpr int CARD_SMS = 132;     // the H100 SXM
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int SCRATCH = 4096;     // the barrier and the scan's totals
constexpr int REC = 16;           // elements of a row's record
constexpr int AHEAD = 32;         // rows the walk asks L2 for ahead (SPILL)
// record offsets: R 0, C1 4, E 8, r 12, Z 14; the forward replay scales
// R01, C1, E and Z by R's reciprocal diagonal for the walk.  A thread's run
// is at most 32 / sizeof(T) rows (4 in float64, 8 in float32), so a block
// takes 71,680 bytes of shared memory and three blocks fit an SM.

struct SolveGeometry {
  int cluster, seg, run;  // blocks per column, rows per block, per thread
};

// The launch geometry of line_solve (kernels/linemg.py::solve_geometry
// repeats it, and the gpu test holds the two equal through
// cmfem_line_solve_geometry).  A run longer than 32 / itemsize rows spills.
inline SolveGeometry solve_geometry(int NY, int NX, int itemsize) {
  const int rows = NY - 1;
  if (rows <= 0) return {1, 0, 0};
  const int run_max = 32 / itemsize;
  const int fit = (rows + SOLVE_THREADS * run_max - 1)
                  / (SOLVE_THREADS * run_max);
  const int fill = std::min({MAX_CLUSTER, std::max(1, CARD_SMS / NX),
                             (rows + SOLVE_THREADS - 1) / SOLVE_THREADS});
  // a column that no cluster stages: as many blocks as one wave holds
  const int cluster =
      fit <= MAX_CLUSTER
          ? std::max(fit, fill)
          : std::min(MAX_CLUSTER, std::max(1, 3 * CARD_SMS / NX));
  const int seg = (rows + cluster - 1) / cluster;
  return {cluster, seg, (seg + SOLVE_THREADS - 1) / SOLVE_THREADS};
}

template <typename T>
size_t solve_smem(int run) {
  return size_t(SOLVE_THREADS) * (REC * run + 16 / sizeof(T)) * sizeof(T)
         + SCRATCH;
}

// the forward sweep's affine maps z -> A z + b, as {a00, a01, a10, a11, b0,
// b1}: g becomes g o f (f first)
template <typename T>
__device__ __forceinline__ void compose(const T (&f)[6], T (&g)[6]) {
  const T a00 = g[0] * f[0] + g[1] * f[2], a01 = g[0] * f[1] + g[1] * f[3];
  const T a10 = g[2] * f[0] + g[3] * f[2], a11 = g[2] * f[1] + g[3] * f[3];
  const T b0 = g[0] * f[4] + g[1] * f[5] + g[4];
  const T b1 = g[2] * f[4] + g[3] * f[5] + g[5];
  g[0] = a00; g[1] = a01; g[2] = a10; g[3] = a11; g[4] = b0; g[5] = b1;
}

template <typename T>
__device__ __forceinline__ void apply(const T* f, T& z0, T& z1) {
  const T n0 = f[0] * z0 + f[1] * z1 + f[4];
  z1 = f[2] * z0 + f[3] * z1 + f[5];
  z0 = n0;
}

// the walk's row: R01, C1, E, Z scaled (the forward replay's)
template <typename T>
__device__ __forceinline__ void load_walk(const T* p, T (&v)[11]) {
  v[0] = p[1];
#pragma unroll
  for (int m = 0; m < 8; ++m) v[1 + m] = p[4 + m];
  v[9] = p[14];
  v[10] = p[15];
}

// a spilled row's walk values from device memory: R, C1, E of the row and
// its Z (parked in `out`), scaled as the forward replay scales a staged row
template <typename T>
__device__ __forceinline__ void load_spilled(const T* Rr, const T* c1,
                                             const T* e, const T* z,
                                             T (&v)[11]) {
  const T i0 = T(1) / Rr[0], i1 = T(1) / Rr[3];
  v[0] = Rr[1] * i0;
  v[1] = c1[0] * i0; v[2] = c1[1] * i0; v[3] = c1[2] * i1; v[4] = c1[3] * i1;
  v[5] = e[0] * i0; v[6] = e[1] * i0; v[7] = e[2] * i1; v[8] = e[3] * i1;
  v[9] = z[0] * i0;
  v[10] = z[1] * i1;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// RUN: the rows of a thread's run staged in shared memory (the geometry's
// run, or 32 / sizeof(T) where SPILL); a thread's staged-row loops are
// unrolled over RUN and predicated on its own count, the last thread of a
// block owning fewer.  With SPILL the run is `run_arg` rows, the ones past
// RUN in device memory.
template <typename T, int RUN, bool SPILL>
__global__ void __launch_bounds__(SOLVE_THREADS, 3)
line_solve_kernel(const T* __restrict__ R, const T* __restrict__ C1,
                  const T* __restrict__ E, const T* __restrict__ Q,
                  const T* __restrict__ Qf, const T* __restrict__ Rf,
                  const T* __restrict__ r, T* __restrict__ out, int NY,
                  int NX, int seg, int run_arg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = int(cluster.num_blocks());
  const int k = int(cluster.block_rank());
  const int x = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = NY - 1;
  if (rows == 0) {  // NY = 1: x_0 = Rf^{-1} Qf^T r_0
    if (tid == 0) {
      const T* qf = Qf + 4 * x;
      const T z0 = r[2 * x], z1 = r[2 * x + 1];
      upper_solve(Rf + 4 * x, qf[0] * z0 + qf[2] * z1, qf[1] * z0 + qf[3] * z1,
                  out[2 * x], out[2 * x + 1]);
    }
    return;
  }
  // a thread's records, padded by 16 bytes so that neighbouring threads'
  // records fall in different banks
  constexpr int tstride = REC * RUN + 16 / int(sizeof(T));
  T* recs = reinterpret_cast<T*>(smem_raw);
  unsigned char* scratch = smem_raw + size_t(SOLVE_THREADS) * tstride
                                          * sizeof(T);
  uint64_t* bar = reinterpret_cast<uint64_t*>(scratch);
  T* warp_tot = reinterpret_cast<T*>(scratch + 16);  // SOLVE_WARPS x 6
  T* block_tot = warp_tot + SOLVE_WARPS * 6;          // 6
  T* hand = block_tot + 6;  // (x_{y+1}, x_{y+2}) entering this block's top
  T* below_tot = hand + 4;  // the totals of the blocks below, k x 6

  const int run = SPILL ? run_arg : RUN;
  const int a = min(k * seg, rows), b = min(a + seg, rows);
  const int ya = min(a + tid * run, b), yb = min(ya + run, b);
  const int cnt = yb - ya;
  T* mine = recs + tid * tstride;  // this thread's records, row ya first

  // ---- stage the block's rows of R, C1, E (and r) ----
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const int nb = b - a;  // the block's rows; each thread stages <= RUN
    const int staged = SPILL ? nb / run * RUN + min(nb % run, RUN) : nb;
    mbar_expect(bar, uint32_t(staged * 12 * sizeof(T)));
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (j >= cnt) break;
    T* d = mine + j * REC;
    const long long o = (long long)(ya + j) * NX + x;
    bulk_load(d, R + o * 4, 4 * sizeof(T), bar);
    bulk_load(d + 4, C1 + o * 4, 4 * sizeof(T), bar);
    bulk_load(d + 8, E + o * 4, 4 * sizeof(T), bar);
    d[12] = r[(o + NX) * 2];
    d[13] = r[(o + NX) * 2 + 1];
  }

  // ---- forward: compose the run's maps (Q from device memory) ----
  const bool first = k == 0 && tid == 0;  // starts from zc_0 = r_0
  T f[6];
  if (first) {
    f[0] = f[1] = f[2] = f[3] = T(0);
    f[4] = r[2 * x];
    f[5] = r[2 * x + 1];
  } else {
    f[0] = f[3] = T(1);
    f[1] = f[2] = f[4] = f[5] = T(0);
  }
  // P[i][j] = Q[j][2 + i], S[i][j] = Q[2 + j][2 + i]: f becomes
  // (P A, P b + S r_{y+1}), b in the sequential sweep's order
  auto push = [&](const T* q, T r0, T r1) {
    const T a00 = q[2] * f[0] + q[6] * f[2], a01 = q[2] * f[1] + q[6] * f[3];
    const T a10 = q[3] * f[0] + q[7] * f[2], a11 = q[3] * f[1] + q[7] * f[3];
    const T b0 = q[2] * f[4] + q[6] * f[5] + q[10] * r0 + q[14] * r1;
    const T b1 = q[3] * f[4] + q[7] * f[5] + q[11] * r0 + q[15] * r1;
    f[0] = a00; f[1] = a01; f[2] = a10; f[3] = a11; f[4] = b0; f[5] = b1;
  };
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (j >= cnt) break;
    const T* rr = mine + j * REC + 12;
    push(Q + ((long long)(ya + j) * NX + x) * 16, rr[0], rr[1]);
  }
  if constexpr (SPILL) {
#pragma unroll 1
    for (int j = RUN; j < cnt; ++j) {
      const long long o = (long long)(ya + j) * NX + x;
      push(Q + o * 16, r[(o + NX) * 2], r[(o + NX) * 2 + 1]);
    }
  }
  // ---- scan: lanes, warps in order, the cluster's blocks in order ----
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T p[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) p[m] = __shfl_up_sync(0xffffffffu, f[m], off);
    if (lane >= off) compose(p, f);
  }
  T prev[6];  // the inclusive total of the lane below
#pragma unroll
  for (int m = 0; m < 6; ++m) prev[m] = __shfl_up_sync(0xffffffffu, f[m], 1);
  if (lane == 31) {
#pragma unroll
    for (int m = 0; m < 6; ++m) warp_tot[warp * 6 + m] = f[m];
  }
  __syncthreads();
  if (tid == 0) {
    T t[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) t[m] = warp_tot[m];
    for (int w = 1; w < SOLVE_WARPS; ++w) {
      T g[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) g[m] = warp_tot[w * 6 + m];
      compose(t, g);
#pragma unroll
      for (int m = 0; m < 6; ++m) t[m] = g[m];
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) block_tot[m] = t[m];
  }
  cluster.sync();
  // each total of the blocks below read once, by one thread each, in parallel
  if (tid < k) {
    const T* t = cluster.map_shared_rank(block_tot, tid);
#pragma unroll
    for (int m = 0; m < 6; ++m) below_tot[tid * 6 + m] = t[m];
  }
  __syncthreads();
  T z0 = T(0), z1 = T(0);  // zc entering this thread's run
  for (int j = 0; j < k; ++j) apply(below_tot + j * 6, z0, z1);
  for (int w = 0; w < warp; ++w) apply(warp_tot + w * 6, z0, z1);
  if (lane > 0) apply(prev, z0, z1);
  if (first) {
    z0 = r[2 * x];
    z1 = r[2 * x + 1];
  }
  mbar_wait(bar, 0);  // the rows of R, C1, E have landed
  // ---- forward replay: Z_y, and the walk's scaled rows ----
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (j >= cnt) break;
    const T* qg = Q + ((long long)(ya + j) * NX + x) * 16;
    T* q = mine + j * REC;
    const T v[4] = {z0, z1, q[12], q[13]};
    T zz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T s = T(0);
#pragma unroll
      for (int m = 0; m < 4; ++m) s += qg[4 * m + i] * v[m];
      zz[i] = s;
    }
    // row 0 of R, C1, E and Z scaled by 1/R00, row 1 by 1/R11, in place
    const T i0 = T(1) / q[0], i1 = T(1) / q[3];
    q[1] *= i0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      q[4 + m] *= i0; q[6 + m] *= i1;
      q[8 + m] *= i0; q[10 + m] *= i1;
    }
    q[14] = zz[0] * i0;
    q[15] = zz[1] * i1;
    z0 = zz[2];
    z1 = zz[3];
  }
  if constexpr (SPILL) {  // Z_y parks unscaled in x_y's place
#pragma unroll 1
    for (int j = RUN; j < cnt; ++j) {
      const long long o = (long long)(ya + j) * NX + x;
      const T* qg = Q + o * 16;
      const T v[4] = {z0, z1, r[(o + NX) * 2], r[(o + NX) * 2 + 1]};
      T zz[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T s = T(0);
#pragma unroll
        for (int m = 0; m < 4; ++m) s += qg[4 * m + i] * v[m];
        zz[i] = s;
      }
      out[o * 2] = zz[0];
      out[o * 2 + 1] = zz[1];
      z0 = zz[2];
      z1 = zz[3];
    }
  }
  if (cnt > 0 && yb == rows) {  // the top row: x_{NY-1} starts the walk
    const T* qf = Qf + 4 * x;
    T x0, x1;
    upper_solve(Rf + 4 * x, qf[0] * z0 + qf[2] * z1, qf[1] * z0 + qf[3] * z1,
                x0, x1);
    T* o = out + ((long long)rows * NX + x) * 2;
    o[0] = x0;
    o[1] = x1;
    hand[0] = x0; hand[1] = x1; hand[2] = T(0); hand[3] = T(0);
  }
  __syncthreads();
  // ---- backward: one thread walks the blocks from the top ----
  for (int step = C - 1; step >= 0; --step) {
    if (k == step && tid == 0 && a < b) {
      T x10 = hand[0], x11 = hand[1], x20 = hand[2], x21 = hand[3];
      // row y: thread (y - a) / run, slot j = (y - a) % run; the slots
      // below RUN are records in shared memory, the others (SPILL) rows in
      // device memory; q is the record of slot min(j, RUN - 1)
      int j = (b - 1 - a) % run, yc = b - 1;
      T* q = recs + ((b - 1 - a) / run) * tstride + min(j, RUN - 1) * REC;
      auto down = [&]() {  // to the row below
        --yc;
        if (j > 0) {
          if (!SPILL || j < RUN) q -= REC;
          --j;
        } else {
          q -= tstride - (RUN - 1) * REC;
          j = run - 1;
        }
      };
      // the row's walk values into v; returns where its x_y goes
      auto fetch = [&](T (&v)[11]) -> T* {
        if (!SPILL || j < RUN) {
          load_walk(q, v);
          return q + 14;
        }
        const long long o = (long long)yc * NX + x;
        if (yc - AHEAD >= a) {  // into L2 for the walk, AHEAD rows down
          const long long h = o - (long long)AHEAD * NX;
          prefetch_l2(R + h * 4);
          prefetch_l2(C1 + h * 4);
          prefetch_l2(E + h * 4);
          prefetch_l2(out + h * 2);
        }
        load_spilled(R + o * 4, C1 + o * 4, E + o * 4, out + o * 2, v);
        return out + o * 2;
      };
      // x_y = R^{-1} (Z - C1 x_{y+1} - E x_{y+2}) with R's rows scaled,
      // s_y = Z_y - E_y x_{y+2} made a row early, beside the chain, and the
      // newest value x_{y+1}[0] entering last: two multiply-adds lie
      // between a row's x_y[0] and the next's.  v: row y, w: row y - 1;
      // x_y parks in the record's Z (a spilled row's: in `out`).
      T s0, s1;
      auto row = [&](const T (&v)[11], const T (&w)[11], T* p) {
        const T t0 = w[9] - (w[5] * x10 + w[6] * x11);
        const T t1 = w[10] - (w[7] * x10 + w[8] * x11);
        const T n1 = fma(-v[3], x10, fma(-v[4], x11, s1));
        const T n0 = fma(-v[0], n1, fma(-v[1], x10, fma(-v[2], x11, s0)));
        p[0] = n0;
        p[1] = n1;
        x20 = x10; x21 = x11;  // for the hand-off below
        x10 = n0; x11 = n1;
        s0 = t0; s1 = t1;
      };
      // three rows in flight, each loaded two rows ahead of its first use
      T va[11], vb[11], vc[11];
      T* pa = fetch(va);
      T *pb = pa, *pc = pa;
#pragma unroll
      for (int m = 0; m < 11; ++m) vb[m] = vc[m] = va[m];
      auto next = [&](T*& pp, T (&v)[11], int yy) {
        if (yy >= a) {
          down();
          pp = fetch(v);
        }
      };
      next(pb, vb, b - 2);
      next(pc, vc, b - 3);
      s0 = va[9] - (va[5] * x20 + va[6] * x21);
      s1 = va[10] - (va[7] * x20 + va[8] * x21);
#pragma unroll 1
      for (int y = b - 1;; y -= 3) {
        row(va, vb, pa);
        next(pa, va, y - 3);
        if (y - 1 < a) break;
        row(vb, vc, pb);
        next(pb, vb, y - 4);
        if (y - 2 < a) break;
        row(vc, va, pc);
        next(pc, vc, y - 5);
        if (y - 3 < a) break;
      }
      if (k > 0) {
        T* below = cluster.map_shared_rank(hand, k - 1);
        below[0] = x10; below[1] = x11; below[2] = x20; below[3] = x21;
      }
    }
    cluster.sync();
    if (step == k) {  // the walk is past this block: its staged x out
#pragma unroll
      for (int jj = 0; jj < RUN; ++jj) {
        if (jj >= cnt) break;
        const T* p = mine + jj * REC;
        T* o = out + ((long long)(ya + jj) * NX + x) * 2;
        o[0] = p[14];
        o[1] = p[15];
      }
    }
  }
}

template <typename T>
int factor(const void* Al, const void* Ad, const void* Au, void* R, void* C1,
           void* E, void* Q, void* Qf, void* Rf, int NY, int NX,
           void* stream) {
  if (NY < 1 || NX < 1) return (int)cudaErrorInvalidValue;
  line_factor_kernel<T><<<NX, FACTOR_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Al), static_cast<const T*>(Ad),
      static_cast<const T*>(Au), static_cast<T*>(R), static_cast<T*>(C1),
      static_cast<T*>(E), static_cast<T*>(Q), static_cast<T*>(Qf),
      static_cast<T*>(Rf), NY, NX);
  return (int)cudaGetLastError();
}

template <typename T, int RUN, bool SPILL = false>
int launch_solve(const SolveGeometry& g, const void* R, const void* C1,
                 const void* E, const void* Q, const void* Qf, const void* Rf,
                 const void* r, void* out, int NY, int NX, void* stream) {
  static int set_on = -1;  // the device the shared-memory limit was set on
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (set_on != dev) {
    err = cudaFuncSetAttribute(line_solve_kernel<T, RUN, SPILL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(solve_smem<T>(RUN)));
    if (err != cudaSuccess) return (int)err;
    set_on = dev;
  }
  const size_t smem = solve_smem<T>(RUN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(NX * g.cluster));
  cfg.blockDim = dim3(SOLVE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(g.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, line_solve_kernel<T, RUN, SPILL>, static_cast<const T*>(R),
      static_cast<const T*>(C1), static_cast<const T*>(E),
      static_cast<const T*>(Q), static_cast<const T*>(Qf),
      static_cast<const T*>(Rf), static_cast<const T*>(r),
      static_cast<T*>(out), NY, NX, g.seg, g.run);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int solve(const void* R, const void* C1, const void* E, const void* Q,
          const void* Qf, const void* Rf, const void* r, void* out, int NY,
          int NX, void* stream) {
  if (NY < 1 || NX < 1) return (int)cudaErrorInvalidValue;
  const SolveGeometry g = solve_geometry(NY, NX, int(sizeof(T)));
  constexpr int RUN_MAX = 32 / int(sizeof(T));
  if (g.run > RUN_MAX)
    return launch_solve<T, RUN_MAX, true>(g, R, C1, E, Q, Qf, Rf, r, out, NY,
                                          NX, stream);
  switch (g.run) {
    case 0:  // NY = 1
    case 1: return launch_solve<T, 1>(g, R, C1, E, Q, Qf, Rf, r, out, NY, NX,
                                      stream);
    case 2: return launch_solve<T, 2>(g, R, C1, E, Q, Qf, Rf, r, out, NY, NX,
                                      stream);
    case 3: return launch_solve<T, 3>(g, R, C1, E, Q, Qf, Rf, r, out, NY, NX,
                                      stream);
    case 4: return launch_solve<T, 4>(g, R, C1, E, Q, Qf, Rf, r, out, NY, NX,
                                      stream);
  }
  if constexpr (sizeof(T) == 4) {
    switch (g.run) {
      case 5: return launch_solve<T, 5>(g, R, C1, E, Q, Qf, Rf, r, out, NY,
                                        NX, stream);
      case 6: return launch_solve<T, 6>(g, R, C1, E, Q, Qf, Rf, r, out, NY,
                                        NX, stream);
      case 7: return launch_solve<T, 7>(g, R, C1, E, Q, Qf, Rf, r, out, NY,
                                        NX, stream);
      case 8: return launch_solve<T, 8>(g, R, C1, E, Q, Qf, Rf, r, out, NY,
                                        NX, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The block-QR factors of every x-column's line system from the stencil
// blocks (see the layouts above); returns cudaGetLastError() after the
// launch.
extern "C" int cmfem_line_factor_f32(const void* Al, const void* Ad,
                                     const void* Au, void* R, void* C1,
                                     void* E, void* Q, void* Qf, void* Rf,
                                     int NY, int NX, void* stream) {
  return factor<float>(Al, Ad, Au, R, C1, E, Q, Qf, Rf, NY, NX, stream);
}

extern "C" int cmfem_line_factor_f64(const void* Al, const void* Ad,
                                     const void* Au, void* R, void* C1,
                                     void* E, void* Q, void* Qf, void* Rf,
                                     int NY, int NX, void* stream) {
  return factor<double>(Al, Ad, Au, R, C1, E, Q, Qf, Rf, NY, NX, stream);
}

// x = the line solves of r with those factors; returns cudaGetLastError()
// after the launch.
extern "C" int cmfem_line_solve_f32(const void* R, const void* C1,
                                    const void* E, const void* Q,
                                    const void* Qf, const void* Rf,
                                    const void* r, void* x, int NY, int NX,
                                    void* stream) {
  return solve<float>(R, C1, E, Q, Qf, Rf, r, x, NY, NX, stream);
}

extern "C" int cmfem_line_solve_f64(const void* R, const void* C1,
                                    const void* E, const void* Q,
                                    const void* Qf, const void* Rf,
                                    const void* r, void* x, int NY, int NX,
                                    void* stream) {
  return solve<double>(R, C1, E, Q, Qf, Rf, r, x, NY, NX, stream);
}

// line_solve's launch geometry on an NY x NX lattice of `itemsize`-byte
// elements: g = (threads a block, blocks a cluster, rows a block, rows a
// thread), as kernels/linemg.py::solve_geometry gives it
extern "C" void cmfem_line_solve_geometry(int NY, int NX, int itemsize,
                                          int* g) {
  const SolveGeometry s = solve_geometry(NY, NX, itemsize);
  g[0] = SOLVE_THREADS;
  g[1] = s.cluster;
  g[2] = s.seg;
  g[3] = s.run;
}

extern "C" const char* cmfem_linemg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
