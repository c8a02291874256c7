// The y-line factorization and solve of the line multigrid
// (cmfem_tpu_torch/solvers/linemg.py, StripLineMG), one thread per x-column.
//
// No TPU kernel stands behind these: the JAX package runs line_factor and
// line_solve (cmfem_tpu/solvers/linemg.py:157 and :192) as lax.scans of
// small batched products that XLA compiles into loops.  Their torch
// counterparts (kernels/linemg.py::line_factor_plain, line_solve_plain) are
// Python loops over the NY rows of tiny batched ops; on the H100 at 86,130
// DOFs (NY = 957, seven levels) they cost 9.4 s per factorization and 1.3 s
// per preconditioner apply, all of it launch overhead (chip_smoke phase
// 14a, PERF.md).  Here each x-column's recurrence over the rows runs in one
// thread, its 2x2 blocks and 4x4 transforms in registers.
//
// What bounds it: the recurrence.  A column's rows are sequential; a level
// has only NX (<= 45) columns, so at most two warps run and the card is
// idle but for them.  A row's loads (its blocks, 12 or 28 entries) do not
// depend on the carried values, so they are issued ahead of its arithmetic;
// the time per row is the latency of the dependent chain (two square roots
// and divisions per row in the factorization, 24 FMAs in the solve).
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
// what the tests compare.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;

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
__device__ __forceinline__ void load4(const T* p, T (&b)[2][2]) {
  b[0][0] = p[0]; b[0][1] = p[1]; b[1][0] = p[2]; b[1][1] = p[3];
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
line_factor_kernel(const T* __restrict__ Al, const T* __restrict__ Ad,
                   const T* __restrict__ Au, T* __restrict__ R,
                   T* __restrict__ C1, T* __restrict__ E, T* __restrict__ Q,
                   T* __restrict__ Qf, T* __restrict__ Rf, int NY, int NX) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= NX) return;
  T Dc[2][2], Cc[2][2];  // the current top row: (diagonal, coupling y+1)
  load4(Ad + 4 * x, Dc);
  load4(Au + 4 * x, Cc);
#pragma unroll 1
  for (int y = 1; y < NY; ++y) {
    const long long o = ((long long)y * NX + x) * 4;
    T B[2][2], A[2][2], C[2][2];
    load4(Al + o, B);
    load4(Ad + o, A);
    load4(Au + o, C);
    // M = [Dc; B] (4 x 2); the rhs [[Cc, 0], [A, C]] (4 x 4)
    T M[4][2] = {{Dc[0][0], Dc[0][1]}, {Dc[1][0], Dc[1][1]},
                 {B[0][0], B[0][1]}, {B[1][0], B[1][1]}};
    T W[4][4] = {{Cc[0][0], Cc[0][1], T(0), T(0)},
                 {Cc[1][0], Cc[1][1], T(0), T(0)},
                 {A[0][0], A[0][1], C[0][0], C[0][1]},
                 {A[1][0], A[1][1], C[1][0], C[1][1]}};
    // reflector 1 on column 0: u1 = (1, v1)
    T b1, t1, v1[3];
    householder<T, 3>(M[0][0], {M[1][0], M[2][0], M[3][0]}, b1, t1, v1);
    const T u1[4] = {T(1), v1[0], v1[1], v1[2]};
    {
      T w = T(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) w += u1[i] * M[i][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) M[i][1] -= t1 * u1[i] * w;
    }
    // reflector 2 on column 1, rows 1-3: u2 = (0, 1, v2)
    T b2, t2, v2[2];
    householder<T, 2>(M[1][1], {M[2][1], M[3][1]}, b2, t2, v2);
    const T u2[4] = {T(0), T(1), v2[0], v2[1]};
    // right = Q^T W = H2 H1 W, column by column
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
    // Q = H1 H2: row i of H1 times H2
    T* q = Q + ((long long)(y - 1) * NX + x) * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T h1[4];  // row i of H1
#pragma unroll
      for (int k = 0; k < 4; ++k) h1[k] = (i == k ? T(1) : T(0))
                                         - t1 * u1[i] * u1[k];
      T s = T(0);  // h1 . u2
#pragma unroll
      for (int k = 0; k < 4; ++k) s += h1[k] * u2[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[4 * i + j] = h1[j] - t2 * s * u2[j];
    }
    const long long p = ((long long)(y - 1) * NX + x) * 4;
    store4(R + p, b1, M[0][1], T(0), b2);
    store4(C1 + p, W[0][0], W[0][1], W[1][0], W[1][1]);
    store4(E + p, W[0][2], W[0][3], W[1][2], W[1][3]);
    Dc[0][0] = W[2][0]; Dc[0][1] = W[2][1];
    Dc[1][0] = W[3][0]; Dc[1][1] = W[3][1];
    Cc[0][0] = W[2][2]; Cc[0][1] = W[2][3];
    Cc[1][0] = W[3][2]; Cc[1][1] = W[3][3];
  }
  qr2(Dc, Qf + 4 * x, Rf + 4 * x);
}

// x = R^{-1} b for an upper-triangular 2 x 2 R (as solve_triangular)
template <typename T>
__device__ __forceinline__ void upper_solve(const T* Rm, T b0, T b1,
                                            T& x0, T& x1) {
  x1 = b1 / Rm[3];
  x0 = (b0 - Rm[1] * x1) / Rm[0];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
line_solve_kernel(const T* __restrict__ R, const T* __restrict__ C1,
                  const T* __restrict__ E, const T* __restrict__ Q,
                  const T* __restrict__ Qf, const T* __restrict__ Rf,
                  const T* __restrict__ r, T* __restrict__ out, int NY,
                  int NX) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= NX) return;
  // forward: zz = Q_y^T [zc; r_{y+1}]; Z_y = zz[0:2] parks in out[y]
  T z0 = r[2 * x], z1 = r[2 * x + 1];
#pragma unroll 1
  for (int y = 0; y < NY - 1; ++y) {
    const T* q = Q + ((long long)y * NX + x) * 16;
    const T* rr = r + ((long long)(y + 1) * NX + x) * 2;
    const T v[4] = {z0, z1, rr[0], rr[1]};
    T zz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) s += q[4 * k + i] * v[k];
      zz[i] = s;
    }
    T* o = out + ((long long)y * NX + x) * 2;
    o[0] = zz[0];
    o[1] = zz[1];
    z0 = zz[2];
    z1 = zz[3];
  }
  const T* qf = Qf + 4 * x;
  const T zl0 = qf[0] * z0 + qf[2] * z1, zl1 = qf[1] * z0 + qf[3] * z1;
  T x10, x11;  // x_{y+1}
  upper_solve(Rf + 4 * x, zl0, zl1, x10, x11);
  T* last = out + ((long long)(NY - 1) * NX + x) * 2;
  last[0] = x10;
  last[1] = x11;
  T x20 = T(0), x21 = T(0);  // x_{y+2}
  // back substitution: R_y x_y = Z_y - C1_y x_{y+1} - E_y x_{y+2}
#pragma unroll 1
  for (int y = NY - 2; y >= 0; --y) {
    const long long p = ((long long)y * NX + x) * 4;
    const T* c = C1 + p;
    const T* e = E + p;
    T* o = out + ((long long)y * NX + x) * 2;
    const T b0 = o[0] - (c[0] * x10 + c[1] * x11) - (e[0] * x20 + e[1] * x21);
    const T b1 = o[1] - (c[2] * x10 + c[3] * x11) - (e[2] * x20 + e[3] * x21);
    T y0, y1;
    upper_solve(R + p, b0, b1, y0, y1);
    o[0] = y0;
    o[1] = y1;
    x20 = x10;
    x21 = x11;
    x10 = y0;
    x11 = y1;
  }
}

template <typename T>
int factor(const void* Al, const void* Ad, const void* Au, void* R, void* C1,
           void* E, void* Q, void* Qf, void* Rf, int NY, int NX,
           void* stream) {
  if (NY < 1 || NX < 1) return (int)cudaErrorInvalidValue;
  line_factor_kernel<T><<<(NX + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Al), static_cast<const T*>(Ad),
      static_cast<const T*>(Au), static_cast<T*>(R), static_cast<T*>(C1),
      static_cast<T*>(E), static_cast<T*>(Q), static_cast<T*>(Qf),
      static_cast<T*>(Rf), NY, NX);
  return (int)cudaGetLastError();
}

template <typename T>
int solve(const void* R, const void* C1, const void* E, const void* Q,
          const void* Qf, const void* Rf, const void* r, void* out, int NY,
          int NX, void* stream) {
  if (NY < 1 || NX < 1) return (int)cudaErrorInvalidValue;
  line_solve_kernel<T><<<(NX + THREADS - 1) / THREADS, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(R), static_cast<const T*>(C1),
      static_cast<const T*>(E), static_cast<const T*>(Q),
      static_cast<const T*>(Qf), static_cast<const T*>(Rf),
      static_cast<const T*>(r), static_cast<T*>(out), NY, NX);
  return (int)cudaGetLastError();
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

// x = the line solves of r with those factors.
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

extern "C" const char* cmfem_linemg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
