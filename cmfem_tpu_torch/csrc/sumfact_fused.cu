// Fused sum-factorized operator apply  y = A u  on a structured hex lattice.
//
// Replaces the TPU kernel cmfem_tpu/ops/sumfact.py::_bind_fused_zfma (the
// fused z-FMA Pallas kernel that SumFactoredOperator.best_bind picks on the
// TPU).  It computes the same operator on the lattice-numbered vector of
// StructuredGrid3D, but does not carry over the TPU kernel's y-slabs, lane
// slices or overlap-add outside the kernel: the work here is element-local.
//
// Per element, one thread per entry of the (p+1)^3 cube (q1 = p+1 Gauss
// points per axis, so the DOF cube and the quadrature cube are the same
// size N^3):
//   load the N^3 lattice values of u;
//   contract x, y and z against the 1D tables B1/G1 into the 4 quadrature
//   fields (value and the 3 reference gradients);
//   apply the compressed D pointwise.  Planes D00, D0x, D0y, D0z, Dxx, Dxy,
//   Dxz, Dyy, Dyz, Dzz (d11 symmetric, d10 = 0), read at
//   [plane, k*q1+qz, j*q1+qy, i*q1+qx], or at [plane, qz, ...] for the
//   z-periodic Dz;
//   run the transposed contractions and add the N^3 results into y.
// The stages pass through two shared-memory buffers per element; the 1D
// tables are staged in shared memory too.  The kernel is templated on the
// scalar type and on N = p+1, so every contraction loop unrolls.
//
// Scatter: 8 launches, one per parity colour of the element index (i, j, k).
// No two elements of one colour share a DOF, so the adds need no atomics and
// the result is deterministic; the wrapper zeroes y first.
//
// What bounds it: at 48^3, order 2 (912,673 DOFs) one apply reads about
// 2.5 MB of Dz (L2-resident on a 50 MB L2) and 3.65 MB of u, writes 3.65 MB
// of y, and does about 0.4 GFLOP (bench.py's count).  At 3.35 TB/s and tens
// of TFLOP/s that is a few microseconds of work, so this first version is
// bound by latency (6 barriers per element stage chain, uncoalesced
// element-strided loads) and by its 8 launches.  Making it fast (wgmma, TMA,
// fewer passes) is later work.

#include <cuda_runtime.h>

namespace {

template <int N>
struct Tile {
  // elements per block: about 256 threads
  static constexpr int N3 = N * N * N;
  static constexpr int E = (256 / N3) > 0 ? (256 / N3) : 1;
  static constexpr int THREADS = E * N3;
};

template <typename T, int N>
__global__ void __launch_bounds__(Tile<N>::THREADS)
sumfact_colour_kernel(const T* __restrict__ u, const T* __restrict__ D,
                      const T* __restrict__ tab, T* __restrict__ y,
                      int nx, int ny, int ci, int cj, int ck,
                      int ncx, int ncy, long long n_colour, int d_rows,
                      int z_periodic) {
  constexpr int P = N - 1;
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  constexpr int E = Tile<N>::E;
  __shared__ T sB[N2];
  __shared__ T sG[N2];
  __shared__ T buf0[E][4 * N3];
  __shared__ T buf1[E][4 * N3];

  const int tid = threadIdx.x;
  for (int t = tid; t < N2; t += blockDim.x) {
    sB[t] = tab[t];       // B1[q][a] at q*N + a
    sG[t] = tab[N2 + t];  // G1[q][a]
  }

  const int el = tid / N3;  // element of this block's tile
  const int r = tid - el * N3;
  const int z = r / N2;
  const int yy = (r / N) % N;
  const int x = r % N;
  const long long eid = (long long)blockIdx.x * E + el;
  const bool active = eid < n_colour;
  int i = 0, j = 0, k = 0;
  if (active) {
    const long long rest = eid / ncx;
    i = 2 * (int)(eid - rest * ncx) + ci;
    j = 2 * (int)(rest % ncy) + cj;
    k = 2 * (int)(rest / ncy) + ck;
  }
  const long long NX = (long long)nx * P + 1;
  const long long NY = (long long)ny * P + 1;
  const long long g = ((long long)(k * P + z) * NY + (j * P + yy)) * NX
                      + (i * P + x);
  T* b0 = buf0[el];
  T* b1 = buf1[el];

  b0[r] = active ? u[g] : T(0);
  __syncthreads();

  // x: (z-dof, y-dof, x-qp) <- u[z-dof][y-dof][:]
  {
    T t0 = 0, tx = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const T ua = b0[(z * N + yy) * N + a];
      t0 += sB[x * N + a] * ua;
      tx += sG[x * N + a] * ua;
    }
    b1[r] = t0;
    b1[N3 + r] = tx;
  }
  __syncthreads();

  // y: (z-dof, y-qp, x-qp)
  {
    T s00 = 0, s10 = 0, s01 = 0;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const int idx = (z * N + b) * N + x;
      const T t0 = b1[idx];
      const T tx = b1[N3 + idx];
      s00 += sB[yy * N + b] * t0;
      s10 += sB[yy * N + b] * tx;
      s01 += sG[yy * N + b] * t0;
    }
    b0[r] = s00;
    b0[N3 + r] = s10;
    b0[2 * N3 + r] = s01;
  }
  __syncthreads();

  // z: (z-qp, y-qp, x-qp), then D pointwise; W goes to b1 (last read
  // before the previous barrier)
  {
    T V0 = 0, V1 = 0, V2 = 0, V3 = 0;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int idx = (c * N + yy) * N + x;
      const T s00 = b0[idx];
      V0 += sB[z * N + c] * s00;
      V1 += sB[z * N + c] * b0[N3 + idx];
      V2 += sB[z * N + c] * b0[2 * N3 + idx];
      V3 += sG[z * N + c] * s00;
    }
    T W0 = 0, W1 = 0, W2 = 0, W3 = 0;
    if (active) {
      const long long Kx = (long long)nx * N;
      const long long Ky = (long long)ny * N;
      const long long kz = z_periodic ? z : (long long)k * N + z;
      const long long plane = (long long)d_rows * Ky * Kx;
      const T* d = D + (kz * Ky + (j * N + yy)) * Kx + (i * N + x);
      const T d0 = d[0], d1 = d[plane], d2 = d[2 * plane], d3 = d[3 * plane];
      const T d4 = d[4 * plane], d5 = d[5 * plane], d6 = d[6 * plane];
      const T d7 = d[7 * plane], d8 = d[8 * plane], d9 = d[9 * plane];
      W0 = d0 * V0 + d1 * V1 + d2 * V2 + d3 * V3;
      W1 = d4 * V1 + d5 * V2 + d6 * V3;
      W2 = d5 * V1 + d7 * V2 + d8 * V3;
      W3 = d6 * V1 + d8 * V2 + d9 * V3;
    }
    b1[r] = W0;
    b1[N3 + r] = W1;
    b1[2 * N3 + r] = W2;
    b1[3 * N3 + r] = W3;
  }
  __syncthreads();

  // z^T: (z-dof, y-qp, x-qp); the value and z-gradient chains share x/y
  {
    T r0 = 0, rx = 0, ry = 0;
#pragma unroll
    for (int qz = 0; qz < N; ++qz) {
      const int idx = (qz * N + yy) * N + x;
      const T bz = sB[qz * N + z];
      r0 += bz * b1[idx] + sG[qz * N + z] * b1[3 * N3 + idx];
      rx += bz * b1[N3 + idx];
      ry += bz * b1[2 * N3 + idx];
    }
    b0[r] = r0;
    b0[N3 + r] = rx;
    b0[2 * N3 + r] = ry;
  }
  __syncthreads();

  // y^T: (z-dof, y-dof, x-qp)
  {
    T s0 = 0, sx = 0;
#pragma unroll
    for (int qy = 0; qy < N; ++qy) {
      const int idx = (z * N + qy) * N + x;
      s0 += sB[qy * N + yy] * b0[idx] + sG[qy * N + yy] * b0[2 * N3 + idx];
      sx += sB[qy * N + yy] * b0[N3 + idx];
    }
    b1[r] = s0;
    b1[N3 + r] = sx;
  }
  __syncthreads();

  // x^T: (z-dof, y-dof, x-dof), added into y (no other element of this
  // colour touches these DOFs)
  T acc = 0;
#pragma unroll
  for (int qx = 0; qx < N; ++qx) {
    const int idx = (z * N + yy) * N + qx;
    acc += sB[qx * N + x] * b1[idx] + sG[qx * N + x] * b1[N3 + idx];
  }
  if (active) y[g] += acc;
}

template <typename T, int N>
int launch_colours(const T* u, const T* D, const T* tab, T* y, int nx,
                   int ny, int nz, int z_periodic, cudaStream_t stream) {
  const int d_rows = z_periodic ? N : nz * N;
  for (int c = 0; c < 8; ++c) {
    const int ci = c & 1, cj = (c >> 1) & 1, ck = (c >> 2) & 1;
    const int ncx = (nx - ci + 1) / 2;
    const int ncy = (ny - cj + 1) / 2;
    const int ncz = (nz - ck + 1) / 2;
    const long long n_colour = (long long)ncx * ncy * ncz;
    if (n_colour == 0) continue;
    const long long blocks = (n_colour + Tile<N>::E - 1) / Tile<N>::E;
    sumfact_colour_kernel<T, N><<<(unsigned)blocks, Tile<N>::THREADS, 0,
                                  stream>>>(u, D, tab, y, nx, ny, ci, cj, ck,
                                            ncx, ncy, n_colour, d_rows,
                                            z_periodic);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* u, const void* D, const void* tab, void* y, int p,
             int nx, int ny, int nz, int z_periodic, void* stream) {
  const T* u_ = static_cast<const T*>(u);
  const T* D_ = static_cast<const T*>(D);
  const T* t_ = static_cast<const T*>(tab);
  T* y_ = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_colours<T, 2>(u_, D_, t_, y_, nx, ny, nz, z_periodic, s);
    case 2: return launch_colours<T, 3>(u_, D_, t_, y_, nx, ny, nz, z_periodic, s);
    case 3: return launch_colours<T, 4>(u_, D_, t_, y_, nx, ny, nz, z_periodic, s);
    case 4: return launch_colours<T, 5>(u_, D_, t_, y_, nx, ny, nz, z_periodic, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y += A u over every element (y zeroed by the caller).  u: (NZ*NY*NX,),
// D: (10, z_periodic ? q1 : nz*q1, ny*q1, nx*q1), tab: (2, q1, p+1) with
// q1 = p + 1.  Returns cudaGetLastError() after the launches.
extern "C" int cmfem_sumfact_apply_f32(const void* u, const void* D,
                                       const void* tab, void* y, int p,
                                       int nx, int ny, int nz,
                                       int z_periodic, void* stream) {
  return dispatch<float>(u, D, tab, y, p, nx, ny, nz, z_periodic, stream);
}

extern "C" int cmfem_sumfact_apply_f64(const void* u, const void* D,
                                       const void* tab, void* y, int p,
                                       int nx, int ny, int nz,
                                       int z_periodic, void* stream) {
  return dispatch<double>(u, D, tab, y, p, nx, ny, nz, z_periodic, stream);
}

extern "C" const char* cmfem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
