// The z-chain of the sum-factorized operator apply, fused over quadrature
// columns:
//   V = [Az T0, Az Tx, Az Ty, DAz T0]      (value, x-, y-, z-gradient)
//   W = D V pointwise                       (compressed 10-plane D)
//   U0 = Az^T W0 + DAz^T Wz,  Ux = Az^T Wx,  Uy = Az^T Wy.
// The x/y chains before and after stay outside (dense matmuls in torch).
//
// Replaces the TPU kernel cmfem_tpu/ops/sumfact.py::
// SumFactoredOperator._bind_pallas (sumfact.py:768), which runs this chain
// over tiles of 256 quadrature columns with dense (Kz, NZ) z matmuls on a
// sequential grid.  What it keeps out of device memory is kept out here
// too: the four V and four W fields live in registers only.  Its tiles,
// dense z matmuls and sequential grid do not carry over:
//   T0, Tx, Ty, U0, Ux, Uy  (NZ, KK)      KK = Ky*Kx quadrature columns
//   D                       (10, Kz, KK)  or Dz (10, q1, KK), z-periodic
//   tab                     (2, q1, N)    [B1; G1], the 1D tables, N = p+1
// with NZ = nz*p + 1, Kz = nz*q1 and q1 = N.  Planes D00, D0x, D0y, D0z,
// Dxx, Dxy, Dxz, Dyy, Dyz, Dzz (d11 symmetric, d10 = 0).
//
// Design: one thread per (quadrature column c, chunk of z-elements).  The
// column is the minor axis of T, D and U, so every load and store of a
// warp is coalesced with no transpose.  The thread walks its z-elements k:
// it loads the N nodes k*p .. k*p+p of T0/Tx/Ty (node k*p carried in
// registers from element k-1), contracts them against the 1D tables (the
// block-banded Az is never formed), reads the 10 planes at
// [plane, k*q1+qz, c] (or [plane, qz, c] for Dz), forms W and accumulates
// the transposed contractions into the N nodes of U0/Ux/Uy.  Node k*p is
// written once, after the carry from element k-1 is added; nodes inside
// the element are written at once; the last node of the chunk is carried.
// A chunk that does not start at element 0 first runs element k0-1 without
// writing, to compute that carry: every output is written exactly once,
// with no atomics, colouring or zero fill, and its value does not depend
// on the chunking (bitwise).  The wrapper picks the chunk count.
//
// What bounds it: memory.  At 48^3 in float32 one call reads full D
// (119.4 / 283.1 / 553.0 MB at orders 2 / 3 / 4) or Dz (2.5 / 5.9 /
// 11.5 MB) and moves T in and U out (48.3 / 128.3 / 266.8 MB), and does
// 16*(p+1) + 20 FLOP per quadrature point (0.20 GFLOP at order 2, 3 us at
// 67 TFLOP/s).  The bytes bound it: 50 / 123 / 245 us with full D, 15 /
// 40 / 83 us with Dz, at 3.35 TB/s.  With one thread per column only KK =
// 20,736 threads run at order 2 (8% of the 270,336 that 132 SMs hold), each
// with an nz-long dependent loop, so unchunked it would be latency-bound;
// the z chunks multiply the threads, at the cost of one recomputed element
// (D read twice for it) per chunk.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
zchain_kernel(const T* __restrict__ T0, const T* __restrict__ Tx,
              const T* __restrict__ Ty, const T* __restrict__ D,
              const T* __restrict__ tab, T* __restrict__ U0,
              T* __restrict__ Ux, T* __restrict__ Uy, long long KK, int nz,
              int chunk, int z_periodic) {
  constexpr int P = N - 1;
  __shared__ T sB[N * N];  // B1[q][a] at q*N + a
  __shared__ T sG[N * N];
  for (int t = threadIdx.x; t < N * N; t += blockDim.x) {
    sB[t] = tab[t];
    sG[t] = tab[N * N + t];
  }
  __syncthreads();

  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= KK) return;  // no barrier below
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(nz, k0 + chunk);
  const long long d_rows = z_periodic ? N : (long long)nz * N;
  const long long plane = d_rows * KK;

  // t*[a]: node k*P + a of the current element; node 0 carried in
  T t0[N], tx[N], ty[N];
  // carry of node k*P from element k-1 (zero before element 0)
  T c0 = T(0), cx = T(0), cy = T(0);
  const int kstart = k0 > 0 ? k0 - 1 : 0;
  {
    const long long row = (long long)kstart * P;
    t0[0] = T0[row * KK + c];
    tx[0] = Tx[row * KK + c];
    ty[0] = Ty[row * KK + c];
  }

#pragma unroll 1
  for (int k = kstart; k < k1; ++k) {
#pragma unroll
    for (int a = 1; a < N; ++a) {
      const long long idx = ((long long)k * P + a) * KK + c;
      t0[a] = T0[idx];
      tx[a] = Tx[idx];
      ty[a] = Ty[idx];
    }
    T r0[N], rx[N], ry[N];
#pragma unroll
    for (int a = 0; a < N; ++a) r0[a] = rx[a] = ry[a] = T(0);
    const T* d = D + (z_periodic ? 0 : (long long)k * N * KK) + c;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      T V0 = 0, V1 = 0, V2 = 0, V3 = 0;
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const T b = sB[q * N + a];
        V0 += b * t0[a];
        V1 += b * tx[a];
        V2 += b * ty[a];
        V3 += sG[q * N + a] * t0[a];
      }
      const T* dq = d + (long long)q * KK;
      const T d0 = dq[0], d1 = dq[plane], d2 = dq[2 * plane];
      const T d3 = dq[3 * plane], d4 = dq[4 * plane], d5 = dq[5 * plane];
      const T d6 = dq[6 * plane], d7 = dq[7 * plane], d8 = dq[8 * plane];
      const T d9 = dq[9 * plane];
      const T W0 = d0 * V0 + d1 * V1 + d2 * V2 + d3 * V3;
      const T W1 = d4 * V1 + d5 * V2 + d6 * V3;
      const T W2 = d5 * V1 + d7 * V2 + d8 * V3;
      const T W3 = d6 * V1 + d8 * V2 + d9 * V3;
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const T b = sB[q * N + a];
        r0[a] += b * W0 + sG[q * N + a] * W3;
        rx[a] += b * W1;
        ry[a] += b * W2;
      }
    }
    if (k >= k0) {
      // node k*P: the carry from element k-1 plus this element's share
      const long long row0 = ((long long)k * P) * KK + c;
      U0[row0] = c0 + r0[0];
      Ux[row0] = cx + rx[0];
      Uy[row0] = cy + ry[0];
#pragma unroll
      for (int a = 1; a < P; ++a) {
        const long long idx = ((long long)k * P + a) * KK + c;
        U0[idx] = r0[a];
        Ux[idx] = rx[a];
        Uy[idx] = ry[a];
      }
    }
    c0 = r0[P];
    cx = rx[P];
    cy = ry[P];
    t0[0] = t0[P];
    tx[0] = tx[P];
    ty[0] = ty[P];
  }
  if (k1 == nz) {
    const long long idx = ((long long)nz * P) * KK + c;
    U0[idx] = c0;
    Ux[idx] = cx;
    Uy[idx] = cy;
  }
}

template <typename T, int N>
int launch(const T* T0, const T* Tx, const T* Ty, const T* D, const T* tab,
           T* U0, T* Ux, T* Uy, long long KK, int nz, int chunks,
           int z_periodic, cudaStream_t stream) {
  if (KK == 0) return (int)cudaGetLastError();
  const int chunk = (nz + chunks - 1) / chunks;
  const dim3 grid((unsigned)((KK + THREADS - 1) / THREADS),
                  (unsigned)((nz + chunk - 1) / chunk));
  zchain_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      T0, Tx, Ty, D, tab, U0, Ux, Uy, KK, nz, chunk, z_periodic);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* T0, const void* Tx, const void* Ty, const void* D,
             const void* tab, void* U0, void* Ux, void* Uy, int p,
             long long KK, int nz, int chunks, int z_periodic, void* stream) {
  const T* t0 = static_cast<const T*>(T0);
  const T* tx = static_cast<const T*>(Tx);
  const T* ty = static_cast<const T*>(Ty);
  const T* d = static_cast<const T*>(D);
  const T* tb = static_cast<const T*>(tab);
  T* u0 = static_cast<T*>(U0);
  T* ux = static_cast<T*>(Ux);
  T* uy = static_cast<T*>(Uy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nz < 1 || chunks < 1 || chunks > nz) return (int)cudaErrorInvalidValue;
  switch (p) {
    case 1: return launch<T, 2>(t0, tx, ty, d, tb, u0, ux, uy, KK, nz, chunks, z_periodic, s);
    case 2: return launch<T, 3>(t0, tx, ty, d, tb, u0, ux, uy, KK, nz, chunks, z_periodic, s);
    case 3: return launch<T, 4>(t0, tx, ty, d, tb, u0, ux, uy, KK, nz, chunks, z_periodic, s);
    case 4: return launch<T, 5>(t0, tx, ty, d, tb, u0, ux, uy, KK, nz, chunks, z_periodic, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (U0, Ux, Uy) = the z-chain of (T0, Tx, Ty) through D, all written.
// T*/U*: (nz*p + 1, KK); D: (10, z_periodic ? q1 : nz*q1, KK); tab: (2, q1,
// p+1) with q1 = p + 1; all contiguous on the device; 1 <= chunks <= nz.
// Returns cudaGetLastError() after the launch.
extern "C" int cmfem_zchain_apply_f32(const void* T0, const void* Tx,
                                      const void* Ty, const void* D,
                                      const void* tab, void* U0, void* Ux,
                                      void* Uy, int p, long long KK, int nz,
                                      int chunks, int z_periodic,
                                      void* stream) {
  return dispatch<float>(T0, Tx, Ty, D, tab, U0, Ux, Uy, p, KK, nz, chunks,
                         z_periodic, stream);
}

extern "C" int cmfem_zchain_apply_f64(const void* T0, const void* Tx,
                                      const void* Ty, const void* D,
                                      const void* tab, void* U0, void* Ux,
                                      void* Uy, int p, long long KK, int nz,
                                      int chunks, int z_periodic,
                                      void* stream) {
  return dispatch<double>(T0, Tx, Ty, D, tab, U0, Ux, Uy, p, KK, nz, chunks,
                          z_periodic, stream);
}

extern "C" const char* cmfem_zchain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
