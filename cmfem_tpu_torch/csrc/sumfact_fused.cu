// Element-local sum-factorized operator apply  y = A u  on a structured hex
// lattice, for Hopper (sm_90a).
//
// Replaces two TPU kernels of cmfem_tpu/ops/sumfact.py: B2,
// _bind_fused_zfma (:563, the fused z-FMA kernel on the z-periodic Dz of
// shape (10, q1, Ky, Kx)), and B3, _bind_fused (:365, the slab-fused kernel
// on the full compressed D of shape (10, Kz, Ky, Kx)).  It computes the same
// operator on the lattice-numbered vector of StructuredGrid3D, element by
// element; the TPU kernels' y-slabs, dense z matmuls, lane slices and
// overlap-add outside the kernel exist to fit VMEM and do not carry over.
// Compressed D: planes D00, D0x, D0y, D0z, Dxx, Dxy, Dxz, Dyy, Dyz, Dzz
// (d11 symmetric, d10 = 0), read at [plane, k*q1+qz, j*q1+qy, i*q1+qx], or
// at [plane, qz, ...] for Dz.  q1 = p + 1 = N, so the DOF cube and the
// quadrature cube of an element are both N^3; p = 1..4, float and double.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s float32): B3 by bytes
// (full D is 10 K floats for K = Kx Ky Kz quadrature points: 119 / 283 /
// 553 MB at 48^3, orders 2 / 3 / 4 in float32, 2.4-11x the 50 MB L2, so it
// streams from HBM on every apply); B2 by operations (Dz is L2-resident and
// the ~18 N FMAs per quadrature point dominate).
//
// sumfact_lane_kernel, the one the wrapper launches.  One lane per (element,
// qx, qy) column; the (p+1)^2 <= 25 lanes of one element form a group, and a
// warp holds 32 / N^2 whole elements (8, 3, 2, 1 at p = 1..4).  Consecutive
// element indices (x fastest) fill the groups of a warp, then the warps of a
// block, so a block reads runs of consecutive elements along x.  Each lane
// holds the z-line of every field in registers:
//   load u[a=qx, b=qy, c] for c < N;
//   x: the lane (qx, b) takes u(a, b, c) for every a from lane (a, b) of its
//   group with __shfl_sync and contracts against its rows B1[qx][.],
//   G1[qx][.] (kept in registers); y the same along b;
//   z, the pointwise D stage and z^T in registers, with the tables in shared
//   memory read at loop-counter addresses (one broadcast per value);
//   y^T and x^T by shuffles again, against the columns B1[.][qy], G1[.][qx].
// It replaced an earlier colour design (one thread per entry of the N^3
// cube, two shared-memory buffers per element, six block barriers per
// element chain, 8 launches, one per parity colour of (i, j, k), so that no
// two elements of a launch share a DOF), which lost to it at every order
// and was deleted.  Its four faults, and what this kernel does instead:
//   1. one launch per apply over all elements (plus the wrapper's zero fill
//      of y), not 8 parity-colour launches with 8 partly empty last waves;
//   2. neighbouring lanes and warps hold neighbouring elements along x, so
//      each (plane, qz, qy) row of D and each row of u is read contiguously
//      by one block and crosses HBM once; full D streams once per apply;
//   3. the x/y exchanges are shuffles (about 8 N^2 per lane against 18 N^2
//      FMAs), the z stages read one broadcast table value per 2-3 FMAs: no
//      stage reads two shared-memory operands per FMA;
//   4. no block barrier after the tables are staged: a group lives in one
//      warp, and a shuffle synchronises only that warp.
// The scatter: a DOF interior to its element (one of its (p-1)^3) belongs to
// no other element and is written with a plain store; a DOF on a face, edge
// or vertex is added with atomicAdd (red.global.add, native for float and
// double on sm_90) into y, which the wrapper zeroes first.  The order in
// which the up to 8 elements of a shared node add into it changes from run
// to run, so y on shared nodes varies at the ulp level between runs; interior
// DOFs are bitwise repeatable.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int LANE_MAX_WARPS = 8;  // the launch bound: 256 threads a block

template <int N>
struct Lanes {
  static constexpr int N2 = N * N;
  static constexpr int PER_WARP = 32 / N2;  // whole elements in one warp
};

template <typename T, int N>
__global__ void __launch_bounds__(LANE_MAX_WARPS * 32)
sumfact_lane_kernel(const T* __restrict__ u, const T* __restrict__ D,
                    const T* __restrict__ tab, T* __restrict__ y, int nx,
                    int ny, long long n_el, int d_rows, int z_periodic,
                    int warps) {
  constexpr int P = N - 1;
  constexpr int N2 = N * N;
  constexpr int PER_WARP = Lanes<N>::PER_WARP;
  __shared__ T sB[N2];  // B1[q][a] at q*N + a
  __shared__ T sG[N2];  // G1[q][a]
  for (int t = threadIdx.x; t < N2; t += blockDim.x) {
    sB[t] = tab[t];
    sG[t] = tab[N2 + t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int group = lane / N2;  // element of the warp; == PER_WARP: idle lane
  const int r = lane - group * N2;
  const int qy = r / N;
  const int qx = r - qy * N;
  const int base = group * N2;  // first lane of the group (mod 32 if idle)
  const long long eid =
      ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * PER_WARP + group;
  const bool active = group < PER_WARP && eid < n_el;
  // idle lanes compute element 0 and store nothing: every address stays valid
  // and every lane takes part in every shuffle
  const long long e = active ? eid : 0;
  const long long rest = e / nx;
  const int i = (int)(e - rest * nx);
  const int j = (int)(rest % ny);
  const int k = (int)(rest / ny);

  const long long NX = (long long)nx * P + 1;
  const long long NXY = NX * ((long long)ny * P + 1);
  const long long g0 =
      (long long)k * P * NXY + (long long)(j * P + qy) * NX + (i * P + qx);
  const long long Kx = (long long)nx * N;
  const long long KK = (long long)ny * N * Kx;
  const long long plane = (long long)d_rows * KK;
  const T* d = D + (z_periodic ? 0 : (long long)k * N * KK)
               + (long long)(j * N + qy) * Kx + (i * N + qx);

  T uz[N];
#pragma unroll
  for (int c = 0; c < N; ++c) uz[c] = u[g0 + c * NXY];

  // x: (b, c) rows of u from the group's lanes (a, b), against row qx
  T t0[N], tx[N];
  {
    T bx[N], gx[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      bx[a] = sB[qx * N + a];
      gx[a] = sG[qx * N + a];
    }
#pragma unroll
    for (int c = 0; c < N; ++c) t0[c] = tx[c] = T(0);
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const int src = base + qy * N + a;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T v = __shfl_sync(FULL_MASK, uz[c], src);
        t0[c] += bx[a] * v;
        tx[c] += gx[a] * v;
      }
    }
  }

  // y: from the group's lanes (qx, b), against row qy
  T s00[N], s10[N], s01[N];
  {
    T by[N], gy[N];
#pragma unroll
    for (int b = 0; b < N; ++b) {
      by[b] = sB[qy * N + b];
      gy[b] = sG[qy * N + b];
    }
#pragma unroll
    for (int c = 0; c < N; ++c) s00[c] = s10[c] = s01[c] = T(0);
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const int src = base + b * N + qx;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T v0 = __shfl_sync(FULL_MASK, t0[c], src);
        const T v1 = __shfl_sync(FULL_MASK, tx[c], src);
        s00[c] += by[b] * v0;
        s10[c] += by[b] * v1;
        s01[c] += gy[b] * v0;
      }
    }
  }

  // z, then D pointwise, one quadrature point qz at a time
  T W0[N], W1[N], W2[N], W3[N];
#pragma unroll
  for (int qz = 0; qz < N; ++qz) {
    T V0 = 0, V1 = 0, V2 = 0, V3 = 0;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const T bz = sB[qz * N + c];
      V0 += bz * s00[c];
      V1 += bz * s10[c];
      V2 += bz * s01[c];
      V3 += sG[qz * N + c] * s00[c];
    }
    const T* dq = d + qz * KK;
    const T d0 = dq[0], d1 = dq[plane], d2 = dq[2 * plane];
    const T d3 = dq[3 * plane], d4 = dq[4 * plane], d5 = dq[5 * plane];
    const T d6 = dq[6 * plane], d7 = dq[7 * plane], d8 = dq[8 * plane];
    const T d9 = dq[9 * plane];
    W0[qz] = d0 * V0 + d1 * V1 + d2 * V2 + d3 * V3;
    W1[qz] = d4 * V1 + d5 * V2 + d6 * V3;
    W2[qz] = d5 * V1 + d7 * V2 + d8 * V3;
    W3[qz] = d6 * V1 + d8 * V2 + d9 * V3;
  }

  // z^T; the value and z-gradient chains share x and y
  T r0[N], rx[N], ry[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    T a0 = 0, ax = 0, ay = 0;
#pragma unroll
    for (int qz = 0; qz < N; ++qz) {
      const T bz = sB[qz * N + c];
      a0 += bz * W0[qz] + sG[qz * N + c] * W3[qz];
      ax += bz * W1[qz];
      ay += bz * W2[qz];
    }
    r0[c] = a0;
    rx[c] = ax;
    ry[c] = ay;
  }

  // y^T: the lane (qx, b = qy) takes from the group's lanes (qx, q)
  T s0[N], sx[N];
  {
    T by[N], gy[N];  // columns B1[.][qy], G1[.][qy]
#pragma unroll
    for (int q = 0; q < N; ++q) {
      by[q] = sB[q * N + qy];
      gy[q] = sG[q * N + qy];
    }
#pragma unroll
    for (int c = 0; c < N; ++c) s0[c] = sx[c] = T(0);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int src = base + q * N + qx;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T a0 = __shfl_sync(FULL_MASK, r0[c], src);
        const T ax = __shfl_sync(FULL_MASK, rx[c], src);
        const T ay = __shfl_sync(FULL_MASK, ry[c], src);
        s0[c] += by[q] * a0 + gy[q] * ay;
        sx[c] += by[q] * ax;
      }
    }
  }

  // x^T: the lane (a = qx, b = qy) takes from the group's lanes (q, qy)
  T acc[N];
  {
    T bx[N], gx[N];  // columns B1[.][qx], G1[.][qx]
#pragma unroll
    for (int q = 0; q < N; ++q) {
      bx[q] = sB[q * N + qx];
      gx[q] = sG[q * N + qx];
    }
#pragma unroll
    for (int c = 0; c < N; ++c) acc[c] = T(0);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int src = base + qy * N + q;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T v0 = __shfl_sync(FULL_MASK, s0[c], src);
        const T vx = __shfl_sync(FULL_MASK, sx[c], src);
        acc[c] += bx[q] * v0 + gx[q] * vx;
      }
    }
  }

  if (active) {
    const bool inner_xy = qx > 0 && qx < P && qy > 0 && qy < P;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      T* dst = y + g0 + c * NXY;
      if (inner_xy && c > 0 && c < P)
        *dst = acc[c];  // interior: no other element holds this DOF
      else
        atomicAdd(dst, acc[c]);
    }
  }
}

template <typename T, int N>
int launch_lanes(const T* u, const T* D, const T* tab, T* y, int nx, int ny,
                 int nz, int z_periodic, int per_warp, int warps,
                 long long blocks, cudaStream_t stream) {
  // the geometry comes from the wrapper (kernels/sumfact.py::launch_geometry);
  // refuse one that does not cover the elements exactly
  const long long n_el = (long long)nx * ny * nz;
  const long long per_block = (long long)per_warp * warps;
  if (per_warp != Lanes<N>::PER_WARP || warps < 1 || warps > LANE_MAX_WARPS
      || blocks < 1 || blocks > 0x7fffffffLL || blocks * per_block < n_el
      || (blocks - 1) * per_block >= n_el)
    return (int)cudaErrorInvalidValue;
  const int d_rows = z_periodic ? N : nz * N;
  sumfact_lane_kernel<T, N><<<(unsigned)blocks, warps * 32, 0, stream>>>(
      u, D, tab, y, nx, ny, n_el, d_rows, z_periodic, warps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_lanes(const void* u, const void* D, const void* tab, void* y,
                   int p, int nx, int ny, int nz, int z_periodic,
                   int per_warp, int warps, long long blocks, void* stream) {
  const T* u_ = static_cast<const T*>(u);
  const T* D_ = static_cast<const T*>(D);
  const T* t_ = static_cast<const T*>(tab);
  T* y_ = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_lanes<T, 2>(u_, D_, t_, y_, nx, ny, nz, z_periodic, per_warp, warps, blocks, s);
    case 2: return launch_lanes<T, 3>(u_, D_, t_, y_, nx, ny, nz, z_periodic, per_warp, warps, blocks, s);
    case 3: return launch_lanes<T, 4>(u_, D_, t_, y_, nx, ny, nz, z_periodic, per_warp, warps, blocks, s);
    case 4: return launch_lanes<T, 5>(u_, D_, t_, y_, nx, ny, nz, z_periodic, per_warp, warps, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y += A u over every element (y zeroed by the caller), one launch of the
// lane kernel.  u: (NZ*NY*NX,), D: (10, z_periodic ? q1 : nz*q1, ny*q1,
// nx*q1), tab: (2, q1, p+1) with q1 = p + 1; per_warp, warps, blocks: the
// launch geometry (elements per warp, warps per block, blocks), refused
// with cudaErrorInvalidValue unless it covers the nx*ny*nz elements with no
// empty block.  Returns cudaGetLastError() after the launch.
extern "C" int cmfem_sumfact_apply_f32(const void* u, const void* D,
                                       const void* tab, void* y, int p,
                                       int nx, int ny, int nz, int z_periodic,
                                       int per_warp, int warps,
                                       long long blocks, void* stream) {
  return dispatch_lanes<float>(u, D, tab, y, p, nx, ny, nz, z_periodic,
                               per_warp, warps, blocks, stream);
}

extern "C" int cmfem_sumfact_apply_f64(const void* u, const void* D,
                                       const void* tab, void* y, int p,
                                       int nx, int ny, int nz, int z_periodic,
                                       int per_warp, int warps,
                                       long long blocks, void* stream) {
  return dispatch_lanes<double>(u, D, tab, y, p, nx, ny, nz, z_periodic,
                                per_warp, warps, blocks, stream);
}

extern "C" const char* cmfem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
