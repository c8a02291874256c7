// Element-batched B^T D B apply in the transposed layout:
//   y_eT[:, e] = BG^T (D_e (BG u_eT[:, e]))  for every element e.
//
// Replaces the TPU kernel cmfem_tpu/ops/partial.py::_pallas_btdb (B1), which
// PAOperator and StructuredPAOperator run.  It computes what B1 computes, on
// B1's layout, but does not carry over its 1024-element tile or the padding
// of the element count to that tile:
//   BG    (M*NQ, ND)    m-major [B; Gx; Gy(; Gz)] at the quadrature points
//   u_eT  (ND, ne)      element DOF values, element index minor
//   Dflat (M*M, NQ, ne) the quadrature-point blocks D[r*M+s], element minor
//   y_eT  (ND, ne)      written (not accumulated); the gather before and the
//                       scatter after stay outside, as on the TPU.
// M = 1 + dim: 4 for hexes, 3 for quads.
//
// Design (hexes at orders 1-3, quads at orders 1-4): one thread per
// element.  The element is the minor axis of u_eT,
// Dflat and y_eT, so a warp's loads and stores of them are coalesced.  Each
// thread keeps u_e (ND values) and its y_e accumulator in registers and
// streams over the quadrature points q:
//   U_s(q) = sum_a BG[s*NQ+q, a] u_e[a]          (M values)
//   V_r(q) = sum_s D[r*M+s, q, e] U_s(q)
//   y_e[a] += sum_r BG[r*NQ+q, a] V_r(q)
// BG is staged once per block in (dynamic) shared memory; every thread of a
// warp reads the same entry, a broadcast with no bank conflicts.  The kernel
// is templated on the scalar type and on (M, ND, NQ), so the loops over a
// and s unroll and u_e / y_e stay in registers; the loop over q does not
// unroll (code size).  At p = 3 a thread holds 2*64 values: in float64 that
// is past the 255-register limit and ptxas spills (reported at build time).
//
// What bounds it: at 48^3, order 2 in float32 (M=4, ND=NQ=27, ne=110,592)
// one apply reads 191.1 MB of Dflat plus 11.9 MB of u_eT and writes 11.9 MB
// of y_eT; it does 12.5 kFLOP per element, 1.39 GFLOP in all, 6.4 FLOP/B.
// So the D read bounds it: about 64 us at the H100's 3.35 TB/s.  The
// broadcast shared-memory reads of BG (one per FMA of the two products)
// come next, at a similar time; no speed target applies to this first
// version.
//
// Hexes at order 4 (M=4, ND=NQ=125) take a second design, btdb_tiled_kernel:
// there BG is 250 KB in float32 (500 KB in float64), past the 227 KB of
// shared memory a block may use, and one element's 125 + 125 values do not
// fit in a thread's registers.  The two products are then dense matrix
// products over a block of E elements (32 in float32, 16 in float64):
//   U (500 x E) = BG (500 x 128) u_E (128 x E),  y_E = BG^T V,
// with BG padded by the wrapper to 128 zero-filled columns.  A block of 256
// threads stages u_E, and U (overwritten in place by V after the D stage),
// in shared memory, element minor; BG passes through shared memory in
// chunks (16 or 8 columns for U, transposed on the way in; 32 rows for
// y).  Each thread keeps a 16 x 4 (float64: 8 x 4) tile of U and a 4 x 4
// (2 x 4) tile of y in registers, so one 16-byte shared-memory load feeds
// 4 to 16 FMAs.  Shared memory: 114,944 bytes in both types (two blocks
// per SM), opted in with cudaFuncSetAttribute.
// What bounds it at 48^3 p=4 in float32 (ne = 110,592): Dflat is
// 16*125*110,592*4 B = 884.7 MB, about 264 us at 3.35 TB/s (297 us with
// u_eT and y_eT), but the two dense products do 2 * 2*500*125 FLOP per
// element, 28.1 GFLOP in all with the D stage: about 419 us at 67 TFLOP/s.
// So at order 4 the operations bound it: the register tiles are there to
// keep the FMA units, not the loads, the busy part.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <typename T, int M, int ND, int NQ>
__global__ void __launch_bounds__(THREADS)
btdb_kernel(const T* __restrict__ BG, const T* __restrict__ u,
            const T* __restrict__ D, T* __restrict__ y, long long ne) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sBG = reinterpret_cast<T*>(smem_raw);  // (M*NQ, ND), row-major
  for (int t = threadIdx.x; t < M * NQ * ND; t += blockDim.x) sBG[t] = BG[t];
  __syncthreads();

  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= ne) return;  // no barrier below

  T ue[ND];
  T ye[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    ue[a] = u[(long long)a * ne + e];
    ye[a] = T(0);
  }

#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    T U[M];
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const T* row = sBG + (s * NQ + q) * ND;
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < ND; ++a) acc += row[a] * ue[a];
      U[s] = acc;
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      T v = T(0);
#pragma unroll
      for (int s = 0; s < M; ++s)
        v += D[((long long)(r * M + s) * NQ + q) * ne + e] * U[s];
      const T* row = sBG + (r * NQ + q) * ND;
#pragma unroll
      for (int a = 0; a < ND; ++a) ye[a] += row[a] * v;
    }
  }

#pragma unroll
  for (int a = 0; a < ND; ++a) y[(long long)a * ne + e] = ye[a];
}

template <typename T, int M, int ND, int NQ>
int launch(const T* BG, const T* u, const T* D, T* y, long long ne,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * M * NQ * ND;
  // above 48 KB (p = 3 hexes: 64 KB in float32, 128 KB in float64) only
  // as opted-in dynamic shared memory
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        btdb_kernel<T, M, ND, NQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (ne == 0) return (int)cudaGetLastError();
  const long long blocks = (ne + THREADS - 1) / THREADS;
  btdb_kernel<T, M, ND, NQ><<<(unsigned)blocks, THREADS, smem, stream>>>(
      BG, u, D, y, ne);
  return (int)cudaGetLastError();
}

// The tiled design for hexes at order 4 (see the note at the top).  BG
// arrives padded with zero columns to NDP = 128 entries a row (ldb).
template <typename T, int M, int ND, int NQ>
struct Tiled {
  static constexpr int THREADS = 256;
  static constexpr int E = sizeof(T) == 4 ? 32 : 16;  // elements per block
  static constexpr int TE = 4;                 // elements per thread
  static constexpr int EG = E / TE;            // element groups
  static constexpr int RG = THREADS / EG;      // row groups
  static constexpr int NDP = 128;              // padded DOF count
  static constexpr int J = M * NQ;             // rows of BG (500)
  static constexpr int JP = 512;               // ... padded
  static constexpr int TQ = JP / RG;           // U rows per thread
  static constexpr int TA = NDP / RG;          // y DOFs per thread
  static constexpr int KC1 = sizeof(T) == 4 ? 16 : 8;  // k chunk, stage 1
  static constexpr int LD1 = JP + 4;           // its smem row (bank skew)
  static constexpr int KC2 = 32;               // j chunk, stage 2
  static constexpr int SB = KC1 * LD1 > KC2 * NDP ? KC1 * LD1 : KC2 * NDP;
  static constexpr size_t SMEM = sizeof(T) * ((size_t)NDP * E
                                              + (size_t)JP * E + SB);
  static_assert(ND <= NDP && J <= JP && TQ % 4 == 0 && NDP % KC1 == 0 &&
                JP % KC2 == 0 && TA >= 1 && NDP % RG == 0, "tiling");
};

// n consecutive entries of shared memory (16-byte aligned for n = 4)
template <typename T>
__device__ __forceinline__ void lds4(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

template <typename T, int M, int ND, int NQ>
__global__ void __launch_bounds__(Tiled<T, M, ND, NQ>::THREADS, 2)
btdb_tiled_kernel(const T* __restrict__ BG, const T* __restrict__ u,
                  const T* __restrict__ D, T* __restrict__ y,
                  long long ne) {
  using S = Tiled<T, M, ND, NQ>;
  constexpr int E = S::E, TE = S::TE, EG = S::EG, RG = S::RG;
  constexpr int NDP = S::NDP, J = S::J, JP = S::JP, TQ = S::TQ, TA = S::TA;
  constexpr int KC1 = S::KC1, LD1 = S::LD1, KC2 = S::KC2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // (NDP, E): u_e, zero padded
  T* sUV = su + NDP * E;                   // (JP, E): U, then V in place
  T* sB = sUV + JP * E;                    // a chunk of BG

  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * E;
  for (int t = tid; t < NDP * E; t += S::THREADS) {
    const int a = t / E, el = t - a * E;
    su[t] = (a < ND && e0 + el < ne) ? u[(long long)a * ne + e0 + el] : T(0);
  }

  const int eg = tid % EG;  // this thread's elements: eg*TE + c
  const int rg = tid / EG;

  // stage 1: U[j][e] = sum_k BG[j][k] u[k][e], rows j = 4*rg + 4*RG*i + c
  T acc[TQ][TE];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int c = 0; c < TE; ++c) acc[i][c] = T(0);
#pragma unroll 1
  for (int k0 = 0; k0 < NDP; k0 += KC1) {
    __syncthreads();  // su is written; the previous chunk is consumed
    // sB[kk][j] = BG[j][k0 + kk], read along k (coalesced), stored transposed
    for (int t = tid; t < KC1 * JP; t += S::THREADS) {
      const int j = t / KC1, kk = t - j * KC1;
      sB[kk * LD1 + j] = j < J ? BG[j * NDP + k0 + kk] : T(0);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KC1; ++kk) {
      T ue[4];
      lds4(su + (k0 + kk) * E + eg * TE, ue);
#pragma unroll
      for (int i = 0; i < TQ / 4; ++i) {
        T b[4];
        lds4(sB + kk * LD1 + 4 * rg + 4 * RG * i, b);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < TE; ++c) acc[4 * i + r][c] += b[r] * ue[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TQ / 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TE; ++c)
        sUV[(4 * rg + 4 * RG * i + r) * E + eg * TE + c] = acc[4 * i + r][c];
  __syncthreads();

  // the D stage, in place: V_r(q) = sum_s D[r*M+s](q) U_s(q)
  for (int t = tid; t < NQ * E; t += S::THREADS) {
    const int q = t / E, el = t - q * E;
    const long long e = e0 + el;
    T Us[M], Vr[M];
#pragma unroll
    for (int s = 0; s < M; ++s) Us[s] = sUV[(s * NQ + q) * E + el];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      T v = T(0);
      if (e < ne) {
#pragma unroll
        for (int s = 0; s < M; ++s)
          v += D[((long long)(r * M + s) * NQ + q) * ne + e] * Us[s];
      }
      Vr[r] = v;
    }
#pragma unroll
    for (int r = 0; r < M; ++r) sUV[(r * NQ + q) * E + el] = Vr[r];
  }

  // stage 2: y[a][e] = sum_j BG[j][a] V[j][e] at a = TA*rg + i
  T out[TA][TE];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int c = 0; c < TE; ++c) out[i][c] = T(0);
#pragma unroll 1
  for (int j0 = 0; j0 < JP; j0 += KC2) {
    __syncthreads();  // V is written; the previous chunk is consumed
    for (int t = tid; t < KC2 * NDP; t += S::THREADS) {
      const int jj = t / NDP, a = t - jj * NDP;
      sB[t] = j0 + jj < J ? BG[(j0 + jj) * NDP + a] : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < KC2; ++jj) {
      T v[4];
      lds4(sUV + (j0 + jj) * E + eg * TE, v);
#pragma unroll
      for (int i = 0; i < TA; ++i) {
        const T b = sB[jj * NDP + TA * rg + i];
#pragma unroll
        for (int c = 0; c < TE; ++c) out[i][c] += b * v[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const int a = TA * rg + i;
#pragma unroll
    for (int c = 0; c < TE; ++c) {
      const long long e = e0 + eg * TE + c;
      if (a < ND && e < ne) y[(long long)a * ne + e] = out[i][c];
    }
  }
}

template <typename T, int M, int ND, int NQ>
int launch_tiled(const T* BG, int ldb, const T* u, const T* D, T* y,
                 long long ne, cudaStream_t stream) {
  using S = Tiled<T, M, ND, NQ>;
  if (ldb != S::NDP) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      btdb_tiled_kernel<T, M, ND, NQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (ne == 0) return (int)cudaGetLastError();
  const long long blocks = (ne + S::E - 1) / S::E;
  btdb_tiled_kernel<T, M, ND, NQ><<<(unsigned)blocks, S::THREADS, S::SMEM,
                                    stream>>>(BG, u, D, y, ne);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* BG, int ldb, const void* u, const void* D, void* y,
             int m, int nd, int nq, long long ne, void* stream) {
  const T* b = static_cast<const T*>(BG);
  const T* u_ = static_cast<const T*>(u);
  const T* d = static_cast<const T*>(D);
  T* y_ = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // hexes (M = 4) and quads (M = 3) at orders 1-4 with q1 = p + 1; hexes
  // at order 4 take the tiled design, with BG's rows padded to ldb
  if (m == 4 && nd == 125 && nq == 125) return launch_tiled<T, 4, 125, 125>(b, ldb, u_, d, y_, ne, s);
  if (ldb != nd) return (int)cudaErrorInvalidValue;
  if (m == 4 && nd == 8 && nq == 8) return launch<T, 4, 8, 8>(b, u_, d, y_, ne, s);
  if (m == 4 && nd == 27 && nq == 27) return launch<T, 4, 27, 27>(b, u_, d, y_, ne, s);
  if (m == 4 && nd == 64 && nq == 64) return launch<T, 4, 64, 64>(b, u_, d, y_, ne, s);
  if (m == 3 && nd == 4 && nq == 4) return launch<T, 3, 4, 4>(b, u_, d, y_, ne, s);
  if (m == 3 && nd == 9 && nq == 9) return launch<T, 3, 9, 9>(b, u_, d, y_, ne, s);
  if (m == 3 && nd == 16 && nq == 16) return launch<T, 3, 16, 16>(b, u_, d, y_, ne, s);
  if (m == 3 && nd == 25 && nq == 25) return launch<T, 3, 25, 25>(b, u_, d, y_, ne, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y_eT = BG^T (D (BG u_eT)) per element.  BG: (m*nq, ldb) with its first
// nd columns used (ldb = nd, except 128 for hexes at order 4, whose extra
// columns are zero), u_eT: (nd, ne), Dflat: (m*m, nq, ne), y_eT: (nd, ne),
// all contiguous on the device.  Returns cudaGetLastError() after the
// launch.
extern "C" int cmfem_btdb_apply_f32(const void* BG, int ldb, const void* u,
                                    const void* D, void* y, int m, int nd,
                                    int nq, long long ne, void* stream) {
  return dispatch<float>(BG, ldb, u, D, y, m, nd, nq, ne, stream);
}

extern "C" int cmfem_btdb_apply_f64(const void* BG, int ldb, const void* u,
                                    const void* D, void* y, int m, int nd,
                                    int nq, long long ne, void* stream) {
  return dispatch<double>(BG, ldb, u, D, y, m, nd, nq, ne, stream);
}

extern "C" const char* cmfem_btdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
