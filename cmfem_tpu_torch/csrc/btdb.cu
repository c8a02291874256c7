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
// M = 1 + dim: 4 for hexes, 3 for quads.  Both products stay dense products
// with BG, in true float32 (FFMA) or float64: no tensor cores, no sum
// factorization, all M*M planes of D read, zeros included.
//
// Two designs, between them every (M, ND, NQ) that the JAX package's
// spaces produce at orders 1-4 (kernels/btdb.py::KERNEL_SHAPES: triangles,
// quads, tets and hexes under the quadrature orders its forms and drivers
// use, 2p to 2p + 3 and 4; its spaces have no segments).  ND and M are
// template parameters, NQ a runtime loop bound: a rule with more points
// costs no instantiation of its own and no build time.
//
// (1) btdb_kernel: every shape but hexes at orders 2-4 (ND <= 35), one
// thread per element.  The element is the minor axis of u_eT, Dflat and
// y_eT, so a warp's loads and stores of them are coalesced.  Each thread
// keeps u_e (ND values) and its y_e accumulator in registers and streams
// over the quadrature points; BG is staged in shared memory in chunks of
// quadrature points (all of them where M*NQ*ND entries fit in 48 KB, as for
// the quads and hexes at q1 = p + 1; a tet at order 4 under 216 points
// takes 6 chunks in float64) and every thread of a warp reads the same
// entry (a broadcast).  The D read bounds these small shapes; one shared
// load per FMA comes next.
//
// (2) btdb_tiled_kernel: hexes at orders 2-4 (ND = 27, 64, 125; NQ = ND at
// q1 = p + 1, the shapes timed below, and the other rules' 27 to 216).  From
// order 3 on one element's 2 ND values no longer fit a thread's registers.
// What bounds it at 48^3 (ne = 110,592) in float32, at the H100's 3.35 TB/s
// and 67 TFLOP/s: at order 2 the bytes, 0.064 ms (215 MB; 1.4 GFLOP, 6.4
// FLOP/B); at order 3 the bytes, 0.152 ms (Dflat 453 MB + u, y 57 MB), with
// the operations close behind, 0.112 ms (7.5 GFLOP; 14.7 FLOP/B against the
// card's 20); at order 4 the operations, 0.419 ms (28.1 GFLOP) against
// 0.297 ms for the bytes.  So the FMA units have to stay busy while D
// streams, and a shared-memory load must feed many FMAs.  The design:
//   - A block owns E consecutive elements: 64 in float32 (32 at order 4)
//     and 32 in float64, so that a block has at most 128 threads and 4 (in
//     float64 2) blocks are resident per SM.  Both products are
//     register-tiled dense products over them: a thread holds 8 rows x 4
//     elements of the output, so per step of the reduction it loads 8 BG
//     entries and 4 element values by 16-byte shared loads and does 32
//     FMAs.  Thread (eg, g): elements 4 eg .. 4 eg + 3, rows 8 g .. 8 g + 7;
//     a warp is 8 eg x 4 g, so each operand load of a warp touches at most
//     128 contiguous bytes, the rest by broadcast.
//   - The quadrature points go in slabs of QC = NDP/4 (NDP = ND padded to a
//     multiple of 32: 32, 64, 128).  A slab's rows are ordered (q, s), s
//     minor, M*QC = NDP of them.  For a slab: product 1 gives U (NDP rows x
//     E) in registers, a thread holding U_s(q, e) for all four s of its two
//     q.  The D stage then needs no exchange: the thread reads its 16
//     planes of D at (q, e) straight from device memory (16-byte loads
//     along e, read once and evicted first, the 8 loads of two rows r in
//     flight together), forms V_r(q, e) and writes it to shared memory.
//     Product 2 adds BG_slab^T V into the y tile (NDP x E), which stays in
//     registers over all slabs.  V never takes a pass of its own, and U
//     never leaves the registers.
//   - BG reaches the block as a stream of tiles of 16 x NDP entries that
//     the host laid out once in the order and layout of use (for a slab:
//     NDP/16 tiles of BG^T, reduction index major, for product 1; then
//     NDP/16 tiles of BG rows for product 2; zero where q >= NQ or a DOF
//     >= ND).  cp.async copies them through a ring of 2-4 tiles, one
//     barrier per tile, the loads running under the FMAs; no transposition
//     in the kernel.  The stream (32, 128, 512 KB at orders 2-4) comes from
//     L2, once per block.
//   - When a slab's product 1 starts, the block prefetches that slab's D
//     lines into L2 (prefetch.global.L2), so the D stage waits on L2 and not
//     on device memory (not at order 2, where product 1 is too short for
//     that); the other resident blocks of the SM cover a block's D stage and
//     barriers.
//   - Two instantiations: "wide" when ne is a multiple of 4 and u, D, y are
//     16-byte aligned (16-byte accesses; a thread's 4 elements exist or not
//     as one), else element by element, each masked.  The ragged last block
//     masks its loads and stores either way.
// The tile geometry (E, NDP, threads, ring stages, tiles in the stream)
// comes from kernels/btdb.py::tile_geometry; the entry refuses a launch
// whose geometry differs from the one compiled in.  No atomics: two calls
// agree bitwise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK_BYTES = 48 * 1024;  // BG's chunk: no opt-in needed

template <typename T, int M, int ND>
__global__ void __launch_bounds__(THREADS)
btdb_kernel(const T* __restrict__ BG, const T* __restrict__ u,
            const T* __restrict__ D, T* __restrict__ y, long long ne, int nq,
            int qc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (M, qc, ND): row s*qc + j holds BG row s*nq + q0 + j of the chunk
  T* sBG = reinterpret_cast<T*>(smem_raw);
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = e < ne;  // every thread stays for the barriers

  T ue[ND];
  T ye[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    ue[a] = live ? u[(long long)a * ne + e] : T(0);
    ye[a] = T(0);
  }

#pragma unroll 1
  for (int q0 = 0; q0 < nq; q0 += qc) {
    const int nc = min(qc, nq - q0);
    __syncthreads();  // the last chunk's readers are done
    for (int t = threadIdx.x; t < M * nc * ND; t += THREADS) {
      const int s = t / (nc * ND), r = t - s * nc * ND;
      sBG[s * qc * ND + r] = BG[(long long)(s * nq + q0) * ND + r];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 1
    for (int j = 0; j < nc; ++j) {
      const int q = q0 + j;
      T U[M];
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const T* row = sBG + (s * qc + j) * ND;
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
          v += D[((long long)(r * M + s) * nq + q) * ne + e] * U[s];
        const T* row = sBG + (r * qc + j) * ND;
#pragma unroll
        for (int a = 0; a < ND; ++a) ye[a] += row[a] * v;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int a = 0; a < ND; ++a) y[(long long)a * ne + e] = ye[a];
}

template <typename T, int M, int ND>
int launch(const T* BG, const T* u, const T* D, T* y, long long ne, int nq,
           cudaStream_t stream) {
  const int per_q = (int)sizeof(T) * M * ND;  // bytes of one point's rows
  const int qc = min(nq, CHUNK_BYTES / per_q);
  if (nq < 1 || qc < 1) return (int)cudaErrorInvalidValue;
  if (ne == 0) return (int)cudaGetLastError();
  const long long blocks = (ne + THREADS - 1) / THREADS;
  btdb_kernel<T, M, ND><<<(unsigned)blocks, THREADS, (size_t)qc * per_q,
                          stream>>>(BG, u, D, y, ne, nq, qc);
  return (int)cudaGetLastError();
}

// The tiled design for hexes at orders 2-4 (see the note at the top).
constexpr int SMEM_MAX = 232448;  // bytes a block may use (227 KB)

template <typename T, int ND_>
struct Tile {
  static constexpr int M = 4;                  // hexes
  static constexpr int ND = ND_;
  static constexpr int NDP = (ND + 31) / 32 * 32;  // padded DOF count
  static constexpr int TE = 4, TA = 8, TQ = 2; // a thread's tile
  static constexpr int KC = 16;                // rows of a stream tile
  static constexpr int AG = NDP / TA;          // row groups
  // the choices measured on the H100: blocks of at most 64 (float64: 32)
  // elements and 128 threads, a ring of at most 4 tiles that leaves 4
  // (float64: 2) resident blocks per SM their shared memory
  static constexpr int E_MAX = sizeof(T) == 4 ? 64 : 32;
  static constexpr int THREADS_MAX = 128, STAGES_MAX = 4;
  static constexpr int BLOCKS = sizeof(T) == 4 ? 4 : 2;
  static constexpr int pick_e() {              // elements per block
    int e = E_MAX;
    while (e > 32 && e / TE * AG > THREADS_MAX) e /= 2;
    return e;
  }
  static constexpr int E = pick_e();
  static constexpr int EG = E / TE;            // element groups
  static constexpr int THREADS = EG * AG;
  static constexpr int QC = TQ * AG;           // quadrature points a slab
  static constexpr int HALF = NDP / KC;        // tiles of one product
  // slabs and tiles in the stream of a rule with nq points
  __host__ __device__ static constexpr int nslab(int nq) {
    return (nq + QC - 1) / QC;
  }
  __host__ __device__ static constexpr int tiles(int nq) {
    return nslab(nq) * 2 * HALF;
  }
  static constexpr int TILE = KC * NDP;        // entries of a tile
  static constexpr int pick_stages() {         // tiles in the ring
    const int room = SMEM_MAX / BLOCKS - 1024
        - 2 * NDP * E * (int)sizeof(T);
    const int fit = room / (TILE * (int)sizeof(T));
    return fit > STAGES_MAX ? STAGES_MAX : fit;
  }
  static constexpr int NS = pick_stages();
  // a slab's D lines are prefetched into L2 only where product 1 runs at
  // least 4 tiles meanwhile
  static constexpr bool PREFETCH = HALF >= 4;
  static constexpr int VEC = 16 / sizeof(T);   // entries in 16 bytes
  static constexpr int CPT = TILE / VEC / THREADS;  // copies a thread
  static constexpr size_t SMEM = sizeof(T) * (2 * (size_t)NDP * E
                                              + (size_t)NS * TILE);
  // resident blocks per SM that shared memory (227 KB, 1 KB a block
  // reserved) and 64 K registers allow, for __launch_bounds__
  static constexpr int BY_SMEM = (int)(SMEM_MAX / (SMEM + 1024));
  static constexpr int BY_REGS = 65536 / (THREADS * 128);
  static constexpr int MINB = sizeof(T) == 8 ? 1
      : (BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS);
  static_assert(M * QC == NDP && EG % 8 == 0 && AG % 4 == 0 && NS >= 2 &&
                TILE % (VEC * THREADS) == 0 && THREADS <= 1024 &&
                THREADS % 32 == 0 && MINB >= 1, "tiling");
};

// N consecutive entries from 16-byte aligned shared or global memory
template <int N, typename T>
__device__ __forceinline__ void ld16(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 t = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = t.x; v[2 * i + 1] = t.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

// 4 consecutive entries from 16-byte aligned device memory that is read
// once: streamed, evict first
template <typename T>
__device__ __forceinline__ void ldcs16(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int TA, int TE>
__device__ __forceinline__ void fma_tile(T (&acc)[TA][TE], const T (&b)[TA],
                                         const T (&v)[TE]) {
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int c = 0; c < TE; ++c) acc[i][c] += b[i] * v[c];
}

// WIDE: ne is a multiple of 4 and u, D, y are 16-byte aligned, so a thread's
// 4 elements are there or not as one, and go by 16-byte accesses; otherwise
// element by element, each masked.
template <typename T, class S, bool WIDE>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
btdb_tiled_kernel(const T* __restrict__ bgs, const T* __restrict__ u,
                  const T* __restrict__ D, T* __restrict__ y, long long ne,
                  int nq) {
  constexpr int M = S::M, ND = S::ND, E = S::E, NS = S::NS;
  constexpr int NDP = S::NDP, TE = S::TE, TA = S::TA, TQ = S::TQ;
  constexpr int KC = S::KC, EG = S::EG, QC = S::QC, HALF = S::HALF;
  constexpr int TILE = S::TILE, VEC = S::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // (NDP, E): u_e, zero padded
  T* sV = su + NDP * E;                    // (NDP, E): V of one slab
  T* ring = sV + NDP * E;                  // NS tiles of the BG stream

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int eg = (warp % (EG / 8)) * 8 + (lane & 7);  // elements 4 eg + c
  const int g = (warp / (EG / 8)) * 4 + (lane >> 3);  // rows 8 g + i
  const long long e0 = (long long)blockIdx.x * E;
  const int NQ = nq, NT = S::tiles(nq), NSLAB = S::nslab(nq);
  // elements from this thread's first on, as far as it matters
  const int left = (int)max(0LL, min((long long)TE, ne - (e0 + TE * eg)));

  // tile t of the stream into slot t % NS; always one group, also when the
  // stream has ended, so that wait_group counts the same everywhere
  auto fetch = [&](int t, int slot) {
    if (t < NT) {
      const T* src = bgs + (size_t)t * TILE;
      T* dst = ring + slot * TILE;
#pragma unroll
      for (int i = 0; i < S::CPT; ++i) {
        const int o = (tid + i * S::THREADS) * VEC;
        cp_async16(dst + o, src + o);
      }
    }
    cp_async_commit();
  };
  // the D lines of a slab into L2: 16 planes x QC points x E elements
  auto prefetch_d = [&](int slab) {
    if constexpr (S::PREFETCH) {
      constexpr int LINE = 128 / sizeof(T);  // entries of a 128-byte line
      constexpr int SEG = (E + LINE - 1) / LINE;
      for (int i = tid; i < M * M * QC * SEG; i += S::THREADS) {
        const int row = i / SEG, seg = i - row * SEG;
        const int plane = row / QC, q = slab * QC + row - plane * QC;
        const long long e = e0 + seg * LINE;
        if (q < NQ && e < ne) {
          const T* p = D + ((long long)plane * NQ + q) * ne + e;
          asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) fetch(t, t);
  for (int i = tid; i < NDP * EG; i += S::THREADS) {
    const int a = i / EG, c4 = i - a * EG;
    const long long e = e0 + TE * c4;
    T v[4] = {T(0), T(0), T(0), T(0)};
    const T* p = u + (long long)a * ne + e;
    if (WIDE) {
      if (a < ND && e < ne) ld16(p, v);
    } else if (a < ND) {
#pragma unroll
      for (int c = 0; c < TE; ++c)
        if (c < ne - e) v[c] = p[c];
    }
    st16(su + a * E + TE * c4, v);
  }

  T out[TA][TE];  // y at DOFs 8 g + i, elements 4 eg + c, over all slabs
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int c = 0; c < TE; ++c) out[i][c] = T(0);

  int t = 0, slot = 0;  // the tile in use and its slot, t % NS
  // wait for tile t, free the slot of tile t - 1 and refill it
  auto next_tile = [&]() -> const T* {
    cp_async_wait<NS - 2>();
    __syncthreads();
    fetch(t + NS - 1, slot == 0 ? NS - 1 : slot - 1);
    const T* sB = ring + slot * TILE;
    ++t;
    slot = slot + 1 == NS ? 0 : slot + 1;
    return sB;
  };

#pragma unroll 1
  for (int slab = 0; slab < NSLAB; ++slab) {
    // product 1: U[8 g + i][e] = sum_k BG[row(8 g + i)][k] u[k][e], row
    // 8 g + i of the slab being (q, s) = (slab QC + 2 g + i / 4, i % 4)
    T acc[TA][TE];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int c = 0; c < TE; ++c) acc[i][c] = T(0);
    prefetch_d(slab);
#pragma unroll 1
    for (int kt = 0; kt < HALF; ++kt) {
      const T* sB = next_tile();  // sB[kk][row] = BG[row][kt KC + kk]
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        T b[TA], v[TE];
        ld16(su + (kt * KC + kk) * E + TE * eg, v);
        ld16(sB + kk * NDP + TA * g, b);
        fma_tile(acc, b, v);
      }
    }
    // the D stage in registers: V_r(q, e) = sum_s D[r M + s](q, e) U_s(q, e),
    // two rows r at a time, their 8 planes' loads in flight together
#pragma unroll
    for (int i2 = 0; i2 < TQ; ++i2) {
      const int qq = TQ * g + i2, q = slab * QC + qq;
      const T* dq = D + (long long)q * ne + e0 + TE * eg;  // in plane 0
      T* sv = sV + M * qq * E + TE * eg;                   // row r = 0
#pragma unroll
      for (int r0 = 0; r0 < M; r0 += 2) {
        T V[2][TE];
#pragma unroll
        for (int c = 0; c < TE; ++c) V[0][c] = V[1][c] = T(0);
        if (q < NQ && left > 0) {
          T d[2 * M][TE];
#pragma unroll
          for (int k = 0; k < 2 * M; ++k) {
            if (WIDE) {
              ldcs16(dq, d[k]);
            } else {
#pragma unroll
              for (int c = 0; c < TE; ++c)
                d[k][c] = c < left ? __ldcs(dq + c) : T(0);
            }
            dq += (long long)NQ * ne;  // the next plane
          }
#pragma unroll
          for (int k = 0; k < 2 * M; ++k)
#pragma unroll
            for (int c = 0; c < TE; ++c)
              V[k / M][c] += d[k][c] * acc[M * i2 + k % M][c];
        }
        st16(sv + r0 * E, V[0]);
        st16(sv + (r0 + 1) * E, V[1]);
      }
    }
    // product 2: y[8 g + i][e] += sum_j BG[row(j)][8 g + i] V[j][e]; the
    // first barrier of next_tile publishes V, and the barriers of the next
    // slab's product 1 stand between these reads and its writes of V
#pragma unroll 1
    for (int jt = 0; jt < HALF; ++jt) {
      const T* sB = next_tile();  // sB[jj][a] = BG[row(jt KC + jj)][a]
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        T b[TA], v[TE];
        ld16(sV + (jt * KC + jj) * E + TE * eg, v);
        ld16(sB + jj * NDP + TA * g, b);
        fma_tile(out, b, v);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const int a = TA * g + i;
    if (a < ND && left > 0) {
      T* p = y + (long long)a * ne + e0 + TE * eg;
      if (WIDE) {
        st16(p, out[i]);
      } else {
#pragma unroll
        for (int c = 0; c < TE; ++c)
          if (c < left) p[c] = out[i][c];
      }
    }
  }
}

// the geometry the wrapper computed (kernels/btdb.py::tile_geometry)
struct Geometry {
  int e, ndp, threads, stages, tiles;
};

// dynamic shared memory above 48 KB, and the SM's L1/shared split set for
// it: once per instantiation and device, not per launch
constexpr int MAX_DEVICES = 64;

template <typename T, class S, bool WIDE>
cudaError_t opt_in() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  auto kernel = btdb_tiled_kernel<T, S, WIDE>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename T, int ND>
int launch_tiled(const T* bgs, const T* u, const T* D, T* y, long long ne,
                 int nq, Geometry geo, cudaStream_t stream) {
  using S = Tile<T, ND>;
  if (nq < 1 || geo.e != S::E || geo.ndp != S::NDP ||
      geo.threads != S::THREADS || geo.stages != S::NS ||
      geo.tiles != S::tiles(nq))
    return (int)cudaErrorInvalidValue;
  const bool wide = ne % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(D) |
        reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  auto kernel = wide ? btdb_tiled_kernel<T, S, true>
                     : btdb_tiled_kernel<T, S, false>;
  const cudaError_t err = wide ? opt_in<T, S, true>() : opt_in<T, S, false>();
  if (err != cudaSuccess) return (int)err;
  if (ne == 0) return (int)cudaGetLastError();
  const long long blocks = (ne + S::E - 1) / S::E;
  kernel<<<(unsigned)blocks, S::THREADS, S::SMEM, stream>>>(bgs, u, D, y, ne,
                                                        nq);
  return (int)cudaGetLastError();
}

template <typename T, int ND>
int occupancy_tiled() {
  using S = Tile<T, ND>;
  auto kernel = btdb_tiled_kernel<T, S, true>;
  cudaError_t err = opt_in<T, S, true>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, S::THREADS, S::SMEM);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename T>
int dispatch(const void* BG, const void* u, const void* D, void* y, int m,
             int nd, int nq, long long ne, Geometry geo, void* stream) {
  const T* b = static_cast<const T*>(BG);
  const T* u_ = static_cast<const T*>(u);
  const T* d = static_cast<const T*>(D);
  T* y_ = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // hexes at orders 2-4 take the tiled design, with BG as its tile stream;
  // the rest one thread per element: triangles, quads (M = 3), tets and
  // hexes at order 1 (M = 4), at any nq
  if (m == 4 && nd == 27) return launch_tiled<T, 27>(b, u_, d, y_, ne, nq, geo, s);
  if (m == 4 && nd == 64) return launch_tiled<T, 64>(b, u_, d, y_, ne, nq, geo, s);
  if (m == 4 && nd == 125) return launch_tiled<T, 125>(b, u_, d, y_, ne, nq, geo, s);
  if (geo.e != 0) return (int)cudaErrorInvalidValue;
  switch (m * 1000 + nd) {
    case 3003: return launch<T, 3, 3>(b, u_, d, y_, ne, nq, s);    // tri p1
    case 3006: return launch<T, 3, 6>(b, u_, d, y_, ne, nq, s);    // tri p2
    case 3010: return launch<T, 3, 10>(b, u_, d, y_, ne, nq, s);   // tri p3
    case 3015: return launch<T, 3, 15>(b, u_, d, y_, ne, nq, s);   // tri p4
    case 3004: return launch<T, 3, 4>(b, u_, d, y_, ne, nq, s);    // quad p1
    case 3009: return launch<T, 3, 9>(b, u_, d, y_, ne, nq, s);    // quad p2
    case 3016: return launch<T, 3, 16>(b, u_, d, y_, ne, nq, s);   // quad p3
    case 3025: return launch<T, 3, 25>(b, u_, d, y_, ne, nq, s);   // quad p4
    case 4004: return launch<T, 4, 4>(b, u_, d, y_, ne, nq, s);    // tet p1
    case 4010: return launch<T, 4, 10>(b, u_, d, y_, ne, nq, s);   // tet p2
    case 4020: return launch<T, 4, 20>(b, u_, d, y_, ne, nq, s);   // tet p3
    case 4035: return launch<T, 4, 35>(b, u_, d, y_, ne, nq, s);   // tet p4
    case 4008: return launch<T, 4, 8>(b, u_, d, y_, ne, nq, s);    // hex p1
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y_eT = BG^T (D (BG u_eT)) per element.  u_eT: (nd, ne), Dflat:
// (m*m, nq, ne), y_eT: (nd, ne), all contiguous on the device.  BG: (m*nq,
// nd) for the one-thread-per-element design (e = 0 and the other geometry
// entries unused); for the tiled design (hexes at orders 2-4) BG's tile
// stream (tiles, 16, ndp) as kernels/btdb.py::pack_bg lays it out, with the
// geometry of tile_geometry, which must be the one compiled in.  Returns
// cudaGetLastError() after the launch.
extern "C" int cmfem_btdb_apply_f32(const void* BG, const void* u,
                                    const void* D, void* y, int m, int nd,
                                    int nq, long long ne, int e, int ndp,
                                    int threads, int stages, int tiles,
                                    void* stream) {
  return dispatch<float>(BG, u, D, y, m, nd, nq, ne,
                         Geometry{e, ndp, threads, stages, tiles}, stream);
}

extern "C" int cmfem_btdb_apply_f64(const void* BG, const void* u,
                                    const void* D, void* y, int m, int nd,
                                    int nq, long long ne, int e, int ndp,
                                    int threads, int stages, int tiles,
                                    void* stream) {
  return dispatch<double>(BG, u, D, y, m, nd, nq, ne,
                          Geometry{e, ndp, threads, stages, tiles}, stream);
}

// Resident blocks per SM of the tiled kernel for hexes with nd DOFs in
// float32 (itemsize 4) or float64 (8); 0 for another shape, minus the CUDA
// error on failure.
extern "C" int cmfem_btdb_tiled_blocks_per_sm(int nd, int itemsize) {
  if (nd == 27) return itemsize == 4 ? occupancy_tiled<float, 27>()
                                     : occupancy_tiled<double, 27>();
  if (nd == 64) return itemsize == 4 ? occupancy_tiled<float, 64>()
                                     : occupancy_tiled<double, 64>();
  if (nd == 125) return itemsize == 4 ? occupancy_tiled<float, 125>()
                                      : occupancy_tiled<double, 125>();
  return 0;
}

extern "C" const char* cmfem_btdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
