// Dense SPD solve A x = b for Hopper: Cholesky A = L L^T, then L y = b,
// then L^T x = y, all inside one thread block.
//
// Replaces: mcptam_tpu/core/spd.py::_spd_kernel_blocked (K4, the default)
// and ::_spd_kernel (K5, MCPTAM_SPD_KERNEL=simple), both reached through
// _spd_solve_pallas from ba/bundle.py::_solve_delta_soa once per LM step.
// Plain version: mcptam_tpu_torch/core/spd.py::spd_solve_reference.
//
// What bounds it on the H100: the serial dependence chain.  The reduced
// camera system is small (n = 6 x poses: 96 in the mapping slice, 288 at
// capacity), so the factor is ~n^3/6 = 4 MFLOP at most; what costs is the
// n sequential pivot steps and the block-wide barriers between them, on
// the one SM that holds the matrix.  One block per system keeps the whole
// chain on that SM with no grid-wide synchronisation.  The TPU kernels'
// 128-padding, lane masks and materialised U^T served their (8,128) tiles
// and have no purpose here.  Pivots are clamped at 1e-12 as in the TPU
// kernels.  No tensor cores: wgmma takes f32 only as TF32, which the port
// forbids and the Schur matrix's condition number (~1e7) would not
// survive.  No thread block cluster: it would add a cluster barrier a
// panel for a trailing update one SM finishes in microseconds.
//
// * blocked (K4): the packed lower triangle L (row i holds columns 0..i
//   contiguously), n(n+1)/2 floats, loaded from A's upper triangle
//   (L[i][k] = A[k][i]).  Panels of PB columns, two block barriers a
//   panel and none inside it, 512 threads:
//   1. warp 0 factors the PB x PB diagonal block in registers: lane r
//      holds row r, the pivot and the unscaled column entries a_kj are
//      broadcast by shuffles in the same step (neither waits on the
//      other), every lane takes rsqrt itself.  It writes the block to L,
//      its transpose to a dense aligned Dt (Dt[j][k] = L_kj) and the
//      pivots' 1/sqrt to dinv.
//   2. every thread takes a row i below the block and solves its PB
//      contiguous entries against it in registers (l_ij = a_ij dinv_j,
//      a_ik -= l_ij L_kj, k > j; Dt read as float4 broadcasts), then
//      writes them to L and to Pt, the panel transposed (Pt[c][i - pe]),
//      so that the trailing update reads it conflict-free and as float4.
//   3. the trailing lower triangle takes the rank-PB update in jobs of RT
//      rows x 32 columns, one job a warp at a time: lane l owns column
//      k = 32 BK + l and RT rows, holds RT sums in registers, and per
//      panel column loads its own Pt[c][k] and the rows' RT values as
//      float4 broadcasts; then L[i][k] -= sum, conflict-free along k.
//      Warp 0 takes the jobs of the next diagonal block and goes on to
//      factor it (step 1 of the next panel) while the others finish.
//   2n/PB barriers in the factor, none inside a panel.  PB = 16 and RT = 16, from
//   scripts/compare_parent_kernels.py --variants (PERF.md): PB = 8 is
//   about as fast at n = 96 and slower at 288, PB = 32 slower at both (and
//   it would cap n at 306), RT = 8 slower at both.  What a step of the
//   diagonal block or of a substitution costs on the card is the latency
//   of its shuffles, not the arithmetic.
//
// * blocked, global path (K4 beyond shared memory, n > 322 at m = 1: the
//   mapping LM's system is n = 6 x max_mkfs, so 54 MKFs and up): the same
//   schedule and arithmetic over 1024 threads, with the packed factor in
//   a global workspace the wrapper allocates (L2-resident up to n ~ 3000)
//   and the panel, the diagonal block, the pivot scales and the rhs in
//   shared memory.  The TPU kernel padded n to 128 and kept it all in
//   VMEM; one SM's shared memory holds 227 KB.  The factor's n^3/6 FMAs
//   run on one SM (at least 2.4 ms at n = 1536 at its FP32 rate) and its
//   trailing triangle crosses L2 once a panel: right first, spreading the
//   update over SMs is later work.
//
// * simple (K5): one pivot and one rank-1 update at a time, as the TPU
//   kernel does, with ONE block barrier per pivot, 1024 threads.  The
//   working matrix is the packed UPPER triangle U, row r holding columns
//   r..n-1 contiguously (A's upper rows as they are): row j of U is column
//   j of L, so the pivot column is contiguous.  In the step of pivot j
//   every thread reads row j (read-only in that step: the update writes
//   rows k > j only), takes d = a_jj and inv = rsqrt(max(d, 1e-12))
//   itself, and updates its share a_ik -= (a_ij inv)(a_kj inv), i >= k > j;
//   no thread waits on a pivot thread and no column is copied.  The rows
//   stay unscaled until the last step; one pass then scales each row by
//   its own inv (U_jj = d inv, U_ji = a_ij inv, the TPU kernel's row).
//   The share is 2-D cyclic: lane l takes rows i = l (mod 32), warp w
//   columns k = w (mod 32), so every pivot spreads its (n-j)^2/2 entries
//   evenly; a thread's entries form a fixed triangle of (row block, column
//   block) pairs, unrolled at compile time, a warp touches contiguous a_ik
//   (conflict-free), l_kj is a broadcast and l_ij sits in registers.
//   Up to n = 128 a thread's entries (at most 10) live in registers for
//   the whole factor, and the owners of column j+1 write it to U when
//   step j finishes it; above, they live in U, and each column block's
//   entries are loaded before the previous block's are stored.  What a
//   step costs on the card is the 32 warps' fixed per-pivot work, not the
//   barrier or the entries (~0.5 us a pivot, solves included, at n = 96:
//   PERF.md).
//
// Substitutions (both variants, solve_rhs): for m = 1 by 32-row blocks,
// warp 0 running the chain inside a block and every thread applying the
// block's solution to the other rows; m > 1 keeps a block form, two
// barriers a pivot.
// m > 1 keeps a block form with the rhs in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;  // the blocked variant
constexpr int THREADS_GLOBAL = 1024;  // its global path
constexpr int PB = 16;        // panel width of the blocked variant
constexpr int RT = 16;        // rows a lane takes in a trailing-update job
static_assert(PB % RT == 0 && PB <= 32, "the next diagonal block is whole jobs of one column block");
constexpr int K5_WARPS = 32;  // the simple variant: 1024 threads
constexpr int MAX_ROWS = 11;  // row blocks of a lane in K5: n <= 352
constexpr int REG_ROWS = 4;   // up to here (n <= 128) K5's entries live in registers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }

// offset of row r of the packed upper triangle, which holds columns r..n-1
__device__ __forceinline__ int urow(int r, int n) { return r * n - r * (r - 1) / 2; }

// leading dimension of K4's transposed panel Pt: the trailing rows of the
// first panel, rounded to float4, plus a job's overrun past the last row
// or column (<= 31)
__host__ __device__ __forceinline__ int k4_ld(int n) {
  return ((n > PB ? n - PB + 3 : 0) / 4) * 4 + 32;
}

// shared memory in floats: K4's Pt, Dt, dinv, factor and right-hand sides;
// K5's factor and right-hand sides
__host__ __device__ __forceinline__ size_t shared_floats(bool blocked, int n, int m) {
  return (blocked ? (size_t)PB * k4_ld(n) + PB * PB + PB : 0) + (size_t)n * (n + 1) / 2 +
         (size_t)n * m;
}

// K4's global path keeps in shared memory, ahead of the right-hand sides,
// Pt, Dt and dinv, or, while A is read, one 32 x 33 transpose tile a warp
__host__ __device__ __forceinline__ size_t global_front_floats(int n) {
  const size_t panel = (size_t)PB * k4_ld(n) + PB * PB + PB;
  const size_t tiles = (size_t)(THREADS_GLOBAL / 32) * 32 * 33;
  return panel > tiles ? panel : tiles;
}

// Both substitutions for one right-hand side x (n) in shared memory, where
// L_ij (i >= j) is F[lo(i, j)]: L y = b, then L^T x = y, by 32-row blocks.
// Warp 0 runs the chain inside a block: lane l holds row l of the block,
// divided by its pivot (z_i = x_i / max(L_ii, 1e-12)) and updated with the
// entries of the block, loaded a step ahead and multiplied by the row's
// reciprocal pivot; so z_j is x_j once its last update lands, and a step
// is one shuffle that broadcasts it and one FMA.  Then every thread
// applies the block's solution to one row after it (forward) or before it
// (back), a 32-term dot product, conflict-free in either layout (a row of
// the packed triangle is contiguous, and the offsets i(i+1)/2 of 32
// consecutive rows fall in 32 distinct banks).  Two block barriers a block
// and direction; the warp's chain holds the block's rows only.
template <class Lo>
__device__ __forceinline__ void solve_rhs(const float* F, Lo lo, float* x,
                                          float* __restrict__ X, int n, int T) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int nb = (n + 31) / 32;
  for (int a = 0; a < nb; ++a) {                    // forward
    const int j0 = 32 * a, jn = min(32, n - j0), i = j0 + lane;
    if (tid < 32) {
      const bool in = lane < jn;
      const float rd = in ? 1.0f / fmaxf(F[lo(i, i)], 1e-12f) : 1.0f;
      float z = in ? x[i] * rd : 0.0f;
      float u = (in && lane > 0) ? F[lo(i, j0)] * rd : 0.0f;
#pragma unroll 4
      for (int jj = 0; jj < jn; ++jj) {
        const float un = (in && lane > jj + 1) ? F[lo(i, j0 + jj + 1)] * rd : 0.0f;
        z = fmaf(-u, __shfl_sync(FULL, z, jj), z);
        u = un;
      }
      if (in) x[i] = z;
    }
    __syncthreads();
    for (int r = j0 + 32 + tid; r < n; r += T) {
      float dot = 0.0f;
      for (int jj = 0; jj < jn; ++jj) dot = fmaf(F[lo(r, j0 + jj)], x[j0 + jj], dot);
      x[r] -= dot;
    }
    __syncthreads();
  }
  for (int a = nb - 1; a >= 0; --a) {               // back
    const int j0 = 32 * a, jn = min(32, n - j0), i = j0 + lane;
    if (tid < 32) {
      const bool in = lane < jn;
      const float rd = in ? 1.0f / fmaxf(F[lo(i, i)], 1e-12f) : 1.0f;
      float z = in ? x[i] * rd : 0.0f;
      float u = (in && lane < jn - 1) ? F[lo(j0 + jn - 1, i)] * rd : 0.0f;
#pragma unroll 4
      for (int jj = jn - 1; jj >= 0; --jj) {
        const float un = (jj > 0 && lane < jj - 1) ? F[lo(j0 + jj - 1, i)] * rd : 0.0f;
        z = fmaf(-u, __shfl_sync(FULL, z, jj), z);
        u = un;
      }
      if (in) x[i] = z;
    }
    __syncthreads();
    for (int r = tid; r < j0; r += T) {
      float dot = 0.0f;
      for (int jj = 0; jj < jn; ++jj) dot = fmaf(F[lo(j0 + jj, r)], x[j0 + jj], dot);
      x[r] -= dot;
    }
    __syncthreads();
  }
  for (int e = tid; e < n; e += T) X[e] = x[e];
}

// The same substitutions for m > 1 right-hand sides x (n, m) in shared
// memory, by the whole block of T threads, two barriers a pivot.
template <class Lo>
__device__ void solve_block(const float* F, Lo lo, float* x, float* __restrict__ X,
                            int n, int m, int T) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const float d = fmaxf(F[lo(j, j)], 1e-12f);
    for (int c = tid; c < m; c += T) x[j * m + c] /= d;
    __syncthreads();
    for (int e = tid; e < (n - j - 1) * m; e += T) {
      const int i = j + 1 + e / m, c = e % m;
      x[i * m + c] -= F[lo(i, j)] * x[j * m + c];
    }
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {
    const float d = fmaxf(F[lo(j, j)], 1e-12f);
    for (int c = tid; c < m; c += T) x[j * m + c] /= d;
    __syncthreads();
    for (int e = tid; e < j * m; e += T) {
      const int i = e / m, c = e % m;
      x[i * m + c] -= F[lo(j, i)] * x[j * m + c];
    }
    __syncthreads();
  }
  for (int e = tid; e < n * m; e += T) X[e] = x[e];
}

// K4's diagonal block at p0, in warp 0; lane r holds row p0 + r: its
// entries left of the diagonal in a[], unscaled until their step, and its
// diagonal entry in dg.  A step j shuffles the pivot and the unscaled a_kj
// at once (neither waits on the other), every lane takes inv = rsqrt(d)
// itself and scales its own L_rj = a_rj inv; so the chain from pivot to
// pivot holds one shuffle, not two.  Writes the block to L, its transpose
// to Dt (Dt[j][k] = L_kj) and the pivots' 1/sqrt to dinv.
__device__ __forceinline__ void k4_diagonal(float* L, float* Dt, float* dinv, int p0, int n) {
  const int r = threadIdx.x & 31;
  const int w = min(PB, n - p0);     // < PB only for the last panel
  float* row = L + tri(p0 + min(r, w - 1), p0);
  float a[PB];
#pragma unroll
  for (int c = 0; c < PB; ++c) a[c] = (r < w && c < r) ? row[c] : 0.0f;
  float dg = r < w ? row[r] : 1.0f, lrr = 0.0f;
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    if (j < w) {
      const float d = __shfl_sync(FULL, dg, j);
      float raw[PB];                                // raw[k] = a_kj, unscaled
#pragma unroll
      for (int k = j + 1; k < PB; ++k) raw[k] = __shfl_sync(FULL, a[j], k);
      const float inv = rsqrtf(fmaxf(d, 1e-12f));
      const float li = a[j] * inv;                  // L_rj for r > j
      if (r == j) lrr = d * inv;
      if (r > j) {
        a[j] = li;
        dg = fmaf(-li, li, dg);
      }
#pragma unroll
      for (int k = j + 1; k < PB; ++k)
        if (r > k) a[k] = fmaf(-li, raw[k] * inv, a[k]);
      if (r == 0) dinv[j] = inv;
    }
  }
  if (r < w) {
#pragma unroll
    for (int c = 0; c < PB; ++c)
      if (c < r) row[c] = a[c];
    row[r] = lrr;
  }
  if (r < PB) {
#pragma unroll
    for (int c = 0; c < PB; ++c) Dt[c * PB + r] = c < r ? a[c] : 0.0f;
  }
}

// K4's factor, in place on L.  Ends after a block barrier.  Its shared
// memory (all dynamic: the opt-in cap counts static bytes too): the panel
// transposed Pt (PB x ld), the diagonal block transposed Dt (PB x PB), its
// pivots' 1/sqrt dinv (PB), the packed lower factor L (n(n+1)/2) and the
// right-hand sides (n, m).
//
// A panel p0..pe-1 (every panel but the last is full) takes two block
// barriers: the rows below its diagonal block are solved against it, then
// the trailing triangle takes the panel's rank-PB update while warp 0
// updates and factors the next diagonal block (look-ahead): that block's
// update is exactly the first PB / RT jobs, which no other warp takes.
//
// T threads; GL: L is the global workspace Lg (the global path), else it
// follows dinv in shared memory.
template <int T, bool GL>
__device__ __forceinline__ void k4_factor(float* Lg, int n) {
  extern __shared__ float4 k4_smem[];
  float* Pt = reinterpret_cast<float*>(k4_smem);
  float* Dt = Pt + PB * k4_ld(n);
  float* dinv = Dt + PB * PB;
  float* L = GL ? Lg : dinv + PB;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NW = T / 32;
  const int ld = k4_ld(n);
  if (warp == 0) k4_diagonal(L, Dt, dinv, 0, n);
  __syncthreads();
  for (int p0 = 0; p0 + PB < n; p0 += PB) {
    const int pe = p0 + PB;

    // the panel's rows below the block, a row a thread
    for (int i = pe + tid; i < n; i += T) {
      float* row = L + tri(i, p0);
      float a[PB];
#pragma unroll
      for (int c = 0; c < PB; ++c) a[c] = row[c];
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        a[j] *= dinv[j];
        const float4* dj = reinterpret_cast<const float4*>(Dt + j * PB);
#pragma unroll
        for (int q = (j + 1) / 4; q < PB / 4; ++q) {
          const float4 v = dj[q];
          const float vq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e > j) a[4 * q + e] = fmaf(-a[j], vq[e], a[4 * q + e]);
        }
      }
#pragma unroll
      for (int c = 0; c < PB; ++c) {
        row[c] = a[c];
        Pt[c * ld + (i - pe)] = a[c];
      }
    }
    __syncthreads();

    // rank-PB update of the trailing triangle, rows and columns >= pe, in
    // jobs (column block bk of 32, row chunk q of RT) with q RT >= 32 bk,
    // numbered block by block: warp 0 takes jobs 0..j0-1 (the next
    // diagonal block's rows), the other warps the rest in turn
    const int nt = n - pe;
    const int nq = (nt + RT - 1) / RT, nbk = (nt + 31) / 32;
    const int j0 = min(PB / RT, nq);
    int bk = 0, first = 0;           // first job of column block bk
    for (int job = warp == 0 ? 0 : j0 + warp - 1;; job += warp == 0 ? 1 : NW - 1) {
      if (warp == 0 && job == j0) break;
      while (bk < nbk && job >= first + nq - 32 * bk / RT) {
        first += nq - 32 * bk / RT;
        ++bk;
      }
      if (bk >= nbk) break;
      const int kr = 32 * bk + lane;
      const int ir0 = RT * (32 * bk / RT + job - first);
      float acc[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) acc[t] = 0.0f;
      const float* pk = Pt + kr;
      const float* pi = Pt + ir0;
#pragma unroll
      for (int c = 0; c < PB; ++c, pk += ld, pi += ld) {
        const float b = *pk;
        const float4* pa = reinterpret_cast<const float4*>(pi);
#pragma unroll
        for (int t = 0; t < RT / 4; ++t) {
          const float4 v = pa[t];
          acc[4 * t + 0] = fmaf(v.x, b, acc[4 * t + 0]);
          acc[4 * t + 1] = fmaf(v.y, b, acc[4 * t + 1]);
          acc[4 * t + 2] = fmaf(v.z, b, acc[4 * t + 2]);
          acc[4 * t + 3] = fmaf(v.w, b, acc[4 * t + 3]);
        }
      }
      int e = tri(pe + ir0, pe + kr);              // L[i][k], i = pe + ir0 + t
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int ir = ir0 + t;
        if (ir < nt && kr <= ir) L[e] -= acc[t];
        e += pe + ir + 1;
      }
    }
    if (warp == 0) {
      __syncwarp();                  // the block's entries as every lane wrote them
      k4_diagonal(L, Dt, dinv, pe, n);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
spd_blocked_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ X, int n, int m) {
  extern __shared__ float4 k4_smem[];
  float* L = reinterpret_cast<float*>(k4_smem) + PB * k4_ld(n) + PB * PB + PB;
  float* x = L + n * (n + 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // row r of A's upper triangle (coalesced) -> column r of L
  for (int r = warp; r < n; r += THREADS / 32)
    for (int c = r + lane; c < n; c += 32) L[tri(c, r)] = A[(size_t)r * n + c];
  for (int e = tid; e < n * m; e += THREADS) x[e] = B[e];
  __syncthreads();

  k4_factor<THREADS, false>(nullptr, n);

  const auto lo = [](int i, int j) { return tri(i, j); };
  if (m == 1)
    solve_rhs(L, lo, x, X, n, THREADS);
  else
    solve_block(L, lo, x, X, n, m, THREADS);
}

// K4's global path, for systems whose packed factor does not fit one
// block's shared memory (n > 322 at m = 1): the same schedule, with the
// packed lower factor in the global workspace Lg (n(n+1)/2 floats; 4.7 MB
// at n = 1536, inside the 50 MB L2) and Pt, Dt, dinv and the right-hand
// sides in shared memory.  A's upper triangle reaches Lg by 32x32 tiles
// through shared memory (one a warp, in the space Pt takes later), read
// along A's rows and written along Lg's, both coalesced.  One block of
// THREADS_GLOBAL threads: the trailing update, n^3/6 FMAs at most, runs
// on one SM and reads and writes the trailing triangle through L2 once a
// panel.
__global__ void __launch_bounds__(THREADS_GLOBAL)
spd_blocked_global_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          float* __restrict__ X, float* Lg, int n, int m) {
  extern __shared__ float4 k4_smem[];
  constexpr int NW = THREADS_GLOBAL / 32;
  float* smem = reinterpret_cast<float*>(k4_smem);
  float* x = smem + global_front_floats(n);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float* tile = smem + warp * 32 * 33;
  const int nb = (n + 31) / 32;
  for (int tr = 0, t = 0; tr < nb; ++tr) {
    for (int tc = tr; tc < nb; ++tc, ++t) {
      if (t % NW != warp) continue;
      for (int rr = 0; rr < 32; ++rr) {
        const int r = 32 * tr + rr, c = 32 * tc + lane;
        tile[rr * 33 + lane] = (r < n && c < n) ? A[(size_t)r * n + c] : 0.0f;
      }
      __syncwarp();
      for (int cc = 0; cc < 32; ++cc) {
        const int c = 32 * tc + cc, r = 32 * tr + lane;
        if (c < n && r <= c) Lg[tri(c, r)] = tile[lane * 33 + cc];
      }
      __syncwarp();
    }
  }
  for (int e = tid; e < n * m; e += THREADS_GLOBAL) x[e] = B[e];
  __syncthreads();

  k4_factor<THREADS_GLOBAL, true>(Lg, n);

  const auto lo = [](int i, int j) { return tri(i, j); };
  if (m == 1)
    solve_rhs(Lg, lo, x, X, n, THREADS_GLOBAL);
  else
    solve_block(Lg, lo, x, X, n, m, THREADS_GLOBAL);
}

// K5.  R = ceil(n / 32) row blocks a lane.  Thread (lane, warp) owns the
// entries (i, k), i = lane + 32 a, k = warp + 32 b: row block a, column
// block b, b <= a (below the diagonal block, a > b, every pair has i > k;
// in it, a == b, i >= k is lane >= warp).
template <int R>
__global__ void __launch_bounds__(32 * K5_WARPS)
spd_simple_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ X, int n, int m) {
  constexpr int W = K5_WARPS;
  constexpr int T = 32 * W;
  constexpr bool REG = R <= REG_ROWS;       // a thread's entries fit its registers
  extern __shared__ float smem[];
  float* U = smem;                   // packed upper triangle, n(n+1)/2
  float* x = U + n * (n + 1) / 2;    // right-hand sides (n, m)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // row r of A's upper triangle -> row r of U, coalesced both ways
  for (int r = warp; r < n; r += W) {
    float* ur = U + urow(r, n) - r;  // ur[c] = U[r][c], c >= r
    for (int c = r + lane; c < n; c += 32) ur[c] = A[(size_t)r * n + c];
  }
  for (int e = tid; e < n * m; e += T) x[e] = B[e];
  __syncthreads();

  // ---- factor: one barrier per pivot
  const bool last_ok = lane + 32 * (R - 1) < n;    // row i exists in block R-1
  int kbase[R];                                    // U + kbase[b] + 32 a = &a_ik
#pragma unroll
  for (int b = 0; b < R; ++b) {
    const int k = warp + W * b;
    kbase[b] = urow(k, n) - k + lane;
  }
  // entry (a, b) of this thread exists (i >= k, i < n); k < n is tested
  // per warp where the block is used
#define K5_ENTRY(a, b) (((a) > (b) || lane >= warp) && ((a) != R - 1 || last_ok))
  float e[REG ? R : 1][REG ? R : 1];               // register entries (unused ones vanish)
  if (REG) {
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int a = b; a < R; ++a)
        e[REG ? a : 0][REG ? b : 0] =
            (warp + W * b < n && K5_ENTRY(a, b)) ? U[kbase[b] + 32 * a] : 0.0f;
  }
  for (int j = 0; j < n; ++j) {
    const float* cj = U + urow(j, n) - j;   // cj[i] = a_ij, i >= j (unscaled)
    const float inv = rsqrtf(fmaxf(cj[j], 1e-12f));
    const int b0 = j < warp ? 0 : (j - warp) / W + 1;   // first block with k > j
    float li[R];
#pragma unroll
    for (int a = 0; a < R; ++a)
      li[a] = (a >= b0 && (a < R - 1 || last_ok)) ? cj[lane + 32 * a] * inv : 0.0f;
    if (REG) {
      // update in registers; the owners of column j+1, final now, write it
      // to row j+1 of U for the next step
      const int w1 = (j + 1) % W, b1 = (j + 1) / W;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        if (b >= b0 && warp + W * b < n) {
          const float lk = cj[warp + W * b] * inv;
#pragma unroll
          for (int a = b; a < R; ++a) {
            float& ea = e[REG ? a : 0][REG ? b : 0];
            ea = fmaf(-li[a], lk, ea);
          }
          if (b == b1 && warp == w1) {
#pragma unroll
            for (int a = b; a < R; ++a)
              if (K5_ENTRY(a, b)) U[kbase[b] + 32 * a] = e[REG ? a : 0][REG ? b : 0];
          }
        }
      }
    } else {
      // update in shared memory, one column block at a time; the next
      // block's entries are loaded before this block's are stored, so a
      // load never waits behind the stores
      float v[R], w[R];
      float lkv = 0.0f;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        if (b >= b0 && warp + W * b < n) {
          if (b == b0) {
#pragma unroll
            for (int a = b; a < R; ++a) v[a] = K5_ENTRY(a, b) ? U[kbase[b] + 32 * a] : 0.0f;
            lkv = cj[warp + W * b] * inv;
          }
          float lkw = 0.0f;
          const int bn = b + 1 < R ? b + 1 : b;    // the next block
          if (b + 1 < R && warp + W * bn < n) {
#pragma unroll
            for (int a = bn; a < R; ++a) w[a] = K5_ENTRY(a, bn) ? U[kbase[bn] + 32 * a] : 0.0f;
            lkw = cj[warp + W * bn] * inv;
          }
#pragma unroll
          for (int a = b; a < R; ++a)
            if (K5_ENTRY(a, b)) U[kbase[b] + 32 * a] = fmaf(-li[a], lkv, v[a]);
#pragma unroll
          for (int a = b + 1; a < R; ++a) v[a] = w[a];
          lkv = lkw;
        }
      }
    }
#undef K5_ENTRY
    __syncthreads();
  }
  // every row j still holds a_ij unscaled, its pivot a_jj untouched: scale
  // it by the step's own inv (U_jj = d inv, U_ji = a_ij inv), one warp a row
  for (int r = warp; r < n; r += W) {
    float* ur = U + urow(r, n) - r;
    const float inv = rsqrtf(fmaxf(ur[r], 1e-12f));
    __syncwarp();                    // every lane has read the pivot
    for (int c = r + lane; c < n; c += 32) ur[c] *= inv;
  }
  __syncthreads();

  const auto lo = [n](int i, int j) { return urow(j, n) - j + i; };   // L_ij = U[j][i]
  if (m == 1)
    solve_rhs(U, lo, x, X, n, T);
  else
    solve_block(U, lo, x, X, n, m, T);
}

// raise a kernel's dynamic shared-memory cap to the device's opt-in limit,
// once per kernel; returns the limit in *optin
template <typename K>
cudaError_t opt_in(K kernel, int* optin) {
  if (*optin != 0) return cudaSuccess;
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err == cudaSuccess) *optin = cap;
  return err;
}

// launch one of the kernels on one block
int launch(void (*kernel)(const float*, const float*, float*, int, int), int* optin,
           int threads, bool blocked, const float* A, const float* B, float* X, int n, int m,
           cudaStream_t stream) {
  const cudaError_t err = opt_in(kernel, optin);
  if (err != cudaSuccess) return err;
  if (sizeof(float) * shared_floats(blocked, n, m) > (size_t)*optin) return cudaErrorInvalidValue;
  kernel<<<1, threads, sizeof(float) * shared_floats(blocked, n, m), stream>>>(A, B, X, n, m);
  return cudaGetLastError();
}

template <int R>
int launch_simple(const float* A, const float* B, float* X, int n, int m,
                  cudaStream_t stream) {
  static int optin = 0;
  return launch(spd_simple_kernel<R>, &optin, 32 * K5_WARPS, false, A, B, X, n, m, stream);
}

int launch_simple_rows(const float* A, const float* B, float* X, int n, int m,
                       cudaStream_t stream) {
  switch ((n + 31) / 32) {
    case 1: return launch_simple<1>(A, B, X, n, m, stream);
    case 2: return launch_simple<2>(A, B, X, n, m, stream);
    case 3: return launch_simple<3>(A, B, X, n, m, stream);
    case 4: return launch_simple<4>(A, B, X, n, m, stream);
    case 5: return launch_simple<5>(A, B, X, n, m, stream);
    case 6: return launch_simple<6>(A, B, X, n, m, stream);
    case 7: return launch_simple<7>(A, B, X, n, m, stream);
    case 8: return launch_simple<8>(A, B, X, n, m, stream);
    case 9: return launch_simple<9>(A, B, X, n, m, stream);
    case 10: return launch_simple<10>(A, B, X, n, m, stream);
    default: return launch_simple<11>(A, B, X, n, m, stream);
  }
}

}  // namespace

// A: (n,n) f32 SPD, its upper triangle is read; B, X: (n,m) f32 row-major.
// blocked != 0 selects K4, else K5.  Returns a cudaError_t.
extern "C" int mcptam_spd_solve(const float* A, const float* B, float* X,
                                int n, int m, int blocked, cudaStream_t stream) {
  if (n <= 0 || m <= 0 || n > 32 * MAX_ROWS) return cudaErrorInvalidValue;
  static int optin_blocked = 0;
  return blocked ? launch(spd_blocked_kernel, &optin_blocked, THREADS, true, A, B, X, n, m, stream)
                 : launch_simple_rows(A, B, X, n, m, stream);
}

// K4's global path: the same arguments and the workspace L, n(n+1)/2 f32
// on the same device.  Returns a cudaError_t.
extern "C" int mcptam_spd_solve_global(const float* A, const float* B, float* X, float* L,
                                       int n, int m, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return cudaErrorInvalidValue;
  static int optin = 0;
  const cudaError_t err = opt_in(spd_blocked_global_kernel, &optin);
  if (err != cudaSuccess) return err;
  const size_t bytes = sizeof(float) * (global_front_floats(n) + (size_t)n * m);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  spd_blocked_global_kernel<<<1, THREADS_GLOBAL, bytes, stream>>>(A, B, X, L, n, m);
  return cudaGetLastError();
}
