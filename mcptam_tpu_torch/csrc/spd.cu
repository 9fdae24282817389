// Dense SPD solve A x = b for Hopper: Cholesky A = L L^T, then L y = b,
// then L^T x = y: inside one thread block while the factor fits its
// shared memory, beyond that as a sequence of launches (K4's global path).
//
// Replaces: mcptam_tpu/core/spd.py::_spd_kernel_blocked (K4, the default)
// and ::_spd_kernel (K5, MCPTAM_SPD_KERNEL=simple), both reached through
// _spd_solve_pallas from ba/bundle.py::_solve_delta_soa once per LM step.
// Plain version: mcptam_tpu_torch/core/spd.py::spd_solve_reference.
//
// What bounds the one-block kernels on the H100: the serial dependence
// chain.  The reduced camera system is small (n = 6 x poses: 96 in the
// mapping slice, 288 at capacity), so the factor is ~n^3/6 = 4 MFLOP at most; what costs is the
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
//   mapping LM's system is n = 6 x max_mkfs, so 54 MKFs and up; it
//   replaces _spd_kernel_blocked where the TPU kernel padded n to 128 and
//   kept the whole factor in VMEM, which one SM's 227 KB cannot hold): a
//   right-looking blocked Cholesky spread over the SMs as a fixed sequence
//   of launches on the caller's stream, 2 ceil(n / NB) + 1 of them, with
//   no synchronisation between blocks inside any kernel: each kernel reads
//   only what earlier launches finished.  The workspace holds a dense
//   row-major factor W (n x ld, ld = n rounded up to 4, the lower
//   triangle used), the current panel's factored diagonal block Dg
//   (NB x NB) and the right-hand sides Y (n x m).
//   1. global_load: W's lower triangle from A's upper (W[i][k] = A[k][i])
//      by 32 x 33 shared tiles, a block a tile, and B into Y.
//   2. per panel p0 .. pe = p0 + NB, global_panel: every block loads its
//      rows below the diagonal block (a row a thread), stages the block
//      in shared memory and factors it itself in one warp (a lane a row,
//      the column broadcast through shared memory; redundant NB^3 / 6 FMAs
//      in place of a launch), then solves its rows against it
//      (l_ij = (a_ij - sum_k<j l_ik l_jk) dinv_j).  Block 0 takes the
//      panel's forward step Y[p0:pe] <- L_pp^-1 Y[p0:pe] and stores the
//      factored block: into W when it is the only block (the last panel),
//      else into Dg, since the other blocks of the launch read W's copy;
//      global_update places Dg into W.
//   3. global_update: a block a TILE x TILE tile of the trailing lower
//      triangle (tile row >= tile column, rows and columns >= pe), which
//      stages its two NB-wide strips of the panel in shared memory, forms
//      the product in f32 FFMA with 4 x 4 outputs a thread and subtracts it
//      from W once (diagonal tiles write i >= k only); then blocks of rows
//      of the right-hand side, Y[pe:] -= L[pe:, p0:pe] Y[p0:pe].
//   4. global_back: one block, L^T x = Y by 32-row blocks from the bottom,
//      x in shared memory: a warp's shuffle chain a column on the block's
//      diagonal tile (solve_rhs's back step), then every thread subtracts
//      the block's solution from a row above.
//   What bounds it on this card: latency, at every size the port meets.
//   The factor's FMAs (n^3 / 6, 0.6 G at n = 1536) would take 0.018 ms at
//   the f32 rate and W (9.4 MB at n = 1536) stays in L2; what costs is
//   the chain of 2n / NB dependent launches, each an L2 round trip or two
//   and ~1 us of gap, the NB-step chain of the diagonal block inside every
//   panel launch, and the back-substitution's n / 32 steps on one SM
//   (PERF.md has the split).  The design spreads the update over the SMs
//   and pays a launch and a redundant diagonal factor a panel for it.  NB
//   = 32 and TILE = 32 are measured (scripts/compare_parent_kernels.py
//   --variants): NB = 16 doubles the launches, NB = 64 more than doubles
//   the diagonal chain's cost a panel, TILE = 64 is up to 2% slower at
//   n <= 576 and no faster at 1536.  No tensor cores here
//   either (TF32, see above), and no grid barrier, cooperative launch,
//   cluster or atomic ticket: look-ahead (panel p + 1 during update p) is
//   later work.
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
constexpr int PB = 16;        // panel width of the blocked variant
constexpr int RT = 16;        // rows a lane takes in a trailing-update job
static_assert(PB % RT == 0 && PB <= 32, "the next diagonal block is whole jobs of one column block");
constexpr int K5_WARPS = 32;  // the simple variant: 1024 threads
constexpr int MAX_ROWS = 11;  // row blocks of a lane in K5: n <= 352
constexpr int REG_ROWS = 4;   // up to here (n <= 128) K5's entries live in registers
constexpr unsigned FULL = 0xffffffffu;
// the blocked variant's global path
constexpr int NB = 32;          // panel width
constexpr int TILE = 32;        // trailing-update tile, TILE x TILE, 4 x 4 outputs a thread
constexpr int PANEL_ROWS = 64;  // rows below the diagonal block a panel block solves
constexpr int BACK_THREADS = 1024;
constexpr int UPDATE_THREADS = (TILE / 4) * (TILE / 4);
static_assert(NB % 16 == 0 && NB <= 64, "a panel is whole float4 quads, at most two rows a lane");
static_assert(TILE % 4 == 0 && UPDATE_THREADS <= 1024 && PANEL_ROWS % 32 == 0, "block shapes");

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
__device__ __forceinline__ void k4_factor(int n) {
  extern __shared__ float4 k4_smem[];
  float* Pt = reinterpret_cast<float*>(k4_smem);
  float* Dt = Pt + PB * k4_ld(n);
  float* dinv = Dt + PB * PB;
  float* L = dinv + PB;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int T = THREADS, NW = T / 32;
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

  k4_factor(n);

  const auto lo = [](int i, int j) { return tri(i, j); };
  if (m == 1)
    solve_rhs(L, lo, x, X, n, THREADS);
  else
    solve_block(L, lo, x, X, n, m, THREADS);
}

// ---- K4's global path (the note at the head of the file)

// W's leading dimension: rows start on 16 bytes, for the float4 reads of a
// panel row
__host__ __device__ __forceinline__ int global_ld(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ __forceinline__ int global_panels(int n) { return (n + NB - 1) / NB; }

// the workspace in floats: W (n x ld), Dg (NB x NB), Y (n x m)
__host__ __forceinline__ size_t global_work_floats(int n, int m) {
  return (size_t)n * global_ld(n) + NB * NB + (size_t)n * m;
}

// global_back's shared memory in floats: two 32 x 33 tiles and x (n x m)
__host__ __forceinline__ size_t global_back_floats(int n, int m) {
  return 2 * 32 * 33 + (size_t)n * m;
}

// tiles of the trailing update a side, rows and columns pe .. n-1
__host__ __device__ __forceinline__ int global_tiles(int n, int pe) {
  return (n - pe + TILE - 1) / TILE;
}

// the row r of a lower triangle of blocks, numbered row by row, that holds
// block b: r (r + 1) / 2 <= b < (r + 1) (r + 2) / 2
__device__ __forceinline__ int tri_row(int b) {
  int r = (int)((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > b) --r;
  while ((r + 1) * (r + 2) / 2 <= b) ++r;
  return r;
}

// W's lower triangle from A's upper, a 32 x 32 tile (tr >= tc) a block of
// 256 threads: read along A's rows, written along W's, both coalesced;
// B -> Y over all blocks
__global__ void __launch_bounds__(256)
global_load(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ W,
            float* __restrict__ Y, int n, int m) {
  __shared__ float tile[32][33];
  const int ld = global_ld(n);
  const int tr = tri_row(blockIdx.x), tc = blockIdx.x - tr * (tr + 1) / 2;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {              // A[k][i], k = 32 tc + r
    const int k = 32 * tc + r, i = 32 * tr + tx;
    tile[r][tx] = (k < n && i < n) ? A[(size_t)k * n + i] : 0.0f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {              // W[i][k], i = 32 tr + r
    const int i = 32 * tr + r, k = 32 * tc + tx;
    if (i < n && k <= i) W[(size_t)i * ld + k] = tile[tx][r];
  }
  const size_t nm = (size_t)n * m;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < nm; e += (size_t)gridDim.x * 256)
    Y[e] = B[e];
}

// The panel's diagonal block, staged in Ds (NB x (NB + 1), lower triangle,
// zero elsewhere), factored in one warp: lane r holds rows r + 32 q
// (q < QR), their entries left of the diagonal in a[q][] and their
// diagonal entries in dg[q].  A step j shuffles the pivot, every lane takes
// inv = rsqrt(d) itself and scales its own l_rj = a_rj inv, the lanes below
// write column j into row j of Dt (Dt[j][k] = L_kj) and read it back as
// float4 broadcasts for their update a_rk -= l_rj L_kj, j < k < r.  Dt ends
// as the factor transposed, L_jj on its diagonal, zero below it, rows past
// w the identity; dinv holds the pivots' 1/sqrt and rdiag
// 1 / max(L_jj, 1e-12).  A step is one basic block with no predicate on
// its FMAs, so that the next step's shuffle and rsqrt overlap this one's
// round trip through Dt.
__device__ __forceinline__ void global_diagonal(const float* Ds, int w, float* Dt, float* dinv,
                                                float* rdiag) {
  constexpr int QR = (NB + 31) / 32;
  const int lane = threadIdx.x & 31;
  float a[QR][NB], dg[QR], lrr[QR];
#pragma unroll
  for (int q = 0; q < QR; ++q) {
    const int r = lane + 32 * q;
    const float* row = Ds + min(r, NB - 1) * (NB + 1);
#pragma unroll
    for (int c = 0; c < NB; ++c) a[q][c] = (r < w && c < r) ? row[c] : 0.0f;
    dg[q] = r < w ? row[min(r, NB - 1)] : 1.0f;
    lrr[q] = 1.0f;
  }
  // no branch a step: past w the padded rows (zero, pivot 1) leave the
  // factor as it is and make the identity; the update runs on every lane,
  // and on the lanes at or above the diagonal only touches entries that
  // are never read
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = __shfl_sync(FULL, dg[j / 32], j % 32);
    const float inv = rsqrtf(fmaxf(d, 1e-12f));
    float li[QR];                                   // L_rj for r > j
#pragma unroll
    for (int q = 0; q < QR; ++q) {
      const int r = lane + 32 * q;
      li[q] = a[q][j] * inv;
      if (r == j) lrr[q] = d * inv;
      if (r > j) {
        dg[q] = fmaf(-li[q], li[q], dg[q]);
        if (r < NB) Dt[j * NB + r] = li[q];
      }
    }
    __syncwarp();
    const float4* dj = reinterpret_cast<const float4*>(Dt + j * NB);
#pragma unroll
    for (int t = (j + 1) / 4; t < NB / 4; ++t) {
      const float4 v = dj[t];
      const float vt[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int q = 0; q < QR; ++q)
          if (4 * t + e > j) a[q][4 * t + e] = fmaf(-li[q], vt[e], a[q][4 * t + e]);
      }
    }
    if (lane == 0) dinv[j] = inv;
  }
#pragma unroll
  for (int q = 0; q < QR; ++q) {
    const int r = lane + 32 * q;
    if (r < NB) {
      Dt[r * NB + r] = lrr[q];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < r) Dt[r * NB + c] = 0.0f;
      rdiag[r] = 1.0f / fmaxf(lrr[q], 1e-12f);
    }
  }
}

// Panel p0: block 0 the diagonal block's store and the forward step of
// the right-hand sides, block b > 0 the PANEL_ROWS rows from
// pe + (b - 1) PANEL_ROWS, a row a thread, loaded before the diagonal
// block is factored.
__global__ void __launch_bounds__(PANEL_ROWS)
global_panel(float* __restrict__ W, float* __restrict__ Dg, float* __restrict__ Y,
             int n, int m, int p0) {
  constexpr int QR = (NB + 31) / 32;
  __shared__ __align__(16) float Dt[NB * NB];
  __shared__ float Ds[NB * (NB + 1)], dinv[NB], rdiag[NB];
  const int ld = global_ld(n), w = min(NB, n - p0), pe = p0 + w;
  const int tid = threadIdx.x, lane = tid & 31;
  // this thread's row below the block (the panel is full then: w == NB)
  const int i = pe + ((int)blockIdx.x - 1) * PANEL_ROWS + tid;
  const bool has_row = blockIdx.x > 0 && i < n;
  float a[NB];
  float4* row = reinterpret_cast<float4*>(W + (size_t)(has_row ? i : p0) * ld + p0);
  if (has_row) {
#pragma unroll
    for (int t = 0; t < NB / 4; ++t) {
      const float4 v = row[t];
      a[4 * t] = v.x, a[4 * t + 1] = v.y, a[4 * t + 2] = v.z, a[4 * t + 3] = v.w;
    }
  }
  for (int e = tid; e < NB * NB; e += PANEL_ROWS) {
    const int r = e / NB, c = e % NB;
    Ds[r * (NB + 1) + c] = (r < w && c <= r) ? W[(size_t)(p0 + r) * ld + p0 + c] : 0.0f;
  }
  __syncthreads();
  if (tid < 32) global_diagonal(Ds, w, Dt, dinv, rdiag);
  __syncthreads();
  if (blockIdx.x == 0) {
    // the factored block, lower triangle: into W when no other block of
    // this launch reads W's copy, else into Dg
    const bool alone = gridDim.x == 1;
    for (int e = tid; e < w * w; e += PANEL_ROWS) {
      const int j = e / w, k = e % w;               // L_kj, k >= j
      if (k >= j) {
        if (alone)
          W[(size_t)(p0 + k) * ld + p0 + j] = Dt[j * NB + k];
        else
          Dg[j * NB + k] = Dt[j * NB + k];
      }
    }
    // Y[p0:pe] <- L_pp^-1 Y[p0:pe], a warp a column: lane r holds rows
    // r + 32 q; a step j broadcasts x_j = y_j / L_jj and the rows below
    // subtract L_rj x_j
    for (int c = tid >> 5; c < m; c += PANEL_ROWS / 32) {
      float y[QR];
#pragma unroll
      for (int q = 0; q < QR; ++q) {
        const int r = lane + 32 * q;
        y[q] = r < w ? Y[(size_t)(p0 + r) * m + c] : 0.0f;
      }
      for (int j = 0; j < w; ++j) {
        float yj = y[0];
#pragma unroll
        for (int q = 1; q < QR; ++q)
          if (j >= 32 * q) yj = y[q];
        const float xj = __shfl_sync(FULL, yj, j % 32) * rdiag[j];
#pragma unroll
        for (int q = 0; q < QR; ++q) {
          const int r = lane + 32 * q;
          if (r == j) y[q] = xj;
          if (r > j && r < NB) y[q] = fmaf(-Dt[j * NB + r], xj, y[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < QR; ++q) {
        const int r = lane + 32 * q;
        if (r < w) Y[(size_t)(p0 + r) * m + c] = y[q];
      }
    }
    return;
  }
  if (!has_row) return;
  // the row solved against the block
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    a[j] *= dinv[j];
    const float4* dj = reinterpret_cast<const float4*>(Dt + j * NB);
#pragma unroll
    for (int q = (j + 1) / 4; q < NB / 4; ++q) {
      const float4 v = dj[q];
      const float vq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e > j) a[4 * q + e] = fmaf(-a[j], vq[e], a[4 * q + e]);
    }
  }
#pragma unroll
  for (int t = 0; t < NB / 4; ++t)
    row[t] = make_float4(a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3]);
}

// The trailing update after panel p0 (full: pe = p0 + NB < n).  Blocks
// 0 .. tiles-1: tile (ti, tk), ti >= tk, of TILE x TILE entries at rows
// pe + TILE ti and columns pe + TILE tk: both strips of the panel staged
// transposed in shared memory (As[c][r] = L[i0 + r][p0 + c]), 4 x 4 sums a
// thread accumulated from zero over the panel's columns in order, then
// W -= sum once.  The blocks after them: UPDATE_THREADS rows of the
// right-hand sides each, a row a thread; the first also places the
// panel's diagonal block from Dg into W.
__global__ void __launch_bounds__(UPDATE_THREADS)
global_update(float* __restrict__ W, const float* __restrict__ Dg, float* __restrict__ Y,
              int n, int m, int p0) {
  constexpr int TS = TILE / 4, S = TILE + 4;        // S: a strip row, float4-aligned
  __shared__ __align__(16) float As[NB * S];
  __shared__ __align__(16) float Bs[NB * S];
  const int ld = global_ld(n), pe = p0 + NB, nt = global_tiles(n, pe);
  const int tiles = nt * (nt + 1) / 2, tid = threadIdx.x;
  if ((int)blockIdx.x >= tiles) {
    const int rb = blockIdx.x - tiles;
    if (rb == 0) {
      for (int e = tid; e < NB * NB; e += UPDATE_THREADS) {
        const int j = e / NB, k = e % NB;
        if (k >= j) W[(size_t)(p0 + k) * ld + p0 + j] = Dg[e];
      }
    }
    const int i = pe + rb * UPDATE_THREADS + tid;
    if (i >= n) return;
    const float4* row = reinterpret_cast<const float4*>(W + (size_t)i * ld + p0);
    float l[NB];
#pragma unroll
    for (int t = 0; t < NB / 4; ++t) {
      const float4 v = row[t];
      l[4 * t] = v.x, l[4 * t + 1] = v.y, l[4 * t + 2] = v.z, l[4 * t + 3] = v.w;
    }
    for (int c = 0; c < m; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) acc = fmaf(l[j], Y[(size_t)(p0 + j) * m + c], acc);
      Y[(size_t)i * m + c] -= acc;
    }
    return;
  }
  const int ti = tri_row(blockIdx.x), tk = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = pe + TILE * ti, k0 = pe + TILE * tk;
  for (int e = tid; e < TILE * NB / 4; e += UPDATE_THREADS) {
    const int r = e / (NB / 4), q = e % (NB / 4);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 va = i0 + r < n ? *reinterpret_cast<const float4*>(
                                       W + (size_t)(i0 + r) * ld + p0 + 4 * q) : z;
    const float4 vb = k0 + r < n ? *reinterpret_cast<const float4*>(
                                       W + (size_t)(k0 + r) * ld + p0 + 4 * q) : z;
    As[(4 * q) * S + r] = va.x, As[(4 * q + 1) * S + r] = va.y;
    As[(4 * q + 2) * S + r] = va.z, As[(4 * q + 3) * S + r] = va.w;
    Bs[(4 * q) * S + r] = vb.x, Bs[(4 * q + 1) * S + r] = vb.y;
    Bs[(4 * q + 2) * S + r] = vb.z, Bs[(4 * q + 3) * S + r] = vb.w;
  }
  __syncthreads();
  const int ty = tid / TS, tx = tid % TS;
  float acc[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[s][t] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < NB; ++c) {
    const float4 av = *reinterpret_cast<const float4*>(As + c * S + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(Bs + c * S + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[s][t] = fmaf(ar[s], br[t], acc[s][t]);
  }
  const int k = k0 + 4 * tx;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = i0 + 4 * ty + s;
    if (i >= n) break;
    float* wr = W + (size_t)i * ld + k;
    if (ti != tk) {                                 // left of the diagonal tile: whole quads
      float4 v = *reinterpret_cast<float4*>(wr);
      v.x -= acc[s][0], v.y -= acc[s][1], v.z -= acc[s][2], v.w -= acc[s][3];
      *reinterpret_cast<float4*>(wr) = v;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (k + t <= i) wr[t] -= acc[s][t];
    }
  }
}

// the diagonal tile of the 32-row block at j0, W[j0 .. j0+jn) lower, into
// t (32 x 33, zero elsewhere), by global_back's threads from `first` on
__device__ __forceinline__ void back_tile(const float* W, int ld, int n, int j0, float* t,
                                          int first) {
  const int jn = min(32, n - j0);
  for (int e = threadIdx.x - first; e < 32 * 32; e += BACK_THREADS - first) {
    const int r = e / 32, c = e % 32;
    t[r * 33 + c] = (r < jn && c <= r) ? W[(size_t)(j0 + r) * ld + j0 + c] : 0.0f;
  }
}

// L^T x = Y, one block: x (n x m) in shared memory; 32-row blocks from the
// bottom, each: a warp a column runs solve_rhs's back chain on the block's
// diagonal tile (lane l holds row j0 + l divided by its pivot; a step is
// one shuffle and one FMA), then every thread subtracts the block's
// solution from a row above it, a dot product of up to 32 terms read
// along W's rows.  The warps that run no chain load the next block's tile
// meanwhile, into the other of two buffers: two block barriers a block.
__global__ void __launch_bounds__(BACK_THREADS)
global_back(const float* __restrict__ W, const float* __restrict__ Y, float* __restrict__ X,
            int n, int m) {
  extern __shared__ float back_smem[];
  float* x = back_smem + 2 * 32 * 33;               // two tiles, then x (n x m)
  const int ld = global_ld(n), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nm = n * m, nb = (n + 31) / 32;
  // the chains take warps 0 .. m-1; the others load tiles (all, if none is left)
  const int loaders = m < BACK_THREADS / 32 ? 32 * m : 0;
  for (int e = tid; e < nm; e += BACK_THREADS) x[e] = Y[e];
  back_tile(W, ld, n, 32 * (nb - 1), back_smem + ((nb - 1) & 1) * 32 * 33, 0);
  __syncthreads();
  for (int a = nb - 1; a >= 0; --a) {
    const int j0 = 32 * a, jn = min(32, n - j0);
    const float* tile = back_smem + (a & 1) * 32 * 33;
    if (a > 0 && tid >= loaders)
      back_tile(W, ld, n, j0 - 32, back_smem + ((a - 1) & 1) * 32 * 33, loaders);
    for (int c = warp; c < m; c += BACK_THREADS / 32) {
      const bool in = lane < jn;
      const float rd = in ? 1.0f / fmaxf(tile[lane * 33 + lane], 1e-12f) : 1.0f;
      float z = in ? x[(j0 + lane) * m + c] * rd : 0.0f;
      float u = (in && lane < jn - 1) ? tile[(jn - 1) * 33 + lane] * rd : 0.0f;
      for (int jj = jn - 1; jj >= 0; --jj) {
        const float un = (jj > 0 && lane < jj - 1) ? tile[(jj - 1) * 33 + lane] * rd : 0.0f;
        z = fmaf(-u, __shfl_sync(FULL, z, jj), z);
        u = un;
      }
      if (in) x[(j0 + lane) * m + c] = z;
    }
    if (a > 0 && loaders == 0)
      back_tile(W, ld, n, j0 - 32, back_smem + ((a - 1) & 1) * 32 * 33, 0);
    __syncthreads();
    for (int e = tid; e < j0 * m; e += BACK_THREADS) {
      const int r = e / m, c = e % m;
      float dot = 0.0f;
#pragma unroll 16   // 16 loads in flight a thread: 8 or 32 are slower on the H100
      for (int jj = 0; jj < jn; ++jj)
        dot = fmaf(W[(size_t)(j0 + jj) * ld + r], x[(j0 + jj) * m + c], dot);
      x[e] -= dot;
    }
    __syncthreads();
  }
  for (int e = tid; e < nm; e += BACK_THREADS) X[e] = x[e];
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

// K4's global path: the same arguments, a workspace of work_floats f32 on
// the same device (at least n ld + NB^2 + n m, ld = n rounded up to 4:
// mcptam_spd_global_plan) and the stream; enqueues its launches and
// returns the first cudaError_t.
extern "C" int mcptam_spd_solve_global(const float* A, const float* B, float* X, float* work,
                                       int n, int m, size_t work_floats, cudaStream_t stream) {
  if (n <= 0 || m <= 0 || work_floats < global_work_floats(n, m)) return cudaErrorInvalidValue;
  static int optin = 0;
  cudaError_t err = opt_in(global_back, &optin);
  if (err != cudaSuccess) return err;
  const size_t back = sizeof(float) * global_back_floats(n, m);
  if (back > (size_t)optin) return cudaErrorInvalidValue;
  float* W = work;
  float* Dg = W + (size_t)n * global_ld(n);
  float* Y = Dg + NB * NB;
  const int nb = (n + 31) / 32;
  global_load<<<nb * (nb + 1) / 2, 256, 0, stream>>>(A, B, W, Y, n, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int p0 = 0; p0 < n; p0 += NB) {
    const int pe = p0 + NB < n ? p0 + NB : n;
    global_panel<<<1 + (n - pe + PANEL_ROWS - 1) / PANEL_ROWS, PANEL_ROWS, 0, stream>>>(
        W, Dg, Y, n, m, p0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (pe < n) {
      const int nt = global_tiles(n, pe);
      const int rows = (n - pe + UPDATE_THREADS - 1) / UPDATE_THREADS;
      global_update<<<nt * (nt + 1) / 2 + rows, UPDATE_THREADS, 0, stream>>>(W, Dg, Y, n, m, p0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  global_back<<<1, BACK_THREADS, back, stream>>>(W, Y, X, n, m);
  return cudaGetLastError();
}

// The global path's plan for an (n, m) system: plan[0] NB, plan[1] TILE,
// plan[2] the launches one solve enqueues, plan[3] the workspace in
// floats, plan[4] global_back's shared bytes.  Returns 0.
extern "C" int mcptam_spd_global_plan(int n, int m, long long* plan) {
  plan[0] = NB;
  plan[1] = TILE;
  plan[2] = 2 * global_panels(n) + 1;
  plan[3] = (long long)global_work_floats(n, m);
  plan[4] = (long long)(sizeof(float) * global_back_floats(n, m));
  return 0;
}
