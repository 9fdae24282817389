// Dense SPD solve A x = b for Hopper: Cholesky A = U^T U, then U^T y = b,
// then U x = y, all inside one thread block.
//
// Replaces: mcptam_tpu/core/spd.py::_spd_kernel_blocked (K4, the default)
// and ::_spd_kernel (K5, MCPTAM_SPD_KERNEL=simple), both reached through
// _spd_solve_pallas from ba/bundle.py::_solve_delta_soa once per LM step.
// Plain version: mcptam_tpu_torch/core/spd.py::spd_solve_reference.
//
// What bounds it on the H100: the serial dependence chain.  The reduced
// camera system is small (n = 6 x poses: 96 in the mapping slice, 288 at
// capacity), so the factor is ~n^3/6 = 4 MFLOP at most; what costs is the
// n sequential pivot steps, each a block-wide barrier, and the shared-
// memory traffic of the updates on the one SM that holds the matrix.  One
// block per system keeps the whole chain on that SM with no grid-wide
// synchronisation.  The TPU kernels' 128-padding, lane masks and
// materialised U^T served their (8,128) tiles and have no purpose here.
// Pivots are clamped at 1e-12 as in the TPU kernels.
//
// * blocked (K4): the working matrix is the packed lower triangle L (row i
//   holds columns 0..i contiguously), n(n+1)/2 floats: 166 KB at n = 288,
//   where a full n x n matrix (324 KB) would not fit the 227 KB a block may
//   use; L is loaded from A's upper triangle (L[i][k] = A[k][i]).  Panels
//   of 8 columns: inside a panel the rank-1 updates touch only the panel's
//   columns; then the trailing triangle takes one rank-8 update, each entry
//   an 8-term dot product of two contiguous panel rows.  The solves are
//   blocked the same way.  512 threads.
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
//   PERF.md); the substitutions are a chain of n divide-shuffle-FMA
//   steps each.  For m = 1 both
//   substitutions run in warp 0 with no block barrier: lane l keeps x_i,
//   i = l (mod 32), and the pivots of its rows in registers, the pivot's
//   lane divides and broadcasts x_j with a shuffle, every lane updates its
//   rows.  m > 1 keeps a block form with the rhs in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;  // the blocked variant
constexpr int PB = 8;         // panel width of the blocked variant
constexpr int K5_WARPS = 32;  // the simple variant: 1024 threads
constexpr int MAX_ROWS = 11;  // row blocks of a lane in the simple variant: n <= 352
constexpr int REG_ROWS = 4;   // up to here (n <= 128) its entries live in registers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }

// offset of row r of the packed upper triangle, which holds columns r..n-1
__device__ __forceinline__ int urow(int r, int n) { return r * n - r * (r - 1) / 2; }

// one thread takes pivot j: L[j][j] = sqrt(d), the column scale goes to s_inv
__device__ __forceinline__ void pivot(float* L, int j, float* s_inv) {
  if (threadIdx.x == 0) {
    const float d = L[tri(j, j)];
    const float inv = 1.0f / sqrtf(fmaxf(d, 1e-12f));
    L[tri(j, j)] = d * inv;
    *s_inv = inv;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
spd_blocked_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ X, int n, int m) {
  extern __shared__ float smem[];   // all dynamic: the opt-in cap counts static bytes too
  float* s_inv = smem;               // the current pivot's column scale
  float* L = smem + 4;               // packed lower factor, n(n+1)/2
  float* x = L + n * (n + 1) / 2;    // right-hand sides, (n, m)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = THREADS / 32;

  // row r of A's upper triangle (coalesced) -> column r of L
  for (int r = warp; r < n; r += nwarps)
    for (int c = r + lane; c < n; c += 32) L[tri(c, r)] = A[(size_t)r * n + c];
  for (int e = tid; e < n * m; e += THREADS) x[e] = B[e];
  __syncthreads();

  // ---- factor
  for (int p0 = 0; p0 < n; p0 += PB) {
    const int pe = min(p0 + PB, n);
    for (int j = p0; j < pe; ++j) {
      pivot(L, j, s_inv);
      const float inv = *s_inv;
      for (int i = j + 1 + tid; i < n; i += THREADS) L[tri(i, j)] *= inv;
      __syncthreads();
      // rank-1 update of the panel's remaining columns only; thread i
      // writes row i and reads column j, which nobody writes here
      for (int i = j + 1 + tid; i < n; i += THREADS) {
        const float lij = L[tri(i, j)];
        float* row = L + tri(i, 0);
        const int kend = min(pe, i + 1);
        for (int k = j + 1; k < kend; ++k) row[k] -= lij * L[tri(k, j)];
      }
      __syncthreads();
    }
    // rank-8 update of the trailing triangle (rows remain only after a
    // full panel: a partial one is the last)
    for (int i = pe + warp; i < n; i += nwarps) {
      const float* li = L + tri(i, p0);
      float a[PB];
#pragma unroll
      for (int c = 0; c < PB; ++c) a[c] = li[c];
      float* row = L + tri(i, 0);
      for (int k = pe + lane; k <= i; k += 32) {
        const float* lk = L + tri(k, p0);
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < PB; ++c) s += a[c] * lk[c];
        row[k] -= s;
      }
    }
    __syncthreads();
  }

  // ---- forward solve L y = b (L = U^T)
  for (int p0 = 0; p0 < n; p0 += PB) {
    const int pe = min(p0 + PB, n);
    for (int j = p0; j < pe; ++j) {
      const float d = fmaxf(L[tri(j, j)], 1e-12f);
      for (int c = tid; c < m; c += THREADS) x[j * m + c] /= d;
      __syncthreads();
      for (int e = tid; e < (pe - j - 1) * m; e += THREADS) {
        const int i = j + 1 + e / m, c = e % m;
        x[i * m + c] -= L[tri(i, j)] * x[j * m + c];
      }
      __syncthreads();
    }
    for (int e = tid; e < (n - pe) * m; e += THREADS) {
      const int i = pe + e / m, c = e % m;
      const float* li = L + tri(i, p0);
      float s = 0.0f;
      for (int q = 0; q < pe - p0; ++q) s += li[q] * x[(p0 + q) * m + c];
      x[i * m + c] -= s;
    }
    __syncthreads();
  }

  // ---- back solve U x = y (U[i][j] = L[j][i])
  for (int p0 = ((n - 1) / PB) * PB; p0 >= 0; p0 -= PB) {
    const int pe = min(p0 + PB, n);
    for (int j = pe - 1; j >= p0; --j) {
      const float d = fmaxf(L[tri(j, j)], 1e-12f);
      for (int c = tid; c < m; c += THREADS) x[j * m + c] /= d;
      __syncthreads();
      const float* lj = L + tri(j, 0);
      for (int e = tid; e < (j - p0) * m; e += THREADS) {
        const int i = p0 + e / m, c = e % m;
        x[i * m + c] -= lj[i] * x[j * m + c];
      }
      __syncthreads();
    }
    for (int e = tid; e < p0 * m; e += THREADS) {
      const int i = e / m, c = e % m;
      float s = 0.0f;
      for (int q = p0; q < pe; ++q) s += L[tri(q, i)] * x[q * m + c];
      x[i * m + c] -= s;
    }
    __syncthreads();
  }

  for (int e = tid; e < n * m; e += THREADS) X[e] = x[e];
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
  float* x = U + n * (n + 1) / 2;    // right-hand sides (n, m), m > 1 only
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // row r of A's upper triangle -> row r of U, coalesced both ways
  for (int r = warp; r < n; r += W) {
    float* ur = U + urow(r, n) - r;  // ur[c] = U[r][c], c >= r
    for (int c = r + lane; c < n; c += 32) ur[c] = A[(size_t)r * n + c];
  }
  if (m > 1)
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

  if (m == 1) {
    // ---- both substitutions in warp 0; lane l keeps x_i and the pivot
    // max(U_ii, 1e-12) of its rows i = l + 32 a in registers.  A step: the
    // pivot's lane divides, a shuffle broadcasts x_j, every lane updates
    // its rows with the U entries it loaded before the shuffle.
    if (warp != 0) return;
    float xr[R], dr[R];
    int rb[R];                               // U + rb[a] + j = &U[i][j]
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = lane + 32 * a;
      xr[a] = i < n ? B[i] : 0.0f;
      dr[a] = i < n ? fmaxf(U[urow(i, n)], 1e-12f) : 1.0f;
      rb[a] = urow(i, n) - i;
    }
    // forward L y = b: L_ij = U[j][i], i > j
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * a + jj;
        if (j >= n) break;
        const float* uj = U + urow(j, n) - j;
        float u[R];
#pragma unroll
        for (int a2 = a; a2 < R; ++a2) {
          const int i = lane + 32 * a2;
          u[a2] = (i > j && i < n) ? uj[i] : 0.0f;
        }
        const float yj = __shfl_sync(FULL, xr[a] / dr[a], jj);
        if (lane == jj) xr[a] = yj;
#pragma unroll
        for (int a2 = a; a2 < R; ++a2) {
          const int i = lane + 32 * a2;
          if (i > j && i < n) xr[a2] = fmaf(-u[a2], yj, xr[a2]);
        }
      }
    }
    // back U x = y: x_i -= U[i][j] x_j, i < j
#pragma unroll
    for (int a = R - 1; a >= 0; --a) {
#pragma unroll 4
      for (int jj = 31; jj >= 0; --jj) {
        const int j = 32 * a + jj;
        if (j >= n) continue;
        float u[R];
#pragma unroll
        for (int a2 = 0; a2 <= a; ++a2) u[a2] = lane + 32 * a2 < j ? U[rb[a2] + j] : 0.0f;
        const float xj = __shfl_sync(FULL, xr[a] / dr[a], jj);
        if (lane == jj) xr[a] = xj;
#pragma unroll
        for (int a2 = 0; a2 <= a; ++a2)
          if (lane + 32 * a2 < j) xr[a2] = fmaf(-u[a2], xj, xr[a2]);
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = lane + 32 * a;
      if (i < n) X[i] = xr[a];
    }
    return;
  }

  // ---- m > 1: block form, rhs in shared memory
  for (int j = 0; j < n; ++j) {
    const float* uj = U + urow(j, n) - j;
    const float d = fmaxf(uj[j], 1e-12f);
    for (int c = tid; c < m; c += T) x[j * m + c] /= d;
    __syncthreads();
    for (int e = tid; e < (n - j - 1) * m; e += T) {
      const int i = j + 1 + e / m, c = e % m;
      x[i * m + c] -= uj[i] * x[j * m + c];
    }
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {
    const float d = fmaxf(U[urow(j, n)], 1e-12f);
    for (int c = tid; c < m; c += T) x[j * m + c] /= d;
    __syncthreads();
    for (int e = tid; e < j * m; e += T) {
      const int i = e / m, c = e % m;
      x[i * m + c] -= U[urow(i, n) + j - i] * x[j * m + c];
    }
    __syncthreads();
  }
  for (int e = tid; e < n * m; e += T) X[e] = x[e];
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

int launch_blocked(const float* A, const float* B, float* X, int n, int m,
                   cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (4 + (size_t)n * (n + 1) / 2 + (size_t)n * m);
  static int optin = 0;
  const cudaError_t err = opt_in(spd_blocked_kernel, &optin);
  if (err != cudaSuccess) return err;
  if (n <= 0 || m <= 0 || bytes > (size_t)optin) return cudaErrorInvalidValue;
  spd_blocked_kernel<<<1, THREADS, bytes, stream>>>(A, B, X, n, m);
  return cudaGetLastError();
}

template <int R>
int launch_simple(const float* A, const float* B, float* X, int n, int m,
                  cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ((size_t)n * (n + 1) / 2 + (m > 1 ? (size_t)n * m : 0));
  static int optin = 0;
  const cudaError_t err = opt_in(spd_simple_kernel<R>, &optin);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  spd_simple_kernel<R><<<1, 32 * K5_WARPS, bytes, stream>>>(A, B, X, n, m);
  return cudaGetLastError();
}

int launch_simple_rows(const float* A, const float* B, float* X, int n, int m,
                       cudaStream_t stream) {
  if (n <= 0 || m <= 0 || n > 32 * MAX_ROWS) return cudaErrorInvalidValue;
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
  return blocked ? launch_blocked(A, B, X, n, m, stream)
                 : launch_simple_rows(A, B, X, n, m, stream);
}
