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
// n sequential pivot steps, each a block-wide barrier.  One block per
// system keeps the whole chain on one SM with the matrix in shared memory
// and no grid-wide synchronisation.
//
// Design: the working matrix is the packed lower triangle L (row i holds
// columns 0..i contiguously), n(n+1)/2 floats: 166 KB at n = 288, where a
// full n x n matrix (324 KB) would not fit the 227 KB a block may use.
// L is loaded from A's UPPER triangle (L[i][k] = A[k][i]), which is what
// the TPU kernel's row-oriented factor reads.  The right-hand sides live
// in shared memory beside it.  The TPU kernel's 128-padding, lane masks
// and materialised U^T served its (8,128) tiles and have no purpose here.
//  * simple (K5): per column, one thread takes the pivot, the block scales
//    the column, then shares the rank-1 update of the trailing triangle
//    (rows over warps, columns over lanes); the triangular solves update
//    the remaining rows after each pivot.
//  * blocked (K4): panels of 8 columns.  Inside a panel the rank-1 updates
//    touch only the panel's columns; then the trailing triangle takes one
//    rank-8 update, each entry an 8-term dot product of two contiguous
//    panel rows.  The solves are blocked the same way: sequential inside
//    the panel, one rank-8 update of the rows outside it.
// Pivots are clamped at 1e-12 as in the TPU kernel.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int PB = 8;  // panel width of the blocked variant

__device__ __forceinline__ int tri(int i, int k) { return i * (i + 1) / 2 + k; }

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

template <bool BLOCKED>
__global__ void __launch_bounds__(THREADS)
spd_kernel(const float* __restrict__ A, const float* __restrict__ B,
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
  if (!BLOCKED) {
    for (int j = 0; j < n; ++j) {
      pivot(L, j, s_inv);
      const float inv = *s_inv;
      for (int i = j + 1 + tid; i < n; i += THREADS) L[tri(i, j)] *= inv;
      __syncthreads();
      for (int i = j + 1 + warp; i < n; i += nwarps) {
        const float lij = L[tri(i, j)];
        float* row = L + tri(i, 0);
        for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= lij * L[tri(k, j)];
      }
      __syncthreads();
    }
  } else {
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
  }

  // ---- forward solve L y = b (L = U^T)
  if (!BLOCKED) {
    for (int j = 0; j < n; ++j) {
      const float d = fmaxf(L[tri(j, j)], 1e-12f);
      for (int c = tid; c < m; c += THREADS) x[j * m + c] /= d;
      __syncthreads();
      for (int e = tid; e < (n - j - 1) * m; e += THREADS) {
        const int i = j + 1 + e / m, c = e % m;
        x[i * m + c] -= L[tri(i, j)] * x[j * m + c];
      }
      __syncthreads();
    }
  } else {
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
  }

  // ---- back solve U x = y (U[i][j] = L[j][i])
  if (!BLOCKED) {
    for (int j = n - 1; j >= 0; --j) {
      const float d = fmaxf(L[tri(j, j)], 1e-12f);
      for (int c = tid; c < m; c += THREADS) x[j * m + c] /= d;
      __syncthreads();
      const float* lj = L + tri(j, 0);
      for (int e = tid; e < j * m; e += THREADS) {
        const int i = e / m, c = e % m;
        x[i * m + c] -= lj[i] * x[j * m + c];
      }
      __syncthreads();
    }
  } else {
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
  }

  for (int e = tid; e < n * m; e += THREADS) X[e] = x[e];
}

template <bool BLOCKED>
int launch(const float* A, const float* B, float* X, int n, int m,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (4 + (size_t)n * (n + 1) / 2 + (size_t)n * m);
  static int optin = 0;  // raise the dynamic shared-memory cap once
  if (optin == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(spd_kernel<BLOCKED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) {
      optin = 0;
      return err;
    }
  }
  if (n <= 0 || m <= 0 || bytes > (size_t)optin) return cudaErrorInvalidValue;
  spd_kernel<BLOCKED><<<1, THREADS, bytes, stream>>>(A, B, X, n, m);
  return cudaGetLastError();
}

}  // namespace

// A: (n,n) f32 SPD, its upper triangle is read; B, X: (n,m) f32 row-major.
// blocked != 0 selects K4, else K5.  Returns a cudaError_t.
extern "C" int mcptam_spd_solve(const float* A, const float* B, float* X,
                                int n, int m, int blocked, cudaStream_t stream) {
  return blocked ? launch<true>(A, B, X, n, m, stream)
                 : launch<false>(A, B, X, n, m, stream);
}
