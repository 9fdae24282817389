// MiniPatch's round-trip stability search for Hopper, fused: for each of K
// candidates, take the current frame's 9x9 template at the rounded
// candidate, search the previous frame's 29x29 region for it at every
// offset of radius 10 (plain SSD, bounds mask, first-index argmin), take
// the previous frame's template at the position found, search the current
// frame for it the same way, and keep the candidate when it returns within
// tol px.  One launch for every candidate of a frame.
//
// Replaces: scripts/profile_gather.py::_unaligned_kernel (K8) on
// MiniPatch's path, where mcptam_tpu/ops/minipatch.py::stability_filter
// reads each template and region and XLA fuses the SSD search that
// follows.  Plain version: mcptam_tpu_torch/ops/minipatch_kernel.py::
// stability_reference (the windows through K8's plain gather, then ~250
// eager operators a search: the 81-term SSD as sub, square and add).
// Windows follow K8's contract (csrc/gather_unaligned.cu): a window's start
// is clipped to [0, HH] x [0, AW] of the plane and pixels past the plane
// read as zero, so even a window outside its image holds what the plain
// version reads.
//
// What bounds it on the H100: operations.  At the live path's shape (4
// cameras x (512 + 256 + 128 + 64) = 3840 candidates, two (1920, 1248)
// planes) the planes are 19.2 MB, 5.7 us at 3.35 TB/s, while two searches
// a candidate of 441 offsets x 81 terms x 3 operations are 8.2e8, 12.3 us
// at 67 TFLOP/s (chip_smoke.bound's convention).  The terms cannot become
// FMAs: the plain version rounds the difference, the square and the sum
// each on its own, and the result must be bit-exact.  So three f32 issues
// a term, at 128 lanes an SM, take >= 24.6 us when every search runs.
// Invalid candidates and return searches that cannot change the result
// are skipped, which counts against the bound too (the bound is reckoned
// from the searches the data needs).
//
// Design: one warp a candidate, WARPS warps a block, no block barrier.
// The warp's slice of shared memory holds the region and the template
// (3.7 KB).  A lane takes two of the 63 segments of SEG = 7 consecutive
// offsets of a row; for each template row it reads the SPAN = 15 region
// pixels under its segment into registers once and forms the segment's 63
// terms from them (7 accumulators, in the plain py-major, px-minor order,
// with the _rn intrinsics so that nvcc contracts nothing into an FMA).
// Each lane keeps its first minimum in flat-index order, and a shuffle
// butterfly that prefers the lower index on an equal SSD makes the warp's
// argmin; every lane ends with it, so the same warp runs the return
// search without a broadcast.  A warp whose candidate is invalid exits at
// once; one whose template, first search or return template failed skips
// the return search (kept is False either way).  Only __syncwarp orders
// the shared reads.  What costs on this card (scripts/minipatch_phases.py,
// PERF.md): the first window load, when every warp asks for its windows at
// once, and the SMs' unequal shares of the searches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // candidates a block, a warp each
constexpr int HALF = 4;                  // MINI_HALF
constexpr int T = 2 * HALF + 1;          // the 9x9 template
constexpr int R = 10;                    // STABILITY_RADIUS
constexpr int S = 2 * R + 1;             // 21 offsets a side
constexpr int G = S + T - 1;             // the 29x29 region
constexpr int SEG = 7;                   // offsets of a row a lane takes at once
constexpr int SEGS = S / SEG;            // segments a row
constexpr int NSEG = S * SEGS;           // 63: two a lane, one for lane 31
constexpr int SPAN = SEG + T - 1;        // region pixels under a segment, a row
constexpr unsigned FULL = 0xffffffffu;
static_assert(S % SEG == 0, "segments must tile a row of offsets");
static_assert(WARPS * (G * G + T * T) * 4 <= 48 * 1024,
              "the warps' slices must fit static shared memory");

struct Best {
  float ssd;
  int idx;
};

__device__ __forceinline__ bool inside(int y0, int x0, int size, int h, int w) {
  return y0 >= 0 && x0 >= 0 && y0 + size <= h && x0 + size <= w;
}

// A SIZE x SIZE window of the plane at (r, c) under K8's contract, into the
// warp's shared slice: every lane's loads in flight at once, then stored.
template <int SIZE>
__device__ __forceinline__ void load_window(float* dst,
                                            const float* __restrict__ plane,
                                            int r, int c, int HH, int AW,
                                            int lane) {
  constexpr int N = SIZE * SIZE;
  constexpr int ITS = (N + 31) / 32;
  r = min(max(r, 0), HH);
  c = min(max(c, 0), AW);
  float v[ITS];
#pragma unroll
  for (int it = 0; it < ITS; ++it) {
    const int e = lane + 32 * it;
    const int i = e / SIZE, j = e - (e / SIZE) * SIZE;
    const bool in = e < N && r + i < HH && c + j < AW;
    v[it] = in ? __ldg(plane + (size_t)(r + i) * AW + (c + j)) : 0.0f;
  }
#pragma unroll
  for (int it = 0; it < ITS; ++it) {
    const int e = lane + 32 * it;
    if (e < N) dst[e] = v[it];
  }
}

// The template's SSD at every offset of the region around (cx, cy), masked
// where the offset leaves the image's 4-px border or the region left the
// image, and the warp's first-index argmin; every lane returns it.
__device__ __forceinline__ Best search(const float* region, const float* tmpl,
                                       bool rok, int cx, int cy, int h, int w,
                                       int lane) {
  float best = INFINITY;
  int bidx = S * S;                      // past every offset: loses every tie
  if (rok) {
    for (int s = lane; s < NSEG; s += 32) {
      const int oy = s / SEGS;
      const int ox0 = (s - oy * SEGS) * SEG;
      float acc[SEG];
#pragma unroll
      for (int j = 0; j < SEG; ++j) acc[j] = 0.0f;   // 0 + the first term is exact
      const float* row = region + oy * G + ox0;
#pragma unroll 1
      for (int py = 0; py < T; ++py, row += G) {
        float v[SPAN];
#pragma unroll
        for (int i = 0; i < SPAN; ++i) v[i] = row[i];
#pragma unroll
        for (int px = 0; px < T; ++px) {
          const float t = tmpl[py * T + px];
#pragma unroll
          for (int j = 0; j < SEG; ++j) {
            const float d = __fsub_rn(v[j + px], t);
            acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
          }
        }
      }
      const int yy = cy + oy - R;
      const bool row_in = yy >= HALF && yy < h - HALF;
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const int xx = cx + ox0 + j - R;
        const float v = (row_in && xx >= HALF && xx < w - HALF) ? acc[j] : INFINITY;
        if (v < best) {                  // a lane's offsets come in index order
          best = v;
          bidx = oy * S + ox0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bidx, o);
    if (ob < best || (ob == best && oi < bidx)) {
      best = ob;
      bidx = oi;
    }
  }
  // every offset masked: argmin of an all-inf row is index 0
  return {best, bidx == S * S ? 0 : bidx};
}

__global__ void __launch_bounds__(WARPS * 32)
stability_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                 const int4* __restrict__ desc, const float2* __restrict__ xy,
                 const bool* __restrict__ valid, int K, int HH, int AW,
                 float max_ssd, float tol, bool* __restrict__ kept,
                 bool* __restrict__ ran, bool* __restrict__ found,
                 float2* __restrict__ pos, float* __restrict__ ssd) {
  __shared__ float s_region[WARPS][G * G];
  __shared__ float s_tmpl[WARPS][T * T];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= K) return;
  if (!valid[k]) {
    if (lane == 0) {
      kept[k] = false;
      ran[k] = ran[K + k] = found[k] = found[K + k] = false;
      pos[k] = pos[K + k] = make_float2(0.0f, 0.0f);
      ssd[k] = ssd[K + k] = NAN;
    }
    return;
  }
  float* region = s_region[warp];
  float* tmpl = s_tmpl[warp];
  const int4 d = desc[k];                // row0, col0, h, w
  const float2 c = xy[k];

  // (1) the current frame's template at the rounded candidate (half to
  // even, as torch.round) and the previous frame's region around it
  const int x1 = __float2int_rn(c.x), y1 = __float2int_rn(c.y);
  const bool t_ok = inside(y1 - HALF, x1 - HALF, T, d.z, d.w);
  const bool rok1 = inside(y1 - R - HALF, x1 - R - HALF, G, d.z, d.w);
  load_window<T>(tmpl, cur, d.x + y1 - HALF, d.y + x1 - HALF, HH, AW, lane);
  if (rok1)
    load_window<G>(region, prev, d.x + y1 - R - HALF, d.y + x1 - R - HALF, HH, AW, lane);
  __syncwarp();
  // (2) the search into the previous frame
  const Best b1 = search(region, tmpl, rok1, x1, y1, d.z, d.w, lane);
  const bool f1 = b1.ssd < max_ssd;
  const int x2 = x1 + b1.idx % S - R, y2 = y1 + b1.idx / S - R;

  // the previous frame's template there is searched for back in the
  // current frame, unless the result is already False
  const bool tp_ok = inside(y2 - HALF, x2 - HALF, T, d.z, d.w);
  const bool go = t_ok && f1 && tp_ok;
  bool f2 = false, back = false;
  float ssd2 = NAN;
  float2 p3 = make_float2(0.0f, 0.0f);
  if (go) {                              // uniform over the warp
    __syncwarp();                        // the first search's reads are done
    // (3) the previous frame's template and the current frame's region
    const bool rok2 = inside(y2 - R - HALF, x2 - R - HALF, G, d.z, d.w);
    load_window<T>(tmpl, prev, d.x + y2 - HALF, d.y + x2 - HALF, HH, AW, lane);
    if (rok2)
      load_window<G>(region, cur, d.x + y2 - R - HALF, d.y + x2 - R - HALF, HH, AW, lane);
    __syncwarp();
    // (4) the return search
    const Best b2 = search(region, tmpl, rok2, x2, y2, d.z, d.w, lane);
    f2 = b2.ssd < max_ssd;
    ssd2 = b2.ssd;
    p3 = make_float2((float)(x2 + b2.idx % S - R), (float)(y2 + b2.idx / S - R));
    const float dx = __fsub_rn(p3.x, c.x), dy = __fsub_rn(p3.y, c.y);
    const float err = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    back = f2 && err <= tol;
  }
  // (5) the results
  if (lane == 0) {
    kept[k] = back;
    ran[k] = true;
    ran[K + k] = go;
    found[k] = f1;
    found[K + k] = f2;
    pos[k] = make_float2((float)x2, (float)y2);
    pos[K + k] = p3;
    ssd[k] = b1.ssd;
    ssd[K + k] = ssd2;
  }
}

}  // namespace

// prev, cur: (HH,AW) f32 planes of one layout; desc: (K,4) int32 (row0,
// col0, h, w), 16-byte aligned; xy: (K,2) f32 (x, y), 8-byte aligned;
// valid: (K,) bool.  Outputs: kept (K,) bool; ran, found (2,K) bool; pos
// (2,K,2) f32; ssd (2,K) f32 (row 0 the search into prev, row 1 back).
// Returns a cudaError_t.
extern "C" int mcptam_stability_search(const float* prev, const float* cur,
                                       const int* desc, const float* xy,
                                       const bool* valid, int K, int HH, int AW,
                                       float max_ssd, float tol, bool* kept,
                                       bool* ran, bool* found, float* pos,
                                       float* ssd, cudaStream_t stream) {
  if (K == 0) return cudaSuccess;
  const int blocks = (K + WARPS - 1) / WARPS;
  stability_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      prev, cur, reinterpret_cast<const int4*>(desc),
      reinterpret_cast<const float2*>(xy), valid, K, HH, AW, max_ssd, tol, kept,
      ran, found, reinterpret_cast<float2*>(pos), ssd);
  return cudaGetLastError();
}
