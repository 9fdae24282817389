// FAST-10 front-end for Hopper: score + strict 3x3 nonmax + threshold
// histograms of every pyramid level and camera of a frame, in one launch.
//
// Replaces: mcptam_tpu/ops/fast_pallas.py::_fast_kernel (via fast_frontend).
// Plain version: mcptam_tpu_torch/ops/fast_kernel.py::fast_frontend_reference.
//
// What bounds it on the H100: bytes, on the roofline.  Per pixel it reads
// one float and writes two (score, nm), 5.8 us for the four levels of a
// 4-camera VGA frame at 3.35 TB/s.  What sets its time is the ring test,
// ~165 min/max instructions a score, latency-bound: about seven times the
// byte bound (PERF.md).  The plain PyTorch version materialises the 16
// ring-shifted copies and a 64-way threshold compare in device memory,
// some fifty passes over the image.
//
// Design:
//  * One launch: a 1-D grid over the tiles of every (level, camera), the
//    levels' sizes and output pointers passed by value.  Levels 1-3 alone
//    are less than a wave of the 132 SMs; together with level 0 they fill
//    the card without a launch each.
//  * A block of 8 warps owns a 30x30 output tile.  It stages the image
//    window (38 rows x 40 columns: the 32x32 score tile and the ring's 3-px
//    halo, its left edge rounded down to 16 bytes) with float4 loads, no
//    divide in the loop.  Lane l scores column x0 - 1 + l, warp w score
//    rows 4w..4w+3: four vertically adjacent centres whose ring loads the
//    compiler shares (13.5 shared loads a score instead of 17).  The 1-px
//    score ring around the output tile is what the 3x3 nonmax reads, so
//    30 of 32 score columns and rows are output; 30 divides every level's
//    height (480, 240, 120, 60).
//  * Arcs by doubling: minima over runs of 2, 4 and 8 ring values, 10 as
//    min(8-run, 2-run), ~80 min/max per polarity; the dark arcs are maxima
//    of the same runs.  min/max are exact and r - c rounds monotonically,
//    so the scores equal the reference's bit for bit.
//  * Bins without contention: a pixel's bin (the number of thresholds
//    t - 1e-6 it passes, 0..64) needs two compares (bin_of).  Scores below
//    1 (bin 1: half the pixels of a rendered frame, most of the nonmax
//    image) are counted by a warp ballot into a register, the other bins,
//    spread over 63 values, by shared-memory atomics.  (Warp-aggregating
//    those with __match_any_sync measured slower on the H100.)
//  * 64 registers a thread, so four blocks share an SM: the scoring is
//    latency-bound, and the compiler's free choice (91, two blocks)
//    measured slower.
//  * Histograms finished in the same launch: each block adds its bins to
//    int32 counts in a persistent scratch; the last block of a (level,
//    camera), found by an atomic ticket after a __threadfence, turns them
//    into the cumulative f32 counts freq[t] = #(bin > t) (exact below 2^24
//    pixels) and zeroes the counts and the ticket for the next launch.
//    The wrapper allocates the scratch zeroed once, so a frame takes one
//    device operation.
//  * Histogram rows: each level counts only its rows [y_lo, y_hi) (all
//    of them by default).  A rank of a row-sharded image scores a slab
//    with halo rows and counts its interior (parallel/mesh.py); the scores
//    and the nonmax are written for every row either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 64;
constexpr int HBINS = NBINS + 1;             // bins 0..64
constexpr int SCRATCH_INTS = 2 * HBINS + 2;  // score and nm counts, the ticket, a pad
constexpr int MAX_LEVELS = 8;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int V = 4;                         // score rows a thread computes
constexpr int SROWS = WARPS * V;             // 32 score rows, 32 score columns
constexpr int OUT_W = 30;                    // output tile
constexpr int OUT_H = SROWS - 2;
constexpr int SW = 40;                       // staged columns: 10 float4
constexpr int SH = SROWS + 6;                // staged rows
constexpr int BORDER = 3;
constexpr unsigned FULL = 0xffffffffu;

struct Level {
  const float* img;                          // (C,H,W)
  float* score;                              // (C,H,W)
  float* nm;                                 // (C,H,W)
  float* freq;                               // (C,64)
  float* freq_nm;                            // (C,64)
  int H, W, tiles_x, tiles;                  // tiles of one camera
  int y_lo, y_hi;                            // rows the histograms count
  int block0;                                // first block of this level
  int vec;                                   // rows 16-byte aligned: float4 staging
};

struct Levels {
  Level lv[MAX_LEVELS];
  int L, C;
};

// FAST-10 max-threshold score of the centre p[0] of a staged tile (row
// stride SW): max over the 16 arcs of (min over 10 contiguous ring
// differences), bright and dark, floored at 0.  Bresenham circle of radius
// 3, clockwise from 12 o'clock (ops/fast.py RING_OFFSETS).  Rounding
// r - c is monotone in r, so the arcs of the differences are the
// differences of the arcs of the ring values: the arcs run on the ring
// values and c is subtracted twice, not sixteen times, bit-exactly.
__device__ __forceinline__ float fast_score(const float* p) {
  const float c = p[0];
  const float d[16] = {
      p[-3 * SW],     p[-3 * SW + 1], p[-2 * SW + 2], p[-SW + 3],
      p[3],           p[SW + 3],      p[2 * SW + 2],  p[3 * SW + 1],
      p[3 * SW],      p[3 * SW - 1],  p[2 * SW - 2],  p[SW - 3],
      p[-3],          p[-SW - 3],     p[-2 * SW - 2], p[-3 * SW - 1]};
  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(d[i], d[(i + 1) & 15]);
    hi2[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo4[i] = fminf(lo2[i], lo2[(i + 2) & 15]);
    hi4[i] = fmaxf(hi2[i], hi2[(i + 2) & 15]);
  }
  float bright = fminf(fminf(lo4[0], lo4[4]), lo2[8]);
  float dark = fmaxf(fmaxf(hi4[0], hi4[4]), hi2[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    bright = fmaxf(bright, fminf(fminf(lo4[i], lo4[(i + 4) & 15]), lo2[(i + 8) & 15]));
    dark = fminf(dark, fmaxf(fmaxf(hi4[i], hi4[(i + 4) & 15]), hi2[(i + 8) & 15]));
  }
  return fmaxf(fmaxf(bright - c, c - dark), 0.0f);
}

__device__ __forceinline__ float threshold(int t) { return __int2float_rn(t) - 1e-6f; }

// number of thresholds t in [0, 64) with s > float(t) - 1e-6f, for s >= 0.
// Every threshold lies in [t - 3e-6, t], so all t < floor(s) pass and all
// t > floor(s) + 1 fail: only floor(s) and floor(s) + 1 need a compare.
__device__ __forceinline__ int bin_of(float s) {
  if (!(s < (float)NBINS)) return NBINS;
  const int f = (int)s;
  return f + (s > threshold(f)) + (f + 1 < NBINS && s > threshold(f + 1));
}

// add bin b (HBINS: no pixel) of every lane to h; bin 1, where half the
// pixels fall, only to the warp's count `ones`
__device__ __forceinline__ void count_bin(int b, int* h, int& ones, int lane) {
  ones += __popc(__ballot_sync(FULL, b == 1));
  const unsigned rest = __ballot_sync(FULL, b != 1 && b < HBINS);
  if (rest >> lane & 1u) atomicAdd(&h[b], 1);
}

__global__ void __launch_bounds__(THREADS, 4)
fast_levels_kernel(const Levels P, int* __restrict__ scratch) {
  __shared__ __align__(16) float tile[SH][SW];
  __shared__ float sc[SROWS][SROWS + 1];
  __shared__ int hist[2][HBINS];
  __shared__ int last;

  // the level, camera and tile of this block
  int l = 0;
#pragma unroll
  for (int q = 1; q < MAX_LEVELS; ++q)
    if (q < P.L && (int)blockIdx.x >= P.lv[q].block0) l = q;
  Level Lv = P.lv[0];
#pragma unroll
  for (int q = 1; q < MAX_LEVELS; ++q)
    if (q == l) Lv = P.lv[q];
  const int r = blockIdx.x - Lv.block0;
  const int cam = r / Lv.tiles;
  const int t = r - cam * Lv.tiles;
  const int ty = t / Lv.tiles_x;
  const int x0 = (t - ty * Lv.tiles_x) * OUT_W, y0 = ty * OUT_H;
  const int H = Lv.H, W = Lv.W;
  const size_t plane = (size_t)H * W;
  const float* im = Lv.img + cam * plane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage rows y0-4 .. y0+33, columns xs .. xs+39 (xs a multiple of 4);
  // a warp pass fills 3 rows of 10 float4, zeros outside the image
  const int xs = (x0 - 4) & ~3, ys = y0 - 4;
  {
    const int sub = lane / 10, c4 = lane - 10 * sub;
    const int gx = xs + 4 * c4;
    if (sub < 3) {
      for (int ly = 3 * warp + sub; ly < SH; ly += 3 * WARPS) {
        const int gy = ys + ly;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gy >= 0 && gy < H) {
          const float* row = im + (size_t)gy * W;
          if (Lv.vec) {
            if (gx >= 0 && gx < W) v = *reinterpret_cast<const float4*>(row + gx);
          } else {
            if (gx >= 0 && gx < W) v.x = row[gx];
            if (gx + 1 >= 0 && gx + 1 < W) v.y = row[gx + 1];
            if (gx + 2 >= 0 && gx + 2 < W) v.z = row[gx + 2];
            if (gx + 3 >= 0 && gx + 3 < W) v.w = row[gx + 3];
          }
        }
        *reinterpret_cast<float4*>(&tile[ly][4 * c4]) = v;
      }
    }
  }
  if (tid < 2 * HBINS) (&hist[0][0])[tid] = 0;
  __syncthreads();

  // scores of the 32x32 tile: column x0-1+lane, rows y0-1+sy; the 3-px
  // image border and everything outside the image score 0
  const int x = x0 - 1 + lane;
  const bool x_in = x >= BORDER && x < W - BORDER;
  const float* centre = &tile[V * warp + BORDER][lane + x0 - 1 - xs];
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int sy = V * warp + v, y = y0 - 1 + sy;
    const float f = fast_score(centre + v * SW);
    s[v] = (x_in && y >= BORDER && y < H - BORDER) ? f : 0.0f;
    sc[sy][lane] = s[v];
  }
  __syncthreads();

  // strict 3x3 maximum, the earlier raster pixel winning a tie; write the
  // 30x30 outputs and bin them
  int ones_s = 0, ones_nm = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int sy = V * warp + v, y = y0 - 1 + sy;
    const bool out = lane >= 1 && lane <= OUT_W && sy >= 1 && sy <= OUT_H && x < W && y < H;
    int b_s = HBINS, b_nm = HBINS;
    if (out) {
      const float c = s[v];
      const bool keep = c > sc[sy - 1][lane - 1] && c > sc[sy - 1][lane] &&
                        c > sc[sy - 1][lane + 1] && c > sc[sy][lane - 1] &&
                        c >= sc[sy][lane + 1] && c >= sc[sy + 1][lane - 1] &&
                        c >= sc[sy + 1][lane] && c >= sc[sy + 1][lane + 1];
      const float n = keep ? c : 0.0f;
      const size_t o = cam * plane + (size_t)y * W + x;
      Lv.score[o] = c;
      Lv.nm[o] = n;
      if (y >= Lv.y_lo && y < Lv.y_hi) {
        b_s = bin_of(c);
        b_nm = bin_of(n);
      }
    }
    count_bin(b_s, hist[0], ones_s, lane);
    count_bin(b_nm, hist[1], ones_nm, lane);
  }
  if (lane == 0) {
    if (ones_s) atomicAdd(&hist[0][1], ones_s);
    if (ones_nm) atomicAdd(&hist[1][1], ones_nm);
  }
  __syncthreads();

  // the block's bins into the (level, camera) counts; the last block of
  // the (level, camera) finishes its histograms
  int* cnt = scratch + (size_t)(l * P.C + cam) * SCRATCH_INTS;
  if (tid < 2 * HBINS) {
    const int c = (&hist[0][0])[tid];
    if (c) atomicAdd(&cnt[tid], c);
  }
  __syncthreads();
  if (tid == 0) {
    // the barrier orders the block's count atomics before this fence, the
    // fence before the ticket (the pattern of a cooperative grid sync)
    __threadfence();
    last = atomicAdd(&cnt[2 * HBINS], 1) == Lv.tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < 2 * HBINS) (&hist[0][0])[tid] = __ldcg(cnt + tid);   // one L2 round
  __syncthreads();
  if (tid <= 2 * HBINS) cnt[tid] = 0;        // the counts and the ticket
  if (tid < 2 * NBINS) {
    const int which = tid / NBINS, th = tid - which * NBINS;
    int acc = 0;
    for (int b = th + 1; b <= NBINS; ++b) acc += hist[which][b];
    (which ? Lv.freq_nm : Lv.freq)[cam * NBINS + th] = (float)acc;
  }
}

}  // namespace

// ptrs: L x (img, score, nm, freq, freq_nm) device pointers, dims: L x (H,
// W, y_lo, y_hi), both host arrays; img, score, nm: (C,H,W) f32, freq,
// freq_nm: (C,64) f32 over the rows [y_lo, y_hi).  scratch: L*C*(2*65+2)
// int32 on the device, zero, left zero.  Returns a cudaError_t.
extern "C" int mcptam_fast_frontend_levels(const long long* ptrs, const int* dims,
                                           int L, int C, int* scratch,
                                           cudaStream_t stream) {
  if (L < 1 || L > MAX_LEVELS || C < 1) return cudaErrorInvalidValue;
  Levels P = {};
  P.L = L;
  P.C = C;
  int blocks = 0;
  for (int l = 0; l < L; ++l) {
    Level& v = P.lv[l];
    v.img = reinterpret_cast<const float*>(ptrs[5 * l]);
    v.score = reinterpret_cast<float*>(ptrs[5 * l + 1]);
    v.nm = reinterpret_cast<float*>(ptrs[5 * l + 2]);
    v.freq = reinterpret_cast<float*>(ptrs[5 * l + 3]);
    v.freq_nm = reinterpret_cast<float*>(ptrs[5 * l + 4]);
    v.H = dims[4 * l];
    v.W = dims[4 * l + 1];
    v.y_lo = dims[4 * l + 2];
    v.y_hi = dims[4 * l + 3];
    if (v.H < 1 || v.W < 1 || v.y_lo < 0 || v.y_lo > v.y_hi || v.y_hi > v.H)
      return cudaErrorInvalidValue;
    v.tiles_x = (v.W + OUT_W - 1) / OUT_W;
    v.tiles = v.tiles_x * ((v.H + OUT_H - 1) / OUT_H);
    v.block0 = blocks;
    v.vec = v.W % 4 == 0 && reinterpret_cast<uintptr_t>(v.img) % 16 == 0;
    blocks += C * v.tiles;
  }
  fast_levels_kernel<<<blocks, THREADS, 0, stream>>>(P, scratch);
  return cudaGetLastError();
}
