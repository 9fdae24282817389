// The tracker's patch search for Hopper, fused: for each of K (camera,
// point) pairs, gather the padded search region out of the packed f32
// atlas, score the 8x8 template by ZMSSD at every offset of the (S,S)
// search square (S = 2R+1), mask, take the first-index argmin and emit the
// (15,15) subpixel window at the best offset, all in one block's shared
// memory and one launch for all pairs.
//
// Replaces: mcptam_tpu/ops/pallas_gather.py::_gather_kernel (K2) on the
// tracker's path, where mcptam_tpu/ops/batch_patch.py::find_patches
// gathers each region through it and XLA fuses the ZMSSD search that
// reads it, and the window cut of subpix_refine_region.
// Plain version: mcptam_tpu_torch/ops/search_kernel.py::search_patches_reference
// (the window gather kernel, then ~40 eager operators).
//
// What bounds it on the H100: bytes.  The fine stage reads K = 1000
// regions of 35x35 f32 (4.9 MB) and writes 1000 windows of 15x15 (0.9 MB):
// ~1.8 us at 3.35 TB/s, while its ~62 MFLOP of 8x8 dot products are ~1 us
// of the f32 rate; the TPU kernel's aligned super-windows, DMA slots and
// rolls served its DMA alignment and have no purpose here.  The unfused
// path wrote each region to HBM and read it back through ~40 operators
// (box sums, a cuDNN depthwise convolution, masks, min) and a second
// gather; here the region never leaves shared memory.
//
// Design: one block of THREADS threads a pair, in phases between block
// barriers.  (1) The region's pixels are read into registers, all of a
// thread's reads in flight at once, and decoded into shared memory
// (region2 = raw - 1024 flag, corner = raw >= 512, the search square's
// flags kept as bytes): one pass, where a cp.async copy would need a
// second to decode.  (2) The 8-wide row sums of pixels and of their
// squares, each in column order, and (3) their column sums
// at every offset, rows in order: the plain _box8 order, so sum_p and
// sum_p2 are bit-exact.  (4) A thread takes a tile of YW x XW offsets,
// reads the (YW+7) x (XW+7) pixels under it a row at a time and forms
// every offset's cross term as 64 FMAs in row-major template order (no
// tensor cores: 8x8 f32 dot products, and TF32 is not allowed), then its
// scores and masks.  (5) The argmin is a (score, index) warp shuffle,
// then one across the warps, and (6) the window is cut out of the
// decoded region.  Scores and masks follow the plain expression order with
// round-to-nearest intrinsics, so that nvcc contracts nothing into an FMA
// the plain version does not have; the one difference left is the order
// of the cross term's (and of the template sums') additions.  The pair's
// scalars wait in shared memory between phases, and MIN_BLOCKS caps the
// registers so that the fine stage's pairs fill the card in one wave.
// What costs on this card is latency: a block's phases run one after
// another, and eight blocks an SM do not hide it (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
// blocks an SM must hold: the fine stage's 1000 pairs fill the 132 SMs in
// one wave at 8, which caps a thread at 64 registers
constexpr int MIN_BLOCKS = 8;
constexpr int XW = 2;                    // a thread's offsets along a row
constexpr int YW = 3;                    // and along a column
constexpr int LEVELS = 4;                // config.LEVELS
// region elements a thread loads at once: the fine stage's 35x35 region
// in one chunk
constexpr int LOADS = (35 * 35 + THREADS - 1) / THREADS;
constexpr int PS = 8;                    // PATCH_SIZE
constexpr int HALF = PS / 2;
constexpr int PAD = 3;                   // ops/patch.py _SUBPIX_PAD
constexpr int WSZ = PS + 1 + 2 * PAD;    // the subpixel window, 15
constexpr float PACK_CORNER = 1024.0f;
constexpr unsigned FULL = 0xffffffffu;
// a tile at the square's last row or column reads PAD + YW + PS rows (one
// of them prefetched) and PAD + XW + PS - 2 columns past its first offset:
// inside the region's S + PS + 2 PAD while YW <= 2 PAD - 2, XW <= 2 PAD - 1
static_assert(XW <= 2 * PAD - 1 && YW <= 2 * PAD - 2, "tiles overrun the region");

// (score, index) a is better than b: a lower score, or an equal one at a
// lower index (the first index of the minimum)
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia < ib);
}

// the pair's scalars, kept in shared memory from the prologue to the
// scores and the outputs, so that no register holds them meanwhile
struct Pair {
  long long cxi, cyi;          // the rounded level-local prediction
  float plx, ply;              // the level-local prediction
  float r2;                    // r_lev^2 + 1e-6; -1 where the region was clamped
  float x_lim, y_lim;          // w_l - HALF, h_l - HALF
  float scale;                 // 2^level
  float sum_t, sum_t2;         // the template's sums
  int region_ok, any_offset;
};
constexpr int PAIR_FLOATS = 16;
static_assert(sizeof(Pair) <= 4 * PAIR_FLOATS, "Pair outgrew its room");

// an array over the search square, plus the rows and columns a tile past
// its edge reads
__host__ __device__ __forceinline__ int square_size(int S) { return (S + YW) * S + XW; }

// shared memory in floats ahead of the corner flags: the pair's scalars,
// the template, the region (G2 x G2), the row sums of pixels and of
// squares (G x S each), their column sums (sum_p and sum_p2 over the
// square) and the argmin's per-warp candidates
__host__ __device__ __forceinline__ int front_floats(int S) {
  const int G = S + PS, G2 = G + 2 * PAD;
  return PAIR_FLOATS + PS * PS + ((G2 * G2 + 3) / 4) * 4 + 2 * G * S + 2 * square_size(S) +
         2 * NW + 2;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
search_kernel(const float* __restrict__ atlas, const int64_t* __restrict__ cam_idx,
              const int64_t* __restrict__ level, const float* __restrict__ tmpl,
              const float* __restrict__ pred, const int64_t* __restrict__ hs,
              const int64_t* __restrict__ ws, const int64_t* __restrict__ xoff,
              const bool* __restrict__ exh, int exh_all,
              const float* __restrict__ max_range, float max_range_val, float max_ssd,
              int H, int AW, int R,
              bool* __restrict__ found, float* __restrict__ pos_l0,
              float* __restrict__ best_ssd, int64_t* __restrict__ by_out,
              int64_t* __restrict__ bx_out, bool* __restrict__ ok_out,
              float* __restrict__ win, float* __restrict__ box, int K) {
  extern __shared__ float4 smem4[];
  const int S = 2 * R + 1, G = S + PS, G2 = G + 2 * PAD;
  Pair* P = reinterpret_cast<Pair*>(smem4);
  float* tm = reinterpret_cast<float*>(smem4) + PAIR_FLOATS;   // 64, 16-byte aligned
  float* reg = tm + PS * PS;                               // G2 x G2
  float* hsum = reg + ((G2 * G2 + 3) / 4) * 4;             // G x S
  float* hsum2 = hsum + G * S;                             // G x S
  float* vsum = hsum2 + G * S;                             // square_size
  float* vsum2 = vsum + square_size(S);                    // square_size
  float* red_s = vsum2 + square_size(S);                   // NW
  int* red_i = reinterpret_cast<int*>(red_s + NW);         // NW + 1
  unsigned char* cflag =
      reinterpret_cast<unsigned char*>(reinterpret_cast<float*>(smem4) + front_floats(S));

  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the pair's level-local prediction, search radius and clamped region
  // start, in the plain version's operation order (64-bit integer starts
  // as torch's int64, so a non-finite prediction wraps the same way); the
  // per-level tables are read whole, beside the pair's own values, so that
  // no load waits on another
  const int lvl = static_cast<int>(level[k]);
  long long xo[LEVELS];
  int hl[LEVELS], wl[LEVELS];
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    xo[l] = xoff[l];
    hl[l] = static_cast<int>(hs[l]);
    wl[l] = static_cast<int>(ws[l]);
  }
  long long xoff_l = xo[0];
  int h_l = hl[0], w_l = wl[0];
#pragma unroll
  for (int l = 1; l < LEVELS; ++l)
    if (lvl == l) {
      xoff_l = xo[l];
      h_l = hl[l];
      w_l = wl[l];
    }
  const float scale = exp2f(static_cast<float>(lvl));
  const float plx = __fsub_rn(__fdiv_rn(__fadd_rn(pred[2 * k], 0.5f), scale), 0.5f);
  const float ply = __fsub_rn(__fdiv_rn(__fadd_rn(pred[2 * k + 1], 0.5f), scale), 0.5f);
  const float r_lev = ceilf(__fdiv_rn(max_range ? *max_range : max_range_val, scale));
  const long long cxi = __float2ll_rn(plx), cyi = __float2ll_rn(ply);
  const long long y0 = static_cast<long long>(
      static_cast<unsigned long long>(cyi) - static_cast<unsigned long long>(R + HALF + PAD));
  const long long ax0 = static_cast<long long>(
      static_cast<unsigned long long>(cxi) - static_cast<unsigned long long>(R + HALF + PAD) +
      static_cast<unsigned long long>(xoff_l));
  const bool region_ok = y0 >= 0 && ax0 >= 0 && y0 + G2 <= H && ax0 + G2 <= AW;
  const long long yc = y0 < 0 ? 0 : (y0 > H - G2 ? H - G2 : y0);
  const long long xc = ax0 < 0 ? 0 : (ax0 > AW - G2 ? AW - G2 : ax0);
  const float* src = atlas + (static_cast<size_t>(cam_idx[k]) * H + yc) * AW + xc;
  if (tid == 0) {
    P->cxi = cxi;
    P->cyi = cyi;
    P->plx = plx;
    P->ply = ply;
    P->r2 = region_ok ? __fadd_rn(__fmul_rn(r_lev, r_lev), 1e-6f) : -1.0f;
    P->x_lim = static_cast<float>(w_l) - HALF;
    P->y_lim = static_cast<float>(h_l) - HALF;
    P->scale = scale;
    P->region_ok = region_ok;
    P->any_offset = exh ? exh[k] : exh_all != 0;
  }

  // (1) the region into registers, a thread's reads of a chunk of LOADS x
  // THREADS elements in flight at once (element e = r G2 + c, e = tid +
  // THREADS t, its (r, c) carried from step to step), then decoded into
  // shared memory with the search square's corner flags: one pass, no copy
  // of the raw region.  One chunk up to R = 10.
  constexpr int F0 = PAD + HALF;           // region row / column of offset 0's corner test
  const int step_r = THREADS / G2, step_c = THREADS - step_r * G2;
  {
    int r = tid / G2, c = tid - r * G2;
    for (int e0 = 0; e0 < G2 * G2; e0 += LOADS * THREADS) {
      float raw[LOADS];
      int rl = r, cl = c;
#pragma unroll
      for (int t = 0; t < LOADS; ++t) {
        raw[t] = e0 + tid + t * THREADS < G2 * G2 ? __ldg(src + (size_t)rl * AW + cl) : 0.0f;
        rl += step_r;
        cl += step_c;
        if (cl >= G2) {
          cl -= G2;
          ++rl;
        }
      }
      if (e0 == 0) {
        if (tid < PS * PS / 4)
          reinterpret_cast<float4*>(tm)[tid] =
              __ldg(reinterpret_cast<const float4*>(tmpl + (size_t)k * PS * PS) + tid);
        for (int e = tid; e < square_size(S); e += THREADS) cflag[e] = 0;
        __syncthreads();                   // the flags are zero before any is set
      }
#pragma unroll
      for (int t = 0; t < LOADS; ++t) {
        const int e = e0 + tid + t * THREADS;
        if (e < G2 * G2) {
          const bool flag = raw[t] >= 0.5f * PACK_CORNER;
          reg[e] = flag ? __fsub_rn(raw[t], PACK_CORNER) : raw[t];
          const int fy = r - F0, fx = c - F0;
          if (fy >= 0 && fy < S && fx >= 0 && fx < S) cflag[fy * S + fx] = flag;
        }
        r += step_r;
        c += step_c;
        if (c >= G2) {
          c -= G2;
          ++r;
        }
      }
    }
  }
  __syncthreads();
  // the template's sums, by warp 0 while the others go on
  if (warp == 0) {
    const float a = tm[lane], b = tm[lane + 32];
    float st = __fadd_rn(a, b), st2 = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      st = __fadd_rn(st, __shfl_xor_sync(FULL, st, off));
      st2 = __fadd_rn(st2, __shfl_xor_sync(FULL, st2, off));
    }
    if (lane == 0) {
      P->sum_t = st;
      P->sum_t2 = st2;
    }
  }

  // (2) 8-wide row sums of the region (rows PAD .. PAD+G-1, columns from PAD),
  // summed in column order as _box8's first pass; item q = r S + x
  {
    const int sr = THREADS / S, sx = THREADS - sr * S;
    int r = tid / S, x = tid - r * S;
#pragma unroll 2
    for (int q = tid; q < G * S; q += THREADS) {
      const float* p = reg + (PAD + r) * G2 + PAD + x;
      float s = p[0], s2 = __fmul_rn(p[0], p[0]);
#pragma unroll
      for (int px = 1; px < PS; ++px) {
        s = __fadd_rn(s, p[px]);
        s2 = __fadd_rn(s2, __fmul_rn(p[px], p[px]));
      }
      hsum[q] = s;
      hsum2[q] = s2;
      r += sr;
      x += sx;
      if (x >= S) {
        x -= S;
        ++r;
      }
    }
  }
  __syncthreads();

  // (3) column sums of 8 row sums, rows in order as _box8's second pass:
  // sum_p and sum_p2 at every offset of the square; item q = y S + x
  {
    const int sy = THREADS / S, sx = THREADS - sy * S;
    int y = tid / S, x = tid - y * S;
#pragma unroll 2
    for (int q = tid; q < S * S; q += THREADS) {
      const float* h = hsum + q;
      const float* h2 = hsum2 + q;
      float sp = h[0], sp2 = h2[0];
#pragma unroll
      for (int py = 1; py < PS; ++py) {
        sp = __fadd_rn(sp, h[py * S]);
        sp2 = __fadd_rn(sp2, h2[py * S]);
      }
      vsum[q] = sp;
      vsum2[q] = sp2;
      if (box) {
        box[((size_t)k * S + y) * S + x] = sp;
        box[(((size_t)K + k) * S + y) * S + x] = sp2;
      }
      y += sy;
      x += sx;
      if (x >= S) {
        x -= S;
        ++y;
      }
    }
  }
  __syncthreads();

  // (4) scores over a YW x XW tile of offsets a thread, its best (score,
  // index) kept
  const float4* tm4 = reinterpret_cast<const float4*>(tm);
  const int NGX = (S + XW - 1) / XW, NGY = (S + YW - 1) / YW;
  float bs = INFINITY;
  int bi = 0x7fffffff;
  for (int it = tid; it < NGX * NGY; it += THREADS) {
    const int ty = it / NGX;
    const int oy = ty * YW, ox = (it - ty * NGX) * XW;
    float cross[YW][XW];
#pragma unroll
    for (int j = 0; j < YW; ++j)
#pragma unroll
      for (int i = 0; i < XW; ++i) cross[j][i] = 0.0f;
    const float* base = reg + (PAD + oy) * G2 + PAD + ox;
    // a region row at a time, not unrolled: the tile's accumulators, one
    // row of pixels (the next one loading meanwhile) and one template row
    // stay in registers
    float v[XW + PS - 1];
#pragma unroll
    for (int q = 0; q < XW + PS - 1; ++q) v[q] = base[q];
#pragma unroll 1
    for (int rr = 0; rr < YW + PS - 1; ++rr) {
      float vn[XW + PS - 1];
#pragma unroll
      for (int q = 0; q < XW + PS - 1; ++q) vn[q] = base[(rr + 1) * G2 + q];
#pragma unroll
      for (int j = 0; j < YW; ++j) {
        const int py = rr - j;               // template row of tile row j
        if (py < 0 || py >= PS) continue;
        const float4 ta = tm4[2 * py], tb = tm4[2 * py + 1];
        const float t[PS] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
        for (int px = 0; px < PS; ++px)
#pragma unroll
          for (int i = 0; i < XW; ++i) cross[j][i] = fmaf(t[px], v[px + i], cross[j][i]);
      }
#pragma unroll
      for (int q = 0; q < XW + PS - 1; ++q) v[q] = vn[q];
    }
    // the masks' row and column parts; the pair's scalars
    const float sum_t = P->sum_t, sum_t2 = P->sum_t2, r2 = P->r2;
    const float plx = P->plx, ply = P->ply, x_lim = P->x_lim, y_lim = P->y_lim;
    const float fcx = static_cast<float>(P->cxi), fcy = static_cast<float>(P->cyi);
    const bool any_offset = P->any_offset;
    float dy2[YW];
    bool y_ok[YW];
#pragma unroll
    for (int j = 0; j < YW; ++j) {
      const float yy = __fadd_rn(fcy, static_cast<float>(oy + j - R));
      const float dy = __fsub_rn(yy, ply);
      dy2[j] = __fmul_rn(dy, dy);
      y_ok[j] = oy + j < S && yy >= HALF && yy < y_lim;
    }
#pragma unroll
    for (int i = 0; i < XW; ++i) {
      const int x = ox + i;
      const float xx = __fadd_rn(fcx, static_cast<float>(x - R));
      const float dx = __fsub_rn(xx, plx);
      const float dx2 = __fmul_rn(dx, dx);
      const bool x_ok = x < S && xx >= HALF && xx < x_lim;
#pragma unroll
      for (int j = 0; j < YW; ++j) {
        const int y = oy + j;
        const float sp = vsum[y * S + x], sp2 = vsum2[y * S + x];
        // (sum_p - sum_t)^2 / 64, the division exact as a product
        const float d = __fsub_rn(sp, sum_t);
        const float score = __fsub_rn(
            __fadd_rn(__fsub_rn(sp2, __fmul_rn(2.0f, cross[j][i])), sum_t2),
            __fmul_rn(__fmul_rn(d, d), 1.0f / (PS * PS)));
        const bool valid = x_ok && y_ok[j] && __fadd_rn(dy2[j], dx2) <= r2 &&
                           (cflag[y * S + x] || any_offset);
        const float sc = valid ? score : INFINITY;
        const int idx = y * S + x;
        if ((x < S && y < S) && better(sc, idx, bs, bi)) {
          bs = sc;
          bi = idx;
        }
      }
    }
  }

  // (5) first-index argmin: across the warp, then across the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(FULL, bs, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (better(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_s[warp] = bs;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bs = lane < NW ? red_s[lane] : INFINITY;
    bi = lane < NW ? red_i[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_i[NW] = bi;
      const int by = bi / S, bx = bi - by * S;
      found[k] = bs < max_ssd;
      best_ssd[k] = bs;
      by_out[k] = by;
      bx_out[k] = bx;
      ok_out[k] = P->region_ok;
      const float qx = static_cast<float>(static_cast<long long>(
          static_cast<unsigned long long>(P->cxi) + static_cast<unsigned long long>(bx - R)));
      const float qy = static_cast<float>(static_cast<long long>(
          static_cast<unsigned long long>(P->cyi) + static_cast<unsigned long long>(by - R)));
      pos_l0[2 * k] = __fsub_rn(__fmul_rn(__fadd_rn(qx, 0.5f), P->scale), 0.5f);
      pos_l0[2 * k + 1] = __fsub_rn(__fmul_rn(__fadd_rn(qy, 0.5f), P->scale), 0.5f);
    }
  }
  __syncthreads();

  // (6) the subpixel window at the best offset, out of the decoded region
  const int bb = red_i[NW];
  const int by = bb / S, bx = bb - by * S;
  float* w = win + (size_t)k * WSZ * WSZ;
  for (int e = tid; e < WSZ * WSZ; e += THREADS) {
    const int i = e / WSZ, j = e - i * WSZ;
    w[e] = reg[(by + i) * G2 + bx + j];
  }
}

}  // namespace

// atlas: (C,H,AW) f32 packed corner atlas; cam_idx, level: (K,) int64;
// tmpl: (K,8,8) f32, 16-byte aligned; pred: (K,2) f32 level-0 predictions;
// hs, ws, xoff: (LEVELS,) int64 level heights, widths and atlas offsets;
// exh: (K,) bool or null, then exh_all for every pair; max_range: a f32
// scalar on the device or null, then max_range_val.  Outputs: found,
// region_ok (K,) bool; pos_l0 (K,2), best_ssd (K,) f32; by, bx (K,) int64;
// win (K,15,15) f32; box (2,K,S,S) f32 sum_p and sum_p2, or null.
// Returns a cudaError_t.
extern "C" int mcptam_search_patches(
    const float* atlas, const int64_t* cam_idx, const int64_t* level, const float* tmpl,
    const float* pred, const int64_t* hs, const int64_t* ws, const int64_t* xoff,
    const bool* exh, int exh_all, const float* max_range, float max_range_val,
    float max_ssd, int K, int H, int AW, int R, bool* found, float* pos_l0,
    float* best_ssd, int64_t* by, int64_t* bx, bool* region_ok, float* win, float* box,
    cudaStream_t stream) {
  const int S = 2 * R + 1, G2 = S + PS + 2 * PAD;
  if (R < 0 || G2 > H || G2 > AW) return cudaErrorInvalidValue;
  if (K == 0) return cudaSuccess;
  const size_t bytes = sizeof(float) * front_floats(S) + square_size(S);
  static size_t optin = 48 * 1024;
  if (bytes > optin) {
    const cudaError_t err = cudaFuncSetAttribute(
        search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    optin = bytes;
  }
  search_kernel<<<K, THREADS, bytes, stream>>>(
      atlas, cam_idx, level, tmpl, pred, hs, ws, xoff, exh, exh_all, max_range, max_range_val,
      max_ssd, H, AW, R, found, pos_l0, best_ssd, by, bx, region_ok, win, box, K);
  return cudaGetLastError();
}
