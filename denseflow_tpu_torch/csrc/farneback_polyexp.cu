// Farneback polynomial expansion of every pyramid level of a batch of
// images in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel denseflow_tpu/kernels/farneback_fused.py::
// poly_expand_fused (pallas_call in _polyexp_call, body
// _make_polyexp_kernel). Each pixel's (2n+1)^2 neighbourhood, replicate-
// padded at the image border, is fit with a quadratic under separable
// Gaussian weights: one vertical pass makes three projections (g, x*g,
// x^2*g), horizontal passes make the six S1, Sx, Sy, Sxx, Syy, Sxy, each sum
// taken over the 2n+1 taps in ascending order from the first term, and the
// sparse inverse normal matrix gives channel-first (bx, by, cxx, cyy, cxy).
//
// The JAX package falls back to XLA above a padded plane of 272x384
// (polyexp_fused_fits) and expands one level a call; this kernel covers
// every size with one code path, and every level of a call in one launch.
//
// Design: one thread block per 32x32 output tile of one image of one level.
// The levels' tiles are laid end to end along a 1-D grid; the level table
// (kernel parameters: in and out pointers, images, h, w and each level's
// first block) tells a block its level, image and tile. The block stages
// the replicate-padded (32+2n)^2 input tile in shared memory, runs the
// vertical pass over all 32+2n columns into shared memory, then the
// horizontal pass for its outputs. Reads are clamped into the level and
// writes masked to it, so a tile larger than its level (8x11) stays inside.
// Every output is written once and every input read about 1.7 times (the
// halo); no state crosses blocks. Shared memory is sized for the call's n.
//
// What bounds it: bytes at the finest levels, barely. Per pixel (poly_n =
// 5) the vertical pass does 3 * 21 f32 ops, the horizontal passes 6 * 21 and
// the combination 13: 202 ops against 24 bytes (one image read, five
// coefficients written), 8.4 ops per byte, below the H100's 20 (67 TFLOP/s
// over 3.35 TB/s). A slab's levels are small, so one launch in place of six
// saves more than any change to the tile.
//
// Built with --fmad=false: each product and sum rounded on its own, as in
// the plain PyTorch version (kernels/farneback_fused.py::
// poly_expand_reference), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kMaxN = 10;  // poly_n up to 10: 21 taps
constexpr int kMaxTaps = 2 * kMaxN + 1;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;  // levels a launch takes

struct PolyConsts {
  int n;
  float g[kMaxTaps], xg[kMaxTaps], xxg[kMaxTaps];
  // the nonzero entries of the inverse normal matrix over (1, x, y, x^2,
  // y^2, xy): ig[i][j] of denseflow_tpu/algorithms/farneback._poly_exp_setup
  float ig11, ig22, ig30, ig33, ig34, ig40, ig43, ig44, ig55;
};

struct Levels {
  int count;
  const float* in[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  int first[kMaxLevels + 1];  // the first block of each level; first[count] = all
};

int tiles(int n) { return (n + kTile - 1) / kTile; }

__global__ void __launch_bounds__(kThreads)
polyexp_kernel(const __grid_constant__ Levels L,
               const __grid_constant__ PolyConsts C) {
  extern __shared__ float smem[];
  int lv = 0;
  while (lv + 1 < L.count && (int)blockIdx.x >= L.first[lv + 1]) ++lv;
  const int h = L.h[lv], w = L.w[lv];
  const int tx_n = (w + kTile - 1) / kTile, ty_n = (h + kTile - 1) / kTile;
  int t = (int)blockIdx.x - L.first[lv];
  const int img = t / (tx_n * ty_n);
  t -= img * tx_n * ty_n;
  const int ty = t / tx_n, tx = t - ty * tx_n;

  const int n = C.n, taps = 2 * n + 1;
  const int span = kTile + 2 * n;  // tile extent with its halo
  float* const tile = smem;
  float* const vbuf = smem + span * span;  // three planes of kTile x span
  const int vplane = kTile * span;
  const int y0 = ty * kTile, x0 = tx * kTile;
  const size_t plane = (size_t)h * w;
  const float* src = L.in[lv] + img * plane;
  const int tid = threadIdx.x;

  for (int i = tid; i < span * span; i += kThreads) {
    const int r = i / span, c = i - r * span;
    const int gy = min(max(y0 + r - n, 0), h - 1);
    const int gx = min(max(x0 + c - n, 0), w - 1);
    tile[i] = src[(size_t)gy * w + gx];
  }
  __syncthreads();

  // vertical pass: one load per tap feeds all three projections
  for (int i = tid; i < vplane; i += kThreads) {
    const int r = i / span, c = i - r * span;
    const float s0 = tile[r * span + c];
    float vg = C.g[0] * s0, vxg = C.xg[0] * s0, vxxg = C.xxg[0] * s0;
    for (int j = 1; j < taps; ++j) {
      const float s = tile[(r + j) * span + c];
      vg = vg + C.g[j] * s;
      vxg = vxg + C.xg[j] * s;
      vxxg = vxxg + C.xxg[j] * s;
    }
    vbuf[i] = vg;
    vbuf[vplane + i] = vxg;
    vbuf[2 * vplane + i] = vxxg;
  }
  __syncthreads();

  // horizontal passes and the sparse inverse normal matrix
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i - r * kTile;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const float* vg = vbuf + r * span + c;
    const float* vxg = vg + vplane;
    const float* vxxg = vg + 2 * vplane;
    float S1 = C.g[0] * vg[0], Sx = C.xg[0] * vg[0], Sxx = C.xxg[0] * vg[0];
    float Sy = C.g[0] * vxg[0], Sxy = C.xg[0] * vxg[0];
    float Syy = C.g[0] * vxxg[0];
    for (int j = 1; j < taps; ++j) {
      S1 = S1 + C.g[j] * vg[j];
      Sx = Sx + C.xg[j] * vg[j];
      Sxx = Sxx + C.xxg[j] * vg[j];
      Sy = Sy + C.g[j] * vxg[j];
      Sxy = Sxy + C.xg[j] * vxg[j];
      Syy = Syy + C.g[j] * vxxg[j];
    }
    float* o = L.out[lv] + img * 5 * plane + (size_t)y * w + x;
    o[0] = C.ig11 * Sx;                                   // bx
    o[plane] = C.ig22 * Sy;                               // by
    o[2 * plane] = (C.ig30 * S1 + C.ig33 * Sxx) + C.ig34 * Syy;  // cxx
    o[3 * plane] = (C.ig40 * S1 + C.ig43 * Sxx) + C.ig44 * Syy;  // cyy
    o[4 * plane] = C.ig55 * Sxy;                          // cxy
  }
}

}  // namespace

extern "C" int farneback_polyexp_max_n() { return kMaxN; }
extern "C" int farneback_polyexp_max_levels() { return kMaxLevels; }

// Expand `count` levels in one launch on `stream`: level l is n_img[l]
// images of h[l] x w[l] at in[l], written channel-first to out[l].
// consts: g, xg, xxg (2n+1 each, ascending taps) then the 6x6 inverse normal
// matrix row-major, all float32 in host memory. Returns cudaGetLastError()
// (0 = launched, or nothing to launch).
extern "C" int farneback_polyexp_launch(const float* const* in,
                                        float* const* out, const int* n_img,
                                        const int* h, const int* w, int count,
                                        int n, const float* consts,
                                        void* stream) {
  if (n < 0 || n > kMaxN || count < 1 || count > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  PolyConsts C;
  C.n = n;
  const int taps = 2 * n + 1;
  for (int j = 0; j < taps; ++j) {
    C.g[j] = consts[j];
    C.xg[j] = consts[taps + j];
    C.xxg[j] = consts[2 * taps + j];
  }
  const float* ig = consts + 3 * taps;
  C.ig11 = ig[1 * 6 + 1];
  C.ig22 = ig[2 * 6 + 2];
  C.ig30 = ig[3 * 6 + 0];
  C.ig33 = ig[3 * 6 + 3];
  C.ig34 = ig[3 * 6 + 4];
  C.ig40 = ig[4 * 6 + 0];
  C.ig43 = ig[4 * 6 + 3];
  C.ig44 = ig[4 * 6 + 4];
  C.ig55 = ig[5 * 6 + 5];
  Levels L;
  L.count = count;
  L.first[0] = 0;
  for (int l = 0; l < count; ++l) {
    L.in[l] = in[l];
    L.out[l] = out[l];
    L.h[l] = h[l];
    L.w[l] = w[l];
    const long blocks = h[l] < 1 || w[l] < 1
                            ? 0L
                            : (long)tiles(h[l]) * tiles(w[l]) * n_img[l];
    if (L.first[l] + blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    L.first[l + 1] = L.first[l] + (int)blocks;
  }
  if (L.first[count] == 0) return 0;
  const int span = kTile + 2 * n;
  const int smem = (int)sizeof(float) * (span * span + 3 * kTile * span);
  polyexp_kernel<<<L.first[count], kThreads, smem, (cudaStream_t)stream>>>(L, C);
  return (int)cudaGetLastError();
}
