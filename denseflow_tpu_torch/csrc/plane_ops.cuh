// Plane operations shared by the package's flow kernels, for Hopper (sm_90a).
//
// The counterparts of the JAX package's in-kernel helpers
// (denseflow_tpu/kernels/common.py::make_plane_ops): `shift`, `conv_taps`,
// `box_sum` and `resample`, linear (Farneback) or cubic (TVL1, Brox), plus
// Farneback's border ramp. Each computes, in
// the same order of float operations, what the plain PyTorch helpers in
// denseflow_tpu_torch/kernels/plane_ops.py compute, so a kernel built with
// --fmad=false agrees with its plain version bit for bit.
//
// The Pallas helpers work on whole (hp, wp) planes padded to (8, 128) tiles
// with circular rolls; here a thread computes one pixel, and an index that a
// roll would wrap into the padded band is clamped or zeroed directly. The
// row/column index planes and the `real` mask are the thread's own (r, c)
// and the tests r < h, c < w.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace plane_ops {

// OpenCV's border attenuation ramp (denseflow_tpu/algorithms/farneback.py)
__device__ __constant__ float kBorder[5] = {0.14f, 0.14f, 0.4472f, 0.4472f,
                                            0.4472f};

// Triangle kernel, support (-1, 1): bilinear interpolation weight.
__device__ __forceinline__ float linear_weight(float x) {
  return fmaxf(0.0f, 1.0f - fabsf(x));
}

// The two taps of a linear 1-D resample at integer coordinate `coord` of an
// axis of extent n, with displacement `disp` clamped to +-max_disp and the
// position clamped into [0, n-1]. Of the Pallas roll sweep only the taps at
// floor(d) and floor(d)+1 have weight; the caller adds them in this order
// (i0 then i1) to a zero accumulator, as the sweep does.
struct LinearTaps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ LinearTaps linear_taps(int coord, float disp,
                                                  int n, float max_disp) {
  const float cf = (float)coord;
  const float top = (float)(n - 1);
  const float dc = fminf(fmaxf(disp, -max_disp), max_disp);
  const float pos = fminf(fmaxf(cf + dc, 0.0f), top);
  const float d = pos - cf;
  const float k0 = floorf(d);
  const float k1 = k0 + 1.0f;
  LinearTaps t;
  t.w0 = linear_weight(d - k0);
  t.w1 = linear_weight(d - k1);
  t.i0 = (int)fminf(fmaxf(cf + k0, 0.0f), top);
  t.i1 = (int)fminf(fmaxf(cf + k1, 0.0f), top);
  return t;
}

// shift(p, k)[y] reads p at clamp(y + k, 0, n-1): replicate borders at the
// real extent n.
__device__ __forceinline__ int shift_index(int y, int k, int n) {
  return min(max(y + k, 0), n - 1);
}

// A short stencil's float32 taps, passed by value so that the compiler sees
// them as constants.
template <int N>
struct Taps {
  float c[N];
};

// sum_i taps.c[i] * get(shift_index(y, i - center, n)) over the N taps, in
// the float order of the Pallas conv_taps: zero taps are skipped, the first
// nonzero term starts the sum and the others are added in ascending order.
template <int N, class Get>
__device__ __forceinline__ float conv_taps(const Get& get, const Taps<N> taps,
                                           int center, int y, int n) {
  float out = 0.0f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float c = taps.c[i];
    if (c == 0.0f) continue;
    const float term = c * get(shift_index(y, i - center, n));
    out = first ? term : out + term;
    first = false;
  }
  return out;
}

// Cubic-convolution kernel, a = -0.75 (OpenCV INTER_CUBIC), support (-2, 2).
__device__ __forceinline__ float cubic_weight(float x) {
  const float a = -0.75f;
  const float ax = fabsf(x);
  const float ax2 = ax * ax;
  const float ax3 = ax2 * ax;
  const float inner = (a + 2.0f) * ax3 - (a + 3.0f) * ax2 + 1.0f;
  const float outer = a * (ax3 - 5.0f * ax2 + 8.0f * ax - 4.0f);
  return ax < 1.0f ? inner : (ax < 2.0f ? outer : 0.0f);
}

// The four taps of a cubic 1-D resample at integer coordinate `coord` of an
// axis of extent n, with displacement `disp` clamped to +-max_disp and the
// position clamped into [0, n-1]. Of the Pallas roll sweep only the taps
// floor(pos)-1 .. floor(pos)+2 have weight; the caller adds them in this
// order (m = 0..3) to a zero accumulator, as the sweep does. The cost does
// not grow with max_disp.
struct CubicTaps {
  int i[4];
  float w[4];
};

__device__ __forceinline__ CubicTaps cubic_taps(int coord, float disp, int n,
                                                float max_disp) {
  const float cf = (float)coord;
  const float top = (float)(n - 1);
  const float dc = fminf(fmaxf(disp, -max_disp), max_disp);
  const float pos = fminf(fmaxf(cf + dc, 0.0f), top);
  const float d = pos - cf;
  const float fl = floorf(pos);
  CubicTaps t;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float tap = fl + (float)(m - 1);
    t.w[m] = cubic_weight(d - (tap - cf));
    t.i[m] = (int)fminf(fmaxf(tap, 0.0f), top);
  }
  return t;
}

// The balanced pairwise sum of z(kOff) .. z(kOff + kM - 1), kM a power of
// two: the association of the Pallas cascade,
// sums[2m][k] = sums[m][k] + sums[m][k + m].
template <int kOff, int kM, class Z>
__device__ __forceinline__ float tree_sum(const Z& z) {
  if constexpr (kM == 1) {
    return z(kOff);
  } else {
    return tree_sum<kOff, kM / 2>(z) + tree_sum<kOff + kM / 2, kM / 2>(z);
  }
}

// z(0) .. z(kRem - 1) from offset kOff on, in power-of-two blocks of kM and
// smaller, each block added to `total` (the first one starts it).
template <int kRem, int kOff, int kM, class Z>
__device__ __forceinline__ float block_sums(const Z& z, float total) {
  if constexpr (kM == 0) {
    return total;
  } else if constexpr (kRem >= kM) {
    const float part = tree_sum<kOff, kM>(z);
    return block_sums<kRem - kM, kOff + kM, kM / 2>(
        z, kOff == 0 ? part : total + part);
  } else {
    return block_sums<kRem, kOff, kM / 2>(z, total);
  }
}

__host__ __device__ constexpr int top_pow2(int n) {
  return n < 2 ? 1 : 2 * top_pow2(n / 2);
}

// Sum of the kWin taps at clamp(y + k, 0, n-1), k in [-(kWin/2), kWin/2],
// kWin odd, in the float order of the Pallas box_sum with zero_pad=True.
// z(i) is the zero-padded value at y - kWin/2 + i (0 outside [0, n)), lo
// and hi the line's values at 0 and n-1. For kWin >= 4: the zero-padded
// window summed in power-of-two blocks, largest first, then the clamped
// taps added back as count * edge value. For kWin < 4: the clamped taps in
// ascending order. The window is a template parameter, so every index
// into z is a constant and a window held in registers stays there.
template <int kWin, class Z>
__device__ __forceinline__ float box_sum(const Z& z, int y, int n, float lo,
                                         float hi) {
  constexpr int ctr = kWin / 2;
  if constexpr (kWin < 4) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const int t = y - ctr + i;
      acc = acc + (t < 0 ? lo : (t > n - 1 ? hi : z(i)));
    }
    return acc;
  } else {
    const float total = block_sums<kWin, 0, top_pow2(kWin)>(z, 0.0f);
    const float cnt_lo = (float)max(0, ctr - y);
    const float cnt_hi = (float)max(0, y + ctr - (n - 1));
    return (total + cnt_lo * lo) + cnt_hi * hi;
  }
}

// OpenCV's separable border attenuation at (r, c) of an (h, w) level,
// multiplied factor by factor in the Pallas order: rows j = 0.. (the top
// band, then the bottom), then the columns. Bands multiply where they
// overlap on tiny levels.
__device__ __forceinline__ float border_scale(int r, int c, int h, int w) {
  float s = 1.0f;
  const int kh = min(5, h), kw = min(5, w);
  for (int j = 0; j < kh; ++j) {
    if (r == j) s = s * kBorder[j];
    if (r == h - 1 - j) s = s * kBorder[j];
  }
  for (int j = 0; j < kw; ++j) {
    if (c == j) s = s * kBorder[j];
    if (c == w - 1 - j) s = s * kBorder[j];
  }
  return s;
}

}  // namespace plane_ops
