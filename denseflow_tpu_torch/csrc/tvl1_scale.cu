// One TVL1 pyramid scale for a batch of frame pairs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel denseflow_tpu/kernels/tvl1_fused.py::
// tvl1_scale_fused (kernel body _make_kernel). Per pair it runs up to
// `warps` warps; each warp resamples (I1, I1x, I1y) bicubically (a = -0.75)
// in two separable 1-D passes, rows at u2 then columns at u1, with the
// displacement clamped to +-max_disp and positions and taps clamped to the
// image; then it hoists the warp constants and runs the primal-dual
// iterations in blocks of `check_every`, testing sum(du1^2 + du2^2) against
// eps^2*h*w on the last iteration of each block. A warp that converges in
// its first block ends the pair's warp loop.
//
// The TPU kernel's roll sweep over [k_lo, k_hi] becomes a direct 4-tap load
// per pixel per axis at floor(pos)-1 .. floor(pos)+2 with clamped indices
// (plane_ops::cubic_taps): the same nonzero terms, added in the same
// ascending order, at a cost that does not grow with max_disp
// (auto-escalation re-solves at 80 and 1020 px).
//
// Design: one thread block (CTA) per pair, grid = B. The Pallas kernel's
// grid runs one pair per step with the pair's whole state on chip; on
// Hopper a pair's state (u1, u2, four dual planes, three row-pass planes,
// five warp constants: 14 planes, 4.9 MB at 256x341) cannot sit in one
// SM's 227 KB of shared memory, so it lives in device memory (the outputs
// hold u1/u2, `scratch` the other 12 planes). One CTA per pair keeps every
// dependency inside the block: __syncthreads() separates the primal update
// (reads p at (i,j), (i,j-1), (i-1,j), updates u in place) from the dual
// update (reads u at (i,j), (i,j+1), (i+1,j), updates p in place), the
// epsilon sum is reduced by the block in a fixed order (no float atomics,
// so a pair's result does not depend on its batch-mates or on B), and the
// stop and early exit are decided on the card, with no grid-wide barrier
// and no host round trip inside a scale.
//
// What bounds it: memory traffic. An iteration streams ~23 plane passes
// (~8 MB at 256x341) through L2 per pair; B = 16 pairs hold ~78 MB of
// state, more than the 50 MB L2, so the loop runs at the rate that 16 SMs
// can pull from L2/HBM. It fills only B of the 132 SMs, and runs far
// below both the HBM and the f32 bound of an H100 (PERF.md). Several CTAs
// per pair (clusters or a cooperative grid), shared-memory tiles and CUDA
// graphs are later work.
//
// Built with --fmad=false and without fast math: every product and sum is
// rounded on its own, as in the plain PyTorch version, so the two agree to
// the order of the epsilon reduction.

#include <cuda_runtime.h>
#include <math.h>

#include "plane_ops.cuh"

namespace {

using plane_ops::CubicTaps;

constexpr int kThreads = 1024;
constexpr int kScratchPlanes = 12;
constexpr float kGradEps = 1.1920929e-07f;  // FLT_EPSILON, OpenCV's guard

struct Params {
  int h, w;
  float l_t, theta, taut, thresh, max_disp;
  int iterations, warps, check_every;
};

// Sum of `v` over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (kThreads >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

__global__ void __launch_bounds__(kThreads)
tvl1_scale_kernel(const float* __restrict__ I0, const float* __restrict__ I1,
                  const float* __restrict__ I1x, const float* __restrict__ I1y,
                  const float* __restrict__ u1_in,
                  const float* __restrict__ u2_in, float* u1, float* u2,
                  float* scratch, int* counts, Params P) {
  const int h = P.h, w = P.w, hw = h * w;
  const size_t off = (size_t)blockIdx.x * hw;
  I0 += off; I1 += off; I1x += off; I1y += off;
  u1_in += off; u2_in += off; u1 += off; u2 += off;
  float* S = scratch + (size_t)blockIdx.x * kScratchPlanes * hw;
  float* p11 = S;
  float* p12 = S + hw;
  float* p21 = S + 2 * hw;
  float* p22 = S + 3 * hw;
  float* t1 = S + 4 * hw;   // row-pass results of I1, I1x, I1y
  float* t1x = S + 5 * hw;
  float* t1y = S + 6 * hw;
  float* wx = S + 7 * hw;   // I1wx, I1wy: warped gradients
  float* wy = S + 8 * hw;
  float* rc = S + 9 * hw;   // rho_c = I1w - I1wx*u1 - I1wy*u2 - I0
  float* fi = S + 10 * hw;  // l_t * |grad I1w|^2
  float* rg = S + 11 * hw;  // 1/max(grad, eps) where grad > eps, else 0

  __shared__ float red[kThreads / 32];
  __shared__ float s_err;

  for (int i = threadIdx.x; i < hw; i += kThreads) {
    u1[i] = u1_in[i];
    u2[i] = u2_in[i];
    p11[i] = 0.0f; p12[i] = 0.0f; p21[i] = 0.0f; p22[i] = 0.0f;
  }
  __syncthreads();

  const float md = P.max_disp;
  int total_iters = 0, warps_run = 0;
  for (int wi = 0; wi < P.warps; ++wi) {
    // ---- warp, pass 1: along rows (axis 0) at displacement u2 ----
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const CubicTaps t = plane_ops::cubic_taps(r, u2[i], h, md);
      float oa = 0.0f, ob = 0.0f, oc = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = t.i[m] * w + c;
        oa = oa + t.w[m] * __ldg(I1 + j);
        ob = ob + t.w[m] * __ldg(I1x + j);
        oc = oc + t.w[m] * __ldg(I1y + j);
      }
      t1[i] = oa; t1x[i] = ob; t1y[i] = oc;
    }
    __syncthreads();
    // ---- pass 2: along columns (axis 1) at u1, then the warp constants ----
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const float a = u1[i], b = u2[i];
      const CubicTaps t = plane_ops::cubic_taps(c, a, w, md);
      float ow = 0.0f, ox = 0.0f, oy = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = r * w + t.i[m];
        ow = ow + t.w[m] * t1[j];
        ox = ox + t.w[m] * t1x[j];
        oy = oy + t.w[m] * t1y[j];
      }
      const float grad = ox * ox + oy * oy;
      wx[i] = ox;
      wy[i] = oy;
      rc[i] = ow - ox * a - oy * b - __ldg(I0 + i);
      fi[i] = P.l_t * grad;
      rg[i] = grad > kGradEps ? 1.0f / fmaxf(grad, kGradEps) : 0.0f;
    }
    __syncthreads();

    // ---- primal-dual iterations, epsilon tested every check_every ----
    int n = 0;
    float err = INFINITY;
    while (n < P.iterations && err > P.thresh) {
      for (int k = 0; k < P.check_every; ++k) {
        const bool with_err = k == P.check_every - 1;
        float local = 0.0f;
        for (int i = threadIdx.x; i < hw; i += kThreads) {
          const int r = i / w, c = i - r * w;
          const float a = u1[i], b = u2[i];
          const float gx = wx[i], gy = wy[i];
          const float rho = rc[i] + gx * a + gy * b;
          const float f = fi[i];
          const float mul =
              rho < -f ? P.l_t : (rho > f ? -P.l_t : -rho * rg[i]);
          const float v1 = a + mul * gx;
          const float v2 = b + mul * gy;
          const float q11 = p11[i], q12 = p12[i], q21 = p21[i], q22 = p22[i];
          const float div1 = (c > 0 ? q11 - p11[i - 1] : q11) +
                             (r > 0 ? q12 - p12[i - w] : q12);
          const float div2 = (c > 0 ? q21 - p21[i - 1] : q21) +
                             (r > 0 ? q22 - p22[i - w] : q22);
          const float n1 = v1 + P.theta * div1;
          const float n2 = v2 + P.theta * div2;
          if (with_err) {
            const float e1 = n1 - a, e2 = n2 - b;
            local += e1 * e1 + e2 * e2;
          }
          u1[i] = n1;
          u2[i] = n2;
        }
        if (with_err) {
          block_sum(local, red, &s_err);  // ends in a barrier
        } else {
          __syncthreads();
        }
        for (int i = threadIdx.x; i < hw; i += kThreads) {
          const int r = i / w, c = i - r * w;
          const float a = u1[i], b = u2[i];
          const float g1x = c < w - 1 ? u1[i + 1] - a : 0.0f;
          const float g1y = r < h - 1 ? u1[i + w] - a : 0.0f;
          const float g2x = c < w - 1 ? u2[i + 1] - b : 0.0f;
          const float g2y = r < h - 1 ? u2[i + w] - b : 0.0f;
          const float r1 = 1.0f / (1.0f + P.taut * sqrtf(g1x * g1x + g1y * g1y));
          const float r2 = 1.0f / (1.0f + P.taut * sqrtf(g2x * g2x + g2y * g2y));
          p11[i] = (p11[i] + P.taut * g1x) * r1;
          p12[i] = (p12[i] + P.taut * g1y) * r1;
          p21[i] = (p21[i] + P.taut * g2x) * r2;
          p22[i] = (p22[i] + P.taut * g2y) * r2;
        }
        __syncthreads();
      }
      n += P.check_every;
      err = s_err;
    }
    total_iters += n;
    warps_run += 1;
    // early exit: this warp converged in its first check block
    if (n <= P.check_every && err <= P.thresh) break;
  }
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = total_iters;
    counts[2 * blockIdx.x + 1] = warps_run;
  }
}

}  // namespace

extern "C" int tvl1_scale_scratch_planes() { return kScratchPlanes; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int tvl1_scale_launch(const float* I0, const float* I1,
                                 const float* I1x, const float* I1y,
                                 const float* u1_in, const float* u2_in,
                                 float* u1_out, float* u2_out, float* scratch,
                                 int* counts, int batch, int h, int w,
                                 float l_t, float theta, float taut,
                                 float thresh, float max_disp, int iterations,
                                 int warps, int check_every, void* stream) {
  Params P{h, w, l_t, theta, taut, thresh, max_disp,
           iterations, warps, check_every};
  tvl1_scale_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      I0, I1, I1x, I1y, u1_in, u2_in, u1_out, u2_out, scratch, counts, P);
  return (int)cudaGetLastError();
}
