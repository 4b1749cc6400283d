// One Brox pyramid level for a batch of frame pairs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel denseflow_tpu/kernels/brox_fused.py::
// brox_scale_fused (kernel body _make_kernel) and its spatial tiler
// brox_scale_fused_tiled, which exists only to fit VMEM: this kernel computes
// the untiled answer at every geometry. Per pair it runs up to `outer` warps:
//   1. warp (I1, I1x, I1y) bicubically (a = -0.75), rows at v and then
//      columns at u, displacement clamped to +-max_disp and positions to the
//      level (plane_ops::cubic_taps: a direct 4-tap load per axis, whose cost
//      does not grow with max_disp);
//   2. the warp's constants Iz, Ix, Iy, Ixx, Ixy, Iyy, Ixz, Iyz (the _D5
//      stencils, plane_ops::conv_taps);
//   3. up to `inner` lagged-diffusivity steps from du = dv = 0, each: psi_s
//      of |grad(u + du)|^2 + |grad(v + dv)|^2, psi_d of the combined data and
//      gradient residual, the four interface weights, the 2x2 system, then
//      `solver` Jacobi sweeps; the step whose sum((du - du0)^2 + (dv - dv0)^2)
//      is <= stop/16 ends the inner loop (and is kept);
//   4. u += du, v += dv; the warp whose sum(du^2 + dv^2) is <= stop ends the
//      pair. stop = f32(stop_eps^2*h*w), or -1 (never) when stop_eps = 0.
// The I1 and I0 gradients, which the Pallas kernel recomputes per warp and
// per inner step, are computed once a level, and the warp's derivative
// planes once a warp: the same values, fewer passes.
//
// Design: a thread-block cluster of up to 8 CTAs per pair (grid = clusters x
// pairs; 8 CTAs at 256x341, so a 16-pair slab takes 128 of the 132 SMs).
// A pair's state at 256x341 (32 scratch planes, ~11 MB; 16 pairs hold
// ~180 MB) exceeds an SM's 227 KB of shared memory and the 50 MB L2, so it
// lives in device memory. Every Jacobi sweep reads the previous sweep's
// (du, dv) at the four neighbours, so each sweep ends in a barrier over the
// pair: a cluster barrier (barrier.cluster, release/acquire), with (du, dv)
// rotating among three buffers (the step's start, and two that the sweeps
// ping-pong between, so the inner stop can compare against the start). All
// loops run on the card: one launch a level, no host round trip, whatever
// the stops decide. One CTA per pair, the simplest design (the TVL1 kernel's),
// fills only 16 SMs; a level runs up to 7,700 sweeps, so a cluster per pair
// was taken from the start. Planes written inside the kernel are read with
// __ldcg (L2, not the SM's L1), so a CTA never reads a stale line that
// another CTA of its cluster has since rewritten.
//
// Each stop sum is reduced in a fixed order with no float atomics: each CTA
// sums its pixels (a fixed thread mapping, then a fixed shuffle tree), writes
// one partial, and after the cluster barrier every thread adds the partials
// in rank order, so all CTAs of the pair take the same decision. The pixel
// split depends only on (h, w): a pair's bytes depend neither on its
// batch-mates nor on B.
//
// What bounds it: memory traffic through L2. A sweep touches ~30 values a
// pixel (the ten per-step planes, u, v and (du, dv) at five points), a pair
// at 256x341 streams ~10 MB a sweep, and 16 pairs exceed L2; its operations
// (~55 a pixel a sweep) are far below the card's f32 rate. Shared-memory
// tiles of (du, dv), fusing the sweeps and TMA are later work.
//
// Built with --fmad=false and without fast math: every product and sum is
// rounded on its own, square root and division are IEEE, as in the plain
// version (kernels/brox_fused.py::brox_scale_reference), so the two agree up
// to the order of the stop sums, which only moves a stop that lands on its
// threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "plane_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using plane_ops::CubicTaps;

constexpr int kThreads = 1024;
constexpr int kMaxCtas = 8;  // the portable cluster size
constexpr int kScratchPlanes = 32;
constexpr int kPartials = 2 * kMaxCtas;  // two slots: inner and outer stop

// _D5 of the Pallas kernel, each tap rounded from double to float32
__device__ __forceinline__ plane_ops::Taps<5> d5_taps() {
  return {{(float)(1.0 / 12.0), (float)(-8.0 / 12.0), 0.0f,
           (float)(8.0 / 12.0), (float)(-1.0 / 12.0)}};
}

struct Params {
  int h, w, inner, outer, solver;
  float alpha, gamma, max_disp, stop, eps2;
};

// Plane values along a row (element k at p[k]) or a column (p[k * stride]),
// read through L2.
struct Line {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int k) const {
    return __ldcg(p + (size_t)k * stride);
  }
};

// u + du along a row or a column (the plane U = u + du of the Pallas body).
struct SumLine {
  const float* a;
  const float* b;
  int stride;
  __device__ __forceinline__ float operator()(int k) const {
    const size_t j = (size_t)k * stride;
    return __ldcg(a + j) + __ldcg(b + j);
  }
};

// The _D5 derivative along `line` at y, replicate borders at extent n.
template <class L>
__device__ __forceinline__ float d5(const L& line, int y, int n) {
  return plane_ops::conv_taps<5>(line, d5_taps(), 2, y, n);
}

__device__ __forceinline__ float ld(const float* p, int i) {
  return __ldcg(p + i);
}

// Sum of `v` over the pair's CTAs in a fixed order; every thread of the
// cluster gets the same total. `part` holds one partial per CTA rank. Ends
// after a cluster barrier.
__device__ float pair_sum(float v, float* part, cg::cluster_group& cluster,
                          int rank, int nc) {
  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = red[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[rank] = v;
  }
  cluster.sync();
  float t = __ldcg(part);
  for (int r = 1; r < nc; ++r) t = t + __ldcg(part + r);
  return t;
}

__global__ void __launch_bounds__(kThreads)
brox_scale_kernel(const float* __restrict__ I0, const float* __restrict__ I1,
                  const float* __restrict__ u_in,
                  const float* __restrict__ v_in, float* u, float* v,
                  float* scratch, float* partials, int* counts, Params P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.y;
  const int h = P.h, w = P.w, hw = h * w;
  const size_t off = (size_t)pair * hw;
  I0 += off; I1 += off; u_in += off; v_in += off; u += off; v += off;
  float* S = scratch + (size_t)pair * kScratchPlanes * hw;
  float* I1x = S;            // level constants
  float* I1y = S + hw;
  float* I0x = S + 2 * hw;
  float* I0y = S + 3 * hw;
  float* t1 = S + 4 * hw;    // row pass of I1, I1x, I1y
  float* t1x = S + 5 * hw;
  float* t1y = S + 6 * hw;
  float* Iz = S + 7 * hw;    // warp constants
  float* Ix = S + 8 * hw;
  float* Iy = S + 9 * hw;
  float* Ixx = S + 10 * hw;
  float* Ixy = S + 11 * hw;
  float* Iyy = S + 12 * hw;
  float* Ixz = S + 13 * hw;
  float* Iyz = S + 14 * hw;
  float* psi_s = S + 15 * hw;  // inner-step constants
  float* wE = S + 16 * hw;
  float* wW = S + 17 * hw;
  float* wS = S + 18 * hw;
  float* wN = S + 19 * hw;
  float* wsum = S + 20 * hw;
  float* a12 = S + 21 * hw;
  float* b1 = S + 22 * hw;
  float* b2 = S + 23 * hw;
  float* ru = S + 24 * hw;
  float* rv = S + 25 * hw;
  float* Du[3] = {S + 26 * hw, S + 28 * hw, S + 30 * hw};  // du buffers
  float* Dv[3] = {S + 27 * hw, S + 29 * hw, S + 31 * hw};  // dv buffers
  float* part_in = partials + (size_t)pair * kPartials;
  float* part_out = part_in + kMaxCtas;

  // this CTA's share of the pixels: a contiguous run of the row-major plane
  const int chunk = (hw + nc - 1) / nc;
  const int lo = min(hw, rank * chunk), hi = min(hw, lo + chunk);
  const int t0 = lo + (int)threadIdx.x;
  const float g = P.gamma, al = P.alpha, md = P.max_disp;

  for (int i = t0; i < hi; i += kThreads) {
    const int r = i / w, c = i - r * w;
    u[i] = __ldg(u_in + i);
    v[i] = __ldg(v_in + i);
    I1x[i] = d5(Line{I1 + r * w, 1}, c, w);
    I1y[i] = d5(Line{I1 + c, w}, r, h);
    I0x[i] = d5(Line{I0 + r * w, 1}, c, w);
    I0y[i] = d5(Line{I0 + c, w}, r, h);
  }
  cluster.sync();

  int n_outer = 0, n_inner = 0;
  bool done = false;
  while (!done && n_outer < P.outer) {
    // ---- warp, pass 1: along rows at v ----
    for (int i = t0; i < hi; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const CubicTaps t = plane_ops::cubic_taps(r, ld(v, i), h, md);
      float oa = 0.0f, ob = 0.0f, oc = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = t.i[m] * w + c;
        oa = oa + t.w[m] * __ldg(I1 + j);
        ob = ob + t.w[m] * ld(I1x, j);
        oc = oc + t.w[m] * ld(I1y, j);
      }
      t1[i] = oa; t1x[i] = ob; t1y[i] = oc;
    }
    cluster.sync();
    // ---- pass 2: along columns at u; Iz = I1w - I0 ----
    for (int i = t0; i < hi; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const CubicTaps t = plane_ops::cubic_taps(c, ld(u, i), w, md);
      float ow = 0.0f, ox = 0.0f, oy = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = r * w + t.i[m];
        ow = ow + t.w[m] * ld(t1, j);
        ox = ox + t.w[m] * ld(t1x, j);
        oy = oy + t.w[m] * ld(t1y, j);
      }
      Iz[i] = ow - __ldg(I0 + i);
      Ix[i] = ox;
      Iy[i] = oy;
    }
    cluster.sync();
    // ---- the warp's derivative planes; the inner loop starts at du = 0 ----
    for (int i = t0; i < hi; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const float ix = ld(Ix, i), iy = ld(Iy, i);
      Ixx[i] = d5(Line{Ix + r * w, 1}, c, w);
      Ixy[i] = d5(Line{Ix + c, w}, r, h);
      Iyy[i] = d5(Line{Iy + c, w}, r, h);
      Ixz[i] = ix - ld(I0x, i);
      Iyz[i] = iy - ld(I0y, i);
      Du[0][i] = 0.0f;
      Dv[0][i] = 0.0f;
    }
    cluster.sync();

    int s = 0;  // the buffer holding (du, dv) at the start of the inner step
    for (int it = 0; it < P.inner; ++it) {
      const float* du0 = Du[s];
      const float* dv0 = Dv[s];
      // ---- psi_s from the _D5 gradients of U = u + du, V = v + dv ----
      for (int i = t0; i < hi; i += kThreads) {
        const int r = i / w, c = i - r * w;
        const int rw = r * w;
        const float Ux = d5(SumLine{u + rw, du0 + rw, 1}, c, w);
        const float Uy = d5(SumLine{u + c, du0 + c, w}, r, h);
        const float Vx = d5(SumLine{v + rw, dv0 + rw, 1}, c, w);
        const float Vy = d5(SumLine{v + c, dv0 + c, w}, r, h);
        const float s2 = Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy;
        psi_s[i] = 1.0f / sqrtf(s2 + P.eps2);
      }
      cluster.sync();
      // ---- psi_d, the interface weights and the 2x2 system ----
      for (int i = t0; i < hi; i += kThreads) {
        const int r = i / w, c = i - r * w;
        const float du = ld(du0, i), dv = ld(dv0, i);
        const float iz = ld(Iz, i), ix = ld(Ix, i), iy = ld(Iy, i);
        const float ixx = ld(Ixx, i), ixy = ld(Ixy, i), iyy = ld(Iyy, i);
        const float ixz = ld(Ixz, i), iyz = ld(Iyz, i);
        const float r_data = iz + ix * du + iy * dv;
        const float r_gx = ixz + ixx * du + ixy * dv;
        const float r_gy = iyz + ixy * du + iyy * dv;
        const float pd = 1.0f / sqrtf(r_data * r_data +
                                      g * (r_gx * r_gx + r_gy * r_gy) + P.eps2);
        const float ps = ld(psi_s, i);
        const float e = 0.5f * (ps + ld(psi_s, r * w + plane_ops::shift_index(c, 1, w)));
        const float we = 0.5f * (ps + ld(psi_s, r * w + plane_ops::shift_index(c, -1, w)));
        const float s_ = 0.5f * (ps + ld(psi_s, plane_ops::shift_index(r, 1, h) * w + c));
        const float n_ = 0.5f * (ps + ld(psi_s, plane_ops::shift_index(r, -1, h) * w + c));
        const float ws = e + we + s_ + n_;
        const float a11 = pd * (ix * ix + g * (ixx * ixx + ixy * ixy));
        const float a_12 = pd * (ix * iy + g * (ixx * ixy + ixy * iyy));
        const float a22 = pd * (iy * iy + g * (ixy * ixy + iyy * iyy));
        const float b_1 = -pd * (iz * ix + g * (ixz * ixx + iyz * ixy));
        const float b_2 = -pd * (iz * iy + g * (ixz * ixy + iyz * iyy));
        wE[i] = e; wW[i] = we; wS[i] = s_; wN[i] = n_; wsum[i] = ws;
        a12[i] = a_12; b1[i] = b_1; b2[i] = b_2;
        ru[i] = 1.0f / (a11 + al * ws);
        rv[i] = 1.0f / (a22 + al * ws);
      }
      cluster.sync();
      // ---- Jacobi sweeps: src -> dst, the start buffer s never written ----
      int src = s;
      float err_i = 0.0f;
      for (int k = 0; k < P.solver; ++k) {
        const int dst = k == 0 ? (s + 1) % 3 : 3 - s - src;
        const bool last = k == P.solver - 1;
        const float* dus = Du[src];
        const float* dvs = Dv[src];
        float* dud = Du[dst];
        float* dvd = Dv[dst];
        float local = 0.0f;
        for (int i = t0; i < hi; i += kThreads) {
          const int r = i / w, c = i - r * w;
          const int iE = r * w + plane_ops::shift_index(c, 1, w);
          const int iW = r * w + plane_ops::shift_index(c, -1, w);
          const int iS = plane_ops::shift_index(r, 1, h) * w + c;
          const int iN = plane_ops::shift_index(r, -1, h) * w + c;
          const float e = ld(wE, i), we = ld(wW, i), s_ = ld(wS, i), n_ = ld(wN, i);
          const float ws = ld(wsum, i);
          const float lap_u = e * (ld(u, iE) + ld(dus, iE)) +
                              we * (ld(u, iW) + ld(dus, iW)) +
                              s_ * (ld(u, iS) + ld(dus, iS)) +
                              n_ * (ld(u, iN) + ld(dus, iN)) - ws * ld(u, i);
          const float lap_v = e * (ld(v, iE) + ld(dvs, iE)) +
                              we * (ld(v, iW) + ld(dvs, iW)) +
                              s_ * (ld(v, iS) + ld(dvs, iS)) +
                              n_ * (ld(v, iN) + ld(dvs, iN)) - ws * ld(v, i);
          const float c12 = ld(a12, i);
          const float dun = (ld(b1, i) - c12 * ld(dvs, i) + al * lap_u) * ld(ru, i);
          const float dvn = (ld(b2, i) - c12 * dun + al * lap_v) * ld(rv, i);
          dud[i] = dun;
          dvd[i] = dvn;
          if (last) {
            const float ex = dun - ld(du0, i), ey = dvn - ld(dv0, i);
            local = local + (ex * ex + ey * ey);
          }
        }
        if (last) {
          err_i = pair_sum(local, part_in, cluster, rank, nc);
        } else {
          cluster.sync();
        }
        src = dst;
      }
      s = src;
      ++n_inner;
      if (P.stop >= 0.0f && err_i <= P.stop * 0.0625f) break;
    }

    // ---- u += du, v += dv; the warp's stop ----
    const float* du = Du[s];
    const float* dv = Dv[s];
    float local = 0.0f;
    for (int i = t0; i < hi; i += kThreads) {
      const float a = ld(du, i), b = ld(dv, i);
      local = local + (a * a + b * b);
      u[i] = ld(u, i) + a;
      v[i] = ld(v, i) + b;
    }
    const float err = pair_sum(local, part_out, cluster, rank, nc);
    ++n_outer;
    done = P.stop >= 0.0f && err <= P.stop;
  }
  if (rank == 0 && threadIdx.x == 0) {
    counts[3 * pair] = n_outer;
    counts[3 * pair + 1] = n_inner;
    counts[3 * pair + 2] = n_inner * P.solver;
  }
}

// CTAs per pair: enough that each thread has a few pixels a phase. Depends
// only on the level's size, so a pair's bytes do not depend on B.
int ctas_per_pair(int hw) {
  return hw >= 32768 ? 8 : hw >= 16384 ? 4 : hw >= 8192 ? 2 : 1;
}

}  // namespace

extern "C" int brox_scale_scratch_planes() { return kScratchPlanes; }

extern "C" int brox_scale_partials() { return kPartials; }

// Launch one level on `stream`: u_out, v_out receive the refined flow,
// counts[3b..3b+2] the warps, inner steps and Jacobi sweeps pair b ran.
// scratch holds kScratchPlanes planes a pair, partials kPartials floats a
// pair. Returns the launch's CUDA error, or 0.
extern "C" int brox_scale_launch(
    const float* I0, const float* I1, const float* u_in, const float* v_in,
    float* u_out, float* v_out, float* scratch, float* partials, int* counts,
    int batch, int h, int w, float alpha, float gamma, float max_disp,
    float stop, float eps2, int inner, int outer, int solver, void* stream) {
  const Params P{h, w, inner, outer, solver, alpha, gamma, max_disp, stop,
                 eps2};
  const int nc = ctas_per_pair(h * w);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, brox_scale_kernel, I0, I1,
                                           u_in, v_in, u_out, v_out, scratch,
                                           partials, counts, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
