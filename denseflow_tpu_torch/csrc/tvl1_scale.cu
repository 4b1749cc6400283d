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
// Design: a thread-block cluster per pair, grid = n x B, cluster = n along
// x. CTA k of a cluster owns band k of its pair: full-width rows
// starts[k] .. starts[k+1]-1 (the plan, kernels/tvl1_fused.py::_plan, from
// (h, w) alone). Inside an iteration every read of another pixel is a
// nearest neighbour: the primal step reads p at (i, j-1) and (i-1, j), the
// dual step u at (i, j+1) and (i+1, j). So the only reads that leave a band
// are p12, p22 of the row above it and u1, u2 of the row below, and the
// only barrier over the pair is the cluster's (barrier.cluster), once after
// each step. The warp needs no barrier over the pair: its row pass reads the
// read-only inputs at any row and the band's own u2, its column pass the
// band's own row-pass results, so a __syncthreads() separates them.
//
// Placement (a template parameter; the plan picks it by (h, w)):
//   kShared  the nine planes of the loop (u1, u2, p11, p12, p21, p22 and the
//            warp constants I1wx, I1wy, rho_c: 36 B a pixel) sit in each
//            CTA's shared memory. After its step a CTA pushes the halo row
//            that a neighbour needs into that neighbour's shared memory
//            (DSMEM stores), ordered by the cluster barrier. Every main-path
//            geometry (256x341 and its pyramid) fits a cluster of at most 16:
//            6 CTAs at 105x140-164x218 (17 such clusters fit on an H100 at
//            once, so a 16-pair slab runs in one wave), 16 at 205x273 and
//            256x341, where 6 cannot hold the state.
//   kDevice  the same band schedule with every plane in band-owned device
//            memory (u1, u2 in the outputs), halo rows read through L2 with
//            __ldcg. It exists for the geometries whose state no cluster
//            holds (360x480, 1080p without -ns), so that the kernel still
//            computes the untiled answer there.
// l_t*|grad|^2 and the masked reciprocal are recomputed from I1wx, I1wy each
// iteration (the same operations in the same order, so the same bits)
// rather than stored. The row-pass planes t1, t1x, t1y stay in band-owned
// device memory in both placements: they live for one warp, at most 5 a
// scale.
//
// The epsilon sum is reduced in a fixed order with no float atomics: each
// CTA sums its band (a fixed thread mapping, then a shuffle tree per warp
// into its own shared memory); after the cluster barrier every CTA adds the
// n CTAs' warp partials in rank order over DSMEM. So every CTA of the pair
// takes the same stop decision and the same early exit, and since the plan
// depends only on (h, w), a pair's bytes depend neither on its batch-mates
// nor on B.
//
// What bounds it, as measured on an H100 (PERF.md): neither bytes nor
// the f32 rate. A slab of the main path takes 5.9 ms against a 0.30 ms
// operations bound. An iteration of the shared placement costs about
// 1.7 us plus 1.1 ns a pixel of the band: the fixed part is the two cluster
// barriers and the latency of each step's dependent chain; the part per
// pixel is one SM working through the step's shared-memory accesses, three
// IEEE divisions and two IEEE square roots. At 205x273 and 256x341 only 7
// clusters of 16 fit on the card at once, so a 16-pair slab runs in three
// waves. The device placement runs ~1.7x slower at the same cluster size.
//
// Built with --fmad=false and without fast math: every product and sum is
// rounded on its own, division and square root are IEEE, as in the plain
// PyTorch version, so the two agree up to the order of the epsilon sum,
// which only moves a stop that lands on its threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "plane_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using plane_ops::CubicTaps;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 16;        // a non-portable cluster
constexpr int kPortableCtas = 8;
constexpr int kSmemLimit = 232448;  // shared memory a CTA may use on sm_90
constexpr float kGradEps = 1.1920929e-07f;  // FLT_EPSILON, OpenCV's guard

// Where the state lives; the numbers are kernels/tvl1_fused.py::_PLACEMENTS.
enum Placement : int { kDevice = 0, kShared = 1 };
constexpr int kLoopPlanes = 9;  // u1, u2, p11, p12, p21, p22, wx, wy, rc
constexpr int kHaloRows = 4;    // p12, p22 of the row above; u1, u2 below

struct Params {
  int h, w;
  float l_t, theta, taut, thresh, max_disp;
  int iterations, warps, check_every;
  int nc, band_rows;
  int starts[kMaxCtas + 1];
};

// Dynamic shared memory of a CTA, in bytes.
int smem_bytes(int placement, int band_rows, int w) {
  if (placement != kShared) return 0;
  return (int)sizeof(float) * (kLoopPlanes * band_rows * w + kHaloRows * w);
}

// Planes a pair keeps in device memory besides the outputs: t1, t1x, t1y,
// and in kDevice the loop's planes but u1, u2 (those are the outputs).
__host__ __device__ constexpr int scratch_planes(int placement) {
  return placement == kShared ? 3 : 3 + kLoopPlanes - 2;
}

// Calls f(li, r, c) for each pixel of the band that this thread owns: li its
// index in the band (row-major), r its row in the band, c its column. A
// thread owns the same pixels in every pass and launch, so the order of the
// stop sum is fixed.
template <class F>
__device__ __forceinline__ void for_band(int npx, int w, F&& f) {
  const int dq = kThreads / w, dc = kThreads - dq * w;
  int li = threadIdx.x;
  int r = li / w, c = li - r * w;
  for (; li < npx; li += kThreads) {
    f(li, r, c);
    c += dc;
    r += dq;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
tvl1_band_kernel(const float* __restrict__ I0, const float* __restrict__ I1,
                 const float* __restrict__ I1x, const float* __restrict__ I1y,
                 const float* __restrict__ u1_in,
                 const float* __restrict__ u2_in, float* u1_out,
                 float* u2_out, float* scratch, int* counts, const Params P) {
  constexpr bool kSmem = kMode == kShared;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = P.nc;
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.y;
  const int h = P.h, w = P.w, hw = h * w;
  const int r0 = P.starts[rank];
  const int bh = P.starts[rank + 1] - r0, npx = bh * w;
  const int b0 = r0 * w;  // the band's first pixel in the pair's planes
  const size_t off = (size_t)pair * hw;
  I0 += off + b0;
  u1_in += off + b0;
  u2_in += off + b0;
  I1 += off; I1x += off; I1y += off;
  u1_out += off + b0;
  u2_out += off + b0;
  // Band-owned device planes are offset to the band's first pixel: pixel li
  // of the band at [li], the row above at [li - w], the row below at [li + w].
  float* S = scratch + (size_t)pair * scratch_planes(kMode) * hw + b0;
  float* t1 = S;
  float* t1x = S + hw;
  float* t1y = S + 2 * hw;

  extern __shared__ float smem[];
  __shared__ float red[kWarps];  // this CTA's warp partials of the stop sum
  __shared__ float s_err;
  // the loop's planes; a shared plane holds the longest band of the cluster
  const int stride = kSmem ? P.band_rows * w : hw;
  float* const u1 = kSmem ? smem : u1_out;
  float* const u2 = kSmem ? smem + stride : u2_out;
  float* const L = kSmem ? smem + 2 * stride : S + 3 * hw;
  float* const p11 = L;
  float* const p12 = L + stride;
  float* const p21 = L + 2 * stride;
  float* const p22 = L + 3 * stride;
  float* const wx = L + 4 * stride;  // I1wx, I1wy: warped gradients
  float* const wy = L + 5 * stride;
  float* const rc = L + 6 * stride;  // rho_c = I1w - I1wx*u1 - I1wy*u2 - I0
  // [p12 | p22] of the row above the band, [u1 | u2] of the row below
  float* halo = nullptr;
  float* up = nullptr;  // the halo of the band above (rank - 1), over DSMEM
  float* dn = nullptr;  // the halo of the band below (rank + 1)
  if constexpr (kSmem) {
    halo = L + 7 * stride;
    if (rank > 0) up = cluster.map_shared_rank(halo, rank - 1);
    if (rank < nc - 1) dn = cluster.map_shared_rank(halo, rank + 1);
  }

  for_band(npx, w, [&](int li, int, int) {
    u1[li] = __ldg(u1_in + li);
    u2[li] = __ldg(u2_in + li);
    p11[li] = 0.0f; p12[li] = 0.0f; p21[li] = 0.0f; p22[li] = 0.0f;
  });
  if constexpr (kSmem) {
    for (int k = threadIdx.x; k < kHaloRows * w; k += kThreads) halo[k] = 0.0f;
  }
  // every CTA of the cluster has started and holds its band before any
  // DSMEM store or halo read
  cluster.sync();

  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const float md = P.max_disp, l_t = P.l_t, theta = P.theta, taut = P.taut;
  int total_iters = 0, warps_run = 0;
  for (int wi = 0; wi < P.warps; ++wi) {
    // ---- warp, pass 1: along rows (axis 0) at displacement u2 ----
    for_band(npx, w, [&](int li, int r, int c) {
      const CubicTaps t = plane_ops::cubic_taps(r0 + r, u2[li], h, md);
      float oa = 0.0f, ob = 0.0f, oc = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = t.i[m] * w + c;
        oa = oa + t.w[m] * __ldg(I1 + j);
        ob = ob + t.w[m] * __ldg(I1x + j);
        oc = oc + t.w[m] * __ldg(I1y + j);
      }
      t1[li] = oa; t1x[li] = ob; t1y[li] = oc;
    });
    __syncthreads();
    // ---- pass 2: along columns (axis 1) at u1, then the warp constants ----
    for_band(npx, w, [&](int li, int r, int c) {
      const float a = u1[li], b = u2[li];
      const CubicTaps t = plane_ops::cubic_taps(c, a, w, md);
      float ow = 0.0f, ox = 0.0f, oy = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = r * w + t.i[m];
        ow = ow + t.w[m] * t1[j];
        ox = ox + t.w[m] * t1x[j];
        oy = oy + t.w[m] * t1y[j];
      }
      wx[li] = ox;
      wy[li] = oy;
      rc[li] = ow - ox * a - oy * b - __ldg(I0 + li);
    });
    __syncthreads();

    // ---- primal-dual iterations, epsilon tested every check_every ----
    int n = 0;
    float err = INFINITY;
    while (n < P.iterations && err > P.thresh) {
      for (int k = 0; k < P.check_every; ++k) {
        const bool with_err = k == P.check_every - 1;
        float local = 0.0f;
        // primal: reads p at (i, j-1) and (i-1, j), updates u in place
        for_band(npx, w, [&](int li, int r, int c) {
          const float a = u1[li], b = u2[li];
          const float gx = wx[li], gy = wy[li];
          const float rho = rc[li] + gx * a + gy * b;
          const float grad = gx * gx + gy * gy;
          const float f = l_t * grad;  // l_t * |grad I1w|^2
          const float rg = grad > kGradEps ? 1.0f / fmaxf(grad, kGradEps) : 0.0f;
          const float mul = rho < -f ? l_t : (rho > f ? -l_t : -rho * rg);
          const float v1 = a + mul * gx;
          const float v2 = b + mul * gy;
          const float q11 = p11[li], q12 = p12[li], q21 = p21[li], q22 = p22[li];
          const float dx1 = c > 0 ? q11 - p11[li - 1] : q11;
          const float dx2 = c > 0 ? q21 - p21[li - 1] : q21;
          float dy1 = q12, dy2 = q22;
          if (r0 + r > 0) {
            float a12, a22;  // p12, p22 of the row above
            if (r > 0) {
              a12 = p12[li - w]; a22 = p22[li - w];
            } else if constexpr (kSmem) {
              a12 = halo[c]; a22 = halo[w + c];
            } else {
              a12 = __ldcg(p12 + li - w); a22 = __ldcg(p22 + li - w);
            }
            dy1 = q12 - a12;
            dy2 = q22 - a22;
          }
          const float n1 = v1 + theta * (dx1 + dy1);
          const float n2 = v2 + theta * (dx2 + dy2);
          if (with_err) {
            const float e1 = n1 - a, e2 = n2 - b;
            local += e1 * e1 + e2 * e2;
          }
          u1[li] = n1;
          u2[li] = n2;
          if constexpr (kSmem) {
            if (r == 0 && up != nullptr) {
              up[2 * w + c] = n1;
              up[3 * w + c] = n2;
            }
          }
        });
        if (with_err) {
          for (int o = 16; o > 0; o >>= 1) local += __shfl_down_sync(0xffffffffu, local, o);
          if (lane == 0) red[wid] = local;
        }
        cluster.sync();
        if (with_err && wid == 0) {
          // the pair's sum: each CTA's warp partials by a shuffle tree,
          // the CTAs added in rank order
          float t = 0.0f;
          for (int q = 0; q < nc; ++q) {
            float v = cluster.map_shared_rank(red, q)[lane];
            for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
            t = q == 0 ? v : t + v;
          }
          if (lane == 0) s_err = t;
        }
        // dual: reads u at (i, j+1) and (i+1, j), updates p in place
        for_band(npx, w, [&](int li, int r, int c) {
          const float a = u1[li], b = u2[li];
          const float g1x = c < w - 1 ? u1[li + 1] - a : 0.0f;
          const float g2x = c < w - 1 ? u2[li + 1] - b : 0.0f;
          float g1y = 0.0f, g2y = 0.0f;
          if (r0 + r < h - 1) {
            float d1, d2;  // u1, u2 of the row below
            if (r < bh - 1) {
              d1 = u1[li + w]; d2 = u2[li + w];
            } else if constexpr (kSmem) {
              d1 = halo[2 * w + c]; d2 = halo[3 * w + c];
            } else {
              d1 = __ldcg(u1 + li + w); d2 = __ldcg(u2 + li + w);
            }
            g1y = d1 - a;
            g2y = d2 - b;
          }
          const float r1 = 1.0f / (1.0f + taut * sqrtf(g1x * g1x + g1y * g1y));
          const float r2 = 1.0f / (1.0f + taut * sqrtf(g2x * g2x + g2y * g2y));
          const float n12 = (p12[li] + taut * g1y) * r1;
          const float n22 = (p22[li] + taut * g2y) * r2;
          p11[li] = (p11[li] + taut * g1x) * r1;
          p12[li] = n12;
          p21[li] = (p21[li] + taut * g2x) * r2;
          p22[li] = n22;
          if constexpr (kSmem) {
            if (r == bh - 1 && dn != nullptr) {
              dn[c] = n12;
              dn[w + c] = n22;
            }
          }
        });
        cluster.sync();
      }
      n += P.check_every;
      err = s_err;
    }
    total_iters += n;
    warps_run += 1;
    // early exit: this warp converged in its first check block
    if (n <= P.check_every && err <= P.thresh) break;
  }
  // no CTA touches another's shared memory after the last cluster barrier
  if constexpr (kSmem) {
    for_band(npx, w, [&](int li, int, int) {
      u1_out[li] = u1[li];
      u2_out[li] = u2[li];
    });
  }
  if (rank == 0 && threadIdx.x == 0) {
    counts[2 * pair] = total_iters;
    counts[2 * pair + 1] = warps_run;
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, float*, float*, float*,
                        int*, Params);

Kernel kernel_for(int placement) {
  return placement == kShared ? tvl1_band_kernel<kShared>
                              : tvl1_band_kernel<kDevice>;
}

constexpr int kBadPlan = -1;

// P from the plan that kernels/tvl1_fused.py::_plan made; kBadPlan if the
// plan is not one this kernel runs (bands that do not tile 0..h-1, a
// cluster over 16, or bytes and planes other than the placement needs).
int make_params(Params* P, int h, int w, int placement, int nc,
                const int* starts, int smem, int scratch) {
  if (placement < kDevice || placement > kShared) return kBadPlan;
  if (h < 1 || w < 1 || nc < 1 || nc > kMaxCtas) return kBadPlan;
  if (starts[0] != 0 || starts[nc] != h) return kBadPlan;
  int rows = 0;
  for (int k = 0; k < nc; ++k) {
    const int d = starts[k + 1] - starts[k];
    if (d < 1) return kBadPlan;
    rows = d > rows ? d : rows;
  }
  for (int k = 0; k <= nc; ++k) P->starts[k] = starts[k];
  P->h = h;
  P->w = w;
  P->nc = nc;
  P->band_rows = rows;
  if (smem != smem_bytes(placement, rows, w) || smem > kSmemLimit ||
      scratch != scratch_planes(placement)) {
    return kBadPlan;
  }
  return 0;
}

// Shared-memory size and, for a cluster over 8, the non-portable size.
cudaError_t set_attributes(Kernel fn, int nc, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && nc > kPortableCtas) {
    e = cudaFuncSetAttribute((const void*)fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return e;
}

cudaLaunchConfig_t launch_config(int nc, int batch, int smem,
                                 cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of the plan fit on the current device at once
// (cudaOccupancyMaxActiveClusters) into *out. Returns -1 for a plan the
// kernel does not run, else the CUDA error, or 0.
extern "C" int tvl1_scale_max_active_clusters(int h, int w, int placement,
                                              int nc, const int* starts,
                                              int smem, int scratch,
                                              int* out) {
  Params P{};
  const int e = make_params(&P, h, w, placement, nc, starts, smem, scratch);
  if (e != 0) return e;
  const Kernel fn = kernel_for(placement);
  cudaError_t ce = set_attributes(fn, nc, smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(nc, 1, smem, attr, nullptr);
  ce = cudaOccupancyMaxActiveClusters(out, (const void*)fn, &cfg);
  return (int)ce;
}

// Launch one scale on `stream` with the plan (placement, nc CTAs a pair,
// band rows starts[0..nc], smem bytes of dynamic shared memory a CTA,
// `scratch` planes a pair). u1_out, u2_out receive the flow, counts[2b],
// counts[2b+1] the iterations and warps pair b ran. Returns -1 for a plan
// the kernel does not run, else the launch's CUDA error, or 0.
extern "C" int tvl1_scale_launch(
    const float* I0, const float* I1, const float* I1x, const float* I1y,
    const float* u1_in, const float* u2_in, float* u1_out, float* u2_out,
    float* scratch, int* counts, int batch, int h, int w, float l_t,
    float theta, float taut, float thresh, float max_disp, int iterations,
    int warps, int check_every, int placement, int nc, const int* starts,
    int smem, int scratch_n, void* stream) {
  Params P{};
  const int e = make_params(&P, h, w, placement, nc, starts, smem, scratch_n);
  if (e != 0) return e;
  P.l_t = l_t;
  P.theta = theta;
  P.taut = taut;
  P.thresh = thresh;
  P.max_disp = max_disp;
  P.iterations = iterations;
  P.warps = warps;
  P.check_every = check_every;
  const Kernel fn = kernel_for(placement);
  cudaError_t ce = set_attributes(fn, nc, smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(nc, batch, smem, attr, stream);
  ce = cudaLaunchKernelEx(&cfg, fn, I0, I1, I1x, I1y, u1_in, u2_in, u1_out,
                          u2_out, scratch, counts, P);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
