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
// Design: a thread-block cluster per pair, grid = n x B, cluster = n along
// x. CTA k of a cluster owns band k of its pair: full-width rows
// starts[k] .. starts[k+1]-1 (the plan, kernels/brox_fused.py::_plan, from
// (h, w) alone). Every read of another pixel reaches at most two rows: the
// _D5 gradients of u + du (psi_s) and of Ix, Iy two rows, the Jacobi
// stencil and the interface weights one. So a band needs two halo rows of
// its neighbours, and the pair needs a barrier after each phase whose
// output a neighbour reads: once a Jacobi sweep, once after psi_s, twice a
// warp. With n = 1 that barrier is __syncthreads(); else the cluster's
// (barrier.cluster, release/acquire). All loops run on the card: one launch
// a level, no host round trip, whatever the stops decide.
//
// Placement (a template parameter; the plan picks it by (h, w)):
//   kShared  the planes the sweeps touch sit in each CTA's shared memory:
//            u, v, two ping-pong buffers of (du, dv), psi_s, a12, b1, b2,
//            ru and rv (48 B a pixel). The four interface weights and their
//            sum are recomputed each sweep as 0.5f * (ps + ps_neighbour),
//            the same operations in the same order as the stored planes,
//            so the same bits. u, v, (du, dv) and psi_s carry two halo rows
//            each side; after writing an edge row a CTA pushes it into the
//            neighbour's halo (DSMEM stores), ordered by the barrier that
//            follows. u, v update their halo rows themselves from the
//            (du, dv) halo, with the neighbour's operations.
//   kSplit   u, v and the (du, dv) buffers in shared memory (24 B a pixel),
//            psi_s and the step's constants in band-owned device memory.
//   kDevice  every plane in band-owned device memory (u, v in the outputs),
//            neighbours' rows read through L2; for geometries whose state
//            no cluster holds (360x480, 1080p).
// A CTA is 512 threads, which leaves a thread 128 registers: 1,024 cap it
// at 64 and spill, and 256 and 1,024 measured slower (PERF.md).
// In every placement the level's image gradients, the row-pass planes, the
// warp's eight constants (read once an inner step) and the step's start
// (du0, dv0) (copied out once a step; only the inner stop reads it) stay in
// band-owned device memory. Planes written inside the kernel are read from
// device memory with __ldcg (L2, not the SM's L1), so a CTA never reads a
// stale line that another CTA of its cluster has since rewritten.
//
// Each stop sum is reduced in a fixed order with no float atomics: each CTA
// sums its band (a fixed thread mapping, then a shuffle tree per warp into
// its own shared memory); after the barrier every warp of every CTA adds
// the n CTAs' warp partials in rank order over DSMEM, so all CTAs of the
// pair take the same decision. The plan depends only on (h, w): a pair's
// bytes depend neither on its batch-mates nor on B.
//
// What bounds it: not bytes nor the f32 rate (a sweep is ~36 operations and
// ~30 shared-memory reads a pixel) but the time of each sweep, the barrier
// plus one SM's pass over its band, times up to ~2,000 dependent sweeps a
// level. Only 17 clusters of at most 6 one-CTA-per-SM blocks fit on an H100
// at once, 15 of 7 or 8 and 7 of 12 to 16 (cudaOccupancyMaxActiveClusters),
// so the plan keeps a 16-pair slab in one wave wherever the state allows
// it; at 205x273 and 256x341 it takes 16 CTAs and three waves, whose
// shorter bands measured faster than any one-wave plan. PERF.md has the
// times per level beside the plans not taken.
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

constexpr int kMaxCtas = 16;        // a non-portable cluster
constexpr int kPortableCtas = 8;
constexpr int kSmemLimit = 232448;  // shared memory a CTA may use on sm_90
constexpr int kHalo = 2;            // halo rows each side: the _D5 reach
constexpr int kThreads = 512;       // a CTA's threads

// Where the state lives; the numbers are kernels/brox_fused.py::_PLACEMENTS.
enum Placement : int { kDevice = 0, kShared = 1, kSplit = 2 };
constexpr int kStatePlanes = 6;   // u, v; du, dv in two ping-pong buffers
constexpr int kConstPlanes = 6;   // psi_s, a12, b1, b2, ru, rv
constexpr int kDevicePlanes = 17; // the planes device memory always holds

__host__ __device__ constexpr bool state_in_smem(int p) { return p != kDevice; }
__host__ __device__ constexpr bool consts_in_smem(int p) { return p == kShared; }

// Dynamic shared memory of a CTA, in bytes: the state planes and psi_s
// carry kHalo rows each side, a12, b1, b2, ru, rv only the band.
int smem_bytes(int placement, int band_rows, int w) {
  int f = 0;
  if (state_in_smem(placement)) f += kStatePlanes * (band_rows + 2 * kHalo) * w;
  if (consts_in_smem(placement)) {
    f += (band_rows + 2 * kHalo) * w + (kConstPlanes - 1) * band_rows * w;
  }
  return (int)sizeof(float) * f;
}

// (h, w) planes a pair keeps in device memory besides the outputs.
__host__ __device__ constexpr int scratch_planes(int placement) {
  return kDevicePlanes + (state_in_smem(placement) ? 0 : kStatePlanes - 2) +
         (consts_in_smem(placement) ? 0 : kConstPlanes);
}

// _D5 of the Pallas kernel, each tap rounded from double to float32
__device__ __forceinline__ plane_ops::Taps<5> d5_taps() {
  return {{(float)(1.0 / 12.0), (float)(-8.0 / 12.0), 0.0f,
           (float)(8.0 / 12.0), (float)(-1.0 / 12.0)}};
}

// The _D5 derivative of get(.) at y along an axis of extent n (replicate
// borders).
template <class G>
__device__ __forceinline__ float d5(const G& get, int y, int n) {
  return plane_ops::conv_taps<5>(get, d5_taps(), 2, y, n);
}

struct Params {
  int h, w, inner, outer, solver;
  float alpha, gamma, max_disp, stop, eps2;
  int nc, band_rows;
  int starts[kMaxCtas + 1];
};

// A plane value: shared memory read directly, device memory through L2.
template <bool kSmem>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

// Calls f(li, r, c) for each pixel of the band that this thread owns: li its
// index in the band (row-major), r its row in the band, c its column. A
// thread owns the same pixels in every pass and launch, so the order of the
// stop sums is fixed.
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

// Calls f(j, gr, c) for each pixel of the band's halo rows that lie in the
// level: j its index relative to the band's first pixel, gr its row.
template <class F>
__device__ __forceinline__ void for_halo(int w, int bh, int r0, int h, F&& f) {
  for (int k = threadIdx.x; k < 2 * kHalo * w; k += kThreads) {
    const int q = k / w, c = k - q * w;
    const int lr = q < kHalo ? q - kHalo : bh + q - kHalo;
    const int gr = r0 + lr;
    if (gr >= 0 && gr < h) f(lr * w + c, gr, c);
  }
}

// A neighbour's shared memory (over DSMEM) and the shift of a pixel's index
// from this CTA's layout to the neighbour's.
struct Peer {
  float* base;
  int shift;
  // the neighbour's copy of plane p's pixel i (p in this CTA's smem)
  __device__ __forceinline__ void put(const float* smem, const float* p, int i,
                                      float x) const {
    base[(p - smem) + shift + i] = x;
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
brox_band_kernel(const float* __restrict__ I0, const float* __restrict__ I1,
                 const float* __restrict__ u_in,
                 const float* __restrict__ v_in, float* u_out, float* v_out,
                 float* scratch, int* counts, const Params P) {
  constexpr bool kS = state_in_smem(kMode);
  constexpr bool kC = consts_in_smem(kMode);
  constexpr int kWarps = kThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = P.nc;
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.y;
  const int h = P.h, w = P.w, hw = h * w;
  const int r0 = P.starts[rank];
  const int bh = P.starts[rank + 1] - r0, npx = bh * w;
  const int b0 = r0 * w;  // the band's first pixel in the pair's planes
  const size_t off = (size_t)pair * hw;
  I0 += off; I1 += off; u_in += off; v_in += off;
  u_out += off + b0;
  v_out += off + b0;
  // Band-owned device planes are offset to the band's first pixel: pixel li
  // of the band at [li], the row above at [li - w], the row below at [li + w].
  float* const S = scratch + (size_t)pair * scratch_planes(kMode) * hw + b0;
  float* const I1x = S;  // level constants
  float* const I1y = S + hw;
  float* const I0x = S + 2 * hw;
  float* const I0y = S + 3 * hw;
  float* const t1 = S + 4 * hw;  // row pass of I1, I1x, I1y
  float* const t1x = S + 5 * hw;
  float* const t1y = S + 6 * hw;
  float* const Iz = S + 7 * hw;  // warp constants
  float* const Ix = S + 8 * hw;
  float* const Iy = S + 9 * hw;
  float* const Ixx = S + 10 * hw;
  float* const Ixy = S + 11 * hw;
  float* const Iyy = S + 12 * hw;
  float* const Ixz = S + 13 * hw;
  float* const Iyz = S + 14 * hw;
  float* const D0u = S + 15 * hw;  // (du, dv) at the inner step's start
  float* const D0v = S + 16 * hw;
  float* X = S + kDevicePlanes * hw;  // the placement's device planes

  extern __shared__ float smem[];
  __shared__ float red_in[kWarps];   // warp partials of the inner stop sum
  __shared__ float red_out[kWarps];  // and of the warp's stop sum
  // a shared plane with halo rows holds the longest band of the cluster
  const int hs = (P.band_rows + 2 * kHalo) * w;
  float* const M = smem + kHalo * w;  // band start of the first haloed plane
  // u, v; du buffer b at DU + b * ps, dv buffer b at DU + (2 + b) * ps
  float *U, *V, *DU;
  int ps;
  if constexpr (kS) {
    U = M; V = M + hs; DU = M + 2 * hs; ps = hs;
  } else {
    U = u_out; V = v_out; DU = X; ps = hw;
    X += 4 * hw;
  }
  float *PS, *A12, *B1, *B2, *RU, *RV;  // psi_s and the step's constants
  if constexpr (kC) {
    const int bs = P.band_rows * w;
    PS = M + 6 * hs;
    A12 = smem + 7 * hs; B1 = A12 + bs; B2 = A12 + 2 * bs;
    RU = A12 + 3 * bs; RV = A12 + 4 * bs;
  } else {
    PS = X; A12 = X + hw; B1 = X + 2 * hw; B2 = X + 3 * hw;
    RU = X + 4 * hw; RV = X + 5 * hw;
  }
  Peer up{nullptr, 0}, dn{nullptr, 0};  // the bands above and below
  if constexpr (kS) {
    if (rank > 0) {
      up = {cluster.map_shared_rank(smem, rank - 1), (r0 - P.starts[rank - 1]) * w};
    }
    if (rank < nc - 1) dn = {cluster.map_shared_rank(smem, rank + 1), -bh * w};
  }
  auto sync = [&]() {
    if (nc > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  // Sum of `v` over the pair in a fixed order, the same bits in every
  // thread of the cluster. Ends after the pair's barrier.
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  auto pair_sum = [&](float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[wid] = v;
    sync();
    float t = 0.0f;
    for (int q = 0; q < nc; ++q) {
      const float* rq = nc > 1 ? cluster.map_shared_rank(red, q) : red;
      float x = lane < kWarps ? rq[lane] : 0.0f;
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
      t = q == 0 ? x : t + x;
    }
    return __shfl_sync(0xffffffffu, t, 0);
  };
  const float g = P.gamma, al = P.alpha, md = P.max_disp, eps2 = P.eps2;
  const float* const I1xf = I1x - b0;  // the whole planes, for the warp
  const float* const I1yf = I1y - b0;

  // ---- the level: u, v and the four image gradients ----
  for_band(npx, w, [&](int li, int r, int c) {
    const int gr = r0 + r, i = b0 + li;
    const float* row0 = I0 + gr * w;
    const float* row1 = I1 + gr * w;
    U[li] = __ldg(u_in + i);
    V[li] = __ldg(v_in + i);
    I1x[li] = d5([&](int k) { return __ldg(row1 + k); }, c, w);
    I1y[li] = d5([&](int k) { return __ldg(I1 + k * w + c); }, gr, h);
    I0x[li] = d5([&](int k) { return __ldg(row0 + k); }, c, w);
    I0y[li] = d5([&](int k) { return __ldg(I0 + k * w + c); }, gr, h);
  });
  if constexpr (kS) {
    for_halo(w, bh, r0, h, [&](int j, int gr, int c) {
      U[j] = __ldg(u_in + gr * w + c);
      V[j] = __ldg(v_in + gr * w + c);
    });
  }
  // every CTA of the cluster has started before any DSMEM access, and the
  // image gradients are in place before any band's warp reads them
  sync();

  int n_outer = 0, n_inner = 0;
  bool done = false;
  while (!done && n_outer < P.outer) {
    // ---- warp, pass 1: along rows at v, any row of I1, I1x, I1y ----
    for_band(npx, w, [&](int li, int r, int c) {
      const CubicTaps t = plane_ops::cubic_taps(r0 + r, ld<kS>(V + li), h, md);
      float oa = 0.0f, ob = 0.0f, oc = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = t.i[m] * w + c;
        oa = oa + t.w[m] * __ldg(I1 + j);
        ob = ob + t.w[m] * __ldcg(I1xf + j);
        oc = oc + t.w[m] * __ldcg(I1yf + j);
      }
      t1[li] = oa; t1x[li] = ob; t1y[li] = oc;
    });
    __syncthreads();
    // ---- pass 2: along columns at u, the band's own rows; Iz = I1w - I0;
    // the inner loop starts from (du, dv) = 0 in buffer 0 ----
    for_band(npx, w, [&](int li, int r, int c) {
      const CubicTaps t = plane_ops::cubic_taps(c, ld<kS>(U + li), w, md);
      float ow = 0.0f, ox = 0.0f, oy = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = r * w + t.i[m];
        ow = ow + t.w[m] * t1[j];
        ox = ox + t.w[m] * t1x[j];
        oy = oy + t.w[m] * t1y[j];
      }
      Iz[li] = ow - __ldg(I0 + b0 + li);
      Ix[li] = ox;
      Iy[li] = oy;
      DU[li] = 0.0f;
      DU[2 * ps + li] = 0.0f;
    });
    if constexpr (kS) {
      for_halo(w, bh, r0, h, [&](int j, int, int) {
        DU[j] = 0.0f;
        DU[2 * ps + j] = 0.0f;
      });
    }
    sync();
    // ---- the warp's derivative planes: Ix, Iy two rows past the band ----
    for_band(npx, w, [&](int li, int r, int c) {
      const int gr = r0 + r;
      const float* rx = Ix + r * w;
      Ixx[li] = d5([&](int k) { return __ldcg(rx + k); }, c, w);
      Ixy[li] = d5([&](int k) { return __ldcg(Ix + (k - r0) * w + c); }, gr, h);
      Iyy[li] = d5([&](int k) { return __ldcg(Iy + (k - r0) * w + c); }, gr, h);
      Ixz[li] = __ldcg(Ix + li) - __ldcg(I0x + li);
      Iyz[li] = __ldcg(Iy + li) - __ldcg(I0y + li);
    });

    int cur = 0;  // the buffer holding (du, dv)
    for (int it = 0; it < P.inner; ++it) {
      const float* du0 = DU + cur * ps;
      const float* dv0 = DU + (2 + cur) * ps;
      // ---- psi_s from the _D5 gradients of U = u + du, V = v + dv ----
      for_band(npx, w, [&](int li, int r, int c) {
        const int gr = r0 + r, rw = r * w;
        const float Ux = d5([&](int k) {
          return ld<kS>(U + rw + k) + ld<kS>(du0 + rw + k); }, c, w);
        const float Uy = d5([&](int k) {
          const int j = (k - r0) * w + c;
          return ld<kS>(U + j) + ld<kS>(du0 + j); }, gr, h);
        const float Vx = d5([&](int k) {
          return ld<kS>(V + rw + k) + ld<kS>(dv0 + rw + k); }, c, w);
        const float Vy = d5([&](int k) {
          const int j = (k - r0) * w + c;
          return ld<kS>(V + j) + ld<kS>(dv0 + j); }, gr, h);
        const float s2 = Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy;
        const float p = 1.0f / sqrtf(s2 + eps2);
        PS[li] = p;
        if constexpr (kC) {
          if (r == 0 && up.base) up.put(smem, PS, li, p);
          if (r == bh - 1 && dn.base) dn.put(smem, PS, li, p);
        }
        D0u[li] = ld<kS>(du0 + li);
        D0v[li] = ld<kS>(dv0 + li);
      });
      sync();
      // ---- psi_d, the interface weights and the 2x2 system ----
      for_band(npx, w, [&](int li, int r, int c) {
        const int gr = r0 + r;
        const float du = ld<kS>(du0 + li), dv = ld<kS>(dv0 + li);
        const float iz = __ldcg(Iz + li), ix = __ldcg(Ix + li), iy = __ldcg(Iy + li);
        const float ixx = __ldcg(Ixx + li), ixy = __ldcg(Ixy + li), iyy = __ldcg(Iyy + li);
        const float ixz = __ldcg(Ixz + li), iyz = __ldcg(Iyz + li);
        const float r_data = iz + ix * du + iy * dv;
        const float r_gx = ixz + ixx * du + ixy * dv;
        const float r_gy = iyz + ixy * du + iyy * dv;
        const float pd = 1.0f / sqrtf(r_data * r_data +
                                      g * (r_gx * r_gx + r_gy * r_gy) + eps2);
        const float p = ld<kC>(PS + li);
        const float e = 0.5f * (p + ld<kC>(PS + li + (c < w - 1 ? 1 : 0)));
        const float we = 0.5f * (p + ld<kC>(PS + li - (c > 0 ? 1 : 0)));
        const float s_ = 0.5f * (p + ld<kC>(PS + li + (gr < h - 1 ? w : 0)));
        const float n_ = 0.5f * (p + ld<kC>(PS + li - (gr > 0 ? w : 0)));
        const float ws = e + we + s_ + n_;
        const float a11 = pd * (ix * ix + g * (ixx * ixx + ixy * ixy));
        const float a_12 = pd * (ix * iy + g * (ixx * ixy + ixy * iyy));
        const float a22 = pd * (iy * iy + g * (ixy * ixy + iyy * iyy));
        A12[li] = a_12;
        B1[li] = -pd * (iz * ix + g * (ixz * ixx + iyz * ixy));
        B2[li] = -pd * (iz * iy + g * (ixz * ixy + iyz * iyy));
        RU[li] = 1.0f / (a11 + al * ws);
        RV[li] = 1.0f / (a22 + al * ws);
      });
      // ---- Jacobi sweeps between the two buffers; the inner stop against
      // the step's start (D0u, D0v) ----
      float err_i = 0.0f;
      for (int k = 0; k < P.solver; ++k) {
        const bool last = k == P.solver - 1;
        const float* dus = DU + cur * ps;
        const float* dvs = DU + (2 + cur) * ps;
        float* dud = DU + (1 - cur) * ps;
        float* dvd = DU + (3 - cur) * ps;
        float local = 0.0f;
        for_band(npx, w, [&](int li, int r, int c) {
          const int gr = r0 + r;
          const int iE = li + (c < w - 1 ? 1 : 0);
          const int iW = li - (c > 0 ? 1 : 0);
          const int iS = li + (gr < h - 1 ? w : 0);
          const int iN = li - (gr > 0 ? w : 0);
          const float p = ld<kC>(PS + li);
          const float e = 0.5f * (p + ld<kC>(PS + iE));
          const float we = 0.5f * (p + ld<kC>(PS + iW));
          const float s_ = 0.5f * (p + ld<kC>(PS + iS));
          const float n_ = 0.5f * (p + ld<kC>(PS + iN));
          const float ws = e + we + s_ + n_;
          const float lap_u = e * (ld<kS>(U + iE) + ld<kS>(dus + iE)) +
                              we * (ld<kS>(U + iW) + ld<kS>(dus + iW)) +
                              s_ * (ld<kS>(U + iS) + ld<kS>(dus + iS)) +
                              n_ * (ld<kS>(U + iN) + ld<kS>(dus + iN)) -
                              ws * ld<kS>(U + li);
          const float lap_v = e * (ld<kS>(V + iE) + ld<kS>(dvs + iE)) +
                              we * (ld<kS>(V + iW) + ld<kS>(dvs + iW)) +
                              s_ * (ld<kS>(V + iS) + ld<kS>(dvs + iS)) +
                              n_ * (ld<kS>(V + iN) + ld<kS>(dvs + iN)) -
                              ws * ld<kS>(V + li);
          const float c12 = ld<kC>(A12 + li);
          const float dun = (ld<kC>(B1 + li) - c12 * ld<kS>(dvs + li) + al * lap_u) *
                            ld<kC>(RU + li);
          const float dvn = (ld<kC>(B2 + li) - c12 * dun + al * lap_v) * ld<kC>(RV + li);
          dud[li] = dun;
          dvd[li] = dvn;
          if constexpr (kS) {
            if (r < kHalo && up.base) {
              up.put(smem, dud, li, dun);
              up.put(smem, dvd, li, dvn);
            }
            if (r >= bh - kHalo && dn.base) {
              dn.put(smem, dud, li, dun);
              dn.put(smem, dvd, li, dvn);
            }
          }
          if (last) {
            const float ex = dun - __ldcg(D0u + li), ey = dvn - __ldcg(D0v + li);
            local = local + (ex * ex + ey * ey);
          }
        });
        if (last) {
          err_i = pair_sum(local, red_in);
        } else {
          sync();
        }
        cur = 1 - cur;
      }
      // no sweep: the next step's psi_s pushes wait for this step's reads
      if (P.solver == 0) sync();
      ++n_inner;
      if (P.stop >= 0.0f && err_i <= P.stop * 0.0625f) break;
    }

    // ---- u += du, v += dv (the halo rows too, from the pushed (du, dv)
    // halo, as the neighbour computes them); the warp's stop ----
    const float* du = DU + cur * ps;
    const float* dv = DU + (2 + cur) * ps;
    float local = 0.0f;
    for_band(npx, w, [&](int li, int, int) {
      const float a = ld<kS>(du + li), b = ld<kS>(dv + li);
      local = local + (a * a + b * b);
      U[li] = ld<kS>(U + li) + a;
      V[li] = ld<kS>(V + li) + b;
    });
    if constexpr (kS) {
      for_halo(w, bh, r0, h, [&](int j, int, int) {
        U[j] = U[j] + du[j];
        V[j] = V[j] + dv[j];
      });
    }
    const float err = pair_sum(local, red_out);
    ++n_outer;
    done = P.stop >= 0.0f && err <= P.stop;
  }
  // no CTA leaves while another may still read its shared memory
  sync();
  if constexpr (kS) {
    for_band(npx, w, [&](int li, int, int) {
      u_out[li] = U[li];
      v_out[li] = V[li];
    });
  }
  if (rank == 0 && threadIdx.x == 0) {
    counts[3 * pair] = n_outer;
    counts[3 * pair + 1] = n_inner;
    counts[3 * pair + 2] = n_inner * P.solver;
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        float*, float*, float*, int*, Params);

Kernel kernel_for(int placement) {
  return placement == kShared  ? brox_band_kernel<kShared>
         : placement == kSplit ? brox_band_kernel<kSplit>
                               : brox_band_kernel<kDevice>;
}

constexpr int kBadPlan = -1;

// P from the plan that kernels/brox_fused.py::_plan made; kBadPlan if the
// plan is not one this kernel runs (bands that do not tile 0..h-1, a band
// in shared memory shorter than its halo, a cluster over 16, or bytes and
// planes other than the placement needs).
int make_params(Params* P, int h, int w, int placement, int nc, const int* starts,
                int smem, int scratch) {
  if (placement < kDevice || placement > kSplit) return kBadPlan;
  if (h < 1 || w < 1 || nc < 1 || nc > kMaxCtas) return kBadPlan;
  if (starts[0] != 0 || starts[nc] != h) return kBadPlan;
  int rows = 0;
  const int least = state_in_smem(placement) && nc > 1 ? kHalo : 1;
  for (int k = 0; k < nc; ++k) {
    const int d = starts[k + 1] - starts[k];
    if (d < least) return kBadPlan;
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

cudaLaunchConfig_t launch_config(int nc, int batch, int smem, cudaLaunchAttribute* attr,
                                 void* stream) {
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
extern "C" int brox_scale_max_active_clusters(int h, int w, int placement,
                                              int nc, const int* starts,
                                              int smem, int scratch, int* out) {
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

// Launch one level on `stream` with the plan (placement, nc CTAs a pair,
// band rows starts[0..nc], smem bytes of dynamic shared memory a CTA,
// `scratch` planes a pair). u_out, v_out receive the refined
// flow, counts[3b..3b+2] the warps, inner steps and Jacobi sweeps pair b
// ran. Returns -1 for a plan the kernel does not run, else the launch's
// CUDA error, or 0.
extern "C" int brox_scale_launch(
    const float* I0, const float* I1, const float* u_in, const float* v_in,
    float* u_out, float* v_out, float* scratch, int* counts, int batch, int h,
    int w, float alpha, float gamma, float max_disp, float stop, float eps2,
    int inner, int outer, int solver, int placement, int nc, const int* starts,
    int smem, int scratch_n, void* stream) {
  Params P{};
  const int e = make_params(&P, h, w, placement, nc, starts, smem, scratch_n);
  if (e != 0) return e;
  P.inner = inner;
  P.outer = outer;
  P.solver = solver;
  P.alpha = alpha;
  P.gamma = gamma;
  P.max_disp = max_disp;
  P.stop = stop;
  P.eps2 = eps2;
  const Kernel fn = kernel_for(placement);
  cudaError_t ce = set_attributes(fn, nc, smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(nc, batch, smem, attr, stream);
  ce = cudaLaunchKernelEx(&cfg, fn, I0, I1, u_in, v_in, u_out, v_out, scratch,
                          counts, P);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
