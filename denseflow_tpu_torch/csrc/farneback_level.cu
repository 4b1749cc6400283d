// One Farneback pyramid level for a batch of frame pairs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel denseflow_tpu/kernels/farneback_fused.py::
// farneback_level_fused (body _make_kernel) and its spatial tiler
// farneback_level_fused_tiled, which exists only to fit VMEM: this kernel
// computes the untiled answer at every geometry. Per pair it runs up to
// num_iters iterations of:
//   1. warp the five R1 polynomial planes, rows at v and then columns at u,
//      linearly, displacement clamped to +-max_disp and positions to the
//      level (plane_ops::linear_taps);
//   2. average them with R0 and apply OpenCV's border ramp;
//   3. build the five normal-equation planes M = (G11, G12, G22, h1, h2);
//   4. box-blur each win x win with replicate borders, columns then rows,
//      in the float order of the Pallas cascade (plane_ops::box_sum);
//   5. solve the 2x2 system with +1e-3 and test the pair's stop,
//      sum(du^2 + dv^2) <= stop_eps^2*h*w. The update of the iteration that
//      meets it is kept.
//
// Design: one launch a level, a thread-block cluster of n CTAs a pair, grid
// = n x B. CTA k owns band k of its pair: full-width rows starts[k] ..
// starts[k+1]-1 (the plan, kernels/farneback_fused.py::_plan, from (h, w)
// alone). The iterations run on the card; a pair whose stop is met leaves
// the loop, so no dead iteration costs anything. An iteration is three
// stages over the band:
//   M       the warp and the normal equations, a pixel a thread. The column
//           pass at u reads v only on the pixel's own row, so a band needs
//           no u or v of its neighbours. R0 and R1 are read-only and read
//           through L2 (__ldg). A CTA keeps M with kHalo = 6 halo rows on
//           each side: it writes its own first and last kHalo rows into its
//           neighbours' halos as well, and the rows 0 and h-1 of the level
//           into every CTA's edge rows E, ordered by the barrier that ends
//           the stage. Halo rows outside the level, and kHalo columns on
//           each side of every row, stay zero: they are the cascade's zero
//           padding, so no tap is bounds-checked.
//   columns the vertical box sum, in place: a thread walks one column of
//           one plane down the band with the win-tap window in registers,
//           one read a row, and overwrites each row once the window has
//           passed it. Only this CTA reads its copy of M, so nothing waits.
//   rows    the horizontal box sum of the five planes at a pixel, from the
//           band's own rows, then the solve; u and v are updated in place
//           (M is complete, and the next iteration reads u and v only after
//           the stop sum's barrier).
// With n = 1 the barriers are __syncthreads(); else the cluster's.
//
// Placement (a template parameter; the plan picks it by (h, w)):
//   kShared  u, v (band rows) and M (band + halo rows) in shared memory;
//   kSplit   M in shared memory, u and v in the outputs' band rows;
//   kDevice  M in band-owned device memory too, for geometries that no
//            cluster holds (360x480, 1080p).
// Planes written inside the kernel are read from device memory with __ldcg
// (L2, not the SM's L1), so a CTA never reads a stale line.
//
// The stop sum is reduced in a fixed order with no float atomics: each
// thread adds its pixels in a fixed order, each warp by a shuffle tree into
// shared memory; after the barrier every warp of every CTA adds the n CTAs'
// warp partials in rank order over DSMEM, so every CTA takes the same
// decision. The plan depends only on (h, w): a pair's bytes depend neither
// on its batch-mates nor on B.
//
// The window is a template parameter (odd, up to kMaxWin = 13, the halo's
// reach), so every tap of the cascade is a constant index into registers.
//
// What bounds it: neither bytes (14 planes a pair a level) nor the f32 rate
// (~350 operations a pixel an iteration), but each iteration's dependent
// stages: two barriers, a pass over the band by 512 threads of one SM, and
// the column walks, each as long as the band. PERF.md has the times per
// level beside the plans not taken.
//
// Built with --fmad=false and IEEE division: each product and sum rounded
// on its own, as in the plain version (kernels/farneback_fused.py::
// farneback_level_reference), so the two agree bit for bit up to the order
// of the stop sum, which only moves a stop that lands on its threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "plane_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using plane_ops::LinearTaps;

constexpr int kMaxCtas = 16;        // a non-portable cluster
constexpr int kPortableCtas = 8;
constexpr int kSmemLimit = 232448;  // shared memory a CTA may use on sm_90
constexpr int kMaxWin = 13;
constexpr int kHalo = kMaxWin / 2;  // halo rows of M each side
constexpr int kThreads = 512;       // a CTA's threads
constexpr int kWarps = kThreads / 32;

// Where the state lives; the numbers are kernels/farneback_fused.py::_PLACEMENTS.
enum Placement : int { kDevice = 0, kShared = 1, kSplit = 2 };

__host__ __device__ constexpr bool uv_in_smem(int p) { return p == kShared; }
__host__ __device__ constexpr bool m_in_smem(int p) { return p != kDevice; }

// A row of M holds kHalo zero columns each side: the cascade's zero
// padding along the row, so the row pass reads its taps unchecked.
__host__ __device__ constexpr int m_row(int w) { return w + 2 * kHalo; }

// Floats of a CTA's M: five planes of the longest band plus the halo rows.
__host__ __device__ constexpr int m_floats(int rows, int w) {
  return 5 * (rows + 2 * kHalo) * m_row(w);
}

// Dynamic shared memory of a CTA, in bytes: the edge rows E (rows 0 and h-1
// of the five planes), then u and v, then M, as the placement keeps them.
int smem_bytes(int placement, int rows, int w) {
  int f = 10 * w;
  if (uv_in_smem(placement)) f += 2 * rows * w;
  if (m_in_smem(placement)) f += m_floats(rows, w);
  return (int)sizeof(float) * f;
}

// (h, w) planes of device memory a pair needs besides the outputs: every
// CTA's M in the device placement.
int scratch_planes(int placement, int nc, int rows, int h, int w) {
  if (placement != kDevice) return 0;
  const long f = (long)nc * m_floats(rows, w);
  return (int)((f + (long)h * w - 1) / ((long)h * w));
}

struct Params {
  int h, w, num_iters;
  float max_disp, inv_win, stop;
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
// thread owns the same pixels in every pass, so the order of the stop sum is
// fixed.
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

// The vertical box sum of one column of M, in place, times inv_win. col
// points at the column's band row 0; rows -kHalo .. bh + kHalo - 1 are at
// col[row * wp]. lo and hi are the column's values at the level's rows 0
// and h-1; r0 is the band's first row in the level.
template <int kWin, bool kSmem>
__device__ __forceinline__ void column_box(float* col, int wp, int bh, int r0,
                                           int h, float lo, float hi,
                                           float inv_win) {
  constexpr int ctr = kWin / 2;
  float z[kWin];  // rows y - ctr .. y + ctr
#pragma unroll
  for (int i = 0; i < kWin - 1; ++i) z[i] = ld<kSmem>(col + (i - ctr) * wp);
  for (int y = 0; y < bh; ++y) {
    z[kWin - 1] = ld<kSmem>(col + (y + ctr) * wp);
    const float s = plane_ops::box_sum<kWin>([&](int i) { return z[i]; },
                                             r0 + y, h, lo, hi);
    col[y * wp] = s * inv_win;
#pragma unroll
    for (int i = 0; i < kWin - 1; ++i) z[i] = z[i + 1];
  }
}

template <int kMode, int kWin>
__global__ void __launch_bounds__(kThreads, 1)
farneback_band_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                      const float* __restrict__ u_in,
                      const float* __restrict__ v_in, float* u_out,
                      float* v_out, float* scratch, int* iters, const Params P) {
  constexpr bool kU = uv_in_smem(kMode);
  constexpr bool kM = m_in_smem(kMode);
  constexpr int ctr = kWin / 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = P.nc;
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.y;
  const int h = P.h, w = P.w, hw = h * w;
  const int r0 = P.starts[rank];
  const int bh = P.starts[rank + 1] - r0, npx = bh * w;
  const int b0 = r0 * w;  // the band's first pixel in the pair's planes
  const size_t off = (size_t)pair * hw;
  R0 += 5 * off + b0;  // R0 at the band's first pixel, R1 whole
  R1 += 5 * off;
  u_in += off + b0;
  v_in += off + b0;
  u_out += off + b0;
  v_out += off + b0;
  const int mf = m_floats(P.band_rows, w);
  const int wp = m_row(w);
  const int ps = (P.band_rows + 2 * kHalo) * wp;  // a plane of M

  extern __shared__ float smem[];
  __shared__ float red[kWarps];  // warp partials of the stop sum
  float* const E = smem;         // E[(s * 5 + k) * w + c], s = 0: row 0, 1: row h-1
  float* s_next = smem + 10 * w;
  float *U, *V;
  if constexpr (kU) {
    U = s_next;
    V = s_next + P.band_rows * w;
    s_next += 2 * P.band_rows * w;
  } else {
    U = u_out;
    V = v_out;
  }
  // M of CTA q: plane k's band row r, column c at
  // Mq + k * ps + (kHalo + r) * wp + kHalo + c
  auto m_of = [&](int q) -> float* {
    if constexpr (kM) {
      return q == rank ? s_next : cluster.map_shared_rank(s_next, q);
    } else {
      return scratch + ((size_t)pair * nc + q) * mf;
    }
  };
  float* const M = m_of(rank);
  float* const up = rank > 0 ? m_of(rank - 1) : nullptr;
  float* const dn = rank < nc - 1 ? m_of(rank + 1) : nullptr;
  const int up_rows = rank > 0 ? r0 - P.starts[rank - 1] : 0;

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
  auto pair_sum = [&](float v) {
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

  // ---- u, v in ----
  for_band(npx, w, [&](int li, int, int) {
    U[li] = __ldg(u_in + li);
    V[li] = __ldg(v_in + li);
  });
  // zero all of M: the padding columns stay so, and the halo rows
  // outside the level too; the neighbours' rows arrive after the barrier
  for (int k = threadIdx.x; k < mf; k += kThreads) M[k] = 0.0f;
  // every CTA of the cluster has started before any DSMEM access
  sync();

  const float md = P.max_disp, inv_win = P.inv_win;
  int n_iters = 0;
  bool done = false;
  while (!done && n_iters < P.num_iters) {
    // ---- M: warp and normal equations; halo and edge rows to the peers ----
    for_band(npx, w, [&](int li, int r, int c) {
      const int gr = r0 + r;
      const float uu = ld<kU>(U + li), vv = ld<kU>(V + li);
      const float* vrow = V + r * w;
      // columns at u; at each column tap, the row pass at that column's v
      const LinearTaps tc = plane_ops::linear_taps(c, uu, w, md);
      const LinearTaps ta = plane_ops::linear_taps(gr, ld<kU>(vrow + tc.i0), h, md);
      const LinearTaps tb = plane_ops::linear_taps(gr, ld<kU>(vrow + tc.i1), h, md);
      float ws[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float* p = R1 + (size_t)k * hw;
        float t0 = 0.0f;
        t0 = t0 + ta.w0 * __ldg(p + ta.i0 * w + tc.i0);
        t0 = t0 + ta.w1 * __ldg(p + ta.i1 * w + tc.i0);
        float t1 = 0.0f;
        t1 = t1 + tb.w0 * __ldg(p + tb.i0 * w + tc.i1);
        t1 = t1 + tb.w1 * __ldg(p + tb.i1 * w + tc.i1);
        float o = 0.0f;
        o = o + tc.w0 * t0;
        o = o + tc.w1 * t1;
        ws[k] = o;
      }
      const float* q0 = R0 + li;
      float a11 = (__ldg(q0 + 2 * (size_t)hw) + ws[2]) * 0.5f;
      float a22 = (__ldg(q0 + 3 * (size_t)hw) + ws[3]) * 0.5f;
      float a12 = (__ldg(q0 + 4 * (size_t)hw) + ws[4]) * 0.25f;
      const float db1 = (__ldg(q0) - ws[0]) * 0.5f;
      const float db2 = (__ldg(q0 + hw) - ws[1]) * 0.5f;
      float b1 = (db1 + a11 * uu) + a12 * vv;
      float b2 = (db2 + a12 * uu) + a22 * vv;
      const float bs = plane_ops::border_scale(gr, c, h, w);
      a11 = a11 * bs;
      a22 = a22 * bs;
      a12 = a12 * bs;
      b1 = b1 * bs;
      b2 = b2 * bs;
      float m[5];
      m[0] = a11 * a11 + a12 * a12;  // G11
      m[1] = (a11 + a22) * a12;      // G12
      m[2] = a22 * a22 + a12 * a12;  // G22
      m[3] = a11 * b1 + a12 * b2;    // h1
      m[4] = a12 * b1 + a22 * b2;    // h2
      const int j = (kHalo + r) * wp + kHalo + c;
#pragma unroll
      for (int k = 0; k < 5; ++k) M[k * ps + j] = m[k];
      if (r < kHalo && up) {
#pragma unroll
        for (int k = 0; k < 5; ++k) up[k * ps + j + up_rows * wp] = m[k];
      }
      if (r >= bh - kHalo && dn) {
#pragma unroll
        for (int k = 0; k < 5; ++k) dn[k * ps + j - bh * wp] = m[k];
      }
      if (gr == 0 || gr == h - 1) {
        for (int q = 0; q < nc; ++q) {
          float* eq = nc > 1 ? cluster.map_shared_rank(E, q) : E;
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            if (gr == 0) eq[k * w + c] = m[k];
            if (gr == h - 1) eq[(5 + k) * w + c] = m[k];
          }
        }
      }
    });
    sync();
    // ---- columns: the vertical box sum of each plane, in place ----
    for (int t = threadIdx.x; t < 5 * w; t += kThreads) {
      const int k = t / w, c = t - k * w;
      column_box<kWin, kM>(M + k * ps + kHalo * wp + kHalo + c, wp, bh, r0, h,
                           E[k * w + c], E[(5 + k) * w + c], inv_win);
    }
    __syncthreads();
    // ---- rows: the horizontal box sum, the solve, u and v in place ----
    float local = 0.0f;
    for_band(npx, w, [&](int li, int r, int c) {
      float g[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float* row = M + k * ps + (kHalo + r) * wp + kHalo;  // column 0
        const float* taps = row + c - ctr;  // the zero padding past the edges
        const float s = plane_ops::box_sum<kWin>(
            [&](int i) { return ld<kM>(taps + i); }, c, w, ld<kM>(row),
            ld<kM>(row + w - 1));
        g[k] = s * inv_win;
      }
      const float g11 = g[0], g12 = g[1], g22 = g[2], h1 = g[3], h2 = g[4];
      const float idet = 1.0f / ((g11 * g22 - g12 * g12) + 1e-3f);
      const float un = (g22 * h1 - g12 * h2) * idet;
      const float vn = (g11 * h2 - g12 * h1) * idet;
      const float du = un - ld<kU>(U + li), dv = vn - ld<kU>(V + li);
      U[li] = un;
      V[li] = vn;
      local = local + (du * du + dv * dv);
    });
    const float err = pair_sum(local);
    ++n_iters;
    done = err <= P.stop;
  }
  // no CTA leaves while another may still read its shared memory
  sync();
  if constexpr (kU) {
    for_band(npx, w, [&](int li, int, int) {
      u_out[li] = U[li];
      v_out[li] = V[li];
    });
  }
  if (rank == 0 && threadIdx.x == 0) iters[pair] = n_iters;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        float*, float*, float*, int*, Params);

template <int kMode>
Kernel kernel_for_window(int win) {
  switch (win) {
    case 1: return farneback_band_kernel<kMode, 1>;
    case 3: return farneback_band_kernel<kMode, 3>;
    case 5: return farneback_band_kernel<kMode, 5>;
    case 7: return farneback_band_kernel<kMode, 7>;
    case 9: return farneback_band_kernel<kMode, 9>;
    case 11: return farneback_band_kernel<kMode, 11>;
    case 13: return farneback_band_kernel<kMode, 13>;
    default: return nullptr;
  }
}

Kernel kernel_for(int placement, int win) {
  return placement == kShared  ? kernel_for_window<kShared>(win)
         : placement == kSplit ? kernel_for_window<kSplit>(win)
                               : kernel_for_window<kDevice>(win);
}

constexpr int kBadPlan = -1;

// P from the plan that kernels/farneback_fused.py::_plan made; kBadPlan if
// the plan or window is not one this kernel runs (an even window or one
// over kMaxWin, bands that do not tile 0..h-1, a band of a cluster shorter
// than the halo, a cluster over 16, or bytes and planes other than the
// placement needs).
int make_params(Params* P, int h, int w, int win, int placement, int nc,
                const int* starts, int smem, int scratch) {
  if (placement < kDevice || placement > kSplit) return kBadPlan;
  if (win < 1 || win > kMaxWin || win % 2 == 0) return kBadPlan;
  if (h < 1 || w < 1 || nc < 1 || nc > kMaxCtas) return kBadPlan;
  if (starts[0] != 0 || starts[nc] != h) return kBadPlan;
  int rows = 0;
  const int least = nc > 1 ? kHalo : 1;
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
      scratch != scratch_planes(placement, nc, rows, h, w)) {
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
// (cudaOccupancyMaxActiveClusters) into *out. Returns -1 for a plan or
// window the kernel does not run, else the CUDA error, or 0.
extern "C" int farneback_level_max_active_clusters(int h, int w, int win,
                                                   int placement, int nc,
                                                   const int* starts, int smem,
                                                   int scratch, int* out) {
  Params P{};
  const int e = make_params(&P, h, w, win, placement, nc, starts, smem, scratch);
  if (e != 0) return e;
  const Kernel fn = kernel_for(placement, win);
  cudaError_t ce = set_attributes(fn, nc, smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(nc, 1, smem, attr, nullptr);
  ce = cudaOccupancyMaxActiveClusters(out, (const void*)fn, &cfg);
  return (int)ce;
}

// Launch one level on `stream` with the plan (placement, nc CTAs a pair,
// band rows starts[0..nc], smem bytes of dynamic shared memory a CTA,
// `scratch_n` planes a pair of `scratch`). u_out, v_out receive the flow
// refined from u_in, v_in, iters[b] the iterations pair b ran. Returns -1
// for a plan or window the kernel does not run, else the launch's CUDA
// error, or 0.
extern "C" int farneback_level_launch(
    const float* R0, const float* R1, const float* u_in, const float* v_in,
    float* u_out, float* v_out, float* scratch, int* iters, int batch, int h,
    int w, int win, int num_iters, float max_disp, float inv_win, float stop,
    int placement, int nc, const int* starts, int smem, int scratch_n,
    void* stream) {
  Params P{};
  const int e = make_params(&P, h, w, win, placement, nc, starts, smem, scratch_n);
  if (e != 0) return e;
  P.num_iters = num_iters;
  P.max_disp = max_disp;
  P.inv_win = inv_win;
  P.stop = stop;
  const Kernel fn = kernel_for(placement, win);
  cudaError_t ce = set_attributes(fn, nc, smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(nc, batch, smem, attr, stream);
  ce = cudaLaunchKernelEx(&cfg, fn, R0, R1, u_in, v_in, u_out, v_out, scratch,
                          iters, P);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
