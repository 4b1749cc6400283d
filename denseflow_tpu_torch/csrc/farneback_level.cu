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
//   3. build the five normal-equation planes (G11, G12, G22, h1, h2);
//   4. box-blur each win x win with replicate borders, rows then columns,
//      in the float order of the Pallas cascade (plane_ops::box_sum);
//   5. solve the 2x2 system with +1e-3 and test the pair's stop,
//      sum(du^2 + dv^2) <= stop_eps^2*h*w. The update of the iteration that
//      meets it is kept.
//
// Design: a pair's state at 256x341 (R0, R1, u, v and ten scratch planes,
// ~8 MB; 16 pairs hold ~130 MB) is far larger than an SM's 227 KB of shared
// memory and than the 50 MB L2, so it lives in device memory. An iteration's
// dependencies reach only one blur window, so each stage is one launch over
// a grid of (pixel blocks x pairs), 256 threads a block, one pixel a thread:
//   update_kernel      warp + normal equations      -> M  (5 planes)
//   vbox_kernel        vertical box sum of M        -> MV (5 planes)
//   hbox_solve_kernel  horizontal box sum, solve, u and v in place, and
//                      each block's share of the stop sum -> partials
//   decide_kernel      per pair, the partials summed in block order; counts
//                      the iteration and clears the pair's `active` flag
//                      when it stops.
// The host enqueues init + num_iters x these four on one stream with no
// synchronisation; a stopped pair's blocks read `active` and exit at once.
// The stop sum is reduced in a fixed order without float atomics, so a
// pair's bytes depend neither on its batch-mates nor on B.
//
// The warp is fused into update_kernel: the column pass at u reads, at its
// two column taps, the row pass at v of that column, computed on the spot
// (the Pallas kernel stores the row pass as a plane). Each pixel gathers
// 5 x 2 x 2 R1 values.
//
// What bounds it: operations. Counted from the code, an iteration does about
// 350 f32 operations a pixel (update 165, the two box passes 85 each, solve
// and stop 19) against 14 planes of bytes a level (R0, R1, u, v read once,
// u, v written once); at 10 iterations that is ~250 operations per byte, far
// above the card's 20. The M and MV planes and the gathers go through L2.
//
// Built with --fmad=false and exact division: each product and sum rounded
// on its own, as in the plain version (kernels/farneback_fused.py::
// farneback_level_reference), so the two agree up to the order of the stop
// sum, which only moves a stop that lands on its threshold.

#include <cuda_runtime.h>
#include <math.h>

#include "plane_ops.cuh"

namespace {

using plane_ops::LinearTaps;

constexpr int kThreads = 256;
constexpr int kScratchPlanes = 10;  // M and MV, 5 planes each

struct Params {
  int h, w, win;
  float max_disp, inv_win, stop;
};

// A line of a plane: element k at p[k * stride].
struct Line {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int k) const {
    return p[(size_t)k * stride];
  }
};

__global__ void init_kernel(int* active, int* iters, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < batch) {
    active[b] = 1;
    iters[b] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
              const float* __restrict__ u, const float* __restrict__ v,
              float* __restrict__ M, const int* __restrict__ active,
              Params P) {
  const int b = blockIdx.y;
  if (!active[b]) return;
  const int h = P.h, w = P.w, hw = h * w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= hw) return;
  const int r = i / w, c = i - r * w;
  const size_t fo = (size_t)b * hw;
  const float* r0 = R0 + 5 * fo + i;
  const float* r1 = R1 + 5 * fo;
  const float* vb = v + fo + (size_t)r * w;
  const float uu = u[fo + i], vv = v[fo + i];

  // columns at u; at each column tap, the row pass at that column's v
  const LinearTaps tc = plane_ops::linear_taps(c, uu, w, P.max_disp);
  const LinearTaps ta = plane_ops::linear_taps(r, vb[tc.i0], h, P.max_disp);
  const LinearTaps tb = plane_ops::linear_taps(r, vb[tc.i1], h, P.max_disp);
  float ws[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float* p = r1 + (size_t)k * hw;
    float t0 = 0.0f;
    t0 = t0 + ta.w0 * __ldg(p + (size_t)ta.i0 * w + tc.i0);
    t0 = t0 + ta.w1 * __ldg(p + (size_t)ta.i1 * w + tc.i0);
    float t1 = 0.0f;
    t1 = t1 + tb.w0 * __ldg(p + (size_t)tb.i0 * w + tc.i1);
    t1 = t1 + tb.w1 * __ldg(p + (size_t)tb.i1 * w + tc.i1);
    float o = 0.0f;
    o = o + tc.w0 * t0;
    o = o + tc.w1 * t1;
    ws[k] = o;
  }

  float a11 = (__ldg(r0 + 2 * (size_t)hw) + ws[2]) * 0.5f;
  float a22 = (__ldg(r0 + 3 * (size_t)hw) + ws[3]) * 0.5f;
  float a12 = (__ldg(r0 + 4 * (size_t)hw) + ws[4]) * 0.25f;
  const float db1 = (__ldg(r0) - ws[0]) * 0.5f;
  const float db2 = (__ldg(r0 + hw) - ws[1]) * 0.5f;
  float b1 = (db1 + a11 * uu) + a12 * vv;
  float b2 = (db2 + a12 * uu) + a22 * vv;
  const float bs = plane_ops::border_scale(r, c, h, w);
  a11 = a11 * bs;
  a22 = a22 * bs;
  a12 = a12 * bs;
  b1 = b1 * bs;
  b2 = b2 * bs;

  float* m = M + 5 * fo + i;
  m[0] = a11 * a11 + a12 * a12;              // G11
  m[hw] = (a11 + a22) * a12;                 // G12
  m[2 * (size_t)hw] = a22 * a22 + a12 * a12;  // G22
  m[3 * (size_t)hw] = a11 * b1 + a12 * b2;    // h1
  m[4 * (size_t)hw] = a12 * b1 + a22 * b2;    // h2
}

__global__ void __launch_bounds__(kThreads)
vbox_kernel(const float* __restrict__ M, float* __restrict__ MV,
            const int* __restrict__ active, Params P) {
  const int b = blockIdx.y;
  if (!active[b]) return;
  const int h = P.h, w = P.w, hw = h * w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= hw) return;
  const int r = i / w, c = i - r * w;
  const size_t base = 5 * (size_t)b * hw;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const Line col{M + base + (size_t)k * hw + c, w};
    MV[base + (size_t)k * hw + i] =
        plane_ops::box_sum(col, r, h, P.win) * P.inv_win;
  }
}

// Sum of `v` over the block in a fixed order (thread 0 gets the total).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
hbox_solve_kernel(const float* __restrict__ MV, float* __restrict__ u,
                  float* __restrict__ v, float* __restrict__ partials,
                  const int* __restrict__ active, Params P) {
  const int b = blockIdx.y;
  if (!active[b]) return;  // uniform over the block
  const int h = P.h, w = P.w, hw = h * w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float e = 0.0f;
  if (i < hw) {
    const int r = i / w, c = i - r * w;
    const size_t fo = (size_t)b * hw;
    float g[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const Line row{MV + 5 * fo + (size_t)k * hw + (size_t)r * w, 1};
      g[k] = plane_ops::box_sum(row, c, w, P.win) * P.inv_win;
    }
    const float g11 = g[0], g12 = g[1], g22 = g[2], h1 = g[3], h2 = g[4];
    const float idet = 1.0f / ((g11 * g22 - g12 * g12) + 1e-3f);
    const float un = (g22 * h1 - g12 * h2) * idet;
    const float vn = (g11 * h2 - g12 * h1) * idet;
    const float du = un - u[fo + i], dv = vn - v[fo + i];
    e = du * du + dv * dv;
    u[fo + i] = un;
    v[fo + i] = vn;
  }
  e = block_sum(e);
  if (threadIdx.x == 0) partials[(size_t)b * gridDim.x + blockIdx.x] = e;
}

__global__ void decide_kernel(const float* __restrict__ partials, int n_part,
                              int* active, int* iters, float stop) {
  const int b = blockIdx.x;
  if (threadIdx.x != 0 || !active[b]) return;
  const float* p = partials + (size_t)b * n_part;
  float err = 0.0f;
  for (int j = 0; j < n_part; ++j) err = err + p[j];
  iters[b] += 1;
  if (err <= stop) active[b] = 0;
}

}  // namespace

extern "C" int farneback_level_scratch_planes() { return kScratchPlanes; }

// Stop-sum partials a pair needs at an (h, w) level: one per pixel block.
extern "C" int farneback_level_partials(int h, int w) {
  return (h * w + kThreads - 1) / kThreads;
}

// Enqueue one level on `stream`: u, v are copied from u_in, v_in and
// refined in place; iters[b] receives the iterations pair b ran. scratch
// holds kScratchPlanes planes a pair, partials farneback_level_partials a
// pair, active one int a pair. Returns the first launch's CUDA error, or 0.
extern "C" int farneback_level_launch(
    const float* R0, const float* R1, const float* u_in, const float* v_in,
    float* u, float* v, float* scratch, float* partials, int* active,
    int* iters, int batch, int h, int w, int win, int num_iters,
    float max_disp, float inv_win, float stop, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t plane = (size_t)h * w;
  const size_t bytes = (size_t)batch * plane * sizeof(float);
  int err = (int)cudaMemcpyAsync(u, u_in, bytes, cudaMemcpyDeviceToDevice, s);
  if (err) return err;
  err = (int)cudaMemcpyAsync(v, v_in, bytes, cudaMemcpyDeviceToDevice, s);
  if (err) return err;
  init_kernel<<<(batch + 255) / 256, 256, 0, s>>>(active, iters, batch);
  if ((err = (int)cudaGetLastError())) return err;
  const Params P{h, w, win, max_disp, inv_win, stop};
  const int n_part = farneback_level_partials(h, w);
  const dim3 grid(n_part, batch);
  float* M = scratch;
  float* MV = scratch + 5 * batch * plane;
  for (int it = 0; it < num_iters; ++it) {
    update_kernel<<<grid, kThreads, 0, s>>>(R0, R1, u, v, M, active, P);
    if ((err = (int)cudaGetLastError())) return err;
    vbox_kernel<<<grid, kThreads, 0, s>>>(M, MV, active, P);
    if ((err = (int)cudaGetLastError())) return err;
    hbox_solve_kernel<<<grid, kThreads, 0, s>>>(MV, u, v, partials, active, P);
    if ((err = (int)cudaGetLastError())) return err;
    decide_kernel<<<batch, 32, 0, s>>>(partials, n_part, active, iters, stop);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}
