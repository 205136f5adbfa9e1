// Strided sliding-window moments over a NaN-masked f32 residual grid: the
// *_over_time hot loop of the query path.
//
// Replaces: m3_tpu/ops/pallas_window.py `_kernel` (built by `_build`,
// called from `window_stat` by `temporal._window_stat_strided`). Same
// function as the reference's default route, `temporal._window_stat`
// followed by [..., ::stride]: output cell (s, t) reduces the W cells
// [t * stride, t * stride + W) of row s, counting only finite cells
// (+-inf count as missing, as NaN does).
//
//   count  number of finite cells
//   sum    their sum
//   min    their least value; -0.0 orders below +0.0 (XLA's min)
//   max    their greatest value; +0.0 orders above -0.0 (XLA's max)
//   last   the value at the last finite cell, selected, never summed, so
//          a -0.0 survives
//   m2     sum of squared deviations from the window mean, two passes
//          over the cells (sum -> mean -> deviations): the one-pass
//          sumsq - n mu^2 form cancels in f32 when |mu| >> sigma
//
// Every stat also writes the count plane. Where a window has no finite
// cell the planes hold 0 (sum, last, m2), +inf (min) or -inf (max); the
// callers mask those cells to NaN.
//
// Bound on the H100: memory. The grid is read once and two planes are
// written: (S K + 2 S T_out) 4 bytes, 284.8 MB at [100,000, 438] with
// W = 30 and stride 3 (0.085 ms at 3.35 TB/s), 13.6 MB at the slice's
// [10,000, 119], W = 10 (4 us, below the launch latency).
//
// Design: one thread per output cell, looping over its W cells through
// the read-only cache. Neighbouring threads take neighbouring windows of
// one row, so their reads overlap and come mostly from L1; the S T_out
// outputs are written coalesced. No shared-memory staging and no running
// sums yet: the Pallas kernel's block structure and static unroll worked
// around Mosaic and are not carried over. The build has no fast-math
// flag, which could fold isfinite away.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum Stat { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kLast = 4, kM2 = 5 };

template <int STAT>
__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ resid, float* __restrict__ stat,
              float* __restrict__ count, int rows, int k, int w, int stride,
              int t_out) {
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (cell >= static_cast<int64_t>(rows) * t_out) return;
  const int64_t row = cell / t_out;
  const int t = static_cast<int>(cell - row * t_out);
  const float* x = resid + row * k + static_cast<int64_t>(t) * stride;

  int n = 0;
  float acc = 0.0f;
  if (STAT == kMin) acc = INFINITY;
  if (STAT == kMax) acc = -INFINITY;
  for (int j = 0; j < w; ++j) {
    const float v = __ldg(x + j);
    if (!isfinite(v)) continue;
    ++n;
    if (STAT == kSum || STAT == kM2) {
      acc += v;
    } else if (STAT == kMin) {
      if (v < acc || (v == 0.0f && acc == 0.0f && signbit(v))) acc = v;
    } else if (STAT == kMax) {
      if (v > acc || (v == 0.0f && acc == 0.0f && !signbit(v))) acc = v;
    } else if (STAT == kLast) {
      acc = v;
    }
  }
  const float cnt = static_cast<float>(n);
  if (STAT == kM2) {
    const float mu = acc / fmaxf(cnt, 1.0f);
    float m2 = 0.0f;
    for (int j = 0; j < w; ++j) {
      const float v = __ldg(x + j);
      if (!isfinite(v)) continue;
      const float d = v - mu;
      m2 += d * d;
    }
    acc = m2;
  }
  if (STAT == kCount) acc = cnt;
  stat[cell] = acc;
  count[cell] = cnt;
}

template <int STAT>
cudaError_t launch(const float* resid, float* stat, float* count, int rows,
                   int k, int w, int stride, int t_out, cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(rows) * t_out;
  const int64_t blocks = (cells + kThreads - 1) / kThreads;
  window_kernel<STAT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      resid, stat, count, rows, k, w, stride, t_out);
  return cudaGetLastError();
}

}  // namespace

cudaError_t m3_window(const void* resid, void* stat, void* count, int rows,
                      int k, int w, int stride, int which,
                      cudaStream_t stream) {
  if (rows <= 0 || w <= 0 || stride <= 0 || k < w) return cudaErrorInvalidValue;
  const int t_out = (k - w) / stride + 1;
  const float* in = static_cast<const float*>(resid);
  float* out = static_cast<float*>(stat);
  float* cnt = static_cast<float*>(count);
  switch (which) {
    case kCount: return launch<kCount>(in, out, cnt, rows, k, w, stride, t_out, stream);
    case kSum: return launch<kSum>(in, out, cnt, rows, k, w, stride, t_out, stream);
    case kMin: return launch<kMin>(in, out, cnt, rows, k, w, stride, t_out, stream);
    case kMax: return launch<kMax>(in, out, cnt, rows, k, w, stride, t_out, stream);
    case kLast: return launch<kLast>(in, out, cnt, rows, k, w, stride, t_out, stream);
    case kM2: return launch<kM2>(in, out, cnt, rows, k, w, stride, t_out, stream);
    default: return cudaErrorInvalidValue;
  }
}
