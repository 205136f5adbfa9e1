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
// Design (window_tile):
// - Row tiles in shared memory. A block owns R consecutive rows, one
//   contiguous run of R K floats, and copies it in with 16-byte cp.async
//   copies; a head and a tail of under 4 floats move singly, so a row
//   slice at any 4-byte offset (resid[1:] at K = 119) is taken as it is.
//   Every cell of the grid is read from device memory once, and the
//   R T_out cells of both planes are written as contiguous runs. A tile
//   holds at most 4,096 cells (16 KB: 8 blocks fit an SM and hide each
//   other's copies), and R is no larger than gives the grid 8 tiles per
//   SM, so that a small grid ([10,000, 119]: R = 10) runs in one wave.
//   (32 tiles per SM, R = 3 there, ran 1.4x slower on the device.) A row
//   longer than a tile is cut into column tiles of one row.
// - Cells read once. Windows start at multiples of the stride and span
//   W cells, so both are multiples of g = gcd(W, stride). Where g > 1
//   each g-cell chunk is reduced once into a partial in shared memory and
//   a window combines its W / g partials: at W 30, stride 3 a cell is
//   read once instead of 10 times. Partials reorder the sum and subtract
//   nothing (no running sums, no prefix sums: an f32 cumsum cancels on
//   1e13 counters). Where g = 1 a window reads its W staged cells. m2's
//   second pass reads the W staged cells.
// - Branch-free min/max in XLA's order: a finite f32 maps to the int32
//   key bits ^ ((bits >> 31) & 0x7fffffff), whose signed order is the
//   float order with -0.0 below +0.0; min/max run on keys and the result
//   key maps back (the map is its own inverse), bit-identical to a
//   compare with a sign-bit tie test.
// - Windows wider than half a tile (2,048 cells) cannot be staged with
//   their neighbours; window_direct takes them, one thread per output
//   cell reading its W cells through the read-only cache.
// The build has no fast-math flag, which could fold isfinite away.

#include <math.h>
#include <stdint.h>

#include <numeric>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // staged cells per block: 16 KB
constexpr int kTilesPerSm = 8;

enum Stat { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kLast = 4, kM2 = 5 };

// The order key of a float and its inverse: the same map.
__device__ __forceinline__ int flip(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

constexpr int kKeyPosInf = 0x7f800000;                     // flip(+inf)
constexpr int kKeyNegInf = static_cast<int>(0x807fffffu);  // flip(-inf)

// A window's (or a chunk's) running reduction. m2 accumulates as sum.
template <int STAT>
struct Acc {
  int n = 0;
  float x = 0.0f;  // sum (sum, m2) or the last finite value (last)
  int key = STAT == kMin ? kKeyPosInf : kKeyNegInf;  // min, max

  __device__ __forceinline__ void cell(float v) {
    const bool ok = isfinite(v);
    n += ok;
    if (STAT == kSum || STAT == kM2) {
      if (ok) x += v;
    } else if (STAT == kMin) {
      key = min(key, ok ? flip(__float_as_int(v)) : kKeyPosInf);
    } else if (STAT == kMax) {
      key = max(key, ok ? flip(__float_as_int(v)) : kKeyNegInf);
    } else if (STAT == kLast) {
      if (ok) x = v;
    }
  }
  // Fold in a chunk's partial: its count and value bits (bits()).
  __device__ __forceinline__ void part(int pn, int pv) {
    n += pn;
    if (STAT == kSum || STAT == kM2) {
      x += __int_as_float(pv);
    } else if (STAT == kMin) {
      key = min(key, pv);
    } else if (STAT == kMax) {
      key = max(key, pv);
    } else if (STAT == kLast) {
      if (pn > 0) x = __int_as_float(pv);
    }
  }
  __device__ __forceinline__ int bits() const {
    return (STAT == kMin || STAT == kMax) ? key : __float_as_int(x);
  }
};

// Write output cell o of both planes from its window's reduction; m2's
// second pass reads the window's W cells at x.
template <int STAT, class A>
__device__ __forceinline__ void emit(const A& a, const float* x,
                                     int w, float* stat, float* count,
                                     int64_t o) {
  const float cnt = static_cast<float>(a.n);
  float out = a.x;
  if (STAT == kCount) out = cnt;
  if (STAT == kMin || STAT == kMax) out = __int_as_float(flip(a.key));
  if (STAT == kM2) {
    const float mu = a.x / fmaxf(cnt, 1.0f);
    float m2 = 0.0f;
    for (int j = 0; j < w; ++j) {
      const float v = x[j];
      if (!isfinite(v)) continue;
      const float d = v - mu;
      m2 += d * d;
    }
    out = m2;
  }
  stat[o] = out;
  count[o] = cnt;
}

struct Tiling {
  int rows;         // rows per tile (R)
  int outs;         // output cells per row per tile
  int col_tiles;    // tiles across a row (1 unless K > kTileFloats)
  int g;            // gcd(W, stride): cells per partial
  int tile_floats;  // shared floats before the partials
  int parts;        // partials per tile (0 when g = 1)
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copy the n floats at src to sm[mis + i], mis = src's float offset in its
// 16-byte line (sm is 16-byte aligned), so the aligned body moves as
// 16-byte cp.async copies and a head and tail of under 4 floats singly.
// Returns mis once the whole block's copy has landed.
__device__ __forceinline__ int stage(float* sm, const float* src, int n) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) >> 2;
  const int tail0 = head + 4 * body;
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(sm + mis + head + 4 * i, src + head + 4 * i);
  const int t = threadIdx.x;
  if (t < head) sm[mis + t] = src[t];
  if (t >= 32 && t < 32 + n - tail0) sm[mis + tail0 + t - 32] = src[tail0 + t - 32];
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  return mis;
}

template <int STAT>
__global__ void __launch_bounds__(kThreads)
window_tile(const float* __restrict__ resid, float* __restrict__ stat,
            float* __restrict__ count, int rows, int k, int w, int stride,
            int t_out, Tiling tl) {
  // m2's first pass is a sum.
  constexpr int P = STAT == kM2 ? kSum : STAT;
  extern __shared__ __align__(16) float smem[];
  const int ct = blockIdx.x % tl.col_tiles;
  const int row0 = (blockIdx.x / tl.col_tiles) * tl.rows;
  const int nr = min(tl.rows, rows - row0);
  const int t0 = ct * tl.outs;
  const int nt = min(tl.outs, t_out - t0);
  const int span = (nt - 1) * stride + w;  // cells a row's windows read
  const int pitch = tl.col_tiles == 1 ? k : span;  // nr = 1 otherwise
  const float* tile = smem + stage(
      smem, resid + static_cast<int64_t>(row0) * k + static_cast<int64_t>(t0) * stride,
      (nr - 1) * pitch + span);

  const int g = tl.g;
  const int nch = span / g;
  int* pn = reinterpret_cast<int*>(smem + tl.tile_floats);
  int* pv = pn + tl.parts;
  if (g > 1) {
    for (int q = threadIdx.x; q < nr * nch; q += kThreads) {
      const int r = q / nch;
      const float* x = tile + r * pitch + (q - r * nch) * g;
      Acc<P> a;
      for (int j = 0; j < g; ++j) a.cell(x[j]);
      pn[q] = a.n;
      pv[q] = a.bits();
    }
    __syncthreads();
  }
  const int wg = w / g;
  const int sg = stride / g;
  for (int i = threadIdx.x; i < nr * nt; i += kThreads) {
    const int r = i / nt;
    const int t = i - r * nt;
    const float* x = tile + r * pitch + t * stride;
    Acc<P> a;
    if (g > 1) {
      const int q0 = r * nch + t * sg;
      for (int j = 0; j < wg; ++j) a.part(pn[q0 + j], pv[q0 + j]);
    } else {
      for (int j = 0; j < w; ++j) a.cell(x[j]);
    }
    emit<STAT>(a, x, w, stat, count,
            static_cast<int64_t>(row0 + r) * t_out + t0 + t);
  }
}

template <int STAT>
__global__ void __launch_bounds__(kThreads)
window_direct(const float* __restrict__ resid, float* __restrict__ stat,
              float* __restrict__ count, int rows, int k, int w, int stride,
              int t_out) {
  constexpr int P = STAT == kM2 ? kSum : STAT;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (cell >= static_cast<int64_t>(rows) * t_out) return;
  const int64_t row = cell / t_out;
  const int t = static_cast<int>(cell - row * t_out);
  const float* x = resid + row * k + static_cast<int64_t>(t) * stride;
  Acc<P> a;
  for (int j = 0; j < w; ++j) a.cell(__ldg(x + j));
  emit<STAT>(a, x, w, stat, count, cell);
}

template <int STAT>
cudaError_t launch(const float* resid, float* stat, float* count, int rows,
                   int k, int w, int stride, int t_out, cudaStream_t stream) {
  if (2 * w > kTileFloats) {
    const int64_t cells = static_cast<int64_t>(rows) * t_out;
    window_direct<STAT><<<static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(resid, stat, count, rows, k,
                                                 w, stride, t_out);
    return cudaGetLastError();
  }
  Tiling tl;
  tl.g = std::gcd(w, stride);
  if (k <= kTileFloats) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int per_tile = (rows + sms * kTilesPerSm - 1) / (sms * kTilesPerSm);
    tl.rows = max(1, min(kTileFloats / k, per_tile));
    tl.outs = t_out;
    tl.col_tiles = 1;
  } else {
    tl.rows = 1;
    tl.outs = (kTileFloats - w) / stride + 1;
    tl.col_tiles = (t_out + tl.outs - 1) / tl.outs;
  }
  const int span = (tl.outs - 1) * stride + w;
  const int cells = (tl.rows - 1) * (tl.col_tiles == 1 ? k : span) + span;
  tl.tile_floats = (cells + 3 + 3) & ~3;  // + the head offset, 16-byte rounded
  tl.parts = tl.g > 1 ? tl.rows * (span / tl.g) : 0;
  const size_t smem = (static_cast<size_t>(tl.tile_floats) + 2 * tl.parts) * 4;
  const int64_t blocks =
      static_cast<int64_t>((rows + tl.rows - 1) / tl.rows) * tl.col_tiles;
  window_tile<STAT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      resid, stat, count, rows, k, w, stride, t_out, tl);
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
