// TTSZ stream decode: header parse and point scan (read path).
//
// Replaces: m3_tpu/ops/pallas_codec.py `_decode_kernel` (built by
// `_build_decode`, called from `decode_core` on the Pallas route of
// `tsz._decode_fused_jit`). Same function as `tsz._decode_core`: per
// series, parse the v2 header (`tsz._decode_header`), then walk a bit
// cursor through the points (`tsz._decode_step`), emitting per point the
// timestamp delta, the running tick sum t0 + sum(dt), and the value bits
// (raw f64 bits in float mode, the int64 mantissa m in int mode).
//
// The Pallas kernel shares `_decode_header`/`_decode_step` with the XLA
// scan; this kernel cannot, so it re-implements them with native uint64_t,
// and the parity tests against the reference (and, on the card, against
// the plain PyTorch twin in ops/codec_kernels.py) are the guard against
// drift. Reads clamp word indices to the unpadded width mw exactly as
// `tsz._take_word` does, so a speculative read past the stream end sees
// the same word as the reference.
//
// Bound on the H100: memory. At the read shape (N = 100,000, W = 120,
// mw = 446) the kernel needs each row's words only up to its stream's end
// (17 MB at the ingest block's 1.429 bytes per point, of a 178 MB padded
// plane) and writes dt (4 B), ticks (8 B) and value bits (8 B) per point,
// 240 MB: 257 MB in all, 0.077 ms at 3.35 TB/s. A series' decode is
// inherently serial (each point's width is known only after the previous
// point is parsed), about 60 integer operations per point.
//
// Design. A first version (one thread per series, plain stores, __ldg word
// reads) ran at 4.7% of the bound: each warp store touched 32 rows 480
// or 960 bytes apart, and each word read touched 32 rows' cache lines,
// with most of L1 given to shared memory. Now:
// - One thread per series, 128 series a block, the cursor and the float
//   windows in registers: the point scan is serial.
// - Staged stores. Each thread writes its series' points into [128][8 + 1]
//   shared tiles of dt, ticks and value bits (odd pitch: no bank
//   conflicts); every 8 points the block stores each plane's [128, 8]
//   sub-tile with lane <-> point, so a warp writes 4 rows' 64-byte
//   (ticks, values) or 32-byte (dt) runs, whole sectors at W = 120. A W
//   that is not a multiple of 8 ends with a shorter tile.
// - Staged reads. Every 4 points the block copies each series' next 17
//   words (kWin: the most 4 points can read) into shared memory by 4-byte
//   cp.async copies, consecutive threads on consecutive words of a row,
//   each index clamped to mw - 1 as tsz._take_word clamps it; the point
//   scan reads shared memory only. A window costs two barriers.
// - 32 KB of shared memory and 70 registers a thread: 7 blocks (896
//   threads) fit an SM, so the 782 blocks of the read shape run in one
//   wave. (Windows of 8 points, 32 words, needed 40 KB a block, and
//   loading the words through registers more than doubled the registers
//   a thread: both ran slower.)

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // series per block
constexpr int kPoints = 8;     // points staged per series between stores
constexpr int kPitch = kPoints + 1;  // odd pitch: no bank conflicts
constexpr int kSub = 4;        // points decoded per staged window
// Words staged per series per window. A point reads at most 54 bits past
// its start (a 39-bit timestamp, then a 64-bit read 15 bits into the
// value) plus the 2 words a 64-bit read may straddle, and consumes at
// most 118 bits. Window 0 starts at word 0 with the header (<= 168 bits)
// and 3 points: (168 + 2 * 118 + 54) / 32 + 2 = word 16. Later windows
// start within their first word and decode 4 points: (31 + 3 * 118 +
// 54) / 32 + 2 = word 15. So 17 words hold every read.
constexpr int kWin = 17;

// A series' staged words [base, base + kWin), read as tsz._take_word
// reads the row: the loader clamped each index to mw - 1.
__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem));
}

struct Window {
  const uint32_t* w;
  int base;

  __device__ __forceinline__ uint32_t word(int i) const { return w[i - base]; }
  // 64 bits of the stream starting at bit pos (MSB first).
  __device__ __forceinline__ uint64_t read64(int pos) const {
    const int wi = pos >> 5;
    const int bi = pos & 31;
    const uint64_t a = (static_cast<uint64_t>(word(wi)) << 32) | word(wi + 1);
    const uint64_t w2 = word(wi + 2);
    return (a << bi) | (w2 >> (32 - bi));
  }
};

__device__ __forceinline__ uint64_t unzigzag64(uint64_t z) {
  return (z >> 1) ^ (0ull - (z & 1ull));
}

// Leading one bits of a 32-bit word.
__device__ __forceinline__ int leading_ones(uint32_t x) { return __clz(~x); }

// Sign-extend the low nbits (1..32) of v, in wrapping int32 arithmetic.
__device__ __forceinline__ int32_t sext(uint32_t v, int nbits) {
  const uint32_t sb = shl32(1u, nbits - 1);
  return static_cast<int32_t>((v ^ sb) - sb);
}

__device__ __forceinline__ int ts_payload(int ones) {
  switch (ones) {
    case 0: return 0;
    case 1: return 4;
    case 2: return 7;
    case 3: return 9;
    case 4: return 12;
    case 5: return 16;
    case 6: return 20;
    default: return 32;
  }
}

__device__ __forceinline__ int int_payload(int ones) {
  switch (ones) {
    case 0: return 0;
    case 1: return 4;
    case 2: return 7;
    case 3: return 12;
    case 4: return 20;
    case 5: return 32;
    default: return 64;
  }
}

// One series' decoder state between points.
struct Cursor {
  int pos;
  int32_t prev_delta;
  uint64_t pvd, pv, tick;
  int la, ma, lb, mb;
  bool int_mode, ts_regular;
};

// Parse the header (point 0): returns the flag byte, sets c and the
// point's outputs.
template <class R>
__device__ __forceinline__ int32_t header(const R& rd, Cursor& c,
                                          uint64_t& t0, uint64_t& v0) {
  const uint32_t b0 = static_cast<uint32_t>(rd.read64(0) >> 32);
  c.int_mode = (b0 >> 31) == 1u;
  c.ts_regular = ((b0 >> 27) & 1u) == 1u;
  const int t0c = (b0 >> 26) & 1u;
  const int vc = (b0 >> 25) & 1u;
  const int dc = (b0 >> 24) & 1u;
  const int nt0 = 32 + 32 * t0c;
  t0 = unzigzag64(shr64(rd.read64(8), 64 - nt0));
  int pos = 8 + nt0;
  const int nd = c.ts_regular ? 8 + 24 * dc : 0;
  const uint64_t dzz = shr64(rd.read64(pos), 64 - nd);
  const int32_t delta0 =
      c.ts_regular ? static_cast<int32_t>(static_cast<uint32_t>(unzigzag64(dzz)))
                   : 0;
  pos += nd;
  const int nv = c.int_mode ? 32 + 32 * vc : 64;
  const uint64_t vraw = shr64(rd.read64(pos), 64 - nv);
  v0 = c.int_mode ? unzigzag64(vraw) : vraw;
  c.pos = pos + nv;
  c.prev_delta = c.ts_regular ? delta0 : 0;
  c.pvd = 0;
  c.pv = v0;
  c.tick = t0;
  c.la = c.ma = c.lb = c.mb = -1;
  return static_cast<int32_t>(b0 >> 24);
}

// Point i >= 1 (`active`: i < npoints; past it the carry repeats):
// advances c and returns the point's dt; its tick and value bits are
// c.tick and c.pv.
template <class R>
__device__ __forceinline__ int32_t step(const R& rd, Cursor& c, bool active) {
  const int pos = c.pos;
  // --- timestamp: leading-ones prefix selects the payload width ---
  const uint64_t t64 = rd.read64(pos);
  const int ones_t = min(leading_ones(static_cast<uint32_t>(t64 >> 32)), 7);
  const bool is0 = ones_t == 0;
  const int plen = is0 ? 1 : (ones_t <= 5 ? ones_t + 1 : 7);
  const int nbits = ts_payload(ones_t);
  const uint32_t pw = static_cast<uint32_t>((t64 << plen) >> 32);
  const uint32_t pay = shr32(pw, 32 - nbits);
  const int32_t dod = (is0 || c.ts_regular) ? 0 : sext(pay, max(nbits, 1));
  const int32_t delta = static_cast<int32_t>(
      static_cast<uint32_t>(c.prev_delta) + static_cast<uint32_t>(dod));
  const int pos1 = pos + (c.ts_regular ? 0 : (is0 ? 1 : plen + nbits));

  // --- value: float path ('0' | '10' A | '110' B | '111' rewrite) ---
  const uint32_t cf = static_cast<uint32_t>(rd.read64(pos1) >> 32);
  const bool fxor0 = (cf >> 31) == 0u;
  const bool fa = (cf >> 30) == 2u;
  const bool fb = (cf >> 29) == 6u;
  const bool frw = !fxor0 && !fa && !fb;
  const int lead_n = (cf >> 23) & 63u;
  const int mlen_n = static_cast<int>((cf >> 17) & 63u) + 1;
  uint64_t x = 0;
  int fconsumed = 1;
  if (fa) {
    x = shl64(shr64(rd.read64(pos1 + 2), 64 - c.ma), 64 - c.la - c.ma);
    fconsumed = 2 + c.ma;
  } else if (fb) {
    x = shl64(shr64(rd.read64(pos1 + 3), 64 - c.mb), 64 - c.lb - c.mb);
    fconsumed = 3 + c.mb;
  } else if (frw) {
    x = shl64(shr64(rd.read64(pos1 + 15), 64 - mlen_n), 64 - lead_n - mlen_n);
    fconsumed = 15 + mlen_n;
  }
  const uint64_t fval = c.pv ^ x;

  // --- value: int path (leading-ones prefix, v2 buckets) ---
  const int ones_i = min(leading_ones(cf), 6);
  const bool iz = ones_i == 0;
  const int iplen = iz ? 1 : (ones_i <= 4 ? ones_i + 1 : 6);
  const int inb = int_payload(ones_i);
  const uint64_t zz = shr64(rd.read64(pos1 + iplen), 64 - inb);
  const uint64_t vdod = iz ? 0ull : unzigzag64(zz);
  const uint64_t nvd = c.pvd + vdod;
  const uint64_t ival = c.pv + nvd;
  const int iconsumed = iz ? 1 : iplen + inb;

  // --- select by mode; points past npoints keep the carry ---
  const int32_t delta_o = active ? delta : 0;
  if (active) {
    c.pos = pos1 + (c.int_mode ? iconsumed : fconsumed);
    c.pv = c.int_mode ? ival : fval;
    c.prev_delta = delta;
    if (c.int_mode) c.pvd = nvd;
    if (frw) {
      c.lb = c.la;
      c.mb = c.ma;
      c.la = lead_n;
      c.ma = mlen_n;
    }
  }
  c.tick += static_cast<uint64_t>(static_cast<int64_t>(delta_o));
  return delta_o;
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ words,
              const int32_t* __restrict__ npoints, int32_t* __restrict__ dt,
              int64_t* __restrict__ ts, int64_t* __restrict__ vals,
              int32_t* __restrict__ flags, int n, int mw, int window) {
  __shared__ int64_t s_ts[kThreads * kPitch];
  __shared__ int64_t s_vals[kThreads * kPitch];
  __shared__ int32_t s_dt[kThreads * kPitch];
  __shared__ uint32_t s_words[kThreads * kWin];
  __shared__ int s_base[kThreads];
  const int tid = threadIdx.x;
  const int series0 = blockIdx.x * kThreads;
  const int nb = min(kThreads, n - series0);
  // Threads past n decode whatever their window holds and store nothing,
  // so that every thread reaches the block's barriers; the word bound
  // above holds for any bits.
  const int npts = tid < nb ? npoints[series0 + tid] : 0;
  const Window rd{s_words + tid * kWin, 0};
  const uint32_t* rows = words + static_cast<size_t>(series0) * mw;
  // The block's rows' windows, consecutive threads on consecutive words
  // of a row, by 4-byte cp.async copies: all of a thread's copies are in
  // flight at once and hold no registers.
  auto load = [&]() {
    for (int e = tid; e < nb * kWin; e += kThreads) {
      const int b = e / kWin;
      cp_async4(s_words + e, rows + static_cast<size_t>(b) * mw +
                                 min(s_base[b] + e - b * kWin, mw - 1));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  };

  Cursor c;
  c.pos = 0;
  s_base[tid] = 0;
  __syncthreads();
  load();
  __syncthreads();
  uint64_t t0, v0;
  const int32_t flag = header(rd, c, t0, v0);
  if (tid < nb) flags[series0 + tid] = flag;
  for (int i0 = 0; i0 < window; i0 += kSub) {
    const int np = min(kSub, window - i0);
    const Window win{rd.w, s_base[tid]};
    const int slot = tid * kPitch + i0 % kPoints;
    for (int p = 0; p < np; ++p) {
      const int i = i0 + p;
      s_dt[slot + p] = i == 0 ? 0 : step(win, c, i < npts);
      s_ts[slot + p] = static_cast<int64_t>(i == 0 ? t0 : c.tick);
      s_vals[slot + p] = static_cast<int64_t>(i == 0 ? v0 : c.pv);
    }
    s_base[tid] = c.pos >> 5;
    __syncthreads();
    // Every kPoints points (and at the end) the block's [nb, tn] sub-tile
    // of each plane, lane <-> point; then the next window.
    const int end = i0 + np;
    if (end % kPoints == 0 || end == window) {
      const int tile0 = (end - 1) / kPoints * kPoints;
      const int tn = end - tile0;
      for (int e = tid; e < nb * tn; e += kThreads) {
        const int b = e / tn;
        const int p = e - b * tn;
        const size_t o = static_cast<size_t>(series0 + b) * window + tile0 + p;
        dt[o] = s_dt[b * kPitch + p];
        ts[o] = s_ts[b * kPitch + p];
        vals[o] = s_vals[b * kPitch + p];
      }
    }
    if (end < window) load();
    __syncthreads();
  }
}

}  // namespace

cudaError_t m3_decode(const void* words, const void* npoints, void* dt,
                      void* ts, void* vals, void* flags, int n, int mw,
                      int window, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  decode_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(npoints), static_cast<int32_t*>(dt),
      static_cast<int64_t*>(ts), static_cast<int64_t*>(vals),
      static_cast<int32_t*>(flags), n, mw, window);
  return cudaGetLastError();
}
