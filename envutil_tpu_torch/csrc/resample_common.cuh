// Device functions shared by the port's four resampling kernels
// (resample_inline.cu, resample_inline_twined.cu, resample_planar.cu,
// resample_twined.cu): the target half of the coordinate chain (axis
// features -> ray), the source pickup (ray -> padded spline
// coordinates), the gates, the degree-n tensor-product b-spline at one
// coordinate pair read straight from global memory (spline_at), and,
// for the inline kernel, the staged window: a block's bounding box of
// table entries copied into shared memory (stage_window) and the same
// spline read from there (spline_staged). Each kernel source
// includes this header, so ops/kernels.py hashes it into every
// library's build name.
//
// Why the window. A tap is NCH contiguous floats (12 bytes at three
// channels), so a direct gather cannot be vectorised, the lanes of a
// warp read addresses 12 bytes apart, and every one of the
// (n+1)^2 NCH scalar loads of a pixel walks three or four cache lines
// in L1: on the H100 the inline kernel spent ~0.5 ms of its 0.83 ms on
// the main path in those loads, not in device-memory traffic
// (tools/ablation/ablate_inline.py). Neighbouring pixels' supports
// overlap almost entirely, so the block reduces its pixels' supports to
// one box, copies the box's row segments with coalesced cp.async (16
// bytes a lane where the table's rows are 16-byte aligned, 4 bytes
// where not) and reads every tap from shared memory, where a load of a
// warp is one pass over the banks unless two lanes meet in one (the
// staged rows' pitch is padded against that). Weights, tap order and
// accumulation order are spline_at's, so the result is bit-identical.
// A support that is not inside the block's window (the box did not fit
// the budget: a pole, the periodic seam, a cube-face edge, a steep
// downscale; or the support leaves the table, where spline_at's flat
// clamp applies) is read by spline_at itself, per pixel: correctness
// never depends on the window. The twined inline kernel does not stage:
// it is bound by its per-tap arithmetic, and a window measured no gain
// there (resample_inline_twined.cu).
//
// Table storage. The three functions that read the table (spline_at,
// stage_window, spline_staged) take its element type T, float or
// __nv_bfloat16 (--coeff bf16, the JAX kernels' bfloat16 coeff), and
// evaluate in float: each tap is converted where it is loaded
// (tap_value; bf16 -> float is exact), so a bf16 table differs from
// the float32 table it was rounded from only by that rounding. A
// staged window holds the raw entries, bf16 in half the shared memory
// of float32, so at one byte budget more blocks stage; each tap read
// from it is converted as spline_at converts it, and the two branches
// stay bit-identical. A bf16 entry of three channels is 6 bytes, so a
// row segment's first entry is only 2-byte aligned: the 16-byte copy
// starts at the aligned-down element (Window.f0 carries the offset),
// and where the table's rows are no multiple of 16 bytes the window is
// copied element by element with plain loads (cp.async moves 4 bytes
// at least).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace envutil {

constexpr int TMODE_AFFINE = 0;
constexpr int TMODE_SPH = 1;
constexpr int TMODE_CYL = 2;

constexpr int SMODE_SPH = 0;
constexpr int SMODE_CUBEMAP = 1;
constexpr int SMODE_BIATAN6 = 2;

constexpr int GATE_PERIODIC = 0;
constexpr int GATE_MIRROR = 1;  // any other code clamps

constexpr int MAX_DEGREE = 7;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// the padded coefficient table and the evaluation weight matrix
struct Table {
  int64_t hp, wp;
  float wmat[(MAX_DEGREE + 1) * (MAX_DEGREE + 1)];
};

// the source side of the inline kernels
struct Pickup {
  int smode;                    // SMODE_*
  int gate_x, gate_y;           // sph only
  float glx, gux, gly, guy;     // gate bounds (sph only)
  float kx, cx, ky, cy, pad;    // model (or in-face) -> spline affine
  float section_px;             // IR rows per cube face (cubemap/biatan6)
};

// floor-mod, as torch.remainder and the JAX package's mod (not fmodf)
__device__ __forceinline__ float floor_mod(float v, float p) {
  return v - floorf(v / p) * p;
}

__device__ __forceinline__ float gate(float v, int mode, float lower,
                                      float upper) {
  if (mode == GATE_PERIODIC) return lower + floor_mod(v - lower, upper - lower);
  if (mode == GATE_MIRROR) {
    const float period = 2.0f * (upper - lower);
    const float t = floor_mod(v - lower, period);
    return lower + fminf(t, period - t);
  }
  return fminf(fmaxf(v, lower), upper);
}

// one row of the ray matrix applied to (a, b, c) as the plain version
// rounds it: (m0 a + m1 b) + m2 c, with c == 1 adding m2 itself
__device__ __forceinline__ float ray_row(const float* m, float a, float b,
                                        float c, bool affine) {
  const float ab = __fadd_rn(__fmul_rn(m[0], a), __fmul_rn(m[1], b));
  return __fadd_rn(ab, affine ? m[2] : __fmul_rn(m[2], c));
}

// The target half: axis features of column x and row y -> ray by tmode,
// rounded step by step in the plain version's order
// (ops/resample.inline_rays), so nvcc contracts nothing and the ray is
// bit-identical to the plain version's on the card. ``xf``/``yf`` point
// at the feature set to use (the centre's, or a DERIV_BIAS-biased one).
template <int TMODE>
__device__ __forceinline__ void target_ray(const float* xf, const float* yf,
                                           int64_t x, int64_t y,
                                           int64_t width, int64_t height,
                                           const float* bm, float& rx,
                                           float& ry, float& rz) {
  float a, b, c;
  if (TMODE == TMODE_AFFINE) {
    // rect / cubemap / biatan6 targets: (px, py', 1)
    a = xf[x];
    b = yf[y];
    c = 1.0f;
  } else if (TMODE == TMODE_SPH) {
    // spherical target: (sin(lon) cos(lat), sin(lat), cos(lon) cos(lat))
    const float ct = yf[height + y];
    a = __fmul_rn(xf[x], ct);
    b = yf[y];
    c = __fmul_rn(xf[width + x], ct);
  } else {
    // cylindrical target: (sin(az), y, cos(az))
    a = xf[x];
    b = yf[y];
    c = xf[width + x];
  }
  rx = ray_row(bm, a, b, c, TMODE == TMODE_AFFINE);
  ry = ray_row(bm + 3, a, b, c, TMODE == TMODE_AFFINE);
  rz = ray_row(bm + 6, a, b, c, TMODE == TMODE_AFFINE);
}

// guard the inactive divisions of the face cascade against 0/0
__device__ __forceinline__ float safe(float d) { return d == 0.0f ? 1.0f : d; }

// The source half: ray -> padded spline coordinates. The ray need not
// be normalised: the atan2 forms and the face cascade are
// scale-invariant.
__device__ __forceinline__ void pickup(const Pickup& p, float rx, float ry,
                                       float rz, float& sx, float& sy) {
  if (p.smode == SMODE_SPH) {
    // full-spherical mount (geometry.ray_to_ll)
    const float lon = atan2f(rx, rz);
    const float lat = atan2f(ry, sqrtf(rx * rx + rz * rz));
    sx = gate(lon * p.kx + p.cx, p.gate_x, p.glx, p.gux) + p.pad;
    sy = gate(lat * p.ky + p.cy, p.gate_y, p.gly, p.guy) + p.pad;
    return;
  }
  // cubemap IR pickup (geometry.ray_to_cubeface with its tie rules,
  // metrics.get_pickup_coordinate_px as an affine); the division and the
  // affine are rounded step by step as the plain version's
  const float ax = fabsf(rx), ay = fabsf(ry), az = fabsf(rz);
  const bool m1 = ax >= ay, m2 = ax >= az, m3 = ay >= az;
  const bool dom_x = m1 && m2;
  const bool dom_z = !m2 && !m3;
  float fx, fy, face;
  if (dom_x) {
    fx = __fdiv_rn(-rz, safe(rx));
    fy = __fdiv_rn(ry, safe(ax));
    face = rx < 0.0f ? 0.0f : 1.0f;
  } else if (dom_z) {
    fx = __fdiv_rn(rx, safe(rz));
    fy = __fdiv_rn(ry, safe(az));
    face = rz < 0.0f ? 5.0f : 4.0f;
  } else {
    fx = __fdiv_rn(-rx, safe(ay));
    fy = __fdiv_rn(rz, safe(ry));
    face = ry < 0.0f ? 2.0f : 3.0f;
  }
  if (p.smode == SMODE_BIATAN6) {
    constexpr float k4pi = (float)(4.0 / 3.14159265358979323846);
    fx = __fmul_rn(k4pi, atanf(fx));
    fy = __fmul_rn(k4pi, atanf(fy));
  }
  sx = __fadd_rn(__fadd_rn(__fmul_rn(fx, p.kx), p.cx), p.pad);
  sy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(fy, p.ky), p.cy),
                           __fmul_rn(face, p.section_px)), p.pad);
}

// float clamp of a coordinate to [-(n+1), extent + n]: fminf/fmaxf map
// NaN to the bound, so no NaN or inf reaches a float->int conversion,
// and an in-range coordinate is never changed
template <int DEGREE>
__device__ __forceinline__ float clamp_coord(float s, int64_t extent) {
  return fminf(fmaxf(s, -(float)(DEGREE + 1)), (float)(extent + DEGREE));
}

template <int DEGREE>
__device__ __forceinline__ void weights(const float* m, float t,
                                        float (&w)[DEGREE + 1]) {
  // w_j(t) = sum_k M[j, k] t^k in Horner form (ops/spline._weights)
#pragma unroll
  for (int j = 0; j <= DEGREE; ++j) {
    float acc = m[j * (DEGREE + 1) + DEGREE];
#pragma unroll
    for (int k = DEGREE - 1; k >= 0; --k) acc = acc * t + m[j * (DEGREE + 1) + k];
    w[j] = acc;
  }
}

// one table entry as float: a load through the read-only path, and for
// a bf16 table the exact conversion
__device__ __forceinline__ float tap_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tap_load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
// an entry already in hand (a staged window's), as float
__device__ __forceinline__ float tap_value(float v) { return v; }
__device__ __forceinline__ float tap_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The degree-n tensor-product b-spline of the (Hp, Wp, NCH)
// channel-interleaved table of T (float or __nv_bfloat16) at finite
// padded coordinates (sx, sy): each of the (n+1)^2 taps is NCH
// contiguous entries read from global memory through L1/L2 and
// evaluated in float. The flat table offset is 64-bit and clamped to
// the table, as the JAX evaluator's take(mode="clip") does.
template <int DEGREE, int NCH, typename T>
__device__ __forceinline__ void spline_at(const T* __restrict__ coeff,
                                          const Table& t, float sx, float sy,
                                          float (&acc)[NCH]) {
  // split (zimt/eval.h:595-610): floor for odd degrees, round for even
  const float selx = (DEGREE & 1) ? floorf(sx) : floorf(sx + 0.5f);
  const float sely = (DEGREE & 1) ? floorf(sy) : floorf(sy + 0.5f);
  float wx[DEGREE + 1], wy[DEGREE + 1];
  weights<DEGREE>(t.wmat, sx - selx, wx);
  weights<DEGREE>(t.wmat, sy - sely, wy);
  const int64_t bx = (int64_t)selx - DEGREE / 2;
  const int64_t by = (int64_t)sely - DEGREE / 2;
  const int64_t last = t.hp * t.wp - 1;

#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int j = 0; j <= DEGREE; ++j) {
    const int64_t row = (by + j) * t.wp + bx;
    float racc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) racc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k <= DEGREE; ++k) {
      int64_t idx = row + k;
      idx = idx < 0 ? 0 : (idx > last ? last : idx);
      const T* tap = coeff + idx * NCH;
#pragma unroll
      for (int c = 0; c < NCH; ++c) racc[c] += wx[k] * tap_load(tap + c);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += wy[j] * racc[c];
  }
}

// ---- the staged window of the inline kernel ---------------------------

constexpr int WARPS = BLOCK_Y;   // a warp is one 32-pixel row of the block

// bounding box of spline bases (bx, by), in table entries
struct Box {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ Box empty_box() {
  return Box{INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN};
}

// The staged part of the table: entries [x0, x1] x [y0, y1] (empty when
// x1 < x0), held in shared memory as rows of ``pitch`` elements (floats
// or bf16 values) that start at element ``f0`` of the table row.
struct Window {
  int x0, x1, y0, y1;
  int f0, pitch;
};

// spline_at's split of a coordinate pair into the base entry of its
// support; false where the support leaves the table (spline_at's flat
// clamp then decides what is read, so such a support is never staged)
// and for a NaN. The test runs on the floats: table extents are far
// below 2^24, where floats hold every integer, so an accepted base
// converts exactly and equals spline_at's 64-bit one.
template <int DEGREE>
__device__ __forceinline__ bool support_base(const Table& t, float sx,
                                             float sy, int& bx, int& by) {
  const float lx = ((DEGREE & 1) ? floorf(sx) : floorf(sx + 0.5f)) -
                   (float)(DEGREE / 2);
  const float ly = ((DEGREE & 1) ? floorf(sy) : floorf(sy + 0.5f)) -
                   (float)(DEGREE / 2);
  const bool inside = lx >= 0.0f && lx <= (float)((int)t.wp - 1 - DEGREE) &&
                      ly >= 0.0f && ly <= (float)((int)t.hp - 1 - DEGREE);
  bx = inside ? __float2int_rz(lx) : 0;
  by = inside ? __float2int_rz(ly) : 0;
  return inside;
}

template <int DEGREE>
__device__ __forceinline__ void box_add(Box& b, const Table& t, float sx,
                                        float sy) {
  int bx, by;
  if (!support_base<DEGREE>(t, sx, sy, bx, by)) return;
  b.x0 = min(b.x0, bx);
  b.x1 = max(b.x1, bx);
  b.y0 = min(b.y0, by);
  b.y1 = max(b.y1, by);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// one element of a window whose rows are not 16-byte aligned: a float
// by a 4-byte cp.async, a bf16 value by a plain load and store (the
// barrier after the copy makes both visible)
__device__ __forceinline__ void copy_entry(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void copy_entry(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  *dst = __ldg(src);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Reduce the threads' boxes of support bases to the block's, add the
// DEGREE + 1 support, and, if the window fits ``budget`` bytes, copy it
// from the table of T into ``win`` (16-byte aligned shared memory of at
// least ``budget`` bytes), entries as they are stored. Every thread of
// the block must call it; it returns the window, empty when nothing was
// staged. ``sbox`` is four ints of shared memory.
template <int DEGREE, int NCH, typename T>
__device__ __forceinline__ Window stage_window(
    Box b, const Table& t, const T* __restrict__ coeff, T* win,
    int* sbox, int budget) {
  // elements in 16 bytes (a cp.async16), and in the 128 bytes of a
  // pass over the 32 banks
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int BANKS = 128 / (int)sizeof(T);
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = threadIdx.x, warp = threadIdx.y;
  Window w{INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN, 0, 0};
  if (budget <= 0) return w;        // launch-uniform: the direct branch
  if (tid == 0) {
    sbox[0] = INT32_MAX; sbox[1] = INT32_MIN;
    sbox[2] = INT32_MAX; sbox[3] = INT32_MIN;
  }
  __syncthreads();
  b.x0 = __reduce_min_sync(0xffffffffu, b.x0);
  b.x1 = __reduce_max_sync(0xffffffffu, b.x1);
  b.y0 = __reduce_min_sync(0xffffffffu, b.y0);
  b.y1 = __reduce_max_sync(0xffffffffu, b.y1);
  if (lane == 0 && b.x1 >= b.x0) {
    atomicMin(&sbox[0], b.x0); atomicMax(&sbox[1], b.x1);
    atomicMin(&sbox[2], b.y0); atomicMax(&sbox[3], b.y1);
  }
  __syncthreads();
  b = Box{sbox[0], sbox[1], sbox[2], sbox[3]};
  if (b.x1 < b.x0) return w;        // no pixel's support lies in the table
  const int wp = (int)t.wp, hp = (int)t.hp;
  const int x0 = max(b.x0, 0), x1 = min(b.x1 + DEGREE, wp - 1);
  const int y0 = max(b.y0, 0), y1 = min(b.y1 + DEGREE, hp - 1);
  // rows of 16-byte aligned segments where the table allows it: the
  // segment starts at the aligned-down element (a bf16 entry of three
  // channels is 6 bytes, so its own start may be 2-byte aligned only)
  const bool vec = ((wp * NCH) % VEC) == 0 &&
                   (reinterpret_cast<uintptr_t>(coeff) & 15) == 0;
  int f0 = x0 * NCH, f1 = (x1 + 1) * NCH;
  if (vec) {
    f0 &= ~(VEC - 1);
    f1 = (f1 + VEC - 1) & ~(VEC - 1);   // <= wp * NCH, a multiple of VEC
  }
  // Staged rows are ``pitch`` elements apart: the segment's length padded
  // to 16 bytes more than a multiple of 128, so that a warp whose lanes'
  // taps lie on several rows (a slanted or rotated view) spreads over
  // the banks instead of meeting in a few (an unpadded length that is a
  // multiple of 128 bytes would put a whole column into one bank); every
  // staged row then starts 16-byte aligned
  const int span = f1 - f0, rows = y1 - y0 + 1;
  const int pitch = span + ((VEC - span) & (BANKS - 1));
  if ((int64_t)rows * pitch * (int64_t)sizeof(T) > (int64_t)budget) return w;

  for (int r = warp; r < rows; r += WARPS) {
    const T* src = coeff + ((int64_t)(y0 + r) * wp * NCH + f0);
    T* dst = win + r * pitch;
    if (vec) {
      for (int v = lane * VEC; v < span; v += 32 * VEC)
        cp_async16(dst + v, src + v);
    } else {
      for (int v = lane; v < span; v += 32) copy_entry(dst + v, src + v);
    }
  }
  cp_async_wait();
  __syncthreads();
  return Window{x0, x1, y0, y1, f0, pitch};
}

// spline_at, with the taps read from the block's staged window where
// the support lies inside it, and by spline_at itself where it does
// not. Same weights, conversion, tap order and accumulation order:
// bit-identical.
template <int DEGREE, int NCH, typename T>
__device__ __forceinline__ void spline_staged(
    const T* win, const Window& w, const T* __restrict__ coeff,
    const Table& t, float sx, float sy, float (&acc)[NCH]) {
  int bx, by;
  if (!support_base<DEGREE>(t, sx, sy, bx, by) || bx < w.x0 ||
      bx + DEGREE > w.x1 || by < w.y0 || by + DEGREE > w.y1) {
    spline_at<DEGREE, NCH>(coeff, t, sx, sy, acc);
    return;
  }
  const float selx = (DEGREE & 1) ? floorf(sx) : floorf(sx + 0.5f);
  const float sely = (DEGREE & 1) ? floorf(sy) : floorf(sy + 0.5f);
  float wx[DEGREE + 1], wy[DEGREE + 1];
  weights<DEGREE>(t.wmat, sx - selx, wx);
  weights<DEGREE>(t.wmat, sy - sely, wy);
  const T* row = win + ((by - w.y0) * w.pitch + (bx * NCH - w.f0));

#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int j = 0; j <= DEGREE; ++j) {
    float racc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) racc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k <= DEGREE; ++k) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        racc[c] += wx[k] * tap_value(row[k * NCH + c]);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += wy[j] * racc[c];
    row += w.pitch;
  }
}

inline dim3 frame_grid(int64_t height, int64_t width) {
  return dim3((unsigned)((width + BLOCK_X - 1) / BLOCK_X),
              (unsigned)((height + BLOCK_Y - 1) / BLOCK_Y));
}

inline void set_table(Table& t, long long hp, long long wp, int degree,
                      const float* wmat) {
  t.hp = hp;
  t.wp = wp;
  for (int i = 0; i < (degree + 1) * (degree + 1); ++i) t.wmat[i] = wmat[i];
}

// Dispatch a runtime (degree, nch) to ``F::template run<DEGREE, NCH>(args...)``;
// a launcher dispatches the table's element type first, by the struct
// F<T> it names
template <typename F, int DEGREE, typename... A>
cudaError_t by_nch(int nch, A&&... args) {
  switch (nch) {
    case 1: return F::template run<DEGREE, 1>(args...);
    case 2: return F::template run<DEGREE, 2>(args...);
    case 3: return F::template run<DEGREE, 3>(args...);
    case 4: return F::template run<DEGREE, 4>(args...);
  }
  return cudaErrorInvalidValue;
}

template <typename F, typename... A>
cudaError_t by_degree(int degree, int nch, A&&... args) {
  switch (degree) {
    case 0: return by_nch<F, 0>(nch, args...);
    case 1: return by_nch<F, 1>(nch, args...);
    case 2: return by_nch<F, 2>(nch, args...);
    case 3: return by_nch<F, 3>(nch, args...);
    case 4: return by_nch<F, 4>(nch, args...);
    case 5: return by_nch<F, 5>(nch, args...);
    case 6: return by_nch<F, 6>(nch, args...);
    case 7: return by_nch<F, 7>(nch, args...);
  }
  return cudaErrorInvalidValue;
}

}  // namespace envutil
