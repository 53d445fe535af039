// Throw-away variants of the two inline kernels (resample_inline.cu,
// resample_inline_twined.cu as they stood before the staged-window
// redesign), each with one part of the work removed or replaced, to
// attribute the kernels' time on the card where no profiler runs.
// Degree 3 (inline) and degree 1 (twined), three channels. The outputs
// of all variants but 0 are wrong on purpose; tools/ablation/
// ablate_inline.py times them with CUDA events.
//
// Inline variants:
//   0 the kernel as it stood (one thread a pixel, taps gathered from
//     global memory with scalar loads, three scalar stores)
//   1 the coordinate chain replaced by a cheap 1:1 mapping; taps read
//   2 the chain kept; one tap read instead of (n+1)^2
//   3 everything kept; one channel stored instead of three
//   4 the table padded to four channels; one 16-byte load a tap
//   5 the chain alone: no tap read, the coordinates stored
//   6 variant 0 with a polynomial atan2, an approximate division and a
//     reciprocal-multiply gate in the pickup
// Twined variants:
//   0 the kernel as it stood
//   1 the pickup hoisted: three pickups a pixel, taps deflected in
//     coordinate space; every tap's spline gathered
//   2 the pickup per tap kept; one table entry read per tap
//   4 variant 0 with the cheap pickup of inline variant 6
//   5 the pickup per tap alone: no tap read

#include "resample_common.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;
  int row0, face_rows, nfx, nfy, n_taps, precise;
  Pickup pick;
  Table table;
};

__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float q = __fdividef(lo, fmaxf(hi, 1e-30f));
  const bool red = q > 0.4142135624f;
  const float t = red ? __fdividef(q - 1.0f, q + 1.0f) : q;
  const float s = t * t;
  float p = 6.1687607318e-02f;
  p = p * s - 1.0648017377e-01f;
  p = p * s + 1.4253635705e-01f;
  p = p * s - 1.9999158382e-01f;
  p = p * s + 3.3333328366e-01f;
  float r = t - t * (s * p);
  r = red ? 0.78539816339744831f + r : r;
  r = ay > ax ? 1.5707963267948966f - r : r;
  r = x < 0.0f ? 3.14159265358979f - r : r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float fast_gate(float v, int mode, float lower,
                                           float upper) {
  if (mode == GATE_PERIODIC) {
    const float p = upper - lower, d = v - lower;
    return lower + (d - floorf(d * __frcp_rn(p)) * p);
  }
  if (mode == GATE_MIRROR) {
    const float p = 2.0f * (upper - lower), d = v - lower;
    const float t = d - floorf(d * __frcp_rn(p)) * p;
    return lower + fminf(t, p - t);
  }
  return fminf(fmaxf(v, lower), upper);
}

template <bool FAST>
__device__ __forceinline__ void pick(const Pickup& p, float rx, float ry,
                                     float rz, float& sx, float& sy) {
  if (FAST && p.smode == SMODE_SPH) {
    const float lon = fast_atan2(rx, rz);
    const float lat = fast_atan2(ry, sqrtf(rx * rx + rz * rz));
    sx = fast_gate(lon * p.kx + p.cx, p.gate_x, p.glx, p.gux) + p.pad;
    sy = fast_gate(lat * p.ky + p.cy, p.gate_y, p.gly, p.guy) + p.pad;
    return;
  }
  pickup(p, rx, ry, rz, sx, sy);
}

template <int VARIANT, int TMODE>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
inline_kernel(float* __restrict__ out, const float* __restrict__ coeff,
              const float4* __restrict__ coeff4,
              const float* __restrict__ xfeat,
              const float* __restrict__ yfeat,
              const float* __restrict__ bmats, const Params p) {
  constexpr int DEGREE = 3, NCH = 3;
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  float sx, sy;
  if (VARIANT == 1) {
    const int64_t wc = p.table.wp - 8, hc = p.table.hp - 8;
    sx = 4.0f + (float)(x % wc);
    sy = 4.0f + (float)((y + (x / wc) * p.height) % hc);
  } else {
    int face = 0;
    if (p.face_rows > 0) {
      face = (p.row0 + (int)y) / p.face_rows;
      face = min(max(face, 0), 5);
    }
    float rx, ry, rz;
    target_ray<TMODE>(xfeat, yfeat, x, y, p.width, p.height, bmats + face * 9,
                      rx, ry, rz);
    pick<VARIANT == 6>(p.pick, rx, ry, rz, sx, sy);
  }
  float acc[NCH];
  float* dst = out + (y * p.width + x) * NCH;
  if (VARIANT == 5) {
    dst[0] = sx; dst[1] = sy; dst[2] = sx + sy;
    return;
  }
  if (VARIANT == 2 || VARIANT == 4) {
    const float selx = floorf(sx), sely = floorf(sy);
    float wx[DEGREE + 1], wy[DEGREE + 1];
    weights<DEGREE>(p.table.wmat, sx - selx, wx);
    weights<DEGREE>(p.table.wmat, sy - sely, wy);
    const int64_t bx = (int64_t)selx - DEGREE / 2;
    const int64_t by = (int64_t)sely - DEGREE / 2;
    const int64_t last = p.table.hp * p.table.wp - 1;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
    if (VARIANT == 2) {
      int64_t idx = by * p.table.wp + bx;
      idx = idx < 0 ? 0 : (idx > last ? last : idx);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j <= DEGREE; ++j)
#pragma unroll
        for (int k = 0; k <= DEGREE; ++k) s += wx[k] * wy[j];
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[c] = s * __ldg(coeff + idx * NCH + c);
    } else {
#pragma unroll
      for (int j = 0; j <= DEGREE; ++j) {
        const int64_t row = (by + j) * p.table.wp + bx;
        float racc[NCH] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k <= DEGREE; ++k) {
          int64_t idx = row + k;
          idx = idx < 0 ? 0 : (idx > last ? last : idx);
          const float4 v = __ldg(coeff4 + idx);
          racc[0] += wx[k] * v.x;
          racc[1] += wx[k] * v.y;
          racc[2] += wx[k] * v.z;
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[c] += wy[j] * racc[c];
      }
    }
  } else {
    spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, acc);
  }
  if (VARIANT == 3) {
    dst[0] = acc[0] + acc[1] + acc[2];
    return;
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

__device__ __forceinline__ void normalise(float& x, float& y, float& z) {
  const float n = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                                 __fmul_rn(y, y)),
                                       __fmul_rn(z, z)));
  x = __fdiv_rn(x, n);
  y = __fdiv_rn(y, n);
  z = __fdiv_rn(z, n);
}

template <int VARIANT>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
twined_kernel(float* __restrict__ out, const float* __restrict__ coeff,
              const float* __restrict__ xfeat,
              const float* __restrict__ yfeat,
              const float* __restrict__ bmats,
              const float* __restrict__ spread, const Params p) {
  constexpr int DEGREE = 1, NCH = 3, TMODE = TMODE_AFFINE;
  extern __shared__ float taps[];
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const float* bm = bmats;
  const float* xbias = xfeat + p.nfx * p.width;
  const float* ybias = yfeat + p.nfy * p.height;
  float p0[3], du[3], dv[3];
  target_ray<TMODE>(xfeat, yfeat, x, y, p.width, p.height, bm,
                    p0[0], p0[1], p0[2]);
  target_ray<TMODE>(xbias, yfeat, x, y, p.width, p.height, bm,
                    du[0], du[1], du[2]);
  target_ray<TMODE>(xfeat, ybias, x, y, p.width, p.height, bm,
                    dv[0], dv[1], dv[2]);
  normalise(p0[0], p0[1], p0[2]);
  normalise(du[0], du[1], du[2]);
  normalise(dv[0], dv[1], dv[2]);
  float sx0 = 0, sy0 = 0, dux = 0, duy = 0, dvx = 0, dvy = 0;
  if (VARIANT == 1) {
    pickup(p.pick, p0[0], p0[1], p0[2], sx0, sy0);
    pickup(p.pick, du[0], du[1], du[2], dux, duy);
    pickup(p.pick, dv[0], dv[1], dv[2], dvx, dvy);
    dux -= sx0; duy -= sy0; dvx -= sx0; dvy -= sy0;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    du[i] = __fsub_rn(du[i], p0[i]);
    dv[i] = __fsub_rn(dv[i], p0[i]);
  }
  float acc[NCH] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < p.n_taps; ++k) {
    const float cx = taps[3 * k], cy = taps[3 * k + 1], w = taps[3 * k + 2];
    float sx, sy, val[NCH];
    if (VARIANT == 1) {
      sx = clamp_coord<DEGREE>(sx0 + cx * dux + cy * dvx, p.table.wp);
      sy = clamp_coord<DEGREE>(sy0 + cx * duy + cy * dvy, p.table.hp);
    } else {
      float r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        r[i] = __fadd_rn(__fadd_rn(p0[i], __fmul_rn(cx, du[i])),
                         __fmul_rn(cy, dv[i]));
      pick<VARIANT == 4>(p.pick, r[0], r[1], r[2], sx, sy);
    }
    if (VARIANT == 5) {
      val[0] = sx; val[1] = sy; val[2] = sx + sy;
    } else if (VARIANT == 2) {
      const float selx = floorf(sx), sely = floorf(sy);
      const int64_t last = p.table.hp * p.table.wp - 1;
      int64_t idx = (int64_t)sely * p.table.wp + (int64_t)selx;
      idx = idx < 0 ? 0 : (idx > last ? last : idx);
      const float f = (sx - selx) * (sy - sely);
#pragma unroll
      for (int c = 0; c < NCH; ++c) val[c] = f * __ldg(coeff + idx * NCH + c);
    } else {
      spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, val);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

template <int TMODE>
cudaError_t launch_inline(int variant, dim3 grid, dim3 block, cudaStream_t s,
                          float* out, const float* coeff,
                          const float4* coeff4, const float* xfeat,
                          const float* yfeat, const float* bmats,
                          const Params& p) {
#define CASE(V)                                                          \
  case V:                                                                \
    inline_kernel<V, TMODE><<<grid, block, 0, s>>>(out, coeff, coeff4,   \
                                                   xfeat, yfeat, bmats, p); \
    break;
  switch (variant) {
    CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" int ablate_inline(
    int variant, float* out, const float* coeff, const float* coeff4,
    const float* xfeat, const float* yfeat, const float* bmats,
    const float* wmat, long long height, long long width, long long hp,
    long long wp, int row0, int face_rows, int tmode, int smode,
    int gate_x, float glx, float gux, int gate_y, float gly, float guy,
    float kx, float cx, float ky, float cy, float pad, float section_px,
    void* stream) {
  Params p;
  p.height = height; p.width = width; p.row0 = row0; p.face_rows = face_rows;
  p.nfx = p.nfy = 1; p.n_taps = 0; p.precise = 0;
  p.pick = Pickup{smode, gate_x, gate_y, glx, gux, gly, guy,
                  kx, cx, ky, cy, pad, section_px};
  set_table(p.table, hp, wp, 3, wmat);
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid = frame_grid(height, width);
  if (tmode == TMODE_AFFINE)
    return (int)launch_inline<TMODE_AFFINE>(
        variant, grid, block, (cudaStream_t)stream, out, coeff,
        (const float4*)coeff4, xfeat, yfeat, bmats, p);
  if (tmode == TMODE_SPH)
    return (int)launch_inline<TMODE_SPH>(
        variant, grid, block, (cudaStream_t)stream, out, coeff,
        (const float4*)coeff4, xfeat, yfeat, bmats, p);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ablate_twined(
    int variant, float* out, const float* coeff, const float* xfeat,
    const float* yfeat, const float* bmats, const float* spread,
    const float* wmat, long long height, long long width, long long hp,
    long long wp, int n_taps, int smode,
    int gate_x, float glx, float gux, int gate_y, float gly, float guy,
    float kx, float cx, float ky, float cy, float pad, void* stream) {
  Params p;
  p.height = height; p.width = width; p.row0 = 0; p.face_rows = 0;
  p.nfx = p.nfy = 1; p.n_taps = n_taps; p.precise = 0;
  p.pick = Pickup{smode, gate_x, gate_y, glx, gux, gly, guy,
                  kx, cx, ky, cy, pad, 0.0f};
  set_table(p.table, hp, wp, 1, wmat);
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid = frame_grid(height, width);
  const size_t smem = (size_t)3 * n_taps * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define CASE(V)                                                            \
  case V:                                                                  \
    twined_kernel<V><<<grid, block, smem, s>>>(out, coeff, xfeat, yfeat,   \
                                               bmats, spread, p);          \
    break;
  switch (variant) {
    CASE(0) CASE(1) CASE(2) CASE(4) CASE(5)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
  return (int)cudaGetLastError();
}
