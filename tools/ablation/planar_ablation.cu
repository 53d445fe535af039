// Variants of the two planar kernels (resample_planar.cu and
// resample_twined.cu as they stood before the fused coordinate chain),
// each with one part of the work removed or replaced, to attribute the
// kernels' time on the card where no profiler runs. Degree 3, three
// channels. The outputs of all variants but 0 are wrong on purpose;
// tools/ablation/ablate_planar.py times them with CUDA events.
//
// Variants of both kernels:
//   0 the kernel as it stood (coordinate planes and, where given, the
//     mask or the tap-weight planes read; (n+1)^2 taps gathered per
//     spline from global memory with scalar loads)
//   1 planes read; one table entry read per spline instead of (n+1)^2
//   2 planes read; nothing gathered (the coordinates summed and stored)
//   3 taps gathered; no plane read: the coordinates are a cheap affine
//     of the pixel index in registers (``stand``: sx = a x + b, sy =
//     c y + d, covered where x0 <= x < x1 and y0 <= y < y1; the twined
//     kernel's derivatives are the constants du, dv)
//
// Variants of the two chain forms (the coordinate chain in registers,
// planar_chain.cuh), variants 0-2 as above: 0 the chain form as it is,
// 1 the chain and one table entry read per spline, 2 the chain alone
// (nothing gathered); and for the planar chain form 3: each block's
// window staged in shared memory with the inline kernel's stage_window
// and read with spline_staged (resample_common.cuh; 32x8 pixels a
// block, a 32 KB budget).

#include "planar_chain.cuh"

namespace {

using namespace envutil;

struct Stand {
  float a, b, c, d;             // sx = a x + b, sy = c y + d
  int x0, x1, y0, y1;           // covered rectangle (mask or tap weights)
  float dux, duy, dvx, dvy;     // twined: derivative constants
};

struct Params {
  int64_t height, width;
  int n_taps, tapw_u8, variant;
  float lower_x, period_x;
  Stand stand;
  Table table;
};

constexpr int DEGREE = 3;
constexpr int NCH = 3;

__device__ __forceinline__ void one_tap(const float* __restrict__ coeff,
                                        const Table& t, float sx, float sy,
                                        float (&acc)[NCH]) {
  int64_t idx = (int64_t)floorf(sy) * t.wp + (int64_t)floorf(sx);
  const int64_t last = t.hp * t.wp - 1;
  idx = idx < 0 ? 0 : (idx > last ? last : idx);
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = __ldg(coeff + idx * NCH + c);
}

__device__ __forceinline__ void evaluate(int variant,
                                         const float* __restrict__ coeff,
                                         const Table& t, float sx, float sy,
                                         float (&acc)[NCH]) {
  sx = clamp_coord<DEGREE>(sx, t.wp);
  sy = clamp_coord<DEGREE>(sy, t.hp);
  if (variant == 1) {
    one_tap(coeff, t, sx, sy, acc);
  } else if (variant == 2) {
    acc[0] = sx; acc[1] = sy; acc[2] = sx * sy;
  } else {
    spline_at<DEGREE, NCH>(coeff, t, sx, sy, acc);
  }
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
planar_variant(float* __restrict__ out, const float* __restrict__ coeff,
               const float* __restrict__ sxp, const float* __restrict__ syp,
               const float* __restrict__ mask, const Params p) {
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const int64_t pix = y * p.width + x;
  float sx, sy;
  if (p.variant == 3) {
    if (mask != nullptr && !(x >= p.stand.x0 && x < p.stand.x1 &&
                             y >= p.stand.y0 && y < p.stand.y1))
      return;
    sx = p.stand.a * (float)x + p.stand.b;
    sy = p.stand.c * (float)y + p.stand.d;
  } else {
    if (mask != nullptr && !(__ldg(mask + pix) > 0.5f)) return;
    sx = __ldg(sxp + pix);
    sy = __ldg(syp + pix);
  }
  float acc[NCH];
  evaluate(p.variant, coeff, p.table, sx, sy, acc);
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
twined_variant(float* __restrict__ out, const float* __restrict__ coeff,
               const float* __restrict__ sxp, const float* __restrict__ syp,
               const float* __restrict__ duxp, const float* __restrict__ duyp,
               const float* __restrict__ dvxp, const float* __restrict__ dvyp,
               const float* __restrict__ spread,
               const unsigned char* __restrict__ tapw, const Params p) {
  extern __shared__ float taps[];
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const int64_t pix = y * p.width + x;
  const int64_t plane = p.height * p.width;
  const bool stand = p.variant == 3;
  const bool inside = x >= p.stand.x0 && x < p.stand.x1 &&
                      y >= p.stand.y0 && y < p.stand.y1;

  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  bool loaded = false;
  float sx0 = 0.0f, sy0 = 0.0f, dux = 0.0f, duy = 0.0f, dvx = 0.0f,
        dvy = 0.0f;
  for (int k = 0; k < p.n_taps; ++k) {
    float w = taps[3 * k + 2];
    if (tapw != nullptr) {
      const float tw = stand ? (inside ? 1.0f : 0.0f)
                             : (float)__ldg(tapw + (int64_t)k * plane + pix);
      if (tw == 0.0f) continue;
      w *= tw;
    }
    if (!loaded) {
      if (stand) {
        sx0 = p.stand.a * (float)x + p.stand.b;
        sy0 = p.stand.c * (float)y + p.stand.d;
        dux = p.stand.dux; duy = p.stand.duy;
        dvx = p.stand.dvx; dvy = p.stand.dvy;
      } else {
        sx0 = __ldg(sxp + pix);  sy0 = __ldg(syp + pix);
        dux = __ldg(duxp + pix); duy = __ldg(duyp + pix);
        dvx = __ldg(dvxp + pix); dvy = __ldg(dvyp + pix);
      }
      loaded = true;
    }
    const float cx = taps[3 * k], cy = taps[3 * k + 1];
    float sx = sx0 + cx * dux + cy * dvx;
    float sy = sy0 + cx * duy + cy * dvy;
    if (p.period_x > 0.0f) sx = p.lower_x + floor_mod(sx - p.lower_x, p.period_x);
    float val[NCH];
    evaluate(p.variant, coeff, p.table, sx, sy, val);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

struct ChainParams {
  int64_t height, width;
  int row0, face_rows, nfx, nfy, tmode, n_taps, precise, tap_valid, variant;
  ChainPickup pick;
  Table table;
};

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
planar_chain_variant(float* __restrict__ out, const float* __restrict__ coeff,
                     const float* __restrict__ xfeat,
                     const float* __restrict__ yfeat,
                     const float* __restrict__ bmats, const ChainParams p) {
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  int face = 0;
  if (p.face_rows > 0) face = min(max((p.row0 + (int)y) / p.face_rows, 0), 5);
  float r[3], sx, sy;
  chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height, bmats + face * 9,
            r);
  const bool hit = chain_pickup(p.pick, r[0], r[1], r[2], sx, sy);
  float acc[NCH] = {0.0f, 0.0f, 0.0f};
  if (hit) evaluate(p.variant, coeff, p.table, sx, sy, acc);
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

constexpr int STAGE_BYTES = 32 * 1024;

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
planar_chain_staged(float* __restrict__ out, const float* __restrict__ coeff,
                    const float* __restrict__ xfeat,
                    const float* __restrict__ yfeat,
                    const float* __restrict__ bmats, const ChainParams p) {
  __shared__ float4 win4[STAGE_BYTES / 16];
  __shared__ int sbox[4];
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  const bool inside = x < p.width && y < p.height;
  float sx = 0.0f, sy = 0.0f;
  bool hit = false;
  Box box = empty_box();
  if (inside) {
    int face = 0;
    if (p.face_rows > 0) face = min(max((p.row0 + (int)y) / p.face_rows, 0), 5);
    float r[3];
    chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height,
              bmats + face * 9, r);
    hit = chain_pickup(p.pick, r[0], r[1], r[2], sx, sy);
    sx = clamp_coord<DEGREE>(sx, p.table.wp);
    sy = clamp_coord<DEGREE>(sy, p.table.hp);
    if (hit) box_add<DEGREE>(box, p.table, sx, sy);
  }
  float* win = reinterpret_cast<float*>(win4);
  const Window w = stage_window<DEGREE, NCH>(box, p.table, coeff, win, sbox,
                                             STAGE_BYTES);
  if (!inside) return;
  float acc[NCH] = {0.0f, 0.0f, 0.0f};
  if (hit) spline_staged<DEGREE, NCH>(win, w, coeff, p.table, sx, sy, acc);
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
twined_chain_variant(float* __restrict__ out, const float* __restrict__ coeff,
                     const float* __restrict__ xfeat,
                     const float* __restrict__ yfeat,
                     const float* __restrict__ bmats,
                     const float* __restrict__ spread, const ChainParams p) {
  extern __shared__ float taps[];
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  int face = 0;
  if (p.face_rows > 0) face = min(max((p.row0 + (int)y) / p.face_rows, 0), 5);
  const float* bm = bmats + face * 9;
  float p0[3], p10[3], p01[3], du[3], dv[3];
  chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height, bm, p0);
  chain_ray(p.tmode, xfeat + p.nfx * p.width, yfeat, x, y, p.width,
            p.height, bm, p10);
  chain_ray(p.tmode, xfeat, yfeat + p.nfy * p.height, x, y, p.width,
            p.height, bm, p01);
#pragma unroll
  for (int i = 0; i < 3; ++i) { du[i] = p10[i]; dv[i] = p01[i]; }
  derivative_ray(p0, du, p.precise != 0);
  derivative_ray(p0, dv, p.precise != 0);
  const int sface = p.pick.smode == SMODE_MOUNT ? 0 : cube_face(p0[0], p0[1], p0[2]);
  float x0, y0, xu, yu, xv, yv;
  twined_pickup(p.pick, p0[0], p0[1], p0[2], sface, x0, y0);
  twined_pickup(p.pick, p10[0], p10[1], p10[2], sface, xu, yu);
  twined_pickup(p.pick, p01[0], p01[1], p01[2], sface, xv, yv);
  const float dux = coord_derivative(xu, x0, p.pick.period);
  const float duy = coord_derivative(yu, y0, 0.0f);
  const float dvx = coord_derivative(xv, x0, p.pick.period);
  const float dvy = coord_derivative(yv, y0, 0.0f);
  const float sx0 = add(x0, p.pick.pad), sy0 = add(y0, p.pick.pad);
  const float lower = sub(p.pick.pad, 0.5f);
  float acc[NCH] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < p.n_taps; ++k) {
    const float cx = taps[3 * k], cy = taps[3 * k + 1], w = taps[3 * k + 2];
    if (p.tap_valid) {
      float r[3], px, py;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        r[i] = add(add(p0[i], mul(cx, du[i])), mul(cy, dv[i]));
      if (!mount_planar(p.pick, r[0], r[1], r[2], px, py)) continue;
    }
    float sx = sx0 + cx * dux + cy * dvx;
    float sy = sy0 + cx * duy + cy * dvy;
    if (p.pick.period > 0.0f) sx = lower + floor_mod(sx - lower, p.pick.period);
    float val[NCH];
    evaluate(p.variant, coeff, p.table, sx, sy, val);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

Params make_params(long long height, long long width, long long hp,
                   long long wp, const float* wmat, int variant,
                   const float* stand) {
  Params p;
  p.height = height; p.width = width;
  p.variant = variant;
  p.n_taps = 0; p.tapw_u8 = 1;
  p.lower_x = 0.0f; p.period_x = 0.0f;
  p.stand = Stand{stand[0], stand[1], stand[2], stand[3],
                  (int)stand[4], (int)stand[5], (int)stand[6], (int)stand[7],
                  stand[8], stand[9], stand[10], stand[11]};
  set_table(p.table, hp, wp, DEGREE, wmat);
  return p;
}

}  // namespace

// ``stand`` is a host array of 12 floats: a, b, c, d, x0, x1, y0, y1,
// dux, duy, dvx, dvy (see the note at the head).
extern "C" int ablate_planar(int variant, float* out, const float* coeff,
                             const float* sx, const float* sy,
                             const float* mask, const float* wmat,
                             const float* stand, long long height,
                             long long width, long long hp, long long wp,
                             void* stream) {
  const Params p = make_params(height, width, hp, wp, wmat, variant, stand);
  planar_variant<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y), 0,
                   (cudaStream_t)stream>>>(out, coeff, sx, sy, mask, p);
  return (int)cudaGetLastError();
}

extern "C" int ablate_twined(int variant, float* out, const float* coeff,
                             const float* sx, const float* sy,
                             const float* dux, const float* duy,
                             const float* dvx, const float* dvy,
                             const float* spread, const unsigned char* tapw,
                             const float* wmat, const float* stand,
                             long long height, long long width, long long hp,
                             long long wp, int n_taps, float lower_x,
                             float period_x, void* stream) {
  Params p = make_params(height, width, hp, wp, wmat, variant, stand);
  p.n_taps = n_taps;
  p.lower_x = lower_x; p.period_x = period_x;
  twined_variant<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y),
                   (size_t)3 * n_taps * sizeof(float), (cudaStream_t)stream>>>(
      out, coeff, sx, sy, dux, duy, dvx, dvy, spread, tapw, p);
  return (int)cudaGetLastError();
}

// the chain forms' variants; ``ipick``/``fpick`` as for the shipped
// entry points (planar_chain.cuh: set_pickup)
extern "C" int ablate_chain(int variant, float* out, const float* coeff,
                            const float* xfeat, const float* yfeat,
                            const float* bmats, const float* spread,
                            const float* wmat, const int* ipick,
                            const float* fpick, long long height,
                            long long width, long long hp, long long wp,
                            int row0, int face_rows, int tmode, int n_taps,
                            int precise, int tap_valid, void* stream) {
  ChainParams p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows; p.tmode = tmode;
  p.nfx = (tmode == TMODE_SPH || tmode == TMODE_CYL) ? 2 : 1;
  p.nfy = tmode == TMODE_SPH ? 2 : 1;
  p.n_taps = n_taps; p.precise = precise; p.tap_valid = tap_valid;
  p.variant = variant;
  set_pickup(p.pick, ipick, fpick);
  set_table(p.table, hp, wp, DEGREE, wmat);
  if (n_taps == 0 && variant == 3) {
    planar_chain_staged<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y),
                          0, (cudaStream_t)stream>>>(out, coeff, xfeat,
                                                     yfeat, bmats, p);
  } else if (n_taps == 0) {
    planar_chain_variant<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y),
                           0, (cudaStream_t)stream>>>(out, coeff, xfeat,
                                                      yfeat, bmats, p);
  } else {
    twined_chain_variant<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y),
                           (size_t)3 * n_taps * sizeof(float),
                           (cudaStream_t)stream>>>(out, coeff, xfeat, yfeat,
                                                   bmats, spread, p);
  }
  return (int)cudaGetLastError();
}
