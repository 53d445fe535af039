// Inline-coordinates b-spline resampler for Hopper (sm_90a).
//
// Replaces envutil_tpu/ops/pallas_resample.py:_inline_kernel_into (the
// body of resample_inline_into, with _inline_coords_rb, _atan2,
// _gate_const and _eval_row_block). Per output pixel it computes
//   target axis features -> ray by tmode (affine / sph / cyl)
//   -> per-face 3x3 matrix -> lon/lat by atan2 (smode "sph")
//   -> model->spline affine + periodic/mirror/clamp gate
//   -> degree-n tensor-product b-spline over NCH channels
// and stores the (H, W, NCH) channel-interleaved result.
//
// Design. One thread per output pixel on 32x8 blocks; a warp covers 32
// neighbouring pixels of one row. The coefficient table is (Hp, Wp, NCH)
// channel-interleaved, so each of the (n+1)^2 taps is NCH contiguous
// floats read straight from global memory through L1/L2: Hopper needs
// none of the TPU kernel's window classes, window DMA or sheared
// candidate bands, which existed because Mosaic offers only an (8,128)
// in-register gather. The flat table offset is 64-bit and clamped to
// the table, as the JAX evaluator's take(mode="clip") does.
//
// Bound. The kernel moves bytes, not arithmetic: at the main path's
// shapes (2048x12288x3 f32 out, (4104, 8200, 3) f32 table) it writes
// ~302 MB and reads at most ~404 MB of table, about 0.21 ms at
// 3.35 TB/s if every table byte is read once; the arithmetic (~2 atan2
// and ~60 FMAs a pixel, ~4 GFLOP) is ~0.06 ms at 67 TFLOP/s f32.
// chip_smoke.py recomputes the bound from the table entries the frame
// really touches.
//
// Left for later: staging each block's source window in shared memory
// (the taps of neighbouring threads overlap heavily, so L1 carries the
// reuse today), and coalescing the gather across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TMODE_AFFINE = 0;
constexpr int TMODE_SPH = 1;
constexpr int TMODE_CYL = 2;

constexpr int GATE_PERIODIC = 0;
constexpr int GATE_MIRROR = 1;  // any other code clamps

constexpr int MAX_DEGREE = 7;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

struct Params {
  int64_t height, width;        // output window
  int64_t hp, wp;               // padded table
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int gate_x, gate_y;
  float glx, gux, gly, guy;     // gate bounds
  float kx, cx, ky, cy, pad;    // model -> spline affine
  float wmat[(MAX_DEGREE + 1) * (MAX_DEGREE + 1)];  // weight matrix
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

template <int DEGREE, int NCH, int TMODE>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_inline_kernel(float* __restrict__ out,
                       const float* __restrict__ coeff,
                       const float* __restrict__ xfeat,
                       const float* __restrict__ yfeat,
                       const float* __restrict__ bmats,
                       const Params p) {
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;

  int face = 0;
  if (p.face_rows > 0) {
    face = (p.row0 + (int)y) / p.face_rows;
    face = min(max(face, 0), 5);
  }
  const float* bm = bmats + face * 9;

  float rx, ry, rz;
  if (TMODE == TMODE_AFFINE) {
    // rect / cubemap / biatan6 targets: ray = B @ (px, py', 1)
    const float px = xfeat[x];
    const float py = yfeat[y];
    rx = bm[0] * px + bm[1] * py + bm[2];
    ry = bm[3] * px + bm[4] * py + bm[5];
    rz = bm[6] * px + bm[7] * py + bm[8];
  } else if (TMODE == TMODE_SPH) {
    // spherical target: ray = B @ (sin(lon) cos(lat), sin(lat), cos(lon) cos(lat))
    const float sl = xfeat[x], cl = xfeat[p.width + x];
    const float st = yfeat[y], ct = yfeat[p.height + y];
    const float ux = sl * ct, uz = cl * ct;
    rx = bm[0] * ux + bm[1] * st + bm[2] * uz;
    ry = bm[3] * ux + bm[4] * st + bm[5] * uz;
    rz = bm[6] * ux + bm[7] * st + bm[8] * uz;
  } else {
    // cylindrical target: ray = B @ (sin(az), y, cos(az))
    const float sl = xfeat[x], cl = xfeat[p.width + x];
    const float uy = yfeat[y];
    rx = bm[0] * sl + bm[1] * uy + bm[2] * cl;
    ry = bm[3] * sl + bm[4] * uy + bm[5] * cl;
    rz = bm[6] * sl + bm[7] * uy + bm[8] * cl;
  }

  // source side, full-spherical mount (geometry.ray_to_ll): the atan2
  // forms are scale-invariant, so the ray needs no normalization
  const float lon = atan2f(rx, rz);
  const float lat = atan2f(ry, sqrtf(rx * rx + rz * rz));
  const float sx = gate(lon * p.kx + p.cx, p.gate_x, p.glx, p.gux) + p.pad;
  const float sy = gate(lat * p.ky + p.cy, p.gate_y, p.gly, p.guy) + p.pad;

  // split (zimt/eval.h:595-610): floor for odd degrees, round for even
  const float selx = (DEGREE & 1) ? floorf(sx) : floorf(sx + 0.5f);
  const float sely = (DEGREE & 1) ? floorf(sy) : floorf(sy + 0.5f);
  float wx[DEGREE + 1], wy[DEGREE + 1];
  weights<DEGREE>(p.wmat, sx - selx, wx);
  weights<DEGREE>(p.wmat, sy - sely, wy);
  const int64_t bx = (int64_t)selx - DEGREE / 2;
  const int64_t by = (int64_t)sely - DEGREE / 2;
  const int64_t last = p.hp * p.wp - 1;

  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int j = 0; j <= DEGREE; ++j) {
    const int64_t row = (by + j) * p.wp + bx;
    float racc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) racc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k <= DEGREE; ++k) {
      int64_t idx = row + k;
      idx = idx < 0 ? 0 : (idx > last ? last : idx);
      const float* tap = coeff + idx * NCH;
#pragma unroll
      for (int c = 0; c < NCH; ++c) racc[c] += wx[k] * __ldg(tap + c);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += wy[j] * racc[c];
  }
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

template <int DEGREE, int NCH, int TMODE>
cudaError_t launch(float* out, const float* coeff, const float* xfeat,
                   const float* yfeat, const float* bmats, const Params& p,
                   cudaStream_t stream) {
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((unsigned)((p.width + BLOCK_X - 1) / BLOCK_X),
                  (unsigned)((p.height + BLOCK_Y - 1) / BLOCK_Y));
  resample_inline_kernel<DEGREE, NCH, TMODE>
      <<<grid, block, 0, stream>>>(out, coeff, xfeat, yfeat, bmats, p);
  return cudaGetLastError();
}

template <int DEGREE, int NCH>
cudaError_t by_tmode(int tmode, float* out, const float* coeff,
                     const float* xfeat, const float* yfeat,
                     const float* bmats, const Params& p, cudaStream_t s) {
  switch (tmode) {
    case TMODE_AFFINE: return launch<DEGREE, NCH, TMODE_AFFINE>(out, coeff, xfeat, yfeat, bmats, p, s);
    case TMODE_SPH: return launch<DEGREE, NCH, TMODE_SPH>(out, coeff, xfeat, yfeat, bmats, p, s);
    case TMODE_CYL: return launch<DEGREE, NCH, TMODE_CYL>(out, coeff, xfeat, yfeat, bmats, p, s);
  }
  return cudaErrorInvalidValue;
}

template <int DEGREE>
cudaError_t by_nch(int nch, int tmode, float* out, const float* coeff,
                   const float* xfeat, const float* yfeat,
                   const float* bmats, const Params& p, cudaStream_t s) {
  switch (nch) {
    case 1: return by_tmode<DEGREE, 1>(tmode, out, coeff, xfeat, yfeat, bmats, p, s);
    case 2: return by_tmode<DEGREE, 2>(tmode, out, coeff, xfeat, yfeat, bmats, p, s);
    case 3: return by_tmode<DEGREE, 3>(tmode, out, coeff, xfeat, yfeat, bmats, p, s);
    case 4: return by_tmode<DEGREE, 4>(tmode, out, coeff, xfeat, yfeat, bmats, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported
// degree / channel count / target mode. ``wmat`` is a host array of
// (degree+1)^2 floats, copied into the kernel parameters.
extern "C" int envutil_resample_inline(
    float* out, const float* coeff, const float* xfeat, const float* yfeat,
    const float* bmats, const float* wmat,
    long long height, long long width, long long hp, long long wp,
    int row0, int face_rows, int degree, int nch, int tmode,
    int gate_x, float glx, float gux, int gate_y, float gly, float guy,
    float kx, float cx, float ky, float cy, float pad, void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width; p.hp = hp; p.wp = wp;
  p.row0 = row0; p.face_rows = face_rows;
  p.gate_x = gate_x; p.gate_y = gate_y;
  p.glx = glx; p.gux = gux; p.gly = gly; p.guy = guy;
  p.kx = kx; p.cx = cx; p.ky = ky; p.cy = cy; p.pad = pad;
  for (int i = 0; i < (degree + 1) * (degree + 1); ++i) p.wmat[i] = wmat[i];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (degree) {
    case 0: err = by_nch<0>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    case 1: err = by_nch<1>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    case 2: err = by_nch<2>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    case 3: err = by_nch<3>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    case 4: err = by_nch<4>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    case 5: err = by_nch<5>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    case 6: err = by_nch<6>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
    default: err = by_nch<7>(nch, tmode, out, coeff, xfeat, yfeat, bmats, p, s); break;
  }
  return (int)err;
}
