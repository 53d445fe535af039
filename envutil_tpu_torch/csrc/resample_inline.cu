// Inline-coordinates b-spline resampler for Hopper (sm_90a).
//
// Replaces envutil_tpu/ops/pallas_resample.py:_inline_kernel_into (the
// body of resample_inline_into, with _inline_coords_rb, _atan2,
// _gate_const and _eval_row_block). Per output pixel it computes
//   target axis features -> ray by tmode (affine / sph / cyl)
//   -> per-face 3x3 matrix
//   -> source pickup by smode:
//        sph: lon/lat by atan2, model->spline affine, periodic/mirror/
//             clamp gate (full-spherical mount sources);
//        cubemap / biatan6: dominant-axis face by the where-cascade of
//             geometry.ray_to_cubeface, in-face division, biatan6
//             (4/pi) atan, IR affine plus the face's section offset
//             (cubemap IR sources; no gate, as the JAX kernel)
//   -> degree-n tensor-product b-spline over NCH channels
// and stores the (H, W, NCH) channel-interleaved result. The source
// mode is a launch-uniform runtime branch, not a template parameter:
// every warp takes the same side, and the build stays at 96
// instantiations.
//
// The ray is computed with __fmul_rn/__fadd_rn in the plain version's
// order (ops/resample.inline_rays), so nvcc contracts nothing there and
// the ray is bit-identical to the plain version's on the card; so are
// the IR division and affine. The cube face chosen at an edge then
// agrees with the plain version exactly: a flipped face would read the
// other section's support frame, which fill_support filled by bilinear
// reprojection, and agree only to that resampling error.
//
// Design. One thread per output pixel on 32x8 blocks; a warp covers 32
// neighbouring pixels of one row. The coefficient table is (Hp, Wp, NCH)
// channel-interleaved, so each of the (n+1)^2 taps is NCH contiguous
// floats read straight from global memory through L1/L2: Hopper needs
// none of the TPU kernel's window classes, window DMA or sheared
// candidate bands, which existed because Mosaic offers only an (8,128)
// in-register gather. For cubemap sources it needs none of the JAX fast
// path's forced-face 'sec' variants, face-boundary merge passes or
// window classes either: each pixel picks its own face and gathers from
// that face's section in the one launch over the whole frame. The flat
// table offset is 64-bit and clamped to the table, as the JAX
// evaluator's take(mode="clip") does.
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

constexpr int SMODE_SPH = 0;
constexpr int SMODE_CUBEMAP = 1;
constexpr int SMODE_BIATAN6 = 2;

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
  int smode;                    // SMODE_*
  int gate_x, gate_y;           // sph only
  float glx, gux, gly, guy;     // gate bounds (sph only)
  float kx, cx, ky, cy, pad;    // model (or in-face) -> spline affine
  float section_px;             // IR rows per cube face (cubemap/biatan6)
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

// one row of the ray matrix applied to (a, b, c) as the plain version
// rounds it: (m0 a + m1 b) + m2 c, with c == 1 adding m2 itself
__device__ __forceinline__ float ray_row(const float* m, float a, float b,
                                        float c, bool affine) {
  const float ab = __fadd_rn(__fmul_rn(m[0], a), __fmul_rn(m[1], b));
  return __fadd_rn(ab, affine ? m[2] : __fmul_rn(m[2], c));
}

// guard the inactive divisions of the face cascade against 0/0
__device__ __forceinline__ float safe(float d) { return d == 0.0f ? 1.0f : d; }

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

  // ray = B @ (a, b, c) by tmode, rounded step by step (see the top)
  float a, b, c;
  if (TMODE == TMODE_AFFINE) {
    // rect / cubemap / biatan6 targets: (px, py', 1)
    a = xfeat[x];
    b = yfeat[y];
    c = 1.0f;
  } else if (TMODE == TMODE_SPH) {
    // spherical target: (sin(lon) cos(lat), sin(lat), cos(lon) cos(lat))
    const float ct = yfeat[p.height + y];
    a = __fmul_rn(xfeat[x], ct);
    b = yfeat[y];
    c = __fmul_rn(xfeat[p.width + x], ct);
  } else {
    // cylindrical target: (sin(az), y, cos(az))
    a = xfeat[x];
    b = yfeat[y];
    c = xfeat[p.width + x];
  }
  const float rx = ray_row(bm, a, b, c, TMODE == TMODE_AFFINE);
  const float ry = ray_row(bm + 3, a, b, c, TMODE == TMODE_AFFINE);
  const float rz = ray_row(bm + 6, a, b, c, TMODE == TMODE_AFFINE);

  float sx, sy;
  if (p.smode == SMODE_SPH) {
    // full-spherical mount (geometry.ray_to_ll): the atan2 forms are
    // scale-invariant, so the ray needs no normalization
    const float lon = atan2f(rx, rz);
    const float lat = atan2f(ry, sqrtf(rx * rx + rz * rz));
    sx = gate(lon * p.kx + p.cx, p.gate_x, p.glx, p.gux) + p.pad;
    sy = gate(lat * p.ky + p.cy, p.gate_y, p.gly, p.guy) + p.pad;
  } else {
    // cubemap IR pickup (geometry.ray_to_cubeface with its tie rules,
    // metrics.get_pickup_coordinate_px as an affine)
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
// degree / channel count / target mode / source mode. ``wmat`` is a host array of
// (degree+1)^2 floats, copied into the kernel parameters.
extern "C" int envutil_resample_inline(
    float* out, const float* coeff, const float* xfeat, const float* yfeat,
    const float* bmats, const float* wmat,
    long long height, long long width, long long hp, long long wp,
    int row0, int face_rows, int degree, int nch, int tmode, int smode,
    int gate_x, float glx, float gux, int gate_y, float gly, float guy,
    float kx, float cx, float ky, float cy, float pad, float section_px,
    void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (smode < SMODE_SPH || smode > SMODE_BIATAN6) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width; p.hp = hp; p.wp = wp;
  p.row0 = row0; p.face_rows = face_rows;
  p.smode = smode; p.section_px = section_px;
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
