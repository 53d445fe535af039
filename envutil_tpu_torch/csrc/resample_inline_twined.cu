// Inline-coordinates twined b-spline resampler for Hopper (sm_90a).
//
// Replaces envutil_tpu/ops/pallas_resample.py:_inline_twined_kernel_into
// (the body of resample_inline_twined_into). Per output pixel it
// computes the three rays of the twining ninepack - the centre and the
// two DERIV_BIAS-biased grids, from the doubled axis-feature sets -
// normalises them, differences them into the derivative rays du, dv (by
// plain differencing, or with ``precise`` by projection onto the
// centre ray's tangent plane, twining.h:152-263), and sums over the
// spread's taps
//     sum_k w_k * spline(pickup(p0 + cx_k du + cy_k dv))
// with the inline kernel's own pickup and spline (resample_common.cuh).
//
// Where the deflection is linearised. The TPU kernel differences gated
// spline coordinates and deflects in coordinate space, which is sound
// only because its planner keeps it away from the periodic seam, the
// poles and cube edges (those tiles go to rolled/pitched source copies,
// forced-face passes or a patcher). Here one launch covers every pixel,
// so the kernel linearises in ray space, as the reference does
// (twining.h:236-238) and as the exact path (models/synopsis.twined)
// does: each tap's ray p0 + d, d = cx du + cy dv, is picked up on its
// own, and the seam, the poles and cube edges are no special case.
//
// The increment pickup (a spherical source, two or more taps). The
// centre ray is picked up once a pixel (lon0, lat0 by atan2f, rho0 =
// |(x0, z0)|); a tap's longitude and latitude are lon0 and lat0 plus the
// angle of its deflection, atan(t) of a ratio t of cross and dot
// products formed from d (ops/resample.increment_coords has the
// formulas), by an odd polynomial of four terms that is float32-exact
// for |t| <= INCREMENT_TAU = 1/16. Per tap that is three approximate
// reciprocals, one reciprocal square root and some forty fused
// multiply-adds: no transcendental. A tap whose dot product is <= 0 or
// whose |t| exceeds the bound (at or next to a pole, a coarse output
// pixel) takes the full pickup, pickup(), inline. The sum lon0 + dlon
// rounds once where atan2f rounds once, so the coordinates stay within
// an ulp or two of the full pickup's (at the 16K table's seam one ulp
// of the coordinate is 2e-3 px). The gates take their division only
// where a coordinate wraps (gate_unwrapped, bit-identical to gate()),
// and a support inside the table is read with 32-bit offsets from its
// first entry and no clamp per entry (spline_block, bit-identical to
// spline_at). One-tap launches (the taps of twined hdr_merge stitches)
// and cube sources keep the full pickup of every tap, their rays
// rounded as before; the choice is uniform across a launch, so the
// build keeps its 96 instantiations a table type.
//
// Rounding. The rays, their normalisation and the derivative rays are
// computed with __fmul_rn/__fadd_rn/__fsqrt_rn/__fdiv_rn in the plain
// version's order (ops/resample.resample_inline_twined_plain through
// models/synopsis.derivative_rays), bit-identical to the plain
// version's on the card; so is each tap's ray where every tap takes the
// full pickup (deflect's order), and with it the cube face each tap
// picks. The increment fuses multiply-adds and takes approximate
// reciprocals where the plain version rounds each step: the two agree
// to a few ulp of the increments, far below an ulp of the coordinate.
//
// Design. One thread per output pixel on 32x8 blocks and a runtime loop
// over the taps inside; the spread (3 floats a tap, 1/DERIV_BIAS folded
// into the offsets) is staged in dynamic shared memory once per block,
// so the tap count is no template parameter. Taps of one pixel land
// within a few source pixels of each other, so L1 serves most of their
// gathers.
//
// What bounds it on this card. Its instructions, not its loads: an
// ablation of the kernel before the increment (tools/ablation/
// ablate_inline.py) put ~2/3 of its time into each tap's ray, pickup and
// weights. The increment and the two bit-identical shortcuts cut the
// instructions of a tap (tools/ablation/k4_sass.py counts them); where
// the taps' supports scatter (next to a pole) the loads take over.
// Capping the registers at 40 for a sixth block per SM gained up to 5%
// at degree 1 but spilled hundreds of bytes at high degrees, so the
// kernel keeps the compiler's choice (PERF.md has the measurements).
//
// No staged window. The inline kernel copies each block's source window
// into shared memory (resample_common.cuh: stage_window). The same was
// built and timed here (the box of the pixels' first taps widened by
// the spread's reach, a test per tap, global memory for taps outside):
// against this plain loop it cost 15% at 4 taps and broke even from 9
// to 16, because it takes wavefronts off L1 but adds a box, a copy,
// barriers and a test per tap to a kernel that waits on none of its
// loads.
//
// bf16 tables (--coeff bf16): the kernel is templated on the table's
// element type and converts each tap to float where it loads it
// (resample_common.cuh: tap_load); the table's device memory halves.
//
// Left for later: increments for cubemap and biatan6 taps, sharing the
// (n+1)^2 support between neighbouring taps (the TPU kernel's union-tap
// form), and the separable-grid spread layout, which both compute the
// same sum.

#include "resample_common.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;        // output window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int nfx, nfy;                 // feature rows of one set (centre or biased)
  int n_taps;
  int precise;                  // tangent-plane derivative basis
  Pickup pick;
  Table table;
};

__device__ __forceinline__ void normalise(float& x, float& y, float& z) {
  const float n = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                                 __fmul_rn(y, y)),
                                       __fmul_rn(z, z)));
  x = __fdiv_rn(x, n);
  y = __fdiv_rn(y, n);
  z = __fdiv_rn(z, n);
}

// derivative ray from the centre p and a neighbour q, in place in q:
// q - p, or the neighbour's projection onto p's tangent plane
// (t = (p - q) . p ; d = (q + t p) - p), rounded as
// models/synopsis._tangential_basis rounds it
__device__ __forceinline__ void derivative(const float (&p)[3], float (&q)[3],
                                           bool precise) {
  if (!precise) {
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = __fsub_rn(q[i], p[i]);
    return;
  }
  float t = __fmul_rn(__fsub_rn(p[0], q[0]), p[0]);
  t = __fadd_rn(t, __fmul_rn(__fsub_rn(p[1], q[1]), p[1]));
  t = __fadd_rn(t, __fmul_rn(__fsub_rn(p[2], q[2]), p[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q[i] = __fsub_rn(__fadd_rn(q[i], __fmul_rn(t, p[i])), p[i]);
}

// ---- the increment pickup of a spherical source ----------------------

constexpr float INCREMENT_TAU = 1.0f / 16.0f;
constexpr float PI_F = 3.14159265358979323846f;

// atan(t) for |t| <= INCREMENT_TAU: t + t (s (c3 + s (c5 + s c7))),
// s = t^2, in fused multiply-adds (ops/resample.atan_small rounds each
// step; the two differ far below an ulp of the sum with lon0)
__device__ __forceinline__ float atan_small(float t) {
  const float s = t * t;
  const float q = fmaf(s, fmaf(s, -1.0f / 7.0f, 1.0f / 5.0f), -1.0f / 3.0f);
  return fmaf(t, s * q, t);
}

// gate() without its division where nothing wraps: for u = v - lower in
// [0, period) floor_mod(u, period) is u itself (the correctly rounded
// quotient of a float below the period is at most 1 - 2^-24, so its
// floor is 0), and this returns gate()'s value bit for bit; a value that
// wraps, and the clamp, take gate() itself (ops/resample.gate_in_range)
__device__ __forceinline__ float gate_unwrapped(float v, int mode,
                                                float lower, float upper) {
  if (mode == GATE_PERIODIC || mode == GATE_MIRROR) {
    const float period = mode == GATE_PERIODIC ? upper - lower
                                               : 2.0f * (upper - lower);
    const float u = v - lower;
    if (u >= 0.0f && u < period)
      return mode == GATE_PERIODIC ? lower + u : lower + fminf(u, period - u);
  }
  return gate(v, mode, lower, upper);
}

// The centre ray's pickup, once a pixel: lon0, lat0, rho0 = |(x0, z0)|
// and rho0^2.
struct Centre {
  float lon0, lat0, rho0, rho2;
};

__device__ __forceinline__ Centre centre_pickup(const float (&p0)[3]) {
  Centre c;
  c.rho2 = __fadd_rn(__fmul_rn(p0[0], p0[0]), __fmul_rn(p0[2], p0[2]));
  c.rho0 = __fsqrt_rn(c.rho2);
  c.lon0 = atan2f(p0[0], p0[2]);
  c.lat0 = atan2f(p0[1], c.rho0);
  return c;
}

// The padded spline coordinates of the tap ray r = p0 + d as increments
// from the centre's (ops/resample.increment_coords), d the deflection:
// tan(dlon) = (z0 dx - x0 dz) / (rho0^2 + x0 dx + z0 dz), drho = (2 (x0 dx
// + z0 dz) + dx^2 + dz^2) / (rho + rho0), tan(dlat) = (rho0 dy - y0 drho)
// / (rho0 rho + y0 y). No transcendental: three approximate reciprocals
// and one reciprocal square root (MUFU), the rest fused multiply-adds.
// Their few ulp of error are relative to the increments, at most
// INCREMENT_TAU, so the sum with lon0 or lat0 rounds as with exact
// ones but where it lies within a few 1e-9 of a rounding boundary (the
// plain version rounds each step exactly). False, with nothing written,
// for a tap whose dot product is <= 0 or whose tangent exceeds
// INCREMENT_TAU (at or next to a pole, a coarse output pixel, a NaN):
// that tap takes the full pickup.
__device__ __forceinline__ bool increment_pickup(const Pickup& pk,
                                                 const float (&p0)[3],
                                                 const Centre& c,
                                                 const float (&d)[3],
                                                 const float (&r)[3],
                                                 float& sx, float& sy) {
  const float dx = d[0], dy = d[1], dz = d[2];
  const float s = fmaf(p0[0], dx, p0[2] * dz);
  const float dot = c.rho2 + s;
  const float t = __fdividef(fmaf(p0[2], dx, -(p0[0] * dz)), dot);
  const float rho2 = fmaf(r[0], r[0], r[2] * r[2]);
  const float rho = rho2 * rsqrtf(rho2);
  const float drho = __fdividef(fmaf(dz, dz, fmaf(dx, dx, 2.0f * s)),
                                rho + c.rho0);
  const float dot_l = fmaf(c.rho0, rho, p0[1] * r[1]);
  const float t_l = __fdividef(fmaf(c.rho0, dy, -(p0[1] * drho)), dot_l);
  if (!(dot > 0.0f && dot_l > 0.0f && fabsf(t) <= INCREMENT_TAU &&
        fabsf(t_l) <= INCREMENT_TAU))
    return false;
  // lon0 + dlon may pass +-pi, where atan2 would have wrapped
  float lon = c.lon0 + atan_small(t);
  lon = lon > PI_F ? lon - 2.0f * PI_F
                   : (lon < -PI_F ? lon + 2.0f * PI_F : lon);
  const float lat = c.lat0 + atan_small(t_l);
  sx = gate_unwrapped(lon * pk.kx + pk.cx, pk.gate_x, pk.glx, pk.gux) + pk.pad;
  sy = gate_unwrapped(lat * pk.ky + pk.cy, pk.gate_y, pk.gly, pk.guy) + pk.pad;
  return true;
}

// spline_at with one test a support: a (n+1)^2 block inside the table
// is read with 32-bit offsets from its first entry and no clamp per
// entry; a block that leaves the table (or a NaN) takes spline_at and
// its clamped 64-bit loop. Same weights, tap order and accumulation
// order: bit-identical to spline_at.
template <int DEGREE, int NCH, typename T>
__device__ __forceinline__ void spline_block(const T* __restrict__ coeff,
                                             const Table& t, float sx,
                                             float sy, float (&acc)[NCH]) {
  int bx, by;
  if (!support_base<DEGREE>(t, sx, sy, bx, by)) {
    spline_at<DEGREE, NCH>(coeff, t, sx, sy, acc);
    return;
  }
  const float selx = (DEGREE & 1) ? floorf(sx) : floorf(sx + 0.5f);
  const float sely = (DEGREE & 1) ? floorf(sy) : floorf(sy + 0.5f);
  float wx[DEGREE + 1], wy[DEGREE + 1];
  weights<DEGREE>(t.wmat, sx - selx, wx);
  weights<DEGREE>(t.wmat, sy - sely, wy);
  const T* row = coeff + ((int64_t)by * t.wp + bx) * NCH;
  const int pitch = (int)t.wp * NCH;

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
        racc[c] += wx[k] * tap_load(row + (k * NCH + c));
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += wy[j] * racc[c];
    row += pitch;
  }
}

// sum_k w_k spline(pickup(p0 + cx_k du + cy_k dv)) over the spread's
// taps: with INCREMENT each tap's coordinates as increments from the
// centre's, the full pickup where the increment does not take the tap;
// without it every tap's ray as before (rounded as the plain version's,
// bit-identical) through the full pickup
template <bool INCREMENT, int DEGREE, int NCH, typename T>
__device__ __forceinline__ void tap_sum(
    const T* __restrict__ coeff, const Params& p, const float* taps, const float (&p0)[3], const float (&du)[3],
    const float (&dv)[3], float (&acc)[NCH]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  Centre cen{0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (INCREMENT) cen = centre_pickup(p0);
  for (int k = 0; k < p.n_taps; ++k) {
    const float cx = taps[3 * k], cy = taps[3 * k + 1], w = taps[3 * k + 2];
    float r[3], sx, sy, val[NCH];
    if constexpr (INCREMENT) {
      // the deflection, and the tap's ray p0 + d for the full pickup
      float d[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d[i] = fmaf(cy, dv[i], cx * du[i]);
        r[i] = p0[i] + d[i];
      }
      if (!increment_pickup(p.pick, p0, cen, d, r, sx, sy))
        pickup(p.pick, r[0], r[1], r[2], sx, sy);
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        r[i] = __fadd_rn(__fadd_rn(p0[i], __fmul_rn(cx, du[i])),
                         __fmul_rn(cy, dv[i]));
      pickup(p.pick, r[0], r[1], r[2], sx, sy);
    }
    spline_block<DEGREE, NCH>(coeff, p.table, sx, sy, val);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
}

template <int DEGREE, int NCH, int TMODE, typename T>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_inline_twined_kernel(float* __restrict__ out,
                              const T* __restrict__ coeff,
                              const float* __restrict__ xfeat,
                              const float* __restrict__ yfeat,
                              const float* __restrict__ bmats,
                              const float* __restrict__ spread,
                              const Params p) {
  extern __shared__ float taps[];  // (n_taps, 3): cx, cy, w
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int i = tid; i < 3 * p.n_taps; i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();

  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;

  int face = 0;
  if (p.face_rows > 0) {
    face = (p.row0 + (int)y) / p.face_rows;
    face = min(max(face, 0), 5);
  }
  const float* bm = bmats + face * 9;
  const float* xbias = xfeat + p.nfx * p.width;   // the biased sets
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
  derivative(p0, du, p.precise != 0);
  derivative(p0, dv, p.precise != 0);

  float acc[NCH];
  // launch-uniform: a spherical source with two or more taps takes the
  // increment; one-tap launches and cube sources the full pickup
  if (p.pick.smode == SMODE_SPH && p.n_taps >= 2)
    tap_sum<true, DEGREE, NCH>(coeff, p, taps, p0, du, dv, acc);
  else
    tap_sum<false, DEGREE, NCH>(coeff, p, taps, p0, du, dv, acc);
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

template <typename T>
struct Launch {
  template <int DEGREE, int NCH>
  static cudaError_t run(int tmode, float* out, const T* coeff,
                         const float* xfeat, const float* yfeat,
                         const float* bmats, const float* spread,
                         const Params& p, cudaStream_t s) {
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid = frame_grid(p.height, p.width);
    const size_t smem = (size_t)3 * p.n_taps * sizeof(float);
    switch (tmode) {
      case TMODE_AFFINE:
        resample_inline_twined_kernel<DEGREE, NCH, TMODE_AFFINE, T>
            <<<grid, block, smem, s>>>(out, coeff, xfeat, yfeat, bmats,
                                       spread, p);
        break;
      case TMODE_SPH:
        resample_inline_twined_kernel<DEGREE, NCH, TMODE_SPH, T>
            <<<grid, block, smem, s>>>(out, coeff, xfeat, yfeat, bmats,
                                       spread, p);
        break;
      case TMODE_CYL:
        resample_inline_twined_kernel<DEGREE, NCH, TMODE_CYL, T>
            <<<grid, block, smem, s>>>(out, coeff, xfeat, yfeat, bmats,
                                       spread, p);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). ``xfeat`` is (2 nfx, W) and
// ``yfeat`` (2 nfy, H): the centre's feature rows, then the
// DERIV_BIAS-biased ones. ``spread`` is a device array of n_taps
// (cx, cy, w) triplets, at most MAX_TAPS of them (the shared-memory
// stage). ``coeff`` is float32, or bfloat16 where ``coeff_bf16`` is set.
// Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported argument.
extern "C" int envutil_resample_inline_twined(
    float* out, const void* coeff, const float* xfeat, const float* yfeat,
    const float* bmats, const float* spread, const float* wmat,
    long long height, long long width, long long hp, long long wp,
    int row0, int face_rows, int degree, int nch, int tmode, int smode,
    int n_taps, int precise,
    int gate_x, float glx, float gux, int gate_y, float gly, float guy,
    float kx, float cx, float ky, float cy, float pad, float section_px,
    int coeff_bf16, void* stream) {
  constexpr int MAX_TAPS = 4096;  // 48 KiB of shared memory
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (smode < SMODE_SPH || smode > SMODE_BIATAN6) return (int)cudaErrorInvalidValue;
  if (n_taps < 1 || n_taps > MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows;
  p.nfx = tmode == TMODE_AFFINE ? 1 : 2;
  p.nfy = tmode == TMODE_SPH ? 2 : 1;
  p.n_taps = n_taps; p.precise = precise;
  p.pick = Pickup{smode, gate_x, gate_y, glx, gux, gly, guy,
                  kx, cx, ky, cy, pad, section_px};
  set_table(p.table, hp, wp, degree, wmat);
  if (coeff_bf16)
    return (int)by_degree<Launch<__nv_bfloat16>>(
        degree, nch, tmode, out, (const __nv_bfloat16*)coeff, xfeat, yfeat,
        bmats, spread, p, (cudaStream_t)stream);
  return (int)by_degree<Launch<float>>(degree, nch, tmode, out,
                                       (const float*)coeff, xfeat, yfeat,
                                       bmats, spread, p, (cudaStream_t)stream);
}
