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
// does: each tap's ray goes through atan2 and the gate, or through the
// face cascade, on its own, and the seam, the poles and cube edges are
// no special case. The price is the pickup's transcendentals per tap
// instead of per pixel, which is what bounds the kernel (below).
//
// Rounding. The rays, their normalisation, the derivative rays and each
// tap's ray are computed with __fmul_rn/__fadd_rn/__fsqrt_rn/__fdiv_rn
// in the plain version's order (ops/resample.resample_inline_twined_plain
// through models/synopsis.derivative_rays and deflect), so every tap's
// ray is bit-identical to the plain version's on the card and so is the
// cube face each tap picks.
//
// Design. One thread per output pixel on 32x8 blocks and a runtime loop
// over the taps inside; the spread (3 floats a tap, 1/DERIV_BIAS folded
// into the offsets) is staged in dynamic shared memory once per block,
// so the tap count is no template parameter and the build stays at the
// inline kernel's 96 instantiations. Taps of one pixel land within a
// few source pixels of each other, so L1 serves most of their gathers.
//
// What bounds it on this card. By bytes as the inline kernel, with the
// table entries counted over all taps' footprints (chip_smoke.py counts
// them per run); the arithmetic is K times the pickup and the spline,
// which at 16 taps and degree 1 is the larger of the two. Ablation on
// the H100 (tools/ablation/ablate_inline.py) put ~2/3 of the kernel's
// time into the per-tap ray, pickup and weights (0.10 of 0.15 ms at 4
// taps, 0.29 of 0.46 ms at 16) and ~1/3 into the tap loads: it is bound
// by the instructions it runs, not by its loads. A polynomial atan2 and
// a reciprocal gate saved 5-10% and cost a few ulp of longitude, which
// is too much at the seam of an 8K table, so the pickup stays the exact
// one that the plain version's coordinates and face choice agree with.
//
// No staged window. The inline kernel copies each block's source window
// into shared memory (resample_common.cuh: stage_window). The same was
// built and timed here (the box of the pixels' first taps widened by
// the spread's reach, a test per tap, global memory for taps outside):
// against this plain loop it cost 15% at 4 taps and broke even from 9
// to 16, because it takes wavefronts off L1 but adds a box, a copy,
// barriers and a test per tap to a kernel that waits on none of its
// loads. So this kernel gathers every tap with spline_at.
//
// bf16 tables (--coeff bf16): the kernel is templated on the table's
// element type and converts each tap to float where spline_at loads it
// (resample_common.cuh); the bound is the per-tap arithmetic either
// way, and the table's device memory halves.
//
// Left for later: less arithmetic per tap that keeps each tap's ray and
// face bit-identical (none is known), sharing the (n+1)^2 support
// between neighbouring taps (the TPU kernel's union-tap form), and the
// separable-grid spread layout, which both compute the same sum.

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
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
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
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  for (int k = 0; k < p.n_taps; ++k) {
    const float cx = taps[3 * k], cy = taps[3 * k + 1], w = taps[3 * k + 2];
    float r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      r[i] = __fadd_rn(__fadd_rn(p0[i], __fmul_rn(cx, du[i])),
                       __fmul_rn(cy, dv[i]));
    float sx, sy, val[NCH];
    pickup(p.pick, r[0], r[1], r[2], sx, sy);
    spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, val);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
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
