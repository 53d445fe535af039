// One tap of the inline twined kernel (K4) a thread, before and after its
// increment pickup, for counting the instructions of a tap in SASS
// (tools/ablation/k4_sass.py); never launched. Both take the tap's ray
// from a pixel's p0, du, dv and the tap's (cx, cy), pick it up from a
// full-spherical source (smode, periodic longitude and mirror latitude
// gates fixed, so that the compiler drops the cube branch) and evaluate
// the degree-1, three-channel spline of a float32 table, as K4's tap loop
// does for config 4:
// - tap_before: the ray rounded step by step, pickup() (two atan2f, a
//   square root, two gates with their floor-mod divisions) and
//   spline_at() (a clamped 64-bit offset per entry), the loop body before;
// - tap_after: the deflection, increment_pickup() (pickup() only where
//   it declines the tap) and spline_block(), the loop body after; the
//   centre's pickup, once a pixel, comes in with the inputs.

#include "../../envutil_tpu_torch/csrc/resample_inline_twined.cu"

namespace {

using namespace envutil;

__device__ __forceinline__ Pickup sph_pickup(const Pickup& p) {
  Pickup q = p;
  q.smode = SMODE_SPH;
  q.gate_x = GATE_PERIODIC;
  q.gate_y = GATE_MIRROR;
  return q;
}

}  // namespace

// in: 15 floats a thread, p0, du, dv, cx, cy and (tap_after) the
// centre's lon0, lat0, rho0, rho0^2
extern "C" __global__ void tap_before(const float* __restrict__ in,
                           const float* __restrict__ coeff, const Params p,
                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* q = in + 15 * i;
  const Pickup pk = sph_pickup(p.pick);
  float r[3], sx, sy, val[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    r[j] = __fadd_rn(__fadd_rn(q[j], __fmul_rn(q[9], q[3 + j])),
                     __fmul_rn(q[10], q[6 + j]));
  pickup(pk, r[0], r[1], r[2], sx, sy);
  spline_at<1, 3>(coeff, p.table, sx, sy, val);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * i + c] = val[c];
}

extern "C" __global__ void tap_after(const float* __restrict__ in,
                          const float* __restrict__ coeff, const Params p,
                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* q = in + 15 * i;
  const Pickup pk = sph_pickup(p.pick);
  const float p0[3] = {q[0], q[1], q[2]};
  const Centre cen{q[11], q[12], q[13], q[14]};
  float d[3], r[3], sx, sy, val[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d[j] = fmaf(q[10], q[6 + j], q[9] * q[3 + j]);
    r[j] = p0[j] + d[j];
  }
  if (!increment_pickup(pk, p0, cen, d, r, sx, sy))
    pickup(pk, r[0], r[1], r[2], sx, sy);
  spline_block<1, 3>(coeff, p.table, sx, sy, val);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * i + c] = val[c];
}
