// The coordinate chain of the planar kernels' chain forms
// (resample_planar.cu, resample_twined.cu), per pixel in registers:
// target axis features -> ray by a runtime target mode -> basis ->
// normalisation -> source pickup by a runtime source mode -> spline
// coordinates. It is the chain that ops/resample.planar_chain_coords
// computes in plain PyTorch, and that fastpath.coords and
// fastpath.twined_coords computed as a string of elementwise launches
// before every launch of the planes forms.
//
// Target modes: K1's affine / sph / cyl feature sets (target_ray in
// resample_common.cuh, called as it is) and two more on affine
// features (planar x, planar y): ster and fish apply
// geometry.ster_to_ray / fish_to_ray in the kernel.
//
// Source modes: cubemap / biatan6 IR sources through K1's pickup() as
// it is, or, for the twined kernel, a forced-face counterpart
// (geometry.ray_to_cubeface_fixed) that takes all three pickups of the
// ninepack in the centre ray's face; and the mount pickup for partial
// and PTO mounts of the five mount projections: to_plane, the PTO lens
// polynomial, shift and shear (environment._planar_transform), the
// window test (environment._window_mask: z > 0 as well for rectilinear
// sources; an unbounded window for full fisheyes), the model -> spline
// affine (environment._md_to_spline) and the spline gates.
//
// Every step that decides a cube face or a window edge is rounded step
// by step (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn) in the plain
// version's order, as K1 does, so nvcc contracts nothing there; the
// transcendentals are the CUDA math library's, which the plain version
// reaches on the card through PyTorch.

#pragma once

#include "resample_common.cuh"

namespace envutil {

constexpr int TMODE_STER = 3;
constexpr int TMODE_FISH = 4;
constexpr int SMODE_MOUNT = 3;

// the voronoi score of a ray that misses its facet (float32 lowest,
// models/synopsis.LOWEST)
constexpr float LOWEST = -3.402823466e38f;

// mount projections (core/conventions.Projection)
constexpr int PROJ_SPHERICAL = 0;
constexpr int PROJ_CYLINDRICAL = 1;
constexpr int PROJ_RECTILINEAR = 2;
constexpr int PROJ_STEREOGRAPHIC = 3;
constexpr int PROJ_FISHEYE = 4;

// the source side of the chain forms (ops/resample.ChainPickup)
struct ChainPickup {
  int smode;                    // SMODE_CUBEMAP, SMODE_BIATAN6, SMODE_MOUNT
  int proj;                     // mount: PROJ_*
  int gate_x, gate_y;           // mount: GATE_* (any other code clamps)
  int lens, shift, shear;       // mount: PTO transform present
  float kx, cx, ky, cy, pad;    // pickup -> spline affine, brace pad
  float section_px;             // IR rows per cube face
  float glx, gux, gly, guy;     // mount: gate bounds
  float wx0, wx1, wy0, wy1;     // mount: window extent
  float s, a, b, c, d;          // mount: lens radius scale, polynomial
  float h, v, g, t;             // mount: shift, shear
  float period;                 // mount: x period of a periodic source, 0
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// geometry.normalize, rounded as the plain version rounds it
__device__ __forceinline__ void normalise_ray(float (&r)[3]) {
  const float n = __fsqrt_rn(add(add(mul(r[0], r[0]), mul(r[1], r[1])),
                                 mul(r[2], r[2])));
  r[0] = dvd(r[0], n);
  r[1] = dvd(r[1], n);
  r[2] = dvd(r[2], n);
}

// The target half: the normalised ray of pixel (x, y) from the feature
// set ``xf``/``yf`` by a launch-uniform target mode.
__device__ __forceinline__ void chain_ray(int tmode, const float* xf,
                                          const float* yf, int64_t x,
                                          int64_t y, int64_t width,
                                          int64_t height, const float* bm,
                                          float (&r)[3]) {
  if (tmode == TMODE_STER || tmode == TMODE_FISH) {
    // geometry.ster_to_ray / fish_to_ray of the planar (px, py)
    const float px = xf[x], py = yf[y];
    const float rad = __fsqrt_rn(add(mul(px, px), mul(py, py)));
    const float phi = atan2f(px, -py);
    const float sp = sinf(phi), cp = cosf(phi);
    float st, ct;
    if (tmode == TMODE_STER) {
      const float theta = mul(2.0f, atanf(mul(rad, 0.5f)));
      st = sinf(theta);
      ct = cosf(theta);
    } else {
      st = sinf(rad);
      ct = cosf(rad);
    }
    const float a = mul(st, sp), b = mul(-st, cp), c = ct;
    r[0] = ray_row(bm, a, b, c, false);
    r[1] = ray_row(bm + 3, a, b, c, false);
    r[2] = ray_row(bm + 6, a, b, c, false);
  } else if (tmode == TMODE_SPH) {
    target_ray<TMODE_SPH>(xf, yf, x, y, width, height, bm, r[0], r[1], r[2]);
  } else if (tmode == TMODE_CYL) {
    target_ray<TMODE_CYL>(xf, yf, x, y, width, height, bm, r[0], r[1], r[2]);
  } else {
    target_ray<TMODE_AFFINE>(xf, yf, x, y, width, height, bm, r[0], r[1],
                             r[2]);
  }
  normalise_ray(r);
}

// The mount pickup: ray -> model-space planar coordinates of the
// source projection after the PTO transform (px, py), and whether the
// ray falls into the facet's window.
__device__ __forceinline__ bool mount_planar(const ChainPickup& p, float x,
                                             float y, float z, float& px,
                                             float& py) {
  switch (p.proj) {
    case PROJ_SPHERICAL:        // ray_to_ll
      px = atan2f(x, z);
      py = atan2f(y, __fsqrt_rn(add(mul(x, x), mul(z, z))));
      break;
    case PROJ_CYLINDRICAL:      // ray_to_cyl
      px = atan2f(x, z);
      py = dvd(y, __fsqrt_rn(add(mul(x, x), mul(z, z))));
      break;
    case PROJ_RECTILINEAR:      // ray_to_rect
      px = dvd(x, z);
      py = dvd(y, z);
      break;
    case PROJ_STEREOGRAPHIC: {  // ray_to_ster
      const float rn = dvd(1.0f, __fsqrt_rn(add(add(mul(x, x), mul(y, y)),
                                                mul(z, z))));
      const float f = dvd(2.0f, add(mul(z, rn), 1.0f));
      px = mul(mul(x, rn), f);
      py = mul(mul(y, rn), f);
      break;
    }
    default: {                  // ray_to_fish
      const float s = __fsqrt_rn(add(mul(x, x), mul(y, y)));
      const float r = sub((float)(0.5 * 3.14159265358979323846), atan2f(z, s));
      const float phi = atan2f(y, x);
      px = mul(r, cosf(phi));
      py = mul(r, sinf(phi));
    }
  }
  if (p.lens) {                 // lens.lcp_scale in Horner form
    const float r = dvd(__fsqrt_rn(add(mul(px, px), mul(py, py))), p.s);
    const float f = add(mul(add(mul(add(mul(p.a, r), p.b), r), p.c), r), p.d);
    px = mul(px, f);
    py = mul(py, f);
  }
  if (p.shift) {
    px = add(px, p.h);
    py = add(py, p.v);
  }
  if (p.shear) {
    const float nx = add(px, mul(py, p.g));
    const float ny = add(py, mul(px, p.t));
    px = nx;
    py = ny;
  }
  return px >= p.wx0 && px <= p.wx1 && py >= p.wy0 && py <= p.wy1 &&
         (p.proj != PROJ_RECTILINEAR || z > 0.0f);
}

// the cube face of a ray, by geometry.ray_to_cubeface's cascade
__device__ __forceinline__ int cube_face(float rx, float ry, float rz) {
  const float ax = fabsf(rx), ay = fabsf(ry), az = fabsf(rz);
  if (ax >= ay && ax >= az) return rx < 0.0f ? 0 : 1;
  if (!(ax >= az) && !(ay >= az)) return rz < 0.0f ? 5 : 4;
  return ry < 0.0f ? 2 : 3;
}

// IR pickup in a given face (geometry.ray_to_cubeface_fixed, then as
// pickup(), without the pad): past the face's edge the coordinates run
// on into the section's support frame
__device__ __forceinline__ void pickup_in_face(const ChainPickup& p,
                                               float rx, float ry, float rz,
                                               int face, float& sx,
                                               float& sy) {
  const int dom = face >> 1;
  float fx, fy;
  if (dom == 0) {
    fx = dvd(-rz, safe(rx));
    fy = dvd(ry, safe(fabsf(rx)));
  } else if (dom == 1) {
    fx = dvd(-rx, safe(fabsf(ry)));
    fy = dvd(rz, safe(ry));
  } else {
    fx = dvd(rx, safe(rz));
    fy = dvd(ry, safe(fabsf(rz)));
  }
  if (p.smode == SMODE_BIATAN6) {
    constexpr float k4pi = (float)(4.0 / 3.14159265358979323846);
    fx = mul(k4pi, atanf(fx));
    fy = mul(k4pi, atanf(fy));
  }
  sx = add(mul(fx, p.kx), p.cx);
  sy = add(add(mul(fy, p.ky), p.cy), mul((float)face, p.section_px));
}

// The source half of the untwined chain: the ray's padded spline
// coordinates, gated, and whether the ray hits the source.
__device__ __forceinline__ bool chain_pickup(const ChainPickup& p, float rx,
                                             float ry, float rz, float& sx,
                                             float& sy) {
  if (p.smode != SMODE_MOUNT) {
    const Pickup ir{p.smode, GATE_PERIODIC, GATE_PERIODIC, 0.0f, 0.0f, 0.0f,
                    0.0f, p.kx, p.cx, p.ky, p.cy, p.pad, p.section_px};
    pickup(ir, rx, ry, rz, sx, sy);
    return true;
  }
  float px, py;
  const bool hit = mount_planar(p, rx, ry, rz, px, py);
  sx = add(gate(add(mul(px, p.kx), p.cx), p.gate_x, p.glx, p.gux), p.pad);
  sy = add(gate(add(mul(py, p.ky), p.cy), p.gate_y, p.gly, p.guy), p.pad);
  return hit;
}

// The source half of the twined chain: ungated, unpadded spline
// coordinates of a ray; IR sources in the given face.
__device__ __forceinline__ void twined_pickup(const ChainPickup& p, float rx,
                                              float ry, float rz, int face,
                                              float& sx, float& sy) {
  if (p.smode != SMODE_MOUNT) {
    pickup_in_face(p, rx, ry, rz, face, sx, sy);
    return;
  }
  float px, py;
  mount_planar(p, rx, ry, rz, px, py);
  sx = add(mul(px, p.kx), p.cx);
  sy = add(mul(py, p.ky), p.cy);
}

// derivative ray from the centre p and a neighbour q, in place in q:
// q - p, or the neighbour's projection onto p's tangent plane
// (models/synopsis._tangential_basis), as resample_inline_twined.cu
// computes it
__device__ __forceinline__ void derivative_ray(const float (&p)[3],
                                               float (&q)[3], bool precise) {
  if (!precise) {
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = sub(q[i], p[i]);
    return;
  }
  float t = mul(sub(p[0], q[0]), p[0]);
  t = add(t, mul(sub(p[1], q[1]), p[1]));
  t = add(t, mul(sub(p[2], q[2]), p[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = sub(add(q[i], mul(t, p[i])), p[i]);
}

// a coordinate derivative as fastpath.twined_coords takes it: wrapped
// by the period on a periodic source, 0 where not finite
__device__ __forceinline__ float coord_derivative(float a, float b,
                                                  float period) {
  float d = sub(a, b);
  if (period > 0.0f) {
    const float half = mul(0.5f, period);
    d = sub(floor_mod(add(d, half), period), half);
  }
  return fabsf(d) <= 3.402823466e38f ? d : 0.0f;   // NaN and inf to 0
}

// fill a ChainPickup from the host arrays of the C entry points: 7
// ints (smode, proj, gate_x, gate_y, lens, shift, shear) and 24 floats
// (kx .. period in the struct's order); false for an unknown mode
inline bool set_pickup(ChainPickup& p, const int* i, const float* f) {
  p.smode = i[0]; p.proj = i[1]; p.gate_x = i[2]; p.gate_y = i[3];
  p.lens = i[4]; p.shift = i[5]; p.shear = i[6];
  float* dst[] = {&p.kx, &p.cx, &p.ky, &p.cy, &p.pad, &p.section_px,
                  &p.glx, &p.gux, &p.gly, &p.guy, &p.wx0, &p.wx1, &p.wy0,
                  &p.wy1, &p.s, &p.a, &p.b, &p.c, &p.d, &p.h, &p.v, &p.g,
                  &p.t, &p.period};
  for (int k = 0; k < 24; ++k) *dst[k] = f[k];
  return p.smode >= SMODE_CUBEMAP && p.smode <= SMODE_MOUNT &&
         p.proj >= PROJ_SPHERICAL && p.proj <= PROJ_FISHEYE;
}

}  // namespace envutil
