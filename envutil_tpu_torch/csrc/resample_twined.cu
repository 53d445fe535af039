// Planar twined b-spline resampler for Hopper (sm_90a), in two forms.
//
// Replaces two kernels of envutil_tpu/ops/pallas_resample.py:
//   _twined_kernel_into (the body of resample_twined_into, with its
//     merge-mask overlay and its champion-routed per-pixel tap weights),
//   _twined_kernel (the body of resample_twined), the same sum over the
//     whole frame into a fresh output.
// Per output pixel both sum over the spread's taps
//     sum_k w_k * spline(sx + cx_k dux + cy_k dvx, sy + cx_k duy + cy_k dvy)
// on the (Hp, Wp, NCH) channel-interleaved table: the centre's padded
// spline coordinates (sx, sy) deflected in coordinate space by the
// coordinate derivatives (dux, duy), (dvx, dvy).
//
// The chain form (resample_twined_chain_kernel) computes those operands
// per pixel in registers (planar_chain.cuh): the three rays of the
// twining ninepack from the doubled axis features (centre and the two
// DERIV_BIAS-biased grids, as the inline twined kernel), normalised;
// the derivative rays, by differencing or under --twine_precise in the
// centre ray's tangent plane; the three pickups, an IR source's all in
// the centre ray's cube face (past an edge the coordinates run on into
// the section's support frame instead of jumping by a section); the
// coordinate derivatives, wrapped by the period on a periodic source
// and 0 where not finite; and the centre, ungated (a centre outside a
// partial facet may still have valid taps, deflected from where it
// is). For a source that does not cover every ray (``tap_valid``),
// each tap counts only where its deflected ray p0 + cx du + cy dv
// passes the mount's window test, the mask the exact path applies to
// that tap; a pixel with no valid tap is written 0. With a one-tap
// spread the chain form can also write the tap's voronoi score, the z
// of that deflected ray (not renormalised, as the exact path's
// synopsis.twined hands it to the score) times recip_step, or LOWEST
// where the tap misses: a twined stitch renders one tap of every facet
// a launch and picks the champion per tap. These are the
// operands fastpath.twined_coords computed as a string of PyTorch
// launches (three coordinate chains and, for partial facets, one more
// chain and a uint8 plane per tap) before every launch of the planes
// form: on the TPU XLA fuses the JAX package's chain under jit, eager
// PyTorch cannot, and on the H100 that pass took 90-99% of a twined
// planar frame (PERF.md).
//
// The planes form (resample_twined_kernel) reads the six operand planes
// and, for partial facets, (K, H, W) float32 or 8-bit tap-weight planes
// (the counterpart of the TPU kernel's champ[k] == fi, which for one
// facet is the tap's own validity); a merge mask leaves pixels <= 0.5
// untouched. It serves translated facets, whose generic chain has no
// kernel form.
//
// Both forms: each tap's coordinates are clamped as floats like the
// planar kernel's (NaN/inf of grazing rays stay harmless); on a
// horizontally periodic source the deflected x is first wrapped into
// [pad - 1/2, pad - 1/2 + period): the table is braced by a few columns
// only, and a tap deflected across the seam belongs on the other side.
// Only the (K, 3) triplet layout of the spread is taken: the TPU
// kernel's separable grid layout and its union-tap and sheared bodies
// compute the same sum and differ in how (8,128) gathers are shared
// between taps, which Hopper's L1/L2 gathers do not need. One thread
// per output pixel on 32x8 blocks with a runtime tap loop kept rolled;
// the spread is staged in dynamic shared memory once per block.
//
// Bound. Bytes: the table entries under all live taps' footprints
// (chip_smoke.py counts them per run) and the output; the planes form
// reads its six planes and the tap weights as well. Operations: the
// chain's three rays and pickups (and K window tests for a partial
// facet) per pixel, K times the deflection and the spline per live
// tap: at 4 taps the operations bound the chain form.
//
// bf16 tables (--coeff bf16): both forms are templated on the table's
// element type and convert each tap to float where spline_at loads it
// (resample_common.cuh); the operand planes and the tap weights stay
// as they are.
//
// No staged window. Ablation on the H100 (PERF.md, section 6) put the
// chain form's tap loads at 55% of the kernel at config 3 twined and 9%
// at the lens facet twined, where the three rays, three pickups and
// four window tests of every pixel set the pace; a window in the planar
// chain form, whose loads are 49% at config 3, gained nothing there,
// and the twined one would widen each block's box by the spread's reach
// as the inline twined kernel's did. So the taps gather directly.
//
#include "planar_chain.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;        // output window
  int n_taps;
  int tapw_u8;                  // tap-weight planes are 8-bit
  float lower_x, period_x;      // periodic wrap of deflected x (0: none)
  Table table;
};

// The spline of one tap, kept out of line at degrees 5 and above: inlined
// into the tap loop, ptxas spilled 4-24 bytes at degrees 5-7 in every
// arrangement of the loop and its loads that was built, with registers
// to spare. The kernel's parameters are __grid_constant__, so the call
// reads the table's weights where they are.
template <int DEGREE, int NCH, typename T>
__device__ __noinline__ void tap_spline(const T* __restrict__ coeff,
                                        const Table& t, float sx, float sy,
                                        float (&val)[NCH]) {
  spline_at<DEGREE, NCH>(coeff, t, sx, sy, val);
}

template <int DEGREE, int NCH, typename T>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_twined_kernel(float* __restrict__ out,
                       const T* __restrict__ coeff,
                       const float* __restrict__ sxp,
                       const float* __restrict__ syp,
                       const float* __restrict__ duxp,
                       const float* __restrict__ duyp,
                       const float* __restrict__ dvxp,
                       const float* __restrict__ dvyp,
                       const float* __restrict__ spread,
                       const float* __restrict__ mask,
                       const void* __restrict__ tapw,
                       const __grid_constant__ Params p) {
  extern __shared__ float taps[];  // (n_taps, 3): cx, cy, w
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();

  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const int64_t pix = y * p.width + x;
  if (mask != nullptr && !(__ldg(mask + pix) > 0.5f)) return;
  const int64_t plane = p.height * p.width;

  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;

  bool loaded = false;
  float sx0 = 0.0f, sy0 = 0.0f, dux = 0.0f, duy = 0.0f, dvx = 0.0f,
        dvy = 0.0f;
#pragma unroll 1
  for (int k = 0; k < p.n_taps; ++k) {
    float w = taps[3 * k + 2];
    if (tapw != nullptr) {
      const int64_t at = (int64_t)k * plane + pix;
      const float tw = p.tapw_u8
          ? (float)__ldg((const unsigned char*)tapw + at)
          : __ldg((const float*)tapw + at);
      if (tw == 0.0f) continue;
      w *= tw;
    }
    if (!loaded) {
      sx0 = __ldg(sxp + pix);  sy0 = __ldg(syp + pix);
      dux = __ldg(duxp + pix); duy = __ldg(duyp + pix);
      dvx = __ldg(dvxp + pix); dvy = __ldg(dvyp + pix);
      loaded = true;
    }
    const float cx = taps[3 * k], cy = taps[3 * k + 1];
    float sx = sx0 + cx * dux + cy * dvx;
    float sy = sy0 + cx * duy + cy * dvy;
    if (p.period_x > 0.0f) sx = p.lower_x + floor_mod(sx - p.lower_x, p.period_x);
    sx = clamp_coord<DEGREE>(sx, p.table.wp);
    sy = clamp_coord<DEGREE>(sy, p.table.hp);
    float val[NCH];
    if constexpr (DEGREE >= 5) {
      tap_spline<DEGREE, NCH>(coeff, p.table, sx, sy, val);
    } else {
      spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, val);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

template <typename T>
struct Launch {
  template <int DEGREE, int NCH>
  static cudaError_t run(float* out, const T* coeff, const float* sx,
                         const float* sy, const float* dux, const float* duy,
                         const float* dvx, const float* dvy,
                         const float* spread, const float* mask,
                         const void* tapw, const Params& p,
                         cudaStream_t stream) {
    const size_t smem = (size_t)3 * p.n_taps * sizeof(float);
    resample_twined_kernel<DEGREE, NCH, T>
        <<<frame_grid(p.height, p.width), dim3(BLOCK_X, BLOCK_Y), smem,
           stream>>>(out, coeff, sx, sy, dux, duy, dvx, dvy, spread, mask,
                     tapw, p);
    return cudaGetLastError();
  }
};


// ---- the chain form ---------------------------------------------------

struct ChainParams {
  int64_t height, width;        // output window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int nfx, nfy;                 // feature rows of one set (centre or biased)
  int tmode;                    // TMODE_* (planar_chain.cuh)
  int n_taps;
  int precise;                  // tangent-plane derivative basis
  int tap_valid;                // test each tap's ray against the window
  float recip_step;             // score = z of the tap's ray * recip_step
  ChainPickup pick;
  Table table;
};

// The tap's deflected ray p0 + cx du + cy dv into ``r`` and whether the
// tap counts: with ``tap_valid``, where the ray passes the mount's
// window test, the mask the exact path applies to that tap.
__device__ __forceinline__ bool tap_ray(const ChainParams& p,
                                        const float (&p0)[3],
                                        const float (&du)[3],
                                        const float (&dv)[3], float cx,
                                        float cy, float (&r)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = add(add(p0[i], mul(cx, du[i])), mul(cy, dv[i]));
  float px, py;
  return !p.tap_valid || mount_planar(p.pick, r[0], r[1], r[2], px, py);
}

// four blocks an SM (64 registers): without the cap ptxas spilled 8
// bytes at degree 1, two channels; no instantiation needs more
template <int DEGREE, int NCH, typename T>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, 4)
resample_twined_chain_kernel(float* __restrict__ out,
                             float* __restrict__ score,
                             const T* __restrict__ coeff,
                             const float* __restrict__ xfeat,
                             const float* __restrict__ yfeat,
                             const float* __restrict__ bmats,
                             const float* __restrict__ spread,
                             const ChainParams p) {
  extern __shared__ float taps[];  // (n_taps, 3): cx, cy, w
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
  const float* xbias = xfeat + p.nfx * p.width;   // the biased sets
  const float* ybias = yfeat + p.nfy * p.height;

  // the ninepack's three normalised rays and the derivative rays; with
  // ``precise`` the neighbours are then p0 + du and p0 + dv, as in
  // fastpath.twined_coords
  float p0[3], p10[3], p01[3], du[3], dv[3];
  chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height, bm, p0);
  chain_ray(p.tmode, xbias, yfeat, x, y, p.width, p.height, bm, p10);
  chain_ray(p.tmode, xfeat, ybias, x, y, p.width, p.height, bm, p01);
  const bool precise = p.precise != 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    du[i] = p10[i];
    dv[i] = p01[i];
  }
  derivative_ray(p0, du, precise);
  derivative_ray(p0, dv, precise);
  if (precise) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p10[i] = add(p0[i], du[i]);
      p01[i] = add(p0[i], dv[i]);
    }
  }

  // the three pickups (an IR source's in the centre ray's face) and the
  // coordinate derivatives
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

  if (score != nullptr) {
    // a one-tap launch of a twined stitch (the entry point refuses a
    // score with more taps): the tap's score first, so that nothing of
    // it lives on into the tap loop (with the score in the loop ptxas
    // spilled at degree 7); the loop tests the tap's ray again
    float r[3];
    const bool hit = tap_ray(p, p0, du, dv, taps[0], taps[1], r);
    score[y * p.width + x] = hit ? mul(r[2], p.recip_step) : LOWEST;
  }
  const float lower = sub(p.pick.pad, 0.5f);
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < p.n_taps; ++k) {
    const float cx = taps[3 * k], cy = taps[3 * k + 1], w = taps[3 * k + 2];
    float r[3];
    if (p.tap_valid && !tap_ray(p, p0, du, dv, cx, cy, r)) continue;
    float sx = sx0 + cx * dux + cy * dvx;
    float sy = sy0 + cx * duy + cy * dvy;
    if (p.pick.period > 0.0f) sx = lower + floor_mod(sx - lower, p.pick.period);
    float val[NCH];
    spline_at<DEGREE, NCH>(coeff, p.table, clamp_coord<DEGREE>(sx, p.table.wp),
                           clamp_coord<DEGREE>(sy, p.table.hp), val);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

template <typename T>
struct ChainLaunch {
  template <int DEGREE, int NCH>
  static cudaError_t run(float* out, float* score, const T* coeff,
                         const float* xfeat, const float* yfeat,
                         const float* bmats, const float* spread,
                         const ChainParams& p, cudaStream_t stream) {
    const size_t smem = (size_t)3 * p.n_taps * sizeof(float);
    resample_twined_chain_kernel<DEGREE, NCH, T>
        <<<frame_grid(p.height, p.width), dim3(BLOCK_X, BLOCK_Y), smem,
           stream>>>(out, score, coeff, xfeat, yfeat, bmats, spread, p);
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). ``spread`` is a device array
// of n_taps (cx, cy, w) triplets, at most MAX_TAPS of them (the
// shared-memory stage); ``mask`` and ``tapw`` may be null; ``tapw`` is
// (n_taps, H, W), 8-bit when ``tapw_u8`` is set, else float32. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported argument. ``wmat`` is a host array of (degree+1)^2 floats.
// ``coeff`` is float32, or bfloat16 where ``coeff_bf16`` is set.
extern "C" int envutil_resample_twined(
    float* out, const void* coeff, const float* sx, const float* sy,
    const float* dux, const float* duy, const float* dvx, const float* dvy,
    const float* spread, const float* mask, const void* tapw,
    const float* wmat, long long height, long long width, long long hp,
    long long wp, int degree, int nch, int n_taps, int tapw_u8,
    float lower_x, float period_x, int coeff_bf16, void* stream) {
  constexpr int MAX_TAPS = 4096;  // 48 KiB of shared memory
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (n_taps < 1 || n_taps > MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width;
  p.n_taps = n_taps; p.tapw_u8 = tapw_u8;
  p.lower_x = lower_x; p.period_x = period_x;
  set_table(p.table, hp, wp, degree, wmat);
  if (coeff_bf16)
    return (int)by_degree<Launch<__nv_bfloat16>>(
        degree, nch, out, (const __nv_bfloat16*)coeff, sx, sy, dux, duy, dvx,
        dvy, spread, mask, tapw, p, (cudaStream_t)stream);
  return (int)by_degree<Launch<float>>(degree, nch, out, (const float*)coeff,
                                       sx, sy, dux, duy, dvx, dvy, spread,
                                       mask, tapw, p, (cudaStream_t)stream);
}

// Plain C entry point of the chain form (loaded with ctypes). ``xfeat``
// is (2 nfx, W) and ``yfeat`` (2 nfy, H): the centre's feature rows,
// then the DERIV_BIAS-biased ones, as for the inline twined kernel;
// ``ipick`` / ``fpick`` as for envutil_resample_planar_chain. With
// ``tap_valid`` each tap counts only where its deflected ray falls into
// the mount's window (a source that does not cover every ray). Every
// pixel is written: 0 where no tap is valid. ``score`` may be null;
// otherwise the spread has one tap and ``score`` is an (H, W) device
// plane that receives that tap's score, its deflected ray's z times
// ``recip_step``, LOWEST where the tap misses. ``coeff`` is float32, or
// bfloat16 where ``coeff_bf16`` is set.
extern "C" int envutil_resample_twined_chain(
    float* out, float* score, const void* coeff, const float* xfeat,
    const float* yfeat, const float* bmats, const float* spread,
    const float* wmat, const int* ipick, const float* fpick,
    long long height, long long width, long long hp, long long wp, int row0,
    int face_rows, int degree, int nch, int tmode, int n_taps, int precise,
    int tap_valid, float recip_step, int coeff_bf16, void* stream) {
  constexpr int MAX_TAPS = 4096;  // 48 KiB of shared memory
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (tmode < TMODE_AFFINE || tmode > TMODE_FISH) return (int)cudaErrorInvalidValue;
  if (n_taps < 1 || n_taps > MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (score != nullptr && n_taps != 1) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  ChainParams p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows; p.tmode = tmode;
  p.nfx = (tmode == TMODE_SPH || tmode == TMODE_CYL) ? 2 : 1;
  p.nfy = tmode == TMODE_SPH ? 2 : 1;
  p.n_taps = n_taps; p.precise = precise; p.tap_valid = tap_valid;
  p.recip_step = recip_step;
  if (!set_pickup(p.pick, ipick, fpick)) return (int)cudaErrorInvalidValue;
  if (tap_valid && p.pick.smode != SMODE_MOUNT) return (int)cudaErrorInvalidValue;
  set_table(p.table, hp, wp, degree, wmat);
  if (coeff_bf16)
    return (int)by_degree<ChainLaunch<__nv_bfloat16>>(
        degree, nch, out, score, (const __nv_bfloat16*)coeff, xfeat, yfeat,
        bmats, spread, p, (cudaStream_t)stream);
  return (int)by_degree<ChainLaunch<float>>(degree, nch, out, score,
                                            (const float*)coeff, xfeat, yfeat,
                                            bmats, spread, p,
                                            (cudaStream_t)stream);
}
