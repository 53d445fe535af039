// Planar-coordinates twined b-spline resampler for Hopper (sm_90a).
//
// Replaces two kernels of envutil_tpu/ops/pallas_resample.py:
//   _twined_kernel_into (the body of resample_twined_into, with its
//     merge-mask overlay and its champion-routed per-pixel tap weights),
//   _twined_kernel (the body of resample_twined), the same sum over the
//     whole frame into a fresh output.
// Per output pixel it reads the centre's padded spline coordinates
// (sx, sy) and the coordinate derivative planes (dux, duy, dvx, dvy) and
// sums over the spread's taps
//     sum_k w_k * spline(sx + cx_k dux + cy_k dvx, sy + cx_k duy + cy_k dvy)
// on the (Hp, Wp, NCH) channel-interleaved table. Three forms:
//   - no mask: every pixel is written (the whole-frame form);
//   - merge mask: a pixel whose mask is <= 0.5 reads nothing else and
//     leaves ``out`` untouched, as in the planar kernel;
//   - tap weights, (K, H, W) float32 or 8-bit planes that multiply w_k
//     per pixel: the counterpart of the TPU kernel's champ[k] == fi,
//     which for one facet is the tap's own validity. A tap whose weight
//     is 0 gathers nothing; a pixel whose weights are all 0 writes 0.
//
// Each tap's coordinates are clamped as floats like the planar kernel's
// (NaN/inf planes of grazing rays stay harmless). With ``period_x`` > 0
// the deflected x is first wrapped into [lower_x, lower_x + period_x):
// the table of a horizontally periodic source is braced by a few
// columns only, and a tap deflected across the seam belongs on the
// other side. The coordinate pass hands over derivatives already
// wrapped by the period.
//
// Only the (K, 3) triplet layout of the spread is taken: the TPU
// kernel's separable grid layout and its union-tap and sheared bodies
// compute the same sum and differ in how (8,128) gathers are shared
// between taps, which Hopper's L1/L2 gathers do not need.
//
// Design. One thread per output pixel on 32x8 blocks with a runtime tap
// loop; the spread is staged in dynamic shared memory once per block.
//
// Bound. Bytes: six (seven with the mask) f32 planes read and NCH floats
// written per covered pixel, K tap-weight planes where given, and the
// table entries under all taps' footprints (chip_smoke.py counts them
// per run); operations: K times the spline.
//
// Left for later: fusing the coordinate pass (three coordinate chains
// and, for partial facets, K validity chains of PyTorch operations) into
// this kernel.

#include "resample_common.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;        // output window
  int n_taps;
  int tapw_u8;                  // tap-weight planes are 8-bit
  float lower_x, period_x;      // periodic wrap of deflected x (0: none)
  Table table;
};

template <int DEGREE, int NCH>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_twined_kernel(float* __restrict__ out,
                       const float* __restrict__ coeff,
                       const float* __restrict__ sxp,
                       const float* __restrict__ syp,
                       const float* __restrict__ duxp,
                       const float* __restrict__ duyp,
                       const float* __restrict__ dvxp,
                       const float* __restrict__ dvyp,
                       const float* __restrict__ spread,
                       const float* __restrict__ mask,
                       const void* __restrict__ tapw,
                       const Params p) {
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
    spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, val);
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] += w * val[c];
  }
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

struct Launch {
  template <int DEGREE, int NCH>
  static cudaError_t run(float* out, const float* coeff, const float* sx,
                         const float* sy, const float* dux, const float* duy,
                         const float* dvx, const float* dvy,
                         const float* spread, const float* mask,
                         const void* tapw, const Params& p,
                         cudaStream_t stream) {
    const size_t smem = (size_t)3 * p.n_taps * sizeof(float);
    resample_twined_kernel<DEGREE, NCH>
        <<<frame_grid(p.height, p.width), dim3(BLOCK_X, BLOCK_Y), smem,
           stream>>>(out, coeff, sx, sy, dux, duy, dvx, dvy, spread, mask,
                     tapw, p);
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
extern "C" int envutil_resample_twined(
    float* out, const float* coeff, const float* sx, const float* sy,
    const float* dux, const float* duy, const float* dvx, const float* dvy,
    const float* spread, const float* mask, const void* tapw,
    const float* wmat, long long height, long long width, long long hp,
    long long wp, int degree, int nch, int n_taps, int tapw_u8,
    float lower_x, float period_x, void* stream) {
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
  return (int)by_degree<Launch>(degree, nch, out, coeff, sx, sy, dux, duy,
                                dvx, dvy, spread, mask, tapw, p,
                                (cudaStream_t)stream);
}
