// Planar-coordinates b-spline resampler for Hopper (sm_90a).
//
// Replaces two kernels of envutil_tpu/ops/pallas_resample.py:
//   _resample_kernel_into (the body of resample_planar_into, with
//     _eval_row_block and _emit_rows' merge-mask overlay), and
//   _resample_kernel (the body of resample_planar), the same
//     evaluation over the whole frame into a fresh output.
// Per output pixel it reads the precomputed padded spline coordinates
// (sx, sy), evaluates the degree-n tensor-product b-spline of the
// (Hp, Wp, NCH) channel-interleaved table there and stores NCH floats
// of the (H, W, NCH) output. With a merge mask, a pixel whose mask is
// <= 0.5 reads nothing else and leaves ``out`` untouched (K2's overlay
// onto the prior canvas); without one every pixel is written (K5).
//
// Design. One thread per output pixel on 32x8 blocks, as the inline
// kernel. The mask is read first: the TPU kernel passes whole 8-row
// blocks through when none of their pixels is covered
// (pallas_resample.py:1121-1134); per pixel, an uncovered pixel skips
// its coordinate loads and every table read. The taps gather straight
// from global memory through L1/L2, so none of the TPU kernel's window
// classes, per-tile window DMA, sheared bands or the pass planner that
// chooses them is needed (they exist because Mosaic offers only an
// (8,128) in-register gather), nor the JAX fast path's forced-face
// cubemap variants and face-boundary merge passes: any IR address is
// one gather away.
//
// Coordinates may be non-finite where the mask is 0 (grazing or
// backward rays of a partial facet). Each is clamped as a float to
// [-(n+1), extent + n] before any integer conversion (fminf/fmaxf map
// NaN to the bound), so no NaN or inf reaches a float->int conversion,
// and the 64-bit flat tap index is clamped to the table as in the
// inline kernel and the JAX evaluator's take(mode="clip").
//
// Bound. Bytes: each pixel reads two (three with the mask) f32
// coordinate planes and writes NCH floats; the table entries read are
// those the taps touch, which chip_smoke.py counts per run. The
// arithmetic (two Horner rows of n FMAs per axis and (n+1)^2 x NCH tap
// FMAs) is far below the card's f32 rate, so the kernel is bytes-bound.
//
// The clamp and the spline live in resample_common.cuh, shared with the
// twined kernel.
//
// Left for later: fusing the coordinate pass (fastpath.coords, several
// elementwise PyTorch launches) into this kernel, and staging each
// block's source window in shared memory.

#include "resample_common.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;        // output window
  Table table;
};

template <int DEGREE, int NCH>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_planar_kernel(float* __restrict__ out,
                       const float* __restrict__ coeff,
                       const float* __restrict__ sxp,
                       const float* __restrict__ syp,
                       const float* __restrict__ mask,
                       const Params p) {
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const int64_t pix = y * p.width + x;
  if (mask != nullptr && !(__ldg(mask + pix) > 0.5f)) return;

  const float sx = clamp_coord<DEGREE>(__ldg(sxp + pix), p.table.wp);
  const float sy = clamp_coord<DEGREE>(__ldg(syp + pix), p.table.hp);
  float acc[NCH];
  spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, acc);
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

struct Launch {
  template <int DEGREE, int NCH>
  static cudaError_t run(float* out, const float* coeff, const float* sx,
                         const float* sy, const float* mask, const Params& p,
                         cudaStream_t stream) {
    resample_planar_kernel<DEGREE, NCH>
        <<<frame_grid(p.height, p.width), dim3(BLOCK_X, BLOCK_Y), 0, stream>>>(
            out, coeff, sx, sy, mask, p);
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). ``mask`` may be null (the
// whole window is written). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unsupported degree or channel
// count. ``wmat`` is a host array of (degree+1)^2 floats, copied into
// the kernel parameters.
extern "C" int envutil_resample_planar(
    float* out, const float* coeff, const float* sx, const float* sy,
    const float* mask, const float* wmat, long long height,
    long long width, long long hp, long long wp, int degree, int nch,
    void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width;
  set_table(p.table, hp, wp, degree, wmat);
  return (int)by_degree<Launch>(degree, nch, out, coeff, sx, sy, mask, p,
                                (cudaStream_t)stream);
}
