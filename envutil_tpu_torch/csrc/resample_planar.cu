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
// Left for later: fusing the coordinate pass (fastpath.coords, several
// elementwise PyTorch launches) into this kernel, and staging each
// block's source window in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEGREE = 7;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

struct Params {
  int64_t height, width;        // output window
  int64_t hp, wp;               // padded table
  float wmat[(MAX_DEGREE + 1) * (MAX_DEGREE + 1)];  // weight matrix
};

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

  // clamp as floats first: finite, and far enough out that an in-range
  // coordinate is never changed
  const float sx = fminf(fmaxf(__ldg(sxp + pix), -(float)(DEGREE + 1)),
                         (float)(p.wp + DEGREE));
  const float sy = fminf(fmaxf(__ldg(syp + pix), -(float)(DEGREE + 1)),
                         (float)(p.hp + DEGREE));

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
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

template <int DEGREE, int NCH>
cudaError_t launch(float* out, const float* coeff, const float* sx,
                   const float* sy, const float* mask, const Params& p,
                   cudaStream_t stream) {
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((unsigned)((p.width + BLOCK_X - 1) / BLOCK_X),
                  (unsigned)((p.height + BLOCK_Y - 1) / BLOCK_Y));
  resample_planar_kernel<DEGREE, NCH>
      <<<grid, block, 0, stream>>>(out, coeff, sx, sy, mask, p);
  return cudaGetLastError();
}

template <int DEGREE>
cudaError_t by_nch(int nch, float* out, const float* coeff, const float* sx,
                   const float* sy, const float* mask, const Params& p,
                   cudaStream_t s) {
  switch (nch) {
    case 1: return launch<DEGREE, 1>(out, coeff, sx, sy, mask, p, s);
    case 2: return launch<DEGREE, 2>(out, coeff, sx, sy, mask, p, s);
    case 3: return launch<DEGREE, 3>(out, coeff, sx, sy, mask, p, s);
    case 4: return launch<DEGREE, 4>(out, coeff, sx, sy, mask, p, s);
  }
  return cudaErrorInvalidValue;
}

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
  p.height = height; p.width = width; p.hp = hp; p.wp = wp;
  for (int i = 0; i < (degree + 1) * (degree + 1); ++i) p.wmat[i] = wmat[i];
  cudaStream_t s = (cudaStream_t)stream;
  switch (degree) {
    case 0: return (int)by_nch<0>(nch, out, coeff, sx, sy, mask, p, s);
    case 1: return (int)by_nch<1>(nch, out, coeff, sx, sy, mask, p, s);
    case 2: return (int)by_nch<2>(nch, out, coeff, sx, sy, mask, p, s);
    case 3: return (int)by_nch<3>(nch, out, coeff, sx, sy, mask, p, s);
    case 4: return (int)by_nch<4>(nch, out, coeff, sx, sy, mask, p, s);
    case 5: return (int)by_nch<5>(nch, out, coeff, sx, sy, mask, p, s);
    case 6: return (int)by_nch<6>(nch, out, coeff, sx, sy, mask, p, s);
    default: return (int)by_nch<7>(nch, out, coeff, sx, sy, mask, p, s);
  }
}
