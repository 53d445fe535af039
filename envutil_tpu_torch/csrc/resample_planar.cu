// Planar b-spline resampler for Hopper (sm_90a), in two forms.
//
// Replaces two kernels of envutil_tpu/ops/pallas_resample.py:
//   _resample_kernel_into (the body of resample_planar_into, with
//     _eval_row_block and _emit_rows' merge-mask overlay), and
//   _resample_kernel (the body of resample_planar), the same
//     evaluation over the whole frame into a fresh output.
//
// The chain form (resample_planar_chain_kernel) computes each output
// pixel's coordinate chain in registers (planar_chain.cuh): the target
// ray from the axis features by a launch-uniform target mode (the
// inline kernel's affine / sph / cyl, or stereographic and fisheye
// planar targets), the basis, the normalisation, then the IR pickup of
// a cubemap or biatan6 source, or the mount pickup of a partial or PTO
// mount (to_plane, lens polynomial, shift, shear, window test, affine,
// gates). It evaluates the degree-n tensor-product b-spline of the
// (Hp, Wp, NCH) channel-interleaved table there and stores NCH floats
// of the (H, W, NCH) output, 0 where the ray misses the source: the
// single-facet finish where(mask, canvas, 0), so no zero fill runs
// before it. Given a score plane, it also writes each pixel's voronoi
// score there (models/synopsis.facet_score: the normalised ray's z
// times recip_step where the ray hits, the float32 lowest where it
// misses), which a multi-facet frame's synopsis combine reads
// (runtime/fastpath.multi_frame); the pixels are the same bit for bit
// with and without it. Why the chain is fused: on the TPU the JAX
// package computes the same chain under jit (fastpath._coords) and XLA
// fuses it into a few passes; eager PyTorch ran it as a string of
// elementwise launches (fastpath.coords), each a round trip of a full
// (H, W) float32 plane through device memory, and on the H100 that
// pass took 90-96% of a planar frame (PERF.md). Target and source
// modes are runtime branches, uniform over a launch, so the build
// keeps 32 instantiations (DEGREE x NCH) per form.
//
// The planes form (resample_planar_kernel) reads precomputed padded
// coordinates (sx, sy) and serves the jobs whose chain has no kernel
// form: translated facets (render.generic_r3). With a merge mask, a
// pixel whose mask is <= 0.5 reads nothing else and leaves ``out``
// untouched (K2's overlay onto the prior canvas); without one every
// pixel is written (K5).
//
// Both forms: one thread per output pixel on 32x8 blocks, taps gathered
// straight from global memory through L1/L2, so none of the TPU
// kernel's window classes, per-tile window DMA, sheared bands or the
// pass planner that chooses them is needed (they exist because Mosaic
// offers only an (8,128) in-register gather), nor the JAX fast path's
// forced-face cubemap variants and face-boundary merge passes: any IR
// address is one gather away. Coordinates may be non-finite (grazing
// or backward rays of a partial facet, where the mask is 0); each is
// clamped as a float to [-(n+1), extent + n] before any integer
// conversion (fminf/fmaxf map NaN to the bound), and the 64-bit flat
// tap index is clamped to the table as in the JAX evaluator's
// take(mode="clip").
//
// Bound. Bytes: the table entries under the covered pixels' taps
// (chip_smoke.py counts them per run) and the output; the planes form
// reads two or three f32 planes a pixel as well. Operations: the
// chain's (a few hundred flops a pixel at most, counting a
// transcendental as 20) and two Horner rows of n FMAs per axis plus
// (n+1)^2 x NCH tap FMAs per covered pixel. Both are a few hundredths
// of a millisecond at the port's frame sizes; the kernels run at
// 12-27% of that bound, paced by the chain's dependent operations and
// the scalar tap loads.
//
// bf16 tables (--coeff bf16): both forms are templated on the table's
// element type and convert each tap to float where spline_at loads it
// (resample_common.cuh); the coordinate planes, the stack a stitch
// writes into and the score stay float32.
//
// No staged window. Ablation on the H100 (PERF.md, section 6) put the
// chain form's tap loads at 49% of the kernel at config 3 (0.048 of
// 0.097 ms) and 9% at the lens facet, where the chain over every pixel
// of the equirect sets the pace; the inline kernel's staged window
// (stage_window / spline_staged) on 32x8-pixel blocks read 0.0970
// against 0.0968 ms at config 3 and cost 32% at the lens facet, so the
// taps gather directly.
//
#include "planar_chain.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;        // output window
  Table table;
};

template <int DEGREE, int NCH, typename T>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_planar_kernel(float* __restrict__ out,
                       const T* __restrict__ coeff,
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

template <typename T>
struct Launch {
  template <int DEGREE, int NCH>
  static cudaError_t run(float* out, const T* coeff, const float* sx,
                         const float* sy, const float* mask, const Params& p,
                         cudaStream_t stream) {
    resample_planar_kernel<DEGREE, NCH, T>
        <<<frame_grid(p.height, p.width), dim3(BLOCK_X, BLOCK_Y), 0, stream>>>(
            out, coeff, sx, sy, mask, p);
    return cudaGetLastError();
  }
};

// ---- the chain form ---------------------------------------------------

struct ChainParams {
  int64_t height, width;        // output window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int tmode;                    // TMODE_* (planar_chain.cuh)
  float recip_step;             // score = z * recip_step
  ChainPickup pick;
  Table table;
};

template <int DEGREE, int NCH, typename T>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
resample_planar_chain_kernel(float* __restrict__ out,
                             float* __restrict__ score,
                             const T* __restrict__ coeff,
                             const float* __restrict__ xfeat,
                             const float* __restrict__ yfeat,
                             const float* __restrict__ bmats,
                             const ChainParams p) {
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  int face = 0;
  if (p.face_rows > 0) face = min(max((p.row0 + (int)y) / p.face_rows, 0), 5);
  float r[3], sx, sy;
  chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height, bmats + face * 9,
            r);
  const bool hit = chain_pickup(p.pick, r[0], r[1], r[2], sx, sy);
  float acc[NCH];
  if (hit) {
    spline_at<DEGREE, NCH>(coeff, p.table, clamp_coord<DEGREE>(sx, p.table.wp),
                           clamp_coord<DEGREE>(sy, p.table.hp), acc);
  } else {
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  }
  const int64_t pix = y * p.width + x;
  float* dst = out + pix * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
  if (score != nullptr) score[pix] = hit ? mul(r[2], p.recip_step) : LOWEST;
}

template <typename T>
struct ChainLaunch {
  template <int DEGREE, int NCH>
  static cudaError_t run(float* out, float* score, const T* coeff,
                         const float* xfeat, const float* yfeat,
                         const float* bmats, const ChainParams& p,
                         cudaStream_t stream) {
    resample_planar_chain_kernel<DEGREE, NCH, T>
        <<<frame_grid(p.height, p.width), dim3(BLOCK_X, BLOCK_Y), 0, stream>>>(
            out, score, coeff, xfeat, yfeat, bmats, p);
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). ``mask`` may be null (the
// whole window is written). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unsupported degree or channel
// count. ``wmat`` is a host array of (degree+1)^2 floats, copied into
// the kernel parameters. ``coeff`` is float32, or bfloat16 where
// ``coeff_bf16`` is set.
extern "C" int envutil_resample_planar(
    float* out, const void* coeff, const float* sx, const float* sy,
    const float* mask, const float* wmat, long long height,
    long long width, long long hp, long long wp, int degree, int nch,
    int coeff_bf16, void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width;
  set_table(p.table, hp, wp, degree, wmat);
  if (coeff_bf16)
    return (int)by_degree<Launch<__nv_bfloat16>>(
        degree, nch, out, (const __nv_bfloat16*)coeff, sx, sy, mask, p,
        (cudaStream_t)stream);
  return (int)by_degree<Launch<float>>(degree, nch, out, (const float*)coeff,
                                       sx, sy, mask, p, (cudaStream_t)stream);
}

// Plain C entry point of the chain form (loaded with ctypes). ``xfeat``
// (Fx, W), ``yfeat`` (Fy, H) and ``bmats`` (1 or 6, 9) are device
// arrays as for the inline kernel; ``ipick`` (7 ints) and ``fpick``
// (24 floats) are host arrays holding ChainPickup's fields in their
// order. Every pixel is written: 0 where the ray misses the source.
// ``score`` may be null; otherwise it is an (H, W) device plane that
// receives each pixel's score, the ray's z times ``recip_step``.
// ``coeff`` is float32, or bfloat16 where ``coeff_bf16`` is set.
extern "C" int envutil_resample_planar_chain(
    float* out, float* score, const void* coeff, const float* xfeat,
    const float* yfeat, const float* bmats, const float* wmat,
    const int* ipick, const float* fpick, long long height, long long width,
    long long hp, long long wp, int row0, int face_rows, int degree, int nch,
    int tmode, float recip_step, int coeff_bf16, void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (tmode < TMODE_AFFINE || tmode > TMODE_FISH) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  ChainParams p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows; p.tmode = tmode;
  p.recip_step = recip_step;
  if (!set_pickup(p.pick, ipick, fpick)) return (int)cudaErrorInvalidValue;
  set_table(p.table, hp, wp, degree, wmat);
  if (coeff_bf16)
    return (int)by_degree<ChainLaunch<__nv_bfloat16>>(
        degree, nch, out, score, (const __nv_bfloat16*)coeff, xfeat, yfeat,
        bmats, p, (cudaStream_t)stream);
  return (int)by_degree<ChainLaunch<float>>(degree, nch, out, score,
                                            (const float*)coeff, xfeat, yfeat,
                                            bmats, p, (cudaStream_t)stream);
}
