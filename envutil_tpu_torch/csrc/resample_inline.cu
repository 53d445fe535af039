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
// The device functions (ray, pickup, gate, spline) live in
// resample_common.cuh, shared with the twined kernel.
//
// Left for later: staging each block's source window in shared memory
// (the taps of neighbouring threads overlap heavily, so L1 carries the
// reuse today), and coalescing the gather across the warp.

#include "resample_common.cuh"

namespace {

using namespace envutil;

struct Params {
  int64_t height, width;        // output window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  Pickup pick;
  Table table;
};

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
  float rx, ry, rz, sx, sy;
  target_ray<TMODE>(xfeat, yfeat, x, y, p.width, p.height, bmats + face * 9,
                    rx, ry, rz);
  pickup(p.pick, rx, ry, rz, sx, sy);

  float acc[NCH];
  spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, acc);
  float* dst = out + (y * p.width + x) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
}

struct Launch {
  template <int DEGREE, int NCH>
  static cudaError_t run(int tmode, float* out, const float* coeff,
                         const float* xfeat, const float* yfeat,
                         const float* bmats, const Params& p,
                         cudaStream_t s) {
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid = frame_grid(p.height, p.width);
    switch (tmode) {
      case TMODE_AFFINE:
        resample_inline_kernel<DEGREE, NCH, TMODE_AFFINE>
            <<<grid, block, 0, s>>>(out, coeff, xfeat, yfeat, bmats, p);
        break;
      case TMODE_SPH:
        resample_inline_kernel<DEGREE, NCH, TMODE_SPH>
            <<<grid, block, 0, s>>>(out, coeff, xfeat, yfeat, bmats, p);
        break;
      case TMODE_CYL:
        resample_inline_kernel<DEGREE, NCH, TMODE_CYL>
            <<<grid, block, 0, s>>>(out, coeff, xfeat, yfeat, bmats, p);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported
// degree / channel count / target mode / source mode. ``wmat`` is a host
// array of (degree+1)^2 floats, copied into the kernel parameters.
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
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows;
  p.pick = Pickup{smode, gate_x, gate_y, glx, gux, gly, guy,
                  kx, cx, ky, cy, pad, section_px};
  set_table(p.table, hp, wp, degree, wmat);
  return (int)by_degree<Launch>(degree, nch, tmode, out, coeff, xfeat, yfeat,
                                bmats, p, (cudaStream_t)stream);
}
