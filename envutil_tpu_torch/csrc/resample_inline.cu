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
// What bounds it on this card. By bytes the main path (2048x12288x3 f32
// out, (4104, 8200, 3) f32 table) needs ~0.2 ms at 3.35 TB/s; the
// arithmetic is ~0.09 ms at 67 TFLOP/s. One thread a pixel gathering
// its (n+1)^2 taps from global memory took 0.83 ms there, and ablation
// (tools/ablation/ablate_inline.py) split that into ~0.5 ms of tap
// loads (scalar 4-byte loads 12 bytes apart across a warp, three or
// four cache lines each, served through L1) and ~0.24 ms of coordinate
// chain and stores; cheaper transcendentals, 16-byte tap loads of a
// padded table and a one-channel store changed little or nothing, so
// the pickup and the three 4-byte stores a pixel stay as they were.
//
// Design. A block of 32x8 threads covers a tile of 32 x (8 ROWS) output
// pixels, a warp one row of 32 at a time. Each thread computes its
// pixels' coordinates once; the block reduces their supports to one
// bounding box in the table and, if the box fits the launch's window
// budget, copies it into shared memory with coalesced cp.async
// (resample_common.cuh: stage_window). Every tap is then a
// shared-memory read; weights and order are the direct gather's, so the
// two agree bit for bit. Hopper needs none of the TPU kernel's window
// classes, sheared candidate bands, forced-face 'sec' variants or merge
// passes: each pixel picks its own face in the one launch over the
// whole frame.
//
// What the staged kernel is bound by. Its phases (chain, box and copy,
// taps) run one after the other inside a block and overlap only across
// the blocks an SM holds, and the chain is a long string of dependent
// operations, so the warps in flight set the pace: the register cap
// (MIN_BLOCKS), the tile height and the budget (every block is launched
// with all of it) were chosen by timing builds that differed in one of
// them.
// On the main path the chain and stores take ~0.24 ms of the staged
// kernel's ~0.68 ms (chip_smoke.py times it beside the direct gather's
// ~0.9 ms); the box, copy and barriers and the taps from shared memory
// share the rest. Overlapping the copy with the next tile's chain (a
// persistent block with two windows) is left for later.
//
// bf16 tables (--coeff bf16). The kernel is templated on the table's
// element type; a bf16 window holds its raw entries, so at the same
// 32 KB budget a block can stage a box twice as large (more blocks of a
// steep view, of a pole's neighbourhood, stage), and each tap is
// converted to float where it is read (resample_common.cuh). The
// coordinate chain, the weights and the stores are the float32
// kernel's.
//
// The direct branch. A block whose box does not fit - it holds a pole,
// straddles the periodic seam (the box spans the table's width) or a
// cube-face edge of an IR source (the box jumps by section_px), or the
// view is a steep downscale - reads its taps from global memory as
// before (spline_at; the flat offset is 64-bit and clamped to the
// table, as the JAX evaluator's take(mode="clip") does). So does any
// single pixel whose support leaves the table. The choice is
// block-uniform inside the one kernel; a budget of 0 sends every block
// that way (the wrapper's test keyword).

#include <mutex>

#include "resample_common.cuh"

namespace {

using namespace envutil;

// output rows per thread: the tile is 32 x (8 ROWS). A taller tile
// lowers the window's halo share and lets the compiler interleave the
// rows' chains; more rows cost registers, shared memory and blocks in
// flight. Timed on the H100's main path, two rows beat one (the rows'
// chains interleave) and four (their windows outgrow the budget).
constexpr int ROWS = 2;
// blocks the compiler must leave room for on an SM, which caps the
// registers: the coordinate chain is a long string of dependent
// operations and the phases of a block do not overlap, so it is the
// number of warps in flight that sets the pace. Five blocks (48
// registers) spill a few bytes at degree 3; the higher degrees hold
// more weights and keep four (64 registers).
template <int DEGREE>
constexpr int min_blocks() {
  return DEGREE <= 3 ? 5 : 4;
}

struct Params {
  int64_t height, width;        // output window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int budget;                   // window bytes of shared memory (0: direct)
  Pickup pick;
  Table table;
};

template <int DEGREE, int NCH, int TMODE, typename T>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, min_blocks<DEGREE>())
resample_inline_kernel(float* __restrict__ out,
                       const T* __restrict__ coeff,
                       const float* __restrict__ xfeat,
                       const float* __restrict__ yfeat,
                       const float* __restrict__ bmats,
                       const Params p) {
  extern __shared__ float4 shared[];
  __shared__ int sbox[4];
  T* win = reinterpret_cast<T*>(shared);

  const int width = (int)p.width, height = (int)p.height;
  const int bx0 = blockIdx.x * BLOCK_X;
  const int y0 = blockIdx.y * (BLOCK_Y * ROWS) + threadIdx.y;
  const int x = bx0 + threadIdx.x;

  // the cube face of the thread's first row, by one division; its
  // further rows step by BLOCK_Y
  int face = 0, into = 0;
  if (p.face_rows > 0) {
    face = (p.row0 + y0) / p.face_rows;
    into = (p.row0 + y0) - face * p.face_rows;
  }

  float sx[ROWS], sy[ROWS];
  Box box = empty_box();
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = y0 + i * BLOCK_Y;
    sx[i] = sy[i] = 0.0f;
    if (x < width && y < height) {
      float rx, ry, rz;
      target_ray<TMODE>(xfeat, yfeat, x, y, width, height,
                        bmats + min(max(face, 0), 5) * 9, rx, ry, rz);
      pickup(p.pick, rx, ry, rz, sx[i], sy[i]);
      box_add<DEGREE>(box, p.table, sx[i], sy[i]);
    }
    if (p.face_rows > 0) {
      into += BLOCK_Y;
      while (into >= p.face_rows) {
        into -= p.face_rows;
        ++face;
      }
    }
  }
  const Window w = stage_window<DEGREE, NCH>(box, p.table, coeff, win, sbox,
                                             p.budget);

  if (x >= width) return;
  // one copy of the spline's code for all rows (the build's time and the
  // instruction cache); the row's coordinates are picked by selects
#pragma unroll 1
  for (int i = 0; i < ROWS; ++i) {
    const int y = y0 + i * BLOCK_Y;
    if (y >= height) break;
    float sxi = sx[0], syi = sy[0];
#pragma unroll
    for (int r = 1; r < ROWS; ++r) {
      sxi = i == r ? sx[r] : sxi;
      syi = i == r ? sy[r] : syi;
    }
    float acc[NCH];
    spline_staged<DEGREE, NCH>(win, w, coeff, p.table, sxi, syi, acc);
    float* dst = out + ((int64_t)y * width + x) * NCH;
#pragma unroll
    for (int c = 0; c < NCH; ++c) dst[c] = acc[c];
  }
}

template <typename T>
struct Launch {
  template <int DEGREE, int NCH, int TMODE>
  static cudaError_t go(float* out, const T* coeff, const float* xfeat,
                        const float* yfeat, const float* bmats,
                        const Params& p, cudaStream_t s) {
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((unsigned)((p.width + BLOCK_X - 1) / BLOCK_X),
                    (unsigned)((p.height + BLOCK_Y * ROWS - 1) /
                               (BLOCK_Y * ROWS)));
    const size_t smem = (size_t)p.budget;
    auto kernel = resample_inline_kernel<DEGREE, NCH, TMODE, T>;
    // Above 48 KB (static shared memory included) a kernel must opt
    // in, per device. Every launch tells the current device's copy of
    // the instantiation what it needs, downwards too (a size left set
    // slowed later launches that needed less), and holds a lock from
    // there to the launch, so that another host thread's budget cannot
    // come between the two. A refusal is returned, not worked around.
    static std::mutex launching;
    const std::lock_guard<std::mutex> lock(launching);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, smem, s>>>(out, coeff, xfeat, yfeat, bmats, p);
    return cudaGetLastError();
  }

  template <int DEGREE, int NCH>
  static cudaError_t run(int tmode, float* out, const T* coeff,
                         const float* xfeat, const float* yfeat,
                         const float* bmats, const Params& p,
                         cudaStream_t s) {
    switch (tmode) {
      case TMODE_AFFINE:
        return go<DEGREE, NCH, TMODE_AFFINE>(out, coeff, xfeat, yfeat, bmats,
                                             p, s);
      case TMODE_SPH:
        return go<DEGREE, NCH, TMODE_SPH>(out, coeff, xfeat, yfeat, bmats, p,
                                          s);
      case TMODE_CYL:
        return go<DEGREE, NCH, TMODE_CYL>(out, coeff, xfeat, yfeat, bmats, p,
                                          s);
    }
    return cudaErrorInvalidValue;
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the CUDA error of
// the launch (0 on success; a window budget the card refuses is such an
// error), or cudaErrorInvalidValue for an unsupported degree / channel
// count / target mode / source mode. ``wmat`` is a host array of
// (degree+1)^2 floats, copied into the kernel parameters.
// ``window_bytes`` is the shared memory a block may stage its source
// window in; 0 makes every block gather from global memory. ``coeff``
// is float32, or bfloat16 where ``coeff_bf16`` is set.
extern "C" int envutil_resample_inline(
    float* out, const void* coeff, const float* xfeat, const float* yfeat,
    const float* bmats, const float* wmat,
    long long height, long long width, long long hp, long long wp,
    int row0, int face_rows, int degree, int nch, int tmode, int smode,
    int gate_x, float glx, float gux, int gate_y, float gly, float guy,
    float kx, float cx, float ky, float cy, float pad, float section_px,
    int window_bytes, int coeff_bf16, void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  if (smode < SMODE_SPH || smode > SMODE_BIATAN6) return (int)cudaErrorInvalidValue;
  if (window_bytes < 0 || (window_bytes & 15)) return (int)cudaErrorInvalidValue;
  if (hp >= (1 << 24) || wp >= (1 << 24) || height >= (1LL << 31) ||
      width >= (1LL << 31))
    return (int)cudaErrorInvalidValue;        // 32-bit maths in the kernel
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y * ROWS - 1) / (BLOCK_Y * ROWS) > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows;
  p.budget = window_bytes;
  p.pick = Pickup{smode, gate_x, gate_y, glx, gux, gly, guy,
                  kx, cx, ky, cy, pad, section_px};
  set_table(p.table, hp, wp, degree, wmat);
  if (coeff_bf16)
    return (int)by_degree<Launch<__nv_bfloat16>>(
        degree, nch, tmode, out, (const __nv_bfloat16*)coeff, xfeat, yfeat,
        bmats, p, (cudaStream_t)stream);
  return (int)by_degree<Launch<float>>(degree, nch, tmode, out,
                                       (const float*)coeff, xfeat, yfeat,
                                       bmats, p, (cudaStream_t)stream);
}
