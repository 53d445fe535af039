// Coverage pass of the chain forms' compact grid, for Hopper (sm_90a).
//
// Replaces no pallas_call: it is the counterpart of the JAX planner's
// coverage step, envutil_tpu/runtime/fastpath.py:1040-1045 (plan_passes
// reduces the facet's _coords mask per tile and marks every tile
// without a hit ZERO_PASS), which lists the tiles that the TPU kernels
// resample_planar_into and resample_twined_into (pallas_resample.py
// :1148, :1930) run one grid step each; a tile not listed keeps the
// canvas. Here the list feeds the chain forms (resample_planar.cu,
// resample_twined.cu), which launch one CUDA block per listed 32x8
// block where they launched the whole raster: a stitch's facet covers
// a few percent of an equirect, and the chain over every missed pixel
// (three rays, three pickups and the tap window tests in the twined
// form) was most of its launch.
//
// Two kernels. chain_cover_kernel runs the chain forms' own grid of
// 32x8 blocks over the window and flags each block that holds a pixel
// the chain launch would write as something other than 0 / LOWEST:
// untwined, the centre ray's chain_pickup hits; twined (a source that
// does not cover every ray, so that each tap is tested), some tap's
// tap_ray window test passes, over every tap of the spread, so that
// one list serves each one-tap launch of a twined stitch. It calls the
// device functions of the launches (chain_ray, chain_pickup,
// ninepack_rays, tap_ray; planar_chain.cuh) with the same row0,
// face_rows, target mode and spread, each step rounded as there, so a
// pixel is flagged exactly where its launch writes. chain_margin_kernel
// adds a margin of one block around every flagged block, so that a difference in contraction between
// two builds cannot drop a pixel, and list_kernel (planar_chain.cuh)
// compacts the result in one block into an int32 list of block indices
// by * ceil(W / 32) + bx in ascending order, with its count; the caller
// reads the count once, when the list is built (it is kept per plan:
// runtime/fastpath.block_list).
//
// Bound. Operations: the chain per pixel (untwined: one ray and one
// pickup; twined: three rays, the derivative rays and the tap tests up
// to the first that passes), a few hundred flops at most; bytes: the
// features and the flags, a few kilobytes. At the port's frames (8
// Mpixel) that is a few hundredths of a millisecond, about one
// full-raster launch of the same chain without its spline.

#include "planar_chain.cuh"

namespace {

using namespace envutil;

struct CoverParams {
  int64_t height, width;        // window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int nfx, nfy;                 // feature rows of one set
  int tmode;                    // TMODE_* (planar_chain.cuh)
  int n_taps;                   // 0: untwined
  int precise;                  // tangent-plane derivative basis
  ChainPickup pick;
};

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
chain_cover_kernel(unsigned char* __restrict__ flags,
                   const float* __restrict__ xfeat,
                   const float* __restrict__ yfeat,
                   const float* __restrict__ bmats,
                   const float* __restrict__ spread,
                   const CoverParams p) {
  extern __shared__ float taps[];  // (n_taps, 3): cx, cy, w
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();

  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  bool hit = false;
  if (x < p.width && y < p.height) {
    int face = 0;
    if (p.face_rows > 0)
      face = min(max((p.row0 + (int)y) / p.face_rows, 0), 5);
    const float* bm = bmats + face * 9;
    if (p.n_taps == 0) {
      float r[3], sx, sy;
      chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height, bm, r);
      hit = chain_pickup(p.pick, r[0], r[1], r[2], sx, sy);
    } else {
      float p0[3], p10[3], p01[3], du[3], dv[3];
      ninepack_rays(p.tmode, xfeat, yfeat, p.nfx, p.nfy, x, y, p.width,
                    p.height, bm, p.precise != 0, p0, p10, p01, du, dv);
#pragma unroll 1
      for (int k = 0; k < p.n_taps && !hit; ++k) {
        float r[3];
        hit = tap_ray(p.pick, true, p0, du, dv, taps[3 * k],
                      taps[3 * k + 1], r);
      }
    }
  }
  const int any = __syncthreads_or(hit);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    flags[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = any ? 1 : 0;
}

// the margin: near[b] = 1 where block b or one of its eight neighbours
// is flagged, one thread a block index
__global__ void __launch_bounds__(LIST_THREADS)
chain_margin_kernel(const unsigned char* __restrict__ flags,
                    unsigned char* __restrict__ near, int64_t nby,
                    int64_t nbx) {
  const int64_t b = (int64_t)blockIdx.x * LIST_THREADS + threadIdx.x;
  if (b >= nby * nbx) return;
  const int64_t by = b / nbx, bx = b - by * nbx;
  const int64_t j0 = by > 0 ? by - 1 : 0, j1 = by + 1 < nby ? by + 1 : by;
  const int64_t i0 = bx > 0 ? bx - 1 : 0, i1 = bx + 1 < nbx ? bx + 1 : bx;
  unsigned char any = 0;
  for (int64_t j = j0; j <= j1; ++j)
    for (int64_t i = i0; i <= i1; ++i) any |= flags[j * nbx + i];
  near[b] = any;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Over the (height, width)
// window, flags each 32x8 block and marks it and its neighbours
// (``flags``, 2 ceil(H / 8) ceil(W / 32) bytes of device scratch), and
// writes the marked blocks to ``blocks`` (room for every block) and
// their number to ``count`` (one device int). ``xfeat``, ``yfeat``,
// ``bmats``, ``ipick``, ``fpick``, ``row0``, ``face_rows`` and ``tmode``
// as for envutil_resample_planar_chain; with ``spread`` (a device array
// of ``n_taps`` (cx, cy, w) triplets, the features doubled as for
// envutil_resample_twined_chain) a block is flagged where some tap's
// deflected ray passes the mount's window test (``precise``: the
// tangent-plane derivative rays), without it where the centre ray's
// pickup hits. Returns cudaGetLastError() after the three launches, or
// cudaErrorInvalidValue for an unsupported argument.
extern "C" int envutil_chain_blocks(
    unsigned char* flags, int* blocks, int* count, const float* xfeat,
    const float* yfeat, const float* bmats, const float* spread,
    const int* ipick, const float* fpick, long long height, long long width,
    int row0, int face_rows, int tmode, int n_taps, int precise,
    void* stream) {
  constexpr int MAX_TAPS = 4096;  // 48 KiB of shared memory
  if (tmode < TMODE_AFFINE || tmode > TMODE_FISH) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nby = (height + BLOCK_Y - 1) / BLOCK_Y;
  const int64_t nbx = (width + BLOCK_X - 1) / BLOCK_X;
  const int64_t n = nby * nbx;
  if (nby > 65535 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CoverParams p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows; p.tmode = tmode;
  p.nfx = (tmode == TMODE_SPH || tmode == TMODE_CYL) ? 2 : 1;
  p.nfy = tmode == TMODE_SPH ? 2 : 1;
  p.n_taps = spread == nullptr ? 0 : n_taps;
  p.precise = precise;
  if (!set_pickup(p.pick, ipick, fpick)) return (int)cudaErrorInvalidValue;
  if (spread != nullptr && (n_taps < 1 || n_taps > MAX_TAPS ||
                            p.pick.smode != SMODE_MOUNT))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)3 * p.n_taps * sizeof(float);
  chain_cover_kernel<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y),
                       smem, s>>>(flags, xfeat, yfeat, bmats, spread, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unsigned char* near = flags + n;
  chain_margin_kernel<<<(unsigned)((n + LIST_THREADS - 1) / LIST_THREADS),
                        LIST_THREADS, 0, s>>>(flags, near, nby, nbx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  list_kernel<LIST_THREADS><<<1, LIST_THREADS, 0, s>>>(near, blocks, count, n);
  return (int)cudaGetLastError();
}
