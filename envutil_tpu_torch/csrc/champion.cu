// Champion pass of the voronoi route, for Hopper (sm_90a).
//
// Replaces no pallas_call: it is the counterpart of the XLA code that
// builds the champion stack of the JAX fast path's twined voronoi
// route, envutil_tpu/runtime/fastpath.py:2978-2996 (_pertap_build's
// champ_body: per tap, the argmax over the facets of _tap_mask_score),
// whose (n_taps, H, W) int32 stack feeds the tapsel mode of the TPU
// kernel _twined_kernel_into (pallas_resample.py:1751-1762). Here the
// planes feed the chain forms' champion modes (resample_planar.cu,
// resample_twined.cu): one launch per facet writes only the pixels and
// taps that facet champions, into one frame, so that a voronoi stitch
// needs neither a pixel stack nor a combine. The planes depend on the
// geometry alone, so the caller builds them once per plan
// (runtime/fastpath.champion_planes) where the JAX package recomputes
// them in every jitted frame.
//
// Two kernels and the shared list compaction.
//
// champion_kernel runs once per facet, in facet order, over the facet's
// coverage list (chain_blocks.cu) or the whole window, and updates the
// (K, H, W) float32 best scores and uint8 champions in place: per
// pixel and tap, the facet's voronoi score (models/synopsis.facet_score)
// of the tap's ray, where it is strictly greater than the best so far,
// becomes the best and the facet the champion, so the first facet wins
// a tie as torch.max and the JAX package's argmax do. The score is the
// one the chain forms write beside their pixels: untwined, the normalised ray's z
// times recip_step where chain_pickup hits; twined, the z of the tap's
// deflected ray p0 + cx du + cy dv (not renormalised) where tap_ray's
// window test passes (every tap of a source that covers every ray);
// LOWEST elsewhere, which never wins, so a pixel that no facet covers
// keeps champion 255. It calls those kernels' device functions
// (chain_ray, chain_pickup, ninepack_rays, tap_ray) with the same
// operands, each step rounded as there, so the planes are the argmax of
// the scores the one-tap launches of the stack route write.
//
// champion_flags_kernel reads the finished planes once, a CUDA block
// per 32x8 block of the window, and flags for each facet the blocks in
// which it champions some pixel at some tap; list_kernel
// (planar_chain.cuh) then compacts each facet's flags into its
// champion list, a sublist of its coverage list: the blocks its
// champion-mode launch covers, the counterpart of the TPU kernel's skip
// of row blocks no tap champions for the facet (_emit_rows_zero,
// pallas_resample.py:1060, 1904-1916).
//
// Bound. champion_kernel: per pixel the chain of the launch it mirrors
// (one ray and pickup untwined; three rays, the derivative rays and K
// deflections and window tests twined), a few hundred flops, and the
// planes read and written once (5 bytes a pixel and tap); at 4096x2048
// and 4 taps that is 0.05 ms of bytes a facet. champion_flags_kernel:
// the champion planes read once and F flags a block written.

#include "planar_chain.cuh"

namespace {

using namespace envutil;

// the champion of a pixel and tap no facet covers
constexpr unsigned char NO_CHAMPION = 255;

struct ChampParams {
  int64_t height, width;        // window
  int row0;                     // absolute row of the window's first row
  int face_rows;                // rows per cube face (0: one matrix)
  int nfx, nfy;                 // feature rows of one set
  int tmode;                    // TMODE_* (planar_chain.cuh)
  int n_taps;                   // 0: untwined, one plane
  int precise;                  // tangent-plane derivative basis
  int tap_valid;                // test each tap's ray against the window
  int facet;                    // the facet's index, < NO_CHAMPION
  float recip_step;             // score = z * recip_step
  ChainPickup pick;
};

__device__ __forceinline__ void merge(float* __restrict__ best,
                                      unsigned char* __restrict__ champ,
                                      int64_t at, float score, int facet) {
  if (score > best[at]) {
    best[at] = score;
    champ[at] = (unsigned char)facet;
  }
}

// untwined (one plane) and twined (a plane a tap) as two kernels
template <bool TWINED>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
champion_kernel(float* __restrict__ best, unsigned char* __restrict__ champ,
                const float* __restrict__ xfeat,
                const float* __restrict__ yfeat,
                const float* __restrict__ bmats,
                const float* __restrict__ spread,
                const int* __restrict__ blocks, const ChampParams p) {
  extern __shared__ float taps[];  // (n_taps, 3): cx, cy, w
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < 3 * p.n_taps;
       i += BLOCK_X * BLOCK_Y)
    taps[i] = spread[i];
  __syncthreads();

  int64_t bx, by;
  chain_block(blocks, p.width, bx, by);
  const int64_t x = bx * BLOCK_X + threadIdx.x;
  const int64_t y = by * BLOCK_Y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  int face = 0;
  if (p.face_rows > 0) face = min(max((p.row0 + (int)y) / p.face_rows, 0), 5);
  const float* bm = bmats + face * 9;
  const int64_t pix = y * p.width + x;
  if constexpr (!TWINED) {
    float r[3], sx, sy;
    chain_ray(p.tmode, xfeat, yfeat, x, y, p.width, p.height, bm, r);
    const bool hit = chain_pickup(p.pick, r[0], r[1], r[2], sx, sy);
    merge(best, champ, pix, hit ? mul(r[2], p.recip_step) : LOWEST, p.facet);
    return;
  }
  float p0[3], p10[3], p01[3], du[3], dv[3];
  ninepack_rays(p.tmode, xfeat, yfeat, p.nfx, p.nfy, x, y, p.width,
                p.height, bm, p.precise != 0, p0, p10, p01, du, dv);
  const int64_t plane = p.height * p.width;
#pragma unroll 1
  for (int k = 0; k < p.n_taps; ++k) {
    float r[3];
    const bool hit = tap_ray(p.pick, p.tap_valid, p0, du, dv, taps[3 * k],
                             taps[3 * k + 1], r);
    merge(best, champ, k * plane + pix,
          hit ? mul(r[2], p.recip_step) : LOWEST, p.facet);
  }
}

// flags[f * n + b] = 1 where facet f champions some pixel of block b at
// some tap (n the window's blocks), for f < n_facets
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
champion_flags_kernel(const unsigned char* __restrict__ champ,
                      unsigned char* __restrict__ flags, int64_t height,
                      int64_t width, int n_planes, int n_facets) {
  __shared__ unsigned seen[8];     // a bit per facet id 0..255
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  if (tid < 8) seen[tid] = 0u;
  __syncthreads();
  const int64_t x = (int64_t)blockIdx.x * BLOCK_X + threadIdx.x;
  const int64_t y = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x < width && y < height) {
    const int64_t plane = height * width;
    for (int k = 0; k < n_planes; ++k) {
      const unsigned c = champ[k * plane + y * width + x];
      if (c != NO_CHAMPION) atomicOr(&seen[c >> 5], 1u << (c & 31));
    }
  }
  __syncthreads();
  const int64_t n = (int64_t)gridDim.x * gridDim.y;
  const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (tid < n_facets)
    flags[tid * n + b] = (seen[tid >> 5] >> (tid & 31)) & 1u;
}

}  // namespace

// Plain C entry point (loaded with ctypes) of one facet's update of the
// champion planes: ``best`` (K, H, W) float32 and ``champ`` (K, H, W)
// uint8 device planes, K = max(n_taps, 1), updated in place where the
// facet's score is strictly greater than ``best`` (champ := ``facet``,
// 0 <= facet < 255). ``xfeat``, ``yfeat``, ``bmats``, ``ipick``,
// ``fpick``, ``row0``, ``face_rows``, ``tmode``, ``blocks`` and
// ``n_blocks`` as for envutil_resample_planar_chain; with ``spread`` (a
// device array of ``n_taps`` (cx, cy, w) triplets, the features doubled
// as for envutil_resample_twined_chain, ``precise`` and ``tap_valid`` as
// there) one plane a tap, each tap scored at its deflected ray;
// without it one plane, scored at the centre ray. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported argument.
extern "C" int envutil_champion(
    float* best, unsigned char* champ, const float* xfeat,
    const float* yfeat, const float* bmats, const float* spread,
    const int* ipick, const float* fpick, const int* blocks,
    long long n_blocks, long long height, long long width, int row0,
    int face_rows, int tmode, int n_taps, int precise, int tap_valid,
    int facet, float recip_step, void* stream) {
  constexpr int MAX_TAPS = 4096;  // 48 KiB of shared memory
  if (tmode < TMODE_AFFINE || tmode > TMODE_FISH) return (int)cudaErrorInvalidValue;
  if (facet < 0 || facet >= NO_CHAMPION) return (int)cudaErrorInvalidValue;
  if (!chain_list_ok(blocks, n_blocks)) return (int)cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return 0;
  if ((height + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  ChampParams p;
  p.height = height; p.width = width;
  p.row0 = row0; p.face_rows = face_rows; p.tmode = tmode;
  p.nfx = (tmode == TMODE_SPH || tmode == TMODE_CYL) ? 2 : 1;
  p.nfy = tmode == TMODE_SPH ? 2 : 1;
  p.n_taps = spread == nullptr ? 0 : n_taps;
  p.precise = precise; p.tap_valid = tap_valid;
  p.facet = facet; p.recip_step = recip_step;
  if (!set_pickup(p.pick, ipick, fpick)) return (int)cudaErrorInvalidValue;
  if (spread != nullptr && (n_taps < 1 || n_taps > MAX_TAPS))
    return (int)cudaErrorInvalidValue;
  if (tap_valid && (spread == nullptr || p.pick.smode != SMODE_MOUNT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * p.n_taps * sizeof(float);
  const dim3 grid = chain_grid(blocks, n_blocks, height, width);
  if (p.n_taps == 0)
    champion_kernel<false><<<grid, dim3(BLOCK_X, BLOCK_Y), 0,
                             (cudaStream_t)stream>>>(
        best, champ, xfeat, yfeat, bmats, spread, blocks, p);
  else
    champion_kernel<true><<<grid, dim3(BLOCK_X, BLOCK_Y), smem,
                            (cudaStream_t)stream>>>(
        best, champ, xfeat, yfeat, bmats, spread, blocks, p);
  return (int)cudaGetLastError();
}

// Plain C entry point of the champion lists: from the finished
// (n_planes, H, W) uint8 ``champ`` planes, for each facet f <
// ``n_facets`` (<= 255) the window's 32x8 blocks in which f champions
// some pixel at some plane, as indices by * ceil(W / 32) + bx in
// ascending order at ``blocks`` + f n and their number at ``count`` +
// f (n the window's blocks; ``blocks`` has room for n_facets n ints,
// ``count`` for n_facets, ``flags`` is n_facets n bytes of device
// scratch). Returns cudaGetLastError() after the two launches, or
// cudaErrorInvalidValue for an unsupported argument.
extern "C" int envutil_champion_lists(
    const unsigned char* champ, unsigned char* flags, int* blocks,
    int* count, long long height, long long width, int n_planes,
    int n_facets, void* stream) {
  if (height <= 0 || width <= 0 || n_planes < 1) return (int)cudaErrorInvalidValue;
  if (n_facets < 1 || n_facets > NO_CHAMPION) return (int)cudaErrorInvalidValue;
  const int64_t nby = (height + BLOCK_Y - 1) / BLOCK_Y;
  const int64_t nbx = (width + BLOCK_X - 1) / BLOCK_X;
  if (nby > 65535 || nby * nbx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  champion_flags_kernel<<<frame_grid(height, width), dim3(BLOCK_X, BLOCK_Y),
                          0, s>>>(champ, flags, height, width, n_planes,
                                  n_facets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  list_kernel<LIST_THREADS><<<n_facets, LIST_THREADS, 0, s>>>(
      flags, blocks, count, nby * nbx);
  return (int)cudaGetLastError();
}
