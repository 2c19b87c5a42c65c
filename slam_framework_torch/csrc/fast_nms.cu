// Fused FAST-9/16 corner strength + strict 3x3 non-max suppression for sm_90a:
// every image of a stereo frame's two pyramids in ONE launch.
//
// Replaces the Pallas TPU kernel slam_framework_tpu/ops/fast_pallas.py
// (fast_nms_strength -> _batched_impl, the repository's only pallas_call).
// Computes exactly ops/fast.py's
//   nms3x3(fast_strength_map(img))
// on the WHOLE image, for each image of a list of images of different sizes:
// strength = max(max_i min_arc9(d), -min_i max_arc9(d)) over the 16
// Bresenham-circle differences d = I(p + o) - I(p), with edge-replicated reads
// outside the image, then only strict maxima of the 3x3 neighbourhood are kept
// (neighbours outside the image count as -inf), everything else is 0.
//
// Bound, per 1241x376 stereo frame (8 levels at scale 1.2, both images:
// 2 x 1,444,097 = 2,888,194 pixels):
//   bytes       4 B read + 4 B written per pixel = 23.1 MB, 6.9 us at 3.35 TB/s;
//   operations  2 subtractions + 94 two-input arc min/max + 1 max + 6 for the
//               NMS = 103 fp32 operations per pixel, 0.297 G per frame, 8.9 us
//               at 33.5 T simple fp32 operations/s (67 TFLOP/s counts an FMA as 2).
// Operations bind, not memory. On this card min, max and compare run at half
// the rate of add/multiply (64 instead of 128 lanes per clock and SM), so a
// kernel that is nothing but min/max cannot get under about twice the bound.
//
// What the design does about it:
//  - Arithmetic. Rounding is monotone, so min_k fl(a_k - c) = fl(min_k a_k - c):
//    the arcs are folded over the raw circle pixels a_k and the centre is
//    subtracted twice at the end, not sixteen times at the start. Each window
//    of 8 starting at an odd k serves the two 9-arcs that contain it:
//      max(min(w8[k], a[k-1]), min(w8[k], a[k+8])) = min(w8[k], max(a[k-1], a[k+8]))
//    so eight windows cover all 16 arcs: 47 two-input min/max per branch, 94
//    per pixel, against 256 for folding every arc from scratch.
//  - Three-input min/max. Hopper's DPX instructions (__vimin3_s32, __vimax3_s32)
//    take three operands at the rate of a two-input min, but only for
//    integers. The tile is therefore stored as order-preserving integer keys of
//    the fp32 pixels (made once per loaded pixel), the fold runs on keys, and
//    the three results are mapped back: 34 two-input + 38 three-input
//    instructions per pixel in place of 94. min and max only ever select one
//    of their inputs, so the result has the bits of the plain version (up to
//    the sign of a zero, which compares equal).
//  - One launch. The grid is a flat list of tiles over all images. The table
//    of images (pointers, size, tiles per row, first tile) is a __grid_constant__
//    kernel parameter, passed by value: no copy to the device, nothing to keep
//    alive, and the launch can be captured in a CUDA graph. A block finds its
//    image by a scan of at most 32 first-tile entries.
//  - One barrier, no division per item. A block of FAST_NMS_WARPS warps loads
//    a (TILE_H + 8) x (30 * WARPS + 8) input tile into shared memory with
//    clamped coordinates (= edge replication), one warp per row, one
//    128-byte-coalesced load per 32 columns. After the one __syncthreads(),
//    warp w owns a strip of 32 strength columns and walks down it: each lane
//    reads its 16 circle pixels at compile-time offsets from one moving shared
//    pointer, keeps the strength of three rows in registers, gets its left and
//    right neighbours by warp shuffle, and lanes 1..30 write 30 adjacent
//    outputs per row. Row and column come from threadIdx alone.
//  - Rows of the pyramid's images (1241, 1034, 862, ... floats) are not
//    16-byte aligned, so float4 accesses and TMA (whose global strides must be
//    multiples of 16 bytes) do not apply to these tensors as the pyramid makes
//    them; they are not padded for it, since bytes are not the limit here.
// Nothing of the TPU kernel's layout (32-row strips of a whole resident image,
// column wrap hidden by a border mask) is carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#if !defined(FAST_NMS_WARPS) || !defined(FAST_NMS_TILE_H)
#error "build with -DFAST_NMS_WARPS=<warps per block> -DFAST_NMS_TILE_H=<rows per tile> (ops/fast_cuda.py does)"
#endif

namespace {

constexpr int MAX_IMAGES = 32;  // entries of the by-value table; 32 x 32 B, far under the 4 KB limit
constexpr int WARPS = FAST_NMS_WARPS;
constexpr int LANE_OUT = 30;  // 32 strength columns per warp, less one NMS halo column per side
constexpr int TILE_W = LANE_OUT * WARPS;
constexpr int TILE_H = FAST_NMS_TILE_H;
constexpr int HALO = 4;  // 3 px circle + 1 px NMS ring
constexpr int IN_W = TILE_W + 2 * HALO;
constexpr int IN_H = TILE_H + 2 * HALO;
constexpr int LOADS_PER_ROW = (IN_W + 31) / 32;

struct Image {
  const float* src;
  float* dst;
  int height;
  int width;
  int tiles_x;     // tiles per row of tiles
  int first_tile;  // index of this image's first tile in the flat grid
};
static_assert(sizeof(Image) == 32, "the host fills this table as a packed array of 32-byte records");

struct Params {
  Image img[MAX_IMAGES];
  int n;
};

// Order-preserving map between fp32 bit patterns and signed integers (its own
// inverse): a < b as floats <=> ordered(a) < ordered(b) as ints, for all
// values but NaN; -0.0 sorts below +0.0, which compare equal as floats.
__device__ __forceinline__ int ordered(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

// FAST-9/16 strength of the pixel at `c` in the shared tile of ordered keys
// (row pitch IN_W).
__device__ __forceinline__ float strength_at(const int* __restrict__ c) {
#define FAST_PX(dy, dx) c[(dy) * IN_W + (dx)]
  // Bresenham circle of radius 3, clockwise from 12 o'clock
  const int a[16] = {
      FAST_PX(-3, 0), FAST_PX(-3, 1), FAST_PX(-2, 2), FAST_PX(-1, 3),
      FAST_PX(0, 3), FAST_PX(1, 3), FAST_PX(2, 2), FAST_PX(3, 1),
      FAST_PX(3, 0), FAST_PX(3, -1), FAST_PX(2, -2), FAST_PX(1, -3),
      FAST_PX(0, -3), FAST_PX(-1, -3), FAST_PX(-2, -2), FAST_PX(-3, -1)};
#undef FAST_PX
  // pairs starting at the odd positions k = 2i + 1
  int lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lo[i] = min(a[2 * i + 1], a[(2 * i + 2) & 15]);
    hi[i] = max(a[2 * i + 1], a[(2 * i + 2) & 15]);
  }
  // four pairs make the window of 8 from k; `before` = a[k-1] and `after` =
  // a[k+8] close it into the arcs from k - 1 and from k
  int arc_lo[8], arc_hi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int before = a[2 * i];
    const int after = a[(2 * i + 9) & 15];
    arc_lo[i] = __vimin3_s32(__vimin3_s32(lo[i], lo[(i + 1) & 7], lo[(i + 2) & 7]),
                             lo[(i + 3) & 7], max(before, after));
    arc_hi[i] = __vimax3_s32(__vimax3_s32(hi[i], hi[(i + 1) & 7], hi[(i + 2) & 7]),
                             hi[(i + 3) & 7], min(before, after));
  }
  // max over the 16 arcs of the arc's minimum, min over them of its maximum
  const int bright = __vimax3_s32(__vimax3_s32(arc_lo[0], arc_lo[1], arc_lo[2]),
                                  __vimax3_s32(arc_lo[3], arc_lo[4], arc_lo[5]),
                                  max(arc_lo[6], arc_lo[7]));
  const int dark = __vimin3_s32(__vimin3_s32(arc_hi[0], arc_hi[1], arc_hi[2]),
                                __vimin3_s32(arc_hi[3], arc_hi[4], arc_hi[5]),
                                min(arc_hi[6], arc_hi[7]));
  const float centre = __int_as_float(ordered(c[0]));
  return fmaxf(__int_as_float(ordered(bright)) - centre, centre - __int_as_float(ordered(dark)));
}

__global__ void __launch_bounds__(32 * WARPS)
fast_nms_kernel(const __grid_constant__ Params p) {
  __shared__ int tile[IN_H * IN_W];  // ordered keys of the pixels

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;

  // which image, which tile of it (one division per block)
  const int bid = blockIdx.x;
  int which = 0;
  while (which + 1 < p.n && bid >= p.img[which + 1].first_tile) ++which;
  const Image im = p.img[which];
  const int t = bid - im.first_tile;
  const int ty = t / im.tiles_x;
  const int tx = t - ty * im.tiles_x;
  const int H = im.height;
  const int W = im.width;
  const int x0 = tx * TILE_W;
  const int y0 = ty * TILE_H;
  const int rows = min(TILE_H, H - y0);  // output rows of this tile

  // 1. clamped load: tile[r][c] = src[clamp(y0 - HALO + r)][clamp(x0 - HALO + c)]
  int xs[LOADS_PER_ROW];
#pragma unroll
  for (int i = 0; i < LOADS_PER_ROW; ++i) xs[i] = min(max(x0 - HALO + lane + 32 * i, 0), W - 1);
  for (int r = warp; r < rows + 2 * HALO; r += WARPS) {
    const float* __restrict__ src_row = im.src + (size_t)min(max(y0 - HALO + r, 0), H - 1) * W;
#pragma unroll
    for (int i = 0; i < LOADS_PER_ROW; ++i) {
      if (lane + 32 * i < IN_W) tile[r * IN_W + lane + 32 * i] = ordered(__float_as_int(src_row[xs[i]]));
    }
  }
  __syncthreads();

  // 2. this warp's strip: lane l holds strength column x0 + 30 * warp + l - 1
  const int x = x0 + LANE_OUT * warp + lane - 1;
  if (x0 + LANE_OUT * warp >= W) return;  // the whole strip lies right of the image
  const bool inside = x >= 0 && x < W;
  const bool writes = lane >= 1 && lane <= LANE_OUT && x < W;
  // centre of strength row j (image row y0 + j) is tile row j + HALO
  const int* c = tile + (HALO - 1) * IN_W + LANE_OUT * warp + lane + HALO - 1;
  float* dst = im.dst + ((ptrdiff_t)y0 * W + x);  // x = -1 on lane 0 of the first strip, never written

  // strength of row j, -inf outside the image, and its horizontal maxima:
  // side = max(left, right), h = max(side, own)
  float s_mid, side_mid, h_mid, h_top;
#define FAST_ROW(j, s, side, h)                                          \
  {                                                                      \
    s = strength_at(c);                                                  \
    c += IN_W;                                                           \
    if (!inside || y0 + (j) < 0 || y0 + (j) >= H) s = -INFINITY;         \
    side = fmaxf(__shfl_up_sync(0xffffffffu, s, 1), __shfl_down_sync(0xffffffffu, s, 1)); \
    h = fmaxf(side, s);                                                  \
  }
  {
    float s, side;
    FAST_ROW(-1, s, side, h_top);
  }
  FAST_ROW(0, s_mid, side_mid, h_mid);
  for (int j = 1; j <= rows; ++j) {
    float s, side, h;
    FAST_ROW(j, s, side, h);
    // row j - 1 against its eight neighbours
    const float m = fmaxf(fmaxf(h_top, side_mid), h);
    if (writes) dst[0] = s_mid > m ? s_mid : 0.0f;
    dst += W;
    h_top = h_mid;
    s_mid = s;
    side_mid = side;
    h_mid = h;
  }
#undef FAST_ROW
}

}  // namespace

// images: n_images packed 32-byte records {src, dst, height, width, tiles_x,
// first_tile} in HOST memory (device pointers inside), n_tiles their summed
// tile count. The records are copied into the kernel's parameter, so the
// caller may reuse the buffer as soon as this returns. Launches on `stream`
// without synchronising; returns cudaGetLastError() of the launch.
extern "C" int fast_nms_strength_launch(const void* images, int n_images, int n_tiles, void* stream) {
  if (images == nullptr || n_images <= 0 || n_images > MAX_IMAGES || n_tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  memcpy(p.img, images, (size_t)n_images * sizeof(Image));
  p.n = n_images;
  fast_nms_kernel<<<n_tiles, dim3(32, WARPS), 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
