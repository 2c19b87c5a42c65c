// Fused FAST-9/16 corner strength + strict 3x3 non-max suppression, for sm_90a.
//
// Replaces the Pallas TPU kernel slam_framework_tpu/ops/fast_pallas.py
// (fast_nms_strength). Computes exactly ops/fast.py's
//   nms3x3(fast_strength_map(img))
// on the WHOLE image: strength = max(max_i min_arc9(d), -min_i max_arc9(d)) over
// the 16 Bresenham-circle differences d = I(p + o) - I(p), with edge-replicated
// reads outside the image, then keep only strict maxima of the 3x3
// neighbourhood (neighbours outside the image count as -inf), else 0.
//
// Bound: device memory. Each pixel is read once (plus an 8 px halo per 32 px
// tile, served mostly from L1/L2) and written once: ~8 bytes per pixel, about
// 5 MB for the 16 pyramid images of a 1241x376 stereo frame. The arithmetic is
// ~300 min/max/sub per pixel, far below the card's rate for such traffic.
//
// Design: one thread block per 32x32 output tile of one image. The block loads
// a (32+8) x (32+8) fp32 tile (halo 4 = 3 px circle + 1 px NMS ring) into shared
// memory with clamped indices, which reproduces the reference's edge padding.
// It computes the strength on the tile plus a 1 px ring into a second shared
// array (-inf outside the image), then each output pixel compares against its
// 8 neighbours there. No TPU strip layout or column wrap is carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IN = TILE + 2 * HALO;  // 40
constexpr int SW = TILE + 2;         // strength tile with a 1 px ring
constexpr int BX = 32;
constexpr int BY = 8;

__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void __launch_bounds__(BX * BY)
fast_nms_kernel(const float* __restrict__ imgs, float* __restrict__ out, int H, int W) {
  __shared__ float tile[IN][IN];
  __shared__ float strength[SW][SW];

  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const size_t plane = (size_t)H * (size_t)W;
  const float* img = imgs + (size_t)blockIdx.z * plane;
  float* dst = out + (size_t)blockIdx.z * plane;
  const int tid = threadIdx.y * BX + threadIdx.x;

  // 1. clamped tile load: tile[r][c] = img[clamp(y0 - HALO + r), clamp(x0 - HALO + c)]
  for (int i = tid; i < IN * IN; i += BX * BY) {
    const int r = i / IN;
    const int c = i % IN;
    const int y = min(max(y0 - HALO + r, 0), H - 1);
    const int x = min(max(x0 - HALO + c, 0), W - 1);
    tile[r][c] = img[(size_t)y * W + x];
  }
  __syncthreads();

  // 2. strength on the tile + 1 px ring: strength[sy][sx] is image pixel
  //    (y0 - 1 + sy, x0 - 1 + sx), centred at tile[sy + 3][sx + 3]
  for (int i = tid; i < SW * SW; i += BX * BY) {
    const int sy = i / SW;
    const int sx = i % SW;
    const int y = y0 - 1 + sy;
    const int x = x0 - 1 + sx;
    if (y < 0 || y >= H || x < 0 || x >= W) {
      strength[sy][sx] = -INFINITY;
      continue;
    }
    const float c = tile[sy + 3][sx + 3];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[sy + 3 + kCircleDy[k]][sx + 3 + kCircleDx[k]] - c;
    float bright = -INFINITY;  // max over arcs of the arc minimum
    float dark_neg = INFINITY;  // min over arcs of the arc maximum
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float lo = d[k];
      float hi = d[k];
#pragma unroll
      for (int j = 1; j < 9; ++j) {
        lo = fminf(lo, d[(k + j) & 15]);
        hi = fmaxf(hi, d[(k + j) & 15]);
      }
      bright = fmaxf(bright, lo);
      dark_neg = fminf(dark_neg, hi);
    }
    strength[sy][sx] = fmaxf(bright, -dark_neg);
  }
  __syncthreads();

  // 3. strict 3x3 NMS, one output pixel per thread per step
  for (int i = tid; i < TILE * TILE; i += BX * BY) {
    const int oy = i / TILE;
    const int ox = i % TILE;
    const int y = y0 + oy;
    const int x = x0 + ox;
    if (y >= H || x >= W) continue;
    const float s = strength[oy + 1][ox + 1];
    float m = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        m = fmaxf(m, strength[oy + 1 + dy][ox + 1 + dx]);
      }
    }
    dst[(size_t)y * W + x] = s > m ? s : 0.0f;
  }
}

}  // namespace

// imgs, out: (B, H, W) contiguous fp32 on the device. Launches on `stream`
// without synchronising; returns cudaGetLastError() of the launch.
extern "C" int fast_nms_strength_launch(const float* imgs, float* out, int B, int H, int W,
                                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(BX, BY);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(imgs, out, H, W);
  return (int)cudaGetLastError();
}
