// Fused bilinear upsample + argmin over prototypes for Hopper (sm_90a).
//
// Replaces the TPU kernel adlm_tpu/ops/upsample_argmin.py::_kernel
// (launched by upsampled_argmin_pallas).  For distance maps
// dist (B, h, w, P) it writes
//
//   out[b, y, x] = argmin_p bilinear_up(dist)[b, y, x, p]    (B, H, W) int32
//
// with half-pixel source coordinates (torch align_corners=False) and
// first-occurrence ties (strict < in ascending p), without the
// upsampled (B, H, W, P) tensor ever existing in memory.
//
// Arithmetic: each output pixel blends its 4 taps in exact float32, in
// the order of the plain version (adlm_tpu_torch/ops/upsample_argmin.py,
// a port of the JAX scan's 4-tap branch): source coordinate
// (o + 0.5) * float32(h / H) - 0.5 clipped to [0, h - 1], then the x
// blend of each tap row, then the y blend.  Every product and sum goes
// through __fmul_rn / __fadd_rn, so nvcc cannot contract them to FMA,
// and the result is bit-equal to the plain version.  bf16 maps are
// widened to f32 (exact) and take the same exact blend.
//
// Design (simple first): one thread per output pixel, a CTA per
// kTH x kTW output tile.  The CTA stages the source pixels its tile
// reads (its first and last rows' taps, from the same src_coord) for a
// chunk of pc prototypes in shared memory, P-major, loaded with
// consecutive threads on consecutive prototypes; each thread keeps its
// running (min, argmin) in registers across chunks.  The launcher sizes
// the planes by a bound on any tile's extent (stage_extent), so the
// coordinate rule exists once, on the device.
//
// Bound on an H100: the separable form of the blend needs
// 3·P·W·(h + H) f32 operations per image plus P·H·W compares, on
// 4·h·w·P bytes read and 4·H·W written, so the f32 rate bounds it.
// This version blends all four taps per output pixel (about 3x the
// separable count) and reads four shared-memory operands per blend.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;
constexpr int kTH = 8;
// shared memory staged per block (the default limit, no opt-in)
constexpr int kStageBytes = 48 * 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// (o + 0.5) * scale - 0.5, rounded at every step, clipped to [0, n - 1]
__device__ __forceinline__ float src_coord(int o, float scale, int n) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), scale), 0.5f);
  return fminf(fmaxf(s, 0.f), static_cast<float>(n - 1));
}

template <typename T>
__global__ void __launch_bounds__(kTW* kTH)
upsample_argmin_kernel(const T* __restrict__ dist, int32_t* __restrict__ out,
                       int h, int w, int p, int H, int W, float scale_y,
                       float scale_x, int ext_h, int ext_w, int pc) {
  extern __shared__ float tile[];  // (pc, ext_h, ext_w)
  const int b = blockIdx.z;
  const int by = blockIdx.y * kTH, bx = blockIdx.x * kTW;
  const int oy = by + threadIdx.y;
  const int ox = bx + threadIdx.x;
  const int tid = threadIdx.y * kTW + threadIdx.x;

  // the source rows / columns the tile reads: from the low tap of its
  // first output row / column to the high tap of its last
  const int ty0 = static_cast<int>(floorf(src_coord(by, scale_y, h)));
  const int tx0 = static_cast<int>(floorf(src_coord(bx, scale_x, w)));
  const int ty1 = static_cast<int>(floorf(src_coord(min(by + kTH - 1, H - 1), scale_y, h)));
  const int tx1 = static_cast<int>(floorf(src_coord(min(bx + kTW - 1, W - 1), scale_x, w)));
  const int rows = min(ty1 + 1, h - 1) - ty0 + 1;
  const int cols = min(tx1 + 1, w - 1) - tx0 + 1;

  // this pixel's taps and weights (threads past the edge compute the
  // last pixel's and write nothing)
  const float sy = src_coord(min(oy, H - 1), scale_y, h);
  const float sx = src_coord(min(ox, W - 1), scale_x, w);
  const int y0 = static_cast<int>(floorf(sy));
  const int x0 = static_cast<int>(floorf(sx));
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);
  const float wy = __fsub_rn(sy, static_cast<float>(y0));
  const float wx = __fsub_rn(sx, static_cast<float>(x0));
  const float vy = __fsub_rn(1.f, wy);
  const float vx = __fsub_rn(1.f, wx);
  const int t00 = (y0 - ty0) * ext_w + (x0 - tx0);
  const int t01 = (y0 - ty0) * ext_w + (x1 - tx0);
  const int t10 = (y1 - ty0) * ext_w + (x0 - tx0);
  const int t11 = (y1 - ty0) * ext_w + (x1 - tx0);
  const int plane = ext_h * ext_w;

  const T* src = dist + static_cast<int64_t>(b) * h * w * p;
  float best = INFINITY;
  int arg = 0;
  for (int p0 = 0; p0 < p; p0 += pc) {
    const int np = min(pc, p - p0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < rows * cols * np; i += kTW * kTH) {
      const int j = i % np;
      const int rc = i / np;
      const int r = rc / cols, cc = rc - r * cols;
      tile[j * plane + r * ext_w + cc] =
          widen(src[(static_cast<int64_t>(ty0 + r) * w + (tx0 + cc)) * p + p0 + j]);
    }
    __syncthreads();
    for (int j = 0; j < np; ++j) {
      const float* t = tile + j * plane;
      const float fx0 = __fadd_rn(__fmul_rn(t[t00], vx), __fmul_rn(t[t01], wx));
      const float fx1 = __fadd_rn(__fmul_rn(t[t10], vx), __fmul_rn(t[t11], wx));
      const float up = __fadd_rn(__fmul_rn(fx0, vy), __fmul_rn(fx1, wy));
      if (up < best) {
        best = up;
        arg = p0 + j;
      }
    }
  }
  if (oy < H && ox < W) {
    out[(static_cast<int64_t>(b) * H + oy) * W + ox] = arg;
  }
}

}  // namespace

extern "C" {

// Rows (or columns) of shared memory that hold the source extent of
// any tile of `tile` outputs.  The coordinates of its first and last
// outputs lie span = (tile - 1) * n_in / n_out apart, so the tile reads
// at most ceil(span) + 2 rows (the floors, plus the last output's high
// tap); one more row absorbs the f32 rounding of the coordinates.
static int stage_extent(int tile, int n_in, int n_out) {
  const long long span = (static_cast<long long>(tile - 1) * n_in + n_out - 1) / n_out;
  return static_cast<int>(span + 3 < n_in ? span + 3 : n_in);
}

// dist: (b, h, w, p) f32 or bf16 (bf16 != 0), contiguous; out: (b, H, W)
// int32.  Returns a cudaError_t (0 on a successful launch).
int adlm_upsample_argmin(const void* dist, int bf16, int32_t* out, int b, int h,
                         int w, int p, int H, int W, void* stream) {
  if (b <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  if (h <= 0 || w <= 0 || p <= 0) return cudaErrorInvalidValue;
  // float32(h / H), as the plain version computes it
  const float scale_y = static_cast<float>(static_cast<double>(h) / H);
  const float scale_x = static_cast<float>(static_cast<double>(w) / W);
  const int ext_h = stage_extent(kTH, h, H);
  const int ext_w = stage_extent(kTW, w, W);
  const int fit = kStageBytes / static_cast<int>(sizeof(float) * ext_h * ext_w);
  const int pc = fit < p ? fit : p;
  if (pc < 1) return cudaErrorInvalidValue;  // one tile reads too much source
  const size_t smem = sizeof(float) * static_cast<size_t>(pc) * ext_h * ext_w;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, b);
  const dim3 block(kTW, kTH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    upsample_argmin_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(dist), out, h, w, p, H, W, scale_y,
        scale_x, ext_h, ext_w, pc);
  } else {
    upsample_argmin_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(dist), out, h, w, p, H, W, scale_y, scale_x,
        ext_h, ext_w, pc);
  }
  return cudaGetLastError();
}

const char* adlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
