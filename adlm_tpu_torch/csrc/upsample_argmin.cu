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
// upsampled (B, H, W, P) tensor ever existing in memory.  On request it
// also writes the winning value, min_p bilinear_up(dist)[b, y, x, p]
// (B, H, W) f32: the running best the argmin keeps anyway (the TPU
// kernel's bs_ref), one more store per output pixel.  A tensor-parallel
// head's rank calls it on its slice of the prototypes and combines the
// (value, index) pairs across ranks; each value is the whole-bank
// launch's blend of that prototype bit for bit, since nothing in a
// prototype's arithmetic depends on the others.
//
// A launch may cover an output-row window [o0, o0 + rows) of the whole
// (H, W) result alone, from a slab of the map: rows [y_first,
// y_first + hs) of its h rows.  The coordinates stay the whole map's, so
// a window's rows equal the same rows of the whole-frame launch (o0 = 0,
// rows = H, y_first = 0, hs = h) bit for bit.  Spatial eval runs it so,
// each rank on its own label rows.
//
// Arithmetic: exact float32 in the order of the plain version
// (adlm_tpu_torch/ops/upsample_argmin.py::upsampled_argmin_reference):
// source coordinate (o + 0.5) * float32(h / H) - 0.5 clipped to
// [0, h - 1], then the x blend of each tap row, then the y blend.  Every
// product and sum goes through __fmul_rn / __fadd_rn, so nvcc cannot
// contract them to FMA, and the result is bit-equal to the plain
// version.  bf16 maps are widened to f32 (exact) at the x blend.
//
// Bound on an H100: the separable blend needs 3·P·W·(h + H) operations
// per image plus P·H·W compares, on 4·h·w·P bytes read and 4·H·W
// written.  None of them fuse, so each is one lane-instruction and the
// f32 instruction rate (132 SMs x 128 lanes per clock) bounds it.
// Tensor cores do not serve: TF32 is not bit-equal to this blend.
//
// Design: separable and register-tiled, like the TPU kernel's x pass
// once per W block, then a y pass per row block.
//
// * A CTA owns a kTH x kTW (64 x 32) output tile of one image: 8 warps,
//   one per group of kR = 8 output rows, a lane per output column.
//   Where the source box of such a tile does not fit shared memory (a
//   downsample past about 2x), the launcher shrinks the tile (th rows,
//   tw columns) until it does; the lanes and warps past it repeat its
//   last column and row and write nothing.  It
//   walks the prototypes in chunks of pc (up to 64; 3 chunks at the
//   flagship P = 190).  For each chunk it stages the source box its
//   tile reads (rows x cols pixels x pc prototypes; 11 x 7 at the
//   flagship 129 -> 1024, 257 -> 2048 scale) in shared memory with
//   16-byte cp.async copies.  A bf16 box stays bf16 (half the bytes).
// * x pass: fx[r][p][ox] for every staged row r and every output
//   column ox of the tile, once per CTA, into shared memory.  This
//   removes the repetition of the x blend for the ~8 output rows that
//   share a source row.  The box is free once it is done, so the next
//   chunk's box is loaded while the y pass runs.
// * y pass: a thread owns one output column and kR consecutive output
//   rows, with kR running (best, arg) pairs in registers.  Where its kR
//   rows read at most two adjacent tap pairs (y0 in {s, s + 1}: any
//   upsampling by 7x or more), it loads the three fx rows s, s + 1,
//   s + 2 once per prototype and blends all kR outputs from them
//   (y_pass_pair, specialised on the row where y0 steps): 3 shared
//   loads per 8 outputs.  Otherwise (downsampling, small factors) it
//   reads each output's two fx values (y_pass_rows).  A warp is one
//   row group, so the choice is the same for all its lanes.
//
// The sizes are the fastest of those timed on an H100: two barriers per
// chunk cost more than occupancy gains, so the launcher picks the
// largest chunk that leaves two CTAs per SM.  It sizes the box by a
// bound on any tile's extent (stage_extent), so the coordinate rule
// exists once, on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;             // output columns per tile: one per lane
constexpr int kR = 8;               // output rows per thread
constexpr int kGroups = 8;          // row groups (warps) per tile
constexpr int kTH = kR * kGroups;   // output rows per tile
constexpr int kThreads = kTW * kGroups;
constexpr int kBlocksPerSM = 2;
constexpr int kMaxChunk = 64;
constexpr int kSegLanes = 8;        // staging lanes per box pixel
// shared memory per CTA: what kBlocksPerSM CTAs per SM leave each
// (228 KB per SM, 1 KB of it reserved per CTA, 0.5 KB margin), and the
// most an H100 block may opt in to (for boxes that fit few prototypes)
constexpr int kSmemTarget = 228 * 1024 / kBlocksPerSM - 1536;
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// (o + 0.5) * scale - 0.5, rounded at every step, clipped to [0, n - 1]
__device__ __forceinline__ float src_coord(int o, float scale, int n) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), scale), 0.5f);
  return fminf(fmaxf(s, 0.f), static_cast<float>(n - 1));
}

// output row oy's tap rows (relative to box row 0 = source row ty0) and
// the weight of its high tap
__device__ __forceinline__ float y_taps(int oy, float scale_y, int h, int ty0, int& ka,
                                        int& kb) {
  const float sy = src_coord(oy, scale_y, h);
  const int y0 = static_cast<int>(floorf(sy));
  ka = y0 - ty0;
  kb = min(y0 + 1, h - 1) - ty0;
  return __fsub_rn(sy, static_cast<float>(y0));
}

// a * va + b * wa, each step rounded
__device__ __forceinline__ float blend(float a, float va, float b, float wa) {
  return __fadd_rn(__fmul_rn(a, va), __fmul_rn(b, wa));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Elements of T from a pixel's slot start to element p0 of its chunk:
// the copies move whole aligned 16-byte segments, so the chunk starts
// where its first element sits in its segment.
template <typename T>
__device__ __forceinline__ int seg_shift(const T* first) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(first) & 15) / sizeof(T));
}

// Stage prototypes [p0, p0 + np) of every box pixel into `box`: the
// aligned 16-byte segments that hold them, kSegLanes lanes per pixel.
// The slot of pixel q starts at word q * slot_w.  The first and last
// segments may reach up to 15 bytes past the chunk, never past the
// aligned 16-byte segments that hold its own bytes, and so never out
// of the allocation (device allocations are 256-byte aligned granules).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, const int* pix_off,
                                      uint32_t* box, int npix, int p0, int np,
                                      int slot_w, int tid) {
  for (int q = tid / kSegLanes; q < npix; q += kThreads / kSegLanes) {
    const T* first = src + pix_off[q] + p0;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15);
    const uintptr_t hi = reinterpret_cast<uintptr_t>(first + np);
    const int nseg = static_cast<int>((hi - lo + 15) >> 4);
    uint32_t* slot = box + q * slot_w;
    for (int k = tid % kSegLanes; k < nseg; k += kSegLanes) {
      cp_async16(slot + 4 * k, reinterpret_cast<const void*>(lo + 16 * k));
    }
  }
}

// y pass where rows [0, kSplit) of the thread blend fx rows (k0, k1)
// and rows [kSplit, kR) blend (k1, k2): three loads per prototype.
// fx points at the thread's column of fx[r][p][ox].
template <int kSplit>
__device__ __forceinline__ void y_pass_pair(const float* fx, int np, int p0, int k0,
                                            int k1, int k2, const float (&vy)[kR],
                                            const float (&wy)[kR], float (&best)[kR],
                                            int (&arg)[kR]) {
  const float* f0 = fx + k0 * np * kTW;
  const float* f1 = fx + k1 * np * kTW;
  const float* f2 = fx + k2 * np * kTW;
#pragma unroll 4
  for (int j = 0; j < np; ++j) {
    const float a = f0[j * kTW];
    const float b = f1[j * kTW];
    const float c = kSplit < kR ? f2[j * kTW] : 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float up = i < kSplit ? blend(a, vy[i], b, wy[i]) : blend(b, vy[i], c, wy[i]);
      if (up < best[i]) {
        best[i] = up;
        arg[i] = p0 + j;
      }
    }
  }
}

// y pass with each row's own fx rows: two loads per output and prototype.
// Rows oy0 .. oy0 + kR - 1 (clipped to the tile's last row ly); their
// taps are computed again here rather than held in registers by every
// thread.
__device__ __forceinline__ void y_pass_rows(const float* fx, int np, int p0, int oy0,
                                            int ly, float scale_y, int h, int ty0,
                                            const float (&vy)[kR], const float (&wy)[kR],
                                            float (&best)[kR], int (&arg)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    int ka, kb;
    y_taps(min(oy0 + i, ly), scale_y, h, ty0, ka, kb);
    const float* fa = fx + ka * np * kTW;
    const float* fb = fx + kb * np * kTW;
    for (int j = 0; j < np; ++j) {
      const float up = blend(fa[j * kTW], vy[i], fb[j * kTW], wy[i]);
      if (up < best[i]) {
        best[i] = up;
        arg[i] = p0 + j;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
upsample_argmin_kernel(const T* __restrict__ dist, int32_t* __restrict__ out,
                       float* __restrict__ val, int h, int w, int p, int H, int W, int o0, int o_end,
                       int y_first, int hs, int th, int tw, float scale_y,
                       float scale_x, int ext_h, int ext_w, int pc, int slot_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [box: ext_h*ext_w*slot_w words][fx: ext_h * pc * kTW floats]
  // [pixel offsets: ext_h*ext_w int]
  uint32_t* box = reinterpret_cast<uint32_t*>(smem);
  float* fx = reinterpret_cast<float*>(box + ext_h * ext_w * slot_w);
  int* pix_off = reinterpret_cast<int*>(fx + ext_h * pc * kTW);

  const int b = blockIdx.z;
  const int by = o0 + blockIdx.y * th, bx = blockIdx.x * tw;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  // the tile's last output row and column
  const int ly = min(by + th, o_end) - 1, lx = min(bx + tw, W) - 1;

  // the source rows / columns the tile reads: from the low tap of its
  // first output row / column to the high tap of its last
  const int ty0 = static_cast<int>(floorf(src_coord(by, scale_y, h)));
  const int tx0 = static_cast<int>(floorf(src_coord(bx, scale_x, w)));
  const int ty1 = static_cast<int>(floorf(src_coord(ly, scale_y, h)));
  const int tx1 = static_cast<int>(floorf(src_coord(lx, scale_x, w)));
  const int rows = min(ty1 + 1, h - 1) - ty0 + 1;
  const int cols = min(tx1 + 1, w - 1) - tx0 + 1;
  const int npix = rows * cols;

  const T* src = dist + static_cast<int64_t>(b) * hs * w * p;
  for (int q = tid; q < npix; q += kThreads) {
    const int r = q / cols;  // once per box pixel and CTA
    pix_off[q] = ((ty0 - y_first + r) * w + tx0 + (q - r * cols)) * p;
  }

  // this thread's column (threads past the tile compute its last
  // column's and write nothing): its x taps, relative to the box
  const float sx = src_coord(min(bx + tx, lx), scale_x, w);
  const int x0 = static_cast<int>(floorf(sx));
  const float wx = __fsub_rn(sx, static_cast<float>(x0));
  const float vx = __fsub_rn(1.f, wx);
  const int cx0 = x0 - tx0, cx1 = min(x0 + 1, w - 1) - tx0;

  // its kR rows (past the tile: its last row's): y taps relative to the
  // box, and whether they read two adjacent tap pairs only
  const int oy0 = by + ty * kR;
  float vy[kR], wy[kR];
  int split = 0, k0 = 0, k1 = 0, k2 = 0;
  bool paired = true;  // rows [0, split) read (k0, k1), the rest (k1, k2)
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    int ka, kb;
    wy[i] = y_taps(min(oy0 + i, ly), scale_y, h, ty0, ka, kb);
    vy[i] = __fsub_rn(1.f, wy[i]);
    if (i == 0) {
      k0 = ka;
      k1 = kb;
      k2 = min(ty0 + ka + 2, h - 1) - ty0;
    }
    const bool low = ka == k0 && kb == k1;
    split += low;
    paired &= low ? split == i + 1 : (ka == k1 && kb == k2);
  }

  float best[kR];
  int arg[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }

  const int slot_t = slot_w * static_cast<int>(4 / sizeof(T));  // slot stride in T
  const int n_chunks = (p + pc - 1) / pc;
  const T* tbox = reinterpret_cast<const T*>(box);
  __syncthreads();  // pix_off
  stage(src, pix_off, box, npix, 0, min(pc, p), slot_w, tid);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int p0 = c * pc;
    const int np = min(pc, p - p0);
    cp_async_wait_all();
    __syncthreads();  // chunk c staged; chunk c - 1's y pass done with fx

    // x pass: fx[r][j][tx] for every box row r and prototype j
    for (int r = 0; r < rows; ++r) {
      const int q0 = r * cols + cx0, q1 = r * cols + cx1;
      const T* s0 = tbox + q0 * slot_t + seg_shift(src + pix_off[q0] + p0);
      const T* s1 = tbox + q1 * slot_t + seg_shift(src + pix_off[q1] + p0);
      float* f = fx + r * np * kTW + tx;
      for (int j = ty; j < np; j += kGroups) {
        f[j * kTW] = blend(widen(s0[j]), vx, widen(s1[j]), wx);
      }
    }
    __syncthreads();  // fx complete; the box is free

    // the next chunk's box lands while this one's y pass runs
    if (c + 1 < n_chunks) {
      stage(src, pix_off, box, npix, p0 + pc, min(pc, p - p0 - pc), slot_w, tid);
      cp_async_commit();
    }
    if (paired) {
      switch (split) {
        case 1: y_pass_pair<1>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        case 2: y_pass_pair<2>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        case 3: y_pass_pair<3>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        case 4: y_pass_pair<4>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        case 5: y_pass_pair<5>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        case 6: y_pass_pair<6>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        case 7: y_pass_pair<7>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
        default: y_pass_pair<kR>(fx + tx, np, p0, k0, k1, k2, vy, wy, best, arg); break;
      }
    } else {
      y_pass_rows(fx + tx, np, p0, oy0, ly, scale_y, h, ty0, vy, wy, best, arg);
    }
  }

  const int ox = bx + tx;
  if (ox <= lx) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int oy = oy0 + i;
      if (oy <= ly) {
        const int64_t at = (static_cast<int64_t>(b) * (o_end - o0) + oy - o0) * W + ox;
        out[at] = arg[i];
        if (val != nullptr) val[at] = best[i];
      }
    }
  }
}

// Rows (or columns) of shared memory that hold the source extent of
// any tile of `tile` outputs.  The coordinates of its first and last
// outputs lie span = (tile - 1) * n_in / n_out apart, so the tile reads
// at most ceil(span) + 2 rows (the floors, plus the last output's high
// tap); one more row absorbs the f32 rounding of the coordinates.
int stage_extent(int tile, int n_in, int n_out) {
  const long long span = (static_cast<long long>(tile - 1) * n_in + n_out - 1) / n_out;
  return static_cast<int>(span + 3 < n_in ? span + 3 : n_in);
}

// Shared memory of one CTA for chunks of pc prototypes, and the words of
// one pixel's slot in the box: the 16-byte segments that hold a chunk
// starting anywhere in its first segment, an odd count of them, so that
// the x pass's reads of up to 8 neighbouring pixels fall in different
// banks.
size_t smem_bytes(int pc, int elem, int ext_h, int ext_w, int* slot_w) {
  const int segs = ((16 - elem + pc * elem + 15) / 16) | 1;
  *slot_w = 4 * segs;
  const size_t pix = static_cast<size_t>(ext_h) * ext_w;
  return pix * *slot_w * 4 + static_cast<size_t>(ext_h) * pc * kTW * 4 + pix * 4;
}

template <typename T>
int launch(const void* dist, int32_t* out, float* val, int b, int h, int w, int p, int H, int W,
           int o0, int rows, int y_first, int hs, cudaStream_t stream) {
  // float32(h / H), as the plain version computes it
  const float scale_y = static_cast<float>(static_cast<double>(h) / H);
  const float scale_x = static_cast<float>(static_cast<double>(w) / W);
  // the whole tile where its box fits (every upsample); else halve the
  // tile's rows (down to one warp's kR) or columns, whichever spans more
  // source, until it does
  int th = kTH, tw = kTW, ext_h, ext_w, pc, slot_w = 0;
  size_t smem;
  for (;;) {
    ext_h = stage_extent(th, h, H);
    ext_w = stage_extent(tw, w, W);
    pc = p < kMaxChunk ? p : kMaxChunk;
    while (pc > 1 && smem_bytes(pc, sizeof(T), ext_h, ext_w, &slot_w) > kSmemTarget) --pc;
    smem = smem_bytes(pc, sizeof(T), ext_h, ext_w, &slot_w);
    if (smem <= kSmemMax) break;
    if (th > kR && (ext_h >= ext_w || tw == 1)) {
      th /= 2;
    } else if (tw > 1) {
      tw /= 2;
    } else {
      return cudaErrorInvalidValue;  // one row group of one column reads too much
    }
  }
  auto kernel = upsample_argmin_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + tw - 1) / tw, (rows + th - 1) / th, b);
  const dim3 block(kTW, kGroups);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(dist), out, val, h, w, p, H, W, o0,
                                        o0 + rows, y_first, hs, th, tw, scale_y, scale_x,
                                        ext_h, ext_w, pc, slot_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dist: (b, hs, w, p) f32 or bf16 (bf16 != 0), contiguous: rows
// [y_first, y_first + hs) of a (b, h, w, p) map, which must hold every
// row that output rows [o0, o0 + rows) read; out: (b, rows, W) int32,
// rows [o0, o0 + rows) of the (b, H, W) result; val: null, or (b, rows,
// W) f32 for the winning values.  The whole frame is (o0, rows, y_first,
// hs) = (0, H, 0, h).  Returns a cudaError_t (0 on a successful launch).
int adlm_upsample_argmin(const void* dist, int bf16, int32_t* out, float* val, int b, int h,
                         int w, int p, int H, int W, int o0, int rows, int y_first,
                         int hs, void* stream) {
  if (b <= 0 || rows <= 0 || W <= 0) return cudaSuccess;
  if (h <= 0 || w <= 0 || p <= 0 || hs <= 0 || o0 < 0 || o0 + rows > H || y_first < 0 ||
      y_first + hs > h)
    return cudaErrorInvalidValue;
  // the kernel indexes one image's elements with int
  if (static_cast<long long>(hs) * w * p > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(dist, out, val, b, h, w, p, H, W, o0, rows, y_first, hs, s)
              : launch<float>(dist, out, val, b, h, w, p, H, W, o0, rows, y_first, hs, s);
}

const char* adlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
