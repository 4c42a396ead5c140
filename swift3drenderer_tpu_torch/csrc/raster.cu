// The raster kernels of the port: visibility, deferred shading and nearest
// texel fetch of one frame, fused in one launch.
//
// Both replace swift3drenderer_tpu/ops/raster_pallas.py::_raster_kernel (:249,
// the pl.pallas_call of _rasterize_chunk at :1589) with nearest sampling:
//  - raster_flat_nearest, its flat ids_resident form: vis_flat4/vis_body
//    (:381-517) over one ascending slot list per tile;
//  - raster_segmented_nearest, its segmented form: vis_entry (:402-490) over
//    the shared broadband list and the tile's segment of one sorted (tile,
//    slot) entry array (bin_segments, :150), with the order-independent
//    depth-tie rule;
// and, shared by both, shade_body/_shade_slot and color_entry/tex_entry over
// shade_base/color_pack/tex_coord_planes (:519-798) and the nearest
// _fetch_phase with its final pack (:803-1362).
//
// Design. One thread block per kTileW x kTileH pixel tile (TILE_W x TILE_H in
// ops/raster.py, which bins for it), one thread per pixel. The block stages
// its slot lists in shared memory, kThreads entries at a time. The slot
// tables stay in global memory and are read through L1/L2: all threads of a
// block read the same slot's words in the same iteration, so each read is one
// broadcast. The segmented kernel stages the broadband list with each slot's
// bbox tested against the tile once per block, so a tile walks only the
// broadband slots that touch it, as the flat binner would have listed them.
// After visibility each thread shades its own winner and reads its texel with
// one load from the atlas. The TPU kernel's 8-row strips, 8-row atlas-block
// unrolls, row-constant path, midpoint split, DMA windows, strip-scoped loops,
// material-partitioned shade loops and transposed SMEM tables exist only
// because of Mosaic's gathers, branches and 1 MB SMEM; they have no
// counterpart here. The kernels mask the ragged frame edge themselves.
//
// Winners do not depend on the tiling: each pixel tests every live slot whose
// bbox touches its tile, and the exact bbox test is part of coverage
// (raster_pallas.py:384-388). A slot left out of the tile's lists fails that
// test anyway, so winners match the TPU kernel's 120- or 216-row tiles. The
// flat kernel walks ascending slots with a strict '>', so the earlier slot
// keeps a depth tie (render.swift:323-325); the segmented kernel's two lists
// interleave in slot order, so it states the same rule without the order:
// the greater 1/z wins, and at equal 1/z > 0 the smaller slot.
//
// Bound. Per pixel a kernel writes 8 bytes, reads at most one atlas word and
// does ~17 flops for each slot whose bbox touches its tile, plus ~100 for its
// winner's shading; at the main path's shapes the bytes bound
// (chip_smoke.py computes it from the run's own tables and texel fetches).
// These first versions favour being right: tables are read from L1/L2 on
// every slot, and nothing is staged ahead.
//
// Numerics, to stay bit-equal with the plain PyTorch versions:
//  - built with --fmad=false: every multiply and add rounds separately, in the
//    reference's order;
//  - 1/sqrtf(x) with IEEE sqrt and division (no rsqrtf, no fast math);
//  - float -> int32 packs truncate with saturation and NaN -> 0 (cvt.rzi), as
//    XLA does, and are shifted as unsigned words;
//  - nearest addressing sanitizes non-finite levels and uv as
//    ops/texture.py::sample_ripmap does, then fmodf (exact, negative for
//    uv < 0), clamps each axis to [0, 511] inside the texture's 512-row block.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

// Rows of the packed (43, S) f32 and (7, S) i32 tables (ops/raster.py).
constexpr int kW00 = 0, kDX = 3, kDY = 6, kRVZ = 9, kCVP = 12, kNP = 21,
              kATTRP = 30, kTPP = 39, kDZV = 41;
constexpr int kXMIN = 0, kXMAX = 1, kYMIN = 2, kYMAX = 3, kTEXBASE = 4,
              kISTEX = 5;
constexpr int kAtlasEdge = 512;
// The pixel tile; ops/raster.py's TILE_W, TILE_H bin for the same one.
constexpr int kTileW = 32, kTileH = 8, kThreads = kTileW * kTileH;

// NaN tests below are written x != x: no fast math, so they hold.
__device__ __forceinline__ int trunc_i32(float x) { return __float2int_rz(x); }

// Shade-scaled channels packed 0x00RRGGBB (render.swift:84-87, 330).
__device__ __forceinline__ int pack_rgb(float sh, float r, float g, float b) {
  const unsigned cr = static_cast<unsigned>(trunc_i32(sh * r));
  const unsigned cg = static_cast<unsigned>(trunc_i32(sh * g));
  const unsigned cb = static_cast<unsigned>(trunc_i32(sh * b));
  return static_cast<int>((cr << 16) | (cg << 8) | cb);
}

__device__ __forceinline__ float rsqrt3(float x, float y, float z) {
  return 1.0f / sqrtf(x * x + y * y + z * z);
}

// Per-axis ripmap level: clamp to [1, 256], truncate, round up to a power of
// two (render.swift:95-101).
__device__ __forceinline__ int pow2_level(float level) {
  const float l = level != level ? 256.0f : fminf(fmaxf(level, 1.0f), 256.0f);
  int i = trunc_i32(l) - 1;
  i |= i >> 1;
  i |= i >> 2;
  i |= i >> 4;
  return i + 1;
}

// Texel index along one axis: trunc(fmod(uv, 1) * L) + (511 & ~(2L - 1)),
// clamped to [0, 511] (render.swift:104-111).
__device__ __forceinline__ int texel_axis(float uv, float level) {
  const int lp = pow2_level(level);
  const float u = uv != uv ? 0.0f : fminf(fmaxf(uv, -FLT_MAX), FLT_MAX);
  const int t = trunc_i32(fmodf(u, 1.0f) * static_cast<float>(lp))
                + (511 & ~(2 * lp - 1));
  return min(max(t, 0), kAtlasEdge - 1);
}

// 1/z of slot s at pixel (px, py) where s covers it, else 0. Each edge
// function rounds as (w00 + px*dx) + py*dy.
__device__ __forceinline__ float slot_ooz(const float* __restrict__ trf,
                                          const int* __restrict__ tri, int S,
                                          int s, int px, int py, float pxf,
                                          float pyf) {
  const float w0 = trf[(kW00 + 0) * S + s] + pxf * trf[(kDX + 0) * S + s]
                   + pyf * trf[(kDY + 0) * S + s];
  const float w1 = trf[(kW00 + 1) * S + s] + pxf * trf[(kDX + 1) * S + s]
                   + pyf * trf[(kDY + 1) * S + s];
  const float w2 = trf[(kW00 + 2) * S + s] + pxf * trf[(kDX + 2) * S + s]
                   + pyf * trf[(kDY + 2) * S + s];
  const bool cover = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f
                     && px >= tri[kXMIN * S + s] && px <= tri[kXMAX * S + s]
                     && py >= tri[kYMIN * S + s] && py <= tri[kYMAX * S + s];
  const float ooz = w0 * trf[(kRVZ + 0) * S + s] + w1 * trf[(kRVZ + 1) * S + s]
                    + w2 * trf[(kRVZ + 2) * S + s];
  return cover ? ooz : 0.0f;
}

// Phases 2 and 3 for one pixel, and its stores: depth, then the background
// where nothing won, the winner's flat colour pack, or its nearest texel
// times the shade.
__device__ __forceinline__ void shade_and_store(
    const float* __restrict__ trf, const int* __restrict__ tri,
    const int* __restrict__ atlas, int num_textures, int S, float best,
    int win, int px, int py, int width, int height, int background,
    int* __restrict__ pix, float* __restrict__ depth) {
  if (px >= width || py >= height) return;
  const size_t o = static_cast<size_t>(py) * width + px;
  depth[o] = best;
  if (win < 0) {
    pix[o] = background;
    return;
  }
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);

  // ---- phase 2: shade the winner (render.swift:326-331) ----
  const int s = win;
  auto T = [&](int row) { return trf[row * S + s]; };
  const float inv = 1.0f / best;
  const float t0 = (T(kW00 + 0) + pxf * T(kDX + 0) + pyf * T(kDY + 0)) * inv;
  const float t1 = (T(kW00 + 1) + pxf * T(kDX + 1) + pyf * T(kDY + 1)) * inv;
  const float t2 = (T(kW00 + 2) + pxf * T(kDX + 2) + pyf * T(kDY + 2)) * inv;
  auto interp = [&](int row) {
    return T(row) * t0 + T(row + 3) * t1 + T(row + 6) * t2;
  };
  // Halfway-vector headlight.
  float vx = interp(kCVP + 0), vy = interp(kCVP + 1), vz = interp(kCVP + 2);
  const float pn = -rsqrt3(vx, vy, vz);
  vx *= pn;
  vy *= pn;
  vz *= pn;
  float nx = interp(kNP + 0), ny = interp(kNP + 1), nz = interp(kNP + 2);
  const float nn = rsqrt3(nx, ny, nz);
  nx *= nn;
  ny *= nn;
  nz *= nn;
  const float hx = vx + nx, hy = vy + ny, hz = vz + nz;
  const float hn = rsqrt3(hx, hy, hz);
  const float sh = (hx * nx + hy * ny + hz * nz) * hn;
  const float cr = interp(kATTRP + 0), cg = interp(kATTRP + 1),
              cb = interp(kATTRP + 2);
  if (tri[kISTEX * S + s] == 0) {
    pix[o] = pack_rgb(sh, cr, cg, cb);
    return;
  }

  // ---- phase 3: ripmap level per axis, nearest texel, shade multiply ----
  // (cr, cg) is the perspective-correct (u, v) (render.swift:94-111).
  const float lvl_u = best / fabsf(T(kTPP + 0) - cr * T(kDZV + 0));
  const float lvl_v = best / fabsf(T(kTPP + 1) - cg * T(kDZV + 1));
  const int x = texel_axis(cr, lvl_u);
  const int y = texel_axis(cg, lvl_v);
  const int tex = min(max(tri[kTEXBASE * S + s] >> 18, 0),
                      max(num_textures - 1, 0));
  const int word =
      atlas[(static_cast<size_t>(tex) * kAtlasEdge + y) * kAtlasEdge + x];
  pix[o] = pack_rgb(sh, static_cast<float>((word >> 16) & 0xFF),
                    static_cast<float>((word >> 8) & 0xFF),
                    static_cast<float>(word & 0xFF));
}

__global__ void __launch_bounds__(kThreads)
raster_flat_nearest_kernel(const int* __restrict__ counts,
                           const int* __restrict__ ids,
                           const float* __restrict__ trf,
                           const int* __restrict__ tri,
                           const int* __restrict__ atlas, int num_textures,
                           int* __restrict__ pix, float* __restrict__ depth,
                           int S, int width, int height, int background) {
  __shared__ int list[kThreads];
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int px = blockIdx.x * kTileW + threadIdx.x;
  const int py = blockIdx.y * kTileH + threadIdx.y;
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);

  // ---- phase 1: visibility over the tile's ascending slot list ----
  const int n = counts[tile];
  const int* tile_ids = ids + static_cast<size_t>(tile) * S;
  float best = 0.0f;  // depth cleared to 0: 1/z > 0 wherever a slot covers
  int win = -1;
  for (int base = 0; base < n; base += kThreads) {
    const int m = min(kThreads, n - base);
    __syncthreads();
    if (lane < m) list[lane] = tile_ids[base + lane];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const int s = list[j];
      const float ooz = slot_ooz(trf, tri, S, s, px, py, pxf, pyf);
      if (ooz > best) {  // strict: earlier slot wins depth ties
        best = ooz;
        win = s;
      }
    }
  }
  shade_and_store(trf, tri, atlas, num_textures, S, best, win, px, py, width,
                  height, background, pix, depth);
}

__global__ void __launch_bounds__(kThreads)
raster_segmented_nearest_kernel(const int* __restrict__ ids,
                                const int* __restrict__ starts,
                                const int* __restrict__ counts,
                                const int* __restrict__ bb,
                                const int* __restrict__ bb_count,
                                const float* __restrict__ trf,
                                const int* __restrict__ tri,
                                const int* __restrict__ atlas,
                                int num_textures, int* __restrict__ pix,
                                float* __restrict__ depth, int S, int width,
                                int height, int background) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int list[kThreads];
  __shared__ int warp_kept[kWarps];
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  const int warp = lane >> 5;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int px = x0 + threadIdx.x;
  const int py = y0 + threadIdx.y;
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);
  float best = 0.0f;
  int win = -1;
  // The order-independent form of the strict '>' over ascending slots.
  auto visit = [&](int s) {
    const float ooz = slot_ooz(trf, tri, S, s, px, py, pxf, pyf);
    if (ooz > best || (ooz == best && ooz > 0.0f && s < win)) {
      best = ooz;
      win = s;
    }
  };

  // ---- phase 1a: the broadband slots whose bbox touches this tile ----
  const int nb = bb_count[0];
  for (int base = 0; base < nb; base += kThreads) {
    int s = 0;
    bool keep = false;
    if (base + lane < nb) {
      s = bb[base + lane];
      keep = tri[kXMIN * S + s] < x0 + kTileW && tri[kXMAX * S + s] >= x0
             && tri[kYMIN * S + s] < y0 + kTileH && tri[kYMAX * S + s] >= y0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the previous chunk's list is consumed
    if ((lane & 31) == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int at = 0, m = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_kept[w] : 0;
      m += warp_kept[w];
    }
    if (keep) list[at + __popc(ballot & ((1u << (lane & 31)) - 1u))] = s;
    __syncthreads();
    for (int j = 0; j < m; ++j) visit(list[j]);
  }

  // ---- phase 1b: the tile's segment of the sorted entries ----
  const int n = counts[tile];
  const int* seg = ids + starts[tile];
  for (int base = 0; base < n; base += kThreads) {
    const int m = min(kThreads, n - base);
    __syncthreads();
    if (lane < m) list[lane] = seg[base + lane];
    __syncthreads();
    for (int j = 0; j < m; ++j) visit(list[j]);
  }
  shade_and_store(trf, tri, atlas, num_textures, S, best, win, px, py, width,
                  height, background, pix, depth);
}

bool bad_frame(int width, int height, int S) {
  return width <= 0 || height <= 0 || S < 0;
}

dim3 tile_grid(int width, int height) {
  return dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
}

}  // namespace

// Each entry point launches its kernel on ``stream`` over a
// ceil(W/kTileW) x ceil(H/kTileH) grid and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int raster_flat_nearest(const void* counts, const void* ids,
                                   const void* trf, const void* tri,
                                   const void* atlas, void* pix, void* depth,
                                   int S, int num_textures, int width,
                                   int height, int background, void* stream) {
  if (bad_frame(width, height, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  raster_flat_nearest_kernel<<<tile_grid(width, height), dim3(kTileW, kTileH),
                               0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(ids),
      static_cast<const float*>(trf), static_cast<const int*>(tri),
      static_cast<const int*>(atlas), num_textures, static_cast<int*>(pix),
      static_cast<float*>(depth), S, width, height, background);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int raster_segmented_nearest(
    const void* ids, const void* starts, const void* counts, const void* bb,
    const void* bb_count, const void* trf, const void* tri, const void* atlas,
    void* pix, void* depth, int S, int num_textures, int width, int height,
    int background, void* stream) {
  if (bad_frame(width, height, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  raster_segmented_nearest_kernel<<<tile_grid(width, height),
                                    dim3(kTileW, kTileH), 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(bb),
      static_cast<const int*>(bb_count), static_cast<const float*>(trf),
      static_cast<const int*>(tri), static_cast<const int*>(atlas),
      num_textures, static_cast<int*>(pix), static_cast<float*>(depth), S,
      width, height, background);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* s3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
