// The raster kernels of the port: visibility, deferred shading and texel
// fetch of one frame, or of a batch of frames, fused in one launch.
//
// All four replace swift3drenderer_tpu/ops/raster_pallas.py::_raster_kernel
// (:249, the pl.pallas_call of _rasterize_chunk at :1589):
//  - raster_flat_{nearest,bilinear}, its flat ids_resident form:
//    vis_flat4/vis_body (:381-517) over one ascending slot list per tile;
//  - raster_segmented_{nearest,bilinear}, its segmented form: vis_entry
//    (:402-490) over the shared broadband list and the tile's segment of one
//    sorted (tile, slot) entry array (bin_segments, :150), with the
//    order-independent depth-tie rule;
// and, shared by all, shade_body/_shade_slot and color_entry/tex_entry over
// shade_base/color_pack/tex_coord_planes (:519-798) and _fetch_phase with its
// final pack (:803-1362): the nearest fetch, or the bilinear one
// (tex_coord_planes :618-634, fetch_tex/block_body :1132-1280, the float
// channel merge :1346-1360). The grid's third axis is the camera batch, as
// the TPU grid's first (B, nty, ntx; per-frame tables by block index,
// :1548-1557, :1595-1613). Each kernel has a tracking form (kTrackIds), the
// TPU kernel's track_ids (:258-260, :297-304, :398-399, :427-428, :448-476,
// :497-498): a third output plane with each winner's row kGID value, -1 where
// nothing covers. Every kernel takes the band's first framebuffer row y0 (the
// TPU kernel's y0_ref / y_top): it covers rows [y0, y0 + height) of a
// full-frame setup table into a (height, width) output.
//
// Design. One thread block per kTileW x kTileH pixel tile and frame
// (blockIdx.z = frame; TILE_W x TILE_H in ops/raster.py, which bins for it),
// one thread per pixel. A block reads its frame's columns of the batch's
// tables and writes its frame's output planes; otherwise the body is the
// single-frame body. The block stages its
// slot lists in shared memory, kThreads entries at a time. The slot tables
// stay in global memory and are read through L1/L2: all threads of a block
// read the same slot's words in the same iteration, so each read is one
// broadcast. The segmented kernel stages the broadband list with each slot's
// bbox tested against the tile once per block, so a tile walks only the
// broadband slots that touch it, as the flat binner would have listed them.
// After visibility each thread shades its own winner and reads its texel
// with one load from the atlas, or its four bilinear taps with four. The TPU
// kernel's 8-row strips, 8-row atlas-block unrolls, row-constant path,
// midpoint split, DMA windows, strip-scoped loops, material-partitioned
// shade loops and transposed SMEM tables exist only because of Mosaic's
// gathers, branches and 1 MB SMEM; they have no counterpart here. The kernels
// mask the ragged frame edge themselves.
//
// Winners do not depend on the tiling: each pixel tests every live slot whose
// bbox touches its tile, and the exact bbox test is part of coverage
// (raster_pallas.py:384-388). A slot left out of the tile's lists fails that
// test anyway, so winners match the TPU kernel's 120- or 216-row tiles. The
// flat kernel walks ascending slots with a strict '>', so the earlier slot
// keeps a depth tie (render.swift:323-325); the segmented kernel's two lists
// interleave in slot order, so it states the same rule without the order:
// the greater 1/z wins, and at equal 1/z > 0 the smaller slot. The TPU
// kernel's segmented tracking form breaks that tie on the smaller gid
// instead; the two agree because every caller's gids ascend with slot order
// among a frame's live slots (ops/raster.py checks it in the plain version).
//
// Bound. Per pixel a kernel writes 8 bytes (12 tracking), reads at most one
// atlas word (four taps for bilinear, mostly shared with neighbouring
// pixels) and does ~17 flops for each slot whose bbox holds the pixel, plus
// ~100 (bilinear ~135) for its winner's shading; at the main path's shapes
// the bytes bound (chip_smoke.py computes it from the run's own tables and
// texel fetches).
// These first versions favour being right: tables are read from L1/L2 on
// every slot, and nothing is staged ahead.
//
// Numerics, to stay bit-equal with the plain PyTorch versions:
//  - built with --fmad=false: every multiply and add rounds separately, in the
//    reference's order;
//  - 1/sqrtf(x) with IEEE sqrt and division (no rsqrtf, no fast math);
//  - float -> int32 packs truncate with saturation and NaN -> 0 (cvt.rzi), as
//    XLA does, and are shifted as unsigned words;
//  - texel addressing sanitizes non-finite levels and uv as
//    ops/texture.py does. Nearest: fmodf (exact, negative for uv < 0), each
//    axis clamped to [0, 511] inside the texture's 512-row block. Bilinear:
//    the floor-mod of jnp.mod / torch.remainder (fmodf, plus 1 if negative,
//    which may round to 1.0), then mod(u, 1) * L - 0.5, floor, weights
//    t - floor(t), taps & (L - 1), and the four weighted channels summed left
//    to right in the plain version's order.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

// Rows of the packed (43, S) f32 and (7, S) i32 tables (ops/raster.py).
constexpr int kW00 = 0, kDX = 3, kDY = 6, kRVZ = 9, kCVP = 12, kNP = 21,
              kATTRP = 30, kTPP = 39, kDZV = 41;
constexpr int kF32Rows = 43, kI32Rows = 7;
constexpr int kXMIN = 0, kXMAX = 1, kYMIN = 2, kYMAX = 3, kTEXBASE = 4,
              kISTEX = 5, kGID = 6;
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

__device__ __forceinline__ float channel(int word, int shift) {
  return static_cast<float>((word >> shift) & 0xFF);
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

// uv with NaN -> 0 and +-inf -> +-FLT_MAX (torch.nan_to_num).
__device__ __forceinline__ float finite_uv(float uv) {
  return uv != uv ? 0.0f : fminf(fmaxf(uv, -FLT_MAX), FLT_MAX);
}

// Texel index along one axis: trunc(fmod(uv, 1) * L) + (511 & ~(2L - 1)),
// clamped to [0, 511] (render.swift:104-111).
__device__ __forceinline__ int texel_axis(float uv, float level) {
  const int lp = pow2_level(level);
  const int t = trunc_i32(fmodf(finite_uv(uv), 1.0f) * static_cast<float>(lp))
                + (511 & ~(2 * lp - 1));
  return min(max(t, 0), kAtlasEdge - 1);
}

// The two bilinear taps along one axis and the weight of the second
// (ops/texture.py::bilinear_taps): t = mod(uv, 1) * L - 0.5 with the
// floor-mod of jnp.mod, taps floor(t) and floor(t) + 1 wrapped inside the
// level (L is a power of two), weight t - floor(t).
__device__ __forceinline__ void bilinear_axis(float uv, float level, int& lo,
                                              int& hi, float& w) {
  const int lp = pow2_level(level);
  float r = fmodf(finite_uv(uv), 1.0f);
  if (r < 0.0f) r += 1.0f;  // may round to 1.0; the & (L - 1) below wraps it
  const float t = r * static_cast<float>(lp) - 0.5f;
  const float f = floorf(t);
  const int x0 = static_cast<int>(f);  // t lies in [-0.5, L - 0.5]
  const int off = 511 & ~(2 * lp - 1);
  lo = (x0 & (lp - 1)) + off;
  hi = ((x0 + 1) & (lp - 1)) + off;
  w = t - f;
}

// 1/z of a slot at pixel (px, py) where it covers it, else 0; f and i are
// the slot's columns in the batch's f32 and i32 tables (its frame's offset
// plus the slot). Each edge function rounds as (w00 + px*dx) + py*dy.
__device__ __forceinline__ float slot_ooz(const float* __restrict__ trf,
                                          const int* __restrict__ tri, int S,
                                          int f, int i, int px, int py,
                                          float pxf, float pyf) {
  const float w0 = trf[(kW00 + 0) * S + f] + pxf * trf[(kDX + 0) * S + f]
                   + pyf * trf[(kDY + 0) * S + f];
  const float w1 = trf[(kW00 + 1) * S + f] + pxf * trf[(kDX + 1) * S + f]
                   + pyf * trf[(kDY + 1) * S + f];
  const float w2 = trf[(kW00 + 2) * S + f] + pxf * trf[(kDX + 2) * S + f]
                   + pyf * trf[(kDY + 2) * S + f];
  const bool cover = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f
                     && px >= tri[kXMIN * S + i] && px <= tri[kXMAX * S + i]
                     && py >= tri[kYMIN * S + i] && py <= tri[kYMAX * S + i];
  const float ooz = w0 * trf[(kRVZ + 0) * S + f] + w1 * trf[(kRVZ + 1) * S + f]
                    + w2 * trf[(kRVZ + 2) * S + f];
  return cover ? ooz : 0.0f;
}

// Phases 2 and 3 for one pixel, and its stores: depth (and, tracking, the
// winner's gid or -1), then the background where nothing won, the winner's
// flat colour pack, or its nearest texel (or bilinear blend of four) times
// the shade. f and i are the winner's table columns (slot_ooz); py is the
// framebuffer row, row = py - y0 the output row.
template <bool kBilinear, bool kTrackIds>
__device__ __forceinline__ void shade_and_store(
    const float* __restrict__ trf, const int* __restrict__ tri,
    const int* __restrict__ atlas, int num_textures, int S, float best,
    int win, int f, int i, int px, int py, int row, int width, int height,
    int background, int* __restrict__ pix, float* __restrict__ depth,
    int* __restrict__ gid) {
  if (px >= width || row >= height) return;
  const size_t o = static_cast<size_t>(row) * width + px;
  depth[o] = best;
  if constexpr (kTrackIds) gid[o] = win < 0 ? -1 : tri[kGID * S + i];
  if (win < 0) {
    pix[o] = background;
    return;
  }
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);

  // ---- phase 2: shade the winner (render.swift:326-331) ----
  auto T = [&](int r) { return trf[r * S + f]; };
  const float inv = 1.0f / best;
  const float t0 = (T(kW00 + 0) + pxf * T(kDX + 0) + pyf * T(kDY + 0)) * inv;
  const float t1 = (T(kW00 + 1) + pxf * T(kDX + 1) + pyf * T(kDY + 1)) * inv;
  const float t2 = (T(kW00 + 2) + pxf * T(kDX + 2) + pyf * T(kDY + 2)) * inv;
  auto interp = [&](int k) {
    return T(k) * t0 + T(k + 3) * t1 + T(k + 6) * t2;
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
  if (tri[kISTEX * S + i] == 0) {
    pix[o] = pack_rgb(sh, cr, cg, cb);
    return;
  }

  // ---- phase 3: ripmap level per axis, texel fetch, shade multiply ----
  // (cr, cg) is the perspective-correct (u, v) (render.swift:94-111).
  const float lvl_u = best / fabsf(T(kTPP + 0) - cr * T(kDZV + 0));
  const float lvl_v = best / fabsf(T(kTPP + 1) - cg * T(kDZV + 1));
  const int tex = min(max(tri[kTEXBASE * S + i] >> 18, 0),
                      max(num_textures - 1, 0));
  const int* __restrict__ block =
      atlas + static_cast<size_t>(tex) * kAtlasEdge * kAtlasEdge;
  if constexpr (!kBilinear) {
    const int word = block[texel_axis(cg, lvl_v) * kAtlasEdge
                           + texel_axis(cr, lvl_u)];
    pix[o] = pack_rgb(sh, channel(word, 16), channel(word, 8),
                      channel(word, 0));
    return;
  }
  int x0, x1, y0, y1;
  float wx, wy;
  bilinear_axis(cr, lvl_u, x0, x1, wx);
  bilinear_axis(cg, lvl_v, y0, y1, wy);
  const int f00 = block[y0 * kAtlasEdge + x0];
  const int f10 = block[y0 * kAtlasEdge + x1];
  const int f01 = block[y1 * kAtlasEdge + x0];
  const int f11 = block[y1 * kAtlasEdge + x1];
  const float a = (1.0f - wx) * (1.0f - wy), b = wx * (1.0f - wy),
              c = (1.0f - wx) * wy, d = wx * wy;
  auto blend = [&](int shift) {
    return a * channel(f00, shift) + b * channel(f10, shift)
           + c * channel(f01, shift) + d * channel(f11, shift);
  };
  pix[o] = pack_rgb(sh, blend(16), blend(8), blend(0));
}

// Frame blockIdx.z's outputs, and the offsets of its columns in the batch's
// f32 and i32 tables. The tables are indexed from the kernels' own
// parameters with 32-bit column offsets: advancing the table pointers per
// frame instead made the compiler address every load afresh (the
// single-frame kernels ran 7-28 % slower on the H100).
#define S3D_FRAME_OFFSETS()                                        \
  const size_t plane_ = static_cast<size_t>(width) * height;      \
  pix += blockIdx.z * plane_;                                      \
  depth += blockIdx.z * plane_;                                    \
  if constexpr (kTrackIds) gid += blockIdx.z * plane_;             \
  const int f32_frame = blockIdx.z * kF32Rows * S;                 \
  const int i32_frame = blockIdx.z * kI32Rows * S

template <bool kBilinear, bool kTrackIds>
__global__ void __launch_bounds__(kThreads)
raster_flat_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
                   const float* __restrict__ trf, const int* __restrict__ tri,
                   const int* __restrict__ atlas, int num_textures,
                   int* __restrict__ pix, float* __restrict__ depth,
                   int* __restrict__ gid, int S, int width, int height, int y0,
                   int background) {
  __shared__ int list[kThreads];
  S3D_FRAME_OFFSETS();
  const int ntiles = gridDim.x * gridDim.y;
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t frame_tile = static_cast<size_t>(blockIdx.z) * ntiles + tile;
  const int px = blockIdx.x * kTileW + threadIdx.x;
  const int row = blockIdx.y * kTileH + threadIdx.y;
  const int py = y0 + row;
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);

  // ---- phase 1: visibility over the tile's ascending slot list ----
  const int n = counts[frame_tile];
  const int* tile_ids = ids + frame_tile * S;
  float best = 0.0f;  // depth cleared to 0: 1/z > 0 wherever a slot covers
  int win = -1;
  for (int base = 0; base < n; base += kThreads) {
    const int m = min(kThreads, n - base);
    __syncthreads();
    if (lane < m) list[lane] = tile_ids[base + lane];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const int s = list[j];
      const float ooz = slot_ooz(trf, tri, S, f32_frame + s, i32_frame + s,
                                 px, py, pxf, pyf);
      if (ooz > best) {  // strict: earlier slot wins depth ties
        best = ooz;
        win = s;
      }
    }
  }
  shade_and_store<kBilinear, kTrackIds>(
      trf, tri, atlas, num_textures, S, best, win, f32_frame + win,
      i32_frame + win, px, py, row, width, height, background, pix, depth, gid);
}

template <bool kBilinear, bool kTrackIds>
__global__ void __launch_bounds__(kThreads)
raster_segmented_kernel(const int* __restrict__ ids,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const int* __restrict__ bb,
                        const int* __restrict__ bb_count,
                        const float* __restrict__ trf,
                        const int* __restrict__ tri,
                        const int* __restrict__ atlas, int num_textures,
                        int* __restrict__ pix, float* __restrict__ depth,
                        int* __restrict__ gid, int S, int entries, int width,
                        int height, int y0, int background) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int list[kThreads];
  __shared__ int warp_kept[kWarps];
  S3D_FRAME_OFFSETS();
  const size_t frame = blockIdx.z;
  ids += frame * entries;
  bb += frame * S;
  const int ntiles = gridDim.x * gridDim.y;
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  const int warp = lane >> 5;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t frame_tile = frame * ntiles + tile;
  // The tile's first pixel column and framebuffer row.
  const int tx0 = blockIdx.x * kTileW, ty0 = y0 + blockIdx.y * kTileH;
  const int px = tx0 + threadIdx.x;
  const int row = blockIdx.y * kTileH + threadIdx.y;
  const int py = y0 + row;
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);
  float best = 0.0f;
  int win = -1;
  // The order-independent form of the strict '>' over ascending slots.
  auto visit = [&](int s) {
    const float ooz = slot_ooz(trf, tri, S, f32_frame + s, i32_frame + s, px,
                               py, pxf, pyf);
    if (ooz > best || (ooz == best && ooz > 0.0f && s < win)) {
      best = ooz;
      win = s;
    }
  };

  // ---- phase 1a: the broadband slots whose bbox touches this tile ----
  const int nb = bb_count[frame];
  for (int base = 0; base < nb; base += kThreads) {
    int s = 0;
    bool keep = false;
    if (base + lane < nb) {
      s = bb[base + lane];
      const int c = i32_frame + s;
      keep = tri[kXMIN * S + c] < tx0 + kTileW && tri[kXMAX * S + c] >= tx0
             && tri[kYMIN * S + c] < ty0 + kTileH && tri[kYMAX * S + c] >= ty0;
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
  const int n = counts[frame_tile];
  const int* seg = ids + starts[frame_tile];
  for (int base = 0; base < n; base += kThreads) {
    const int m = min(kThreads, n - base);
    __syncthreads();
    if (lane < m) list[lane] = seg[base + lane];
    __syncthreads();
    for (int j = 0; j < m; ++j) visit(list[j]);
  }
  shade_and_store<kBilinear, kTrackIds>(
      trf, tri, atlas, num_textures, S, best, win, f32_frame + win,
      i32_frame + win, px, py, row, width, height, background, pix, depth, gid);
}

bool bad_frame(int frames, int width, int height, int S) {
  return frames <= 0 || frames > 65535 || width <= 0 || height <= 0 || S < 0;
}

dim3 tile_grid(int frames, int width, int height) {
  return dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
              frames);
}

template <bool kBilinear, bool kTrackIds>
void start_flat(const void* counts, const void* ids, const void* trf,
                const void* tri, const void* atlas, void* pix, void* depth,
                void* gid, int frames, int S, int num_textures, int width,
                int height, int y0, int background, void* stream) {
  raster_flat_kernel<kBilinear, kTrackIds>
      <<<tile_grid(frames, width, height), dim3(kTileW, kTileH), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(counts), static_cast<const int*>(ids),
          static_cast<const float*>(trf), static_cast<const int*>(tri),
          static_cast<const int*>(atlas), num_textures, static_cast<int*>(pix),
          static_cast<float*>(depth), static_cast<int*>(gid), S, width, height,
          y0, background);
}

// A null gid selects the kernel without the gid plane.
template <bool kBilinear>
int launch_flat(const void* counts, const void* ids, const void* trf,
                const void* tri, const void* atlas, void* pix, void* depth,
                void* gid, int frames, int S, int num_textures, int width,
                int height, int y0, int background, void* stream) {
  if (bad_frame(frames, width, height, S) || y0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (gid) {
    start_flat<kBilinear, true>(counts, ids, trf, tri, atlas, pix, depth, gid,
                                frames, S, num_textures, width, height, y0,
                                background, stream);
  } else {
    start_flat<kBilinear, false>(counts, ids, trf, tri, atlas, pix, depth,
                                 nullptr, frames, S, num_textures, width,
                                 height, y0, background, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBilinear, bool kTrackIds>
void start_segmented(const void* ids, const void* starts, const void* counts,
                     const void* bb, const void* bb_count, const void* trf,
                     const void* tri, const void* atlas, void* pix,
                     void* depth, void* gid, int frames, int S, int entries,
                     int num_textures, int width, int height, int y0,
                     int background, void* stream) {
  raster_segmented_kernel<kBilinear, kTrackIds>
      <<<tile_grid(frames, width, height), dim3(kTileW, kTileH), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(ids), static_cast<const int*>(starts),
          static_cast<const int*>(counts), static_cast<const int*>(bb),
          static_cast<const int*>(bb_count), static_cast<const float*>(trf),
          static_cast<const int*>(tri), static_cast<const int*>(atlas),
          num_textures, static_cast<int*>(pix), static_cast<float*>(depth),
          static_cast<int*>(gid), S, entries, width, height, y0, background);
}

template <bool kBilinear>
int launch_segmented(const void* ids, const void* starts, const void* counts,
                     const void* bb, const void* bb_count, const void* trf,
                     const void* tri, const void* atlas, void* pix,
                     void* depth, void* gid, int frames, int S, int entries,
                     int num_textures, int width, int height, int y0,
                     int background, void* stream) {
  if (bad_frame(frames, width, height, S) || entries < 0 || y0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (gid) {
    start_segmented<kBilinear, true>(ids, starts, counts, bb, bb_count, trf,
                                     tri, atlas, pix, depth, gid, frames, S,
                                     entries, num_textures, width, height, y0,
                                     background, stream);
  } else {
    start_segmented<kBilinear, false>(ids, starts, counts, bb, bb_count, trf,
                                      tri, atlas, pix, depth, nullptr, frames,
                                      S, entries, num_textures, width, height,
                                      y0, background, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches its kernel on ``stream`` over a
// ceil(W/kTileW) x ceil(H/kTileH) x frames grid, covering framebuffer rows
// [y0, y0 + H), and returns cudaGetLastError() (0 when the launch was
// accepted). Per-frame inputs and outputs are frame-major: frame b's are at b
// times one frame's size. With a non-null gid the tracking form also writes
// the winners' gids there; with a null gid it is the kernel without them.
extern "C" int raster_flat_nearest(const void* counts, const void* ids,
                                   const void* trf, const void* tri,
                                   const void* atlas, void* pix, void* depth,
                                   void* gid, int frames, int S,
                                   int num_textures, int width, int height,
                                   int y0, int background, void* stream) {
  return launch_flat<false>(counts, ids, trf, tri, atlas, pix, depth, gid,
                            frames, S, num_textures, width, height, y0,
                            background, stream);
}

extern "C" int raster_flat_bilinear(const void* counts, const void* ids,
                                    const void* trf, const void* tri,
                                    const void* atlas, void* pix, void* depth,
                                    void* gid, int frames, int S,
                                    int num_textures, int width, int height,
                                    int y0, int background, void* stream) {
  return launch_flat<true>(counts, ids, trf, tri, atlas, pix, depth, gid,
                           frames, S, num_textures, width, height, y0,
                           background, stream);
}

extern "C" int raster_segmented_nearest(
    const void* ids, const void* starts, const void* counts, const void* bb,
    const void* bb_count, const void* trf, const void* tri, const void* atlas,
    void* pix, void* depth, void* gid, int frames, int S, int entries,
    int num_textures, int width, int height, int y0, int background,
    void* stream) {
  return launch_segmented<false>(ids, starts, counts, bb, bb_count, trf, tri,
                                 atlas, pix, depth, gid, frames, S, entries,
                                 num_textures, width, height, y0, background,
                                 stream);
}

extern "C" int raster_segmented_bilinear(
    const void* ids, const void* starts, const void* counts, const void* bb,
    const void* bb_count, const void* trf, const void* tri, const void* atlas,
    void* pix, void* depth, void* gid, int frames, int S, int entries,
    int num_textures, int width, int height, int y0, int background,
    void* stream) {
  return launch_segmented<true>(ids, starts, counts, bb, bb_count, trf, tri,
                                atlas, pix, depth, gid, frames, S, entries,
                                num_textures, width, height, y0, background,
                                stream);
}

extern "C" const char* s3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
