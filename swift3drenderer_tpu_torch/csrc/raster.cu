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
//    order-independent depth-tie rule; here the sort also lists slots per
//    super-tile of G x G tiles, and the broadband list keeps only the rest;
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
// full-frame setup table into a (height, width) output. Each has two timing
// forms besides the frame (kPhases, the TPU kernel's phases, :250-258, read
// by tools/perf_probe.py): kVis stops after visibility and stores each
// pixel's winning slot (-1 where nothing covers) and its 1/z (:491, :514);
// kShade stops before the texel fetch (:800), flat-coloured winners packed,
// textured winners left at the background. Their outputs are not a frame;
// they are built to be right, not fast, and the frame's instances (kFull)
// compile to the code they had before the timing forms existed.
//
// Design. One thread per pixel of a kTileW x kTileH tile (TILE_W x TILE_H in
// ops/raster.py, which bins for it); the grid's third axis is the frame, and
// a block reads its frame's columns of the batch's tables and writes its
// frame's output planes.
// The flat kernel's block covers up to kFlatTiles tiles of one frame, spread
// over it (tiles b, b + G, b + 2G, ... of its G blocks). One warp reads and
// scans its tiles' counts; the block reads every listed slot id of its
// tiles and copies the table columns of the slots they list into shared
// memory with cp.async, as slot-major records; it culls each listed slot
// once for its tile (tile_may_cover), one a thread, and compacts the
// survivors by ballot in the lists' ascending order. The tiles are then
// drawn with no barrier between them: each pixel visits its tile's
// survivors and shades its winner from shared memory, and a warp goes on to
// the next tile while others wait on their texels.
// The segmented kernel's block covers one tile and walks three lists as one
// run: its tile's segment, its super-tile's segment (G x G tiles, the slots
// too wide for per-tile entries) and the residual broadband list (the
// widest). For each chunk of kChunk listed slots it copies their 64-byte
// visibility records (ops/raster.py::pack_slot_records: edge, 1/z and bbox
// words, slot-major) into shared memory with cp.async, 16 bytes a thread
// and four threads a record, double buffered: chunk c + 1 is in flight
// while the block works on chunk c. A residual list longer than a chunk,
// which a tile mostly misses, is first filtered by bbox, one slot a thread
// (bin_segments lists the residual slots' bboxes in the list's order), into
// a list of hits in shared memory; only the hits' records are copied (past
// kHits hits, the rest of the list is copied whole). Each staged record is
// culled once for the block by the same test as the flat kernel's list, the
// rest compacted by ballot, and a visit reads four shared-memory broadcasts
// instead of 16 table words.
// The cull (tile_may_cover) drops a slot whose bbox misses the tile, or one
// of whose edge functions is negative over the whole tile, tested at the
// corner its signs pick.
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
// test anyway, so winners match the TPU kernel's 120- or 216-row tiles; a
// record the segmented kernel's tile test drops covers no pixel of the tile
// in the visit's own rounding, so dropping it changes nothing either. The
// flat kernel walks ascending slots with a strict '>', so the earlier slot
// keeps a depth tie (render.swift:323-325); the segmented kernel's three
// lists interleave in slot order, so it states the same rule without the
// order: the greater 1/z wins, and at equal 1/z > 0 the smaller slot (the
// flat kernel's cull keeps its survivors in ascending order, so its strict
// '>' is that rule too). The TPU kernel's segmented tracking form breaks
// that tie on the smaller gid instead; the two agree because every caller's
// gids ascend with slot order among a frame's live slots (ops/raster.py
// checks it in the plain version).
//
// Bound. Per pixel a kernel writes 8 bytes (12 tracking), reads at most one
// atlas word (four taps for bilinear, mostly shared with neighbouring
// pixels) and does ~17 flops for each slot whose bbox holds the pixel, plus
// ~100 (bilinear ~135) for its winner's shading; at the main path's shapes
// the bytes bound (chip_smoke.py computes it from the run's own tables and
// texel fetches). What holds the segmented kernel near its measured time is
// each block's chain of dependent loads (list bounds, slot ids, records, the
// winner's table columns, its texel) and the fixed cost of a block; the flat
// kernel pays that chain once for up to kFlatTiles tiles, and what holds it
// is the shading's arithmetic and the output stores, not bytes (PERF.md).
//
// Numerics, to stay bit-equal with the plain PyTorch versions:
//  - built with --fmad=false: every multiply and add rounds separately, in the
//    reference's order;
//  - 1/sqrtf(x) with IEEE sqrt and division (no rsqrtf, no fast math);
//  - float -> int32 packs truncate with saturation and NaN -> 0 (cvt.rzi), as
//    XLA does, and are shifted as unsigned words;
//  - texel addressing sanitizes non-finite levels and uv as
//    ops/texture.py does. Nearest: fmod(uv, 1) (exact, negative for uv < 0;
//    computed as uv - truncf(uv)), each axis clamped to [0, 511] inside the
//    texture's 512-row block. Bilinear: the floor-mod of jnp.mod /
//    torch.remainder (fmod, plus 1 if negative, which may round to 1.0),
//    then mod(u, 1) * L - 0.5, floor, weights t - floor(t), taps & (L - 1),
//    and the four weighted channels summed left to right in the plain
//    version's order.

#include <algorithm>
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
constexpr int kWarps = kThreads / 32;
// The rows visibility reads: the f32 rows kW00 .. kRVZ + 2 and the i32 rows
// kXMIN .. kYMAX. A slot record (ops/raster.py::pack_slot_records) holds
// them slot-major, the i32 words bit-cast: 64 bytes, copied as four 16-byte
// pieces.
constexpr int kVisF32Rows = 12, kVisI32Rows = 4;
constexpr int kRecPieces = 4;
// The kernels' forms (ops/raster.py's PHASES, in its order): the frame, and
// the timing forms that stop after visibility or before the texel fetch.
constexpr int kFull = 0, kVis = 1, kShade = 2;

// Asynchronous 16-byte copies from global to shared memory (sm_80 and up):
// the counterpart of the TPU kernel's make_async_copy, one commit group per
// chunk, waited on by count.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
// The 4-byte form, for rows that need not be 16-byte aligned (through L1).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most ``pending`` (0 or 1) commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

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

// fmodf(x, 1.0f) of a finite x, in two instructions: x - truncf(x) is exact
// and equals it for every finite float but for the sign of a zero (x an
// integer), which changes nothing below: the fraction is scaled, then
// truncated or moved by -0.5.
__device__ __forceinline__ float frac_part(float x) { return x - truncf(x); }

// Texel index along one axis: trunc(fmod(uv, 1) * L) + (511 & ~(2L - 1)),
// clamped to [0, 511] (render.swift:104-111).
__device__ __forceinline__ int texel_axis(float uv, float level) {
  const int lp = pow2_level(level);
  const int t = trunc_i32(frac_part(finite_uv(uv)) * static_cast<float>(lp))
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
  float r = frac_part(finite_uv(uv));
  if (r < 0.0f) r += 1.0f;  // may round to 1.0; the & (L - 1) below wraps it
  const float t = r * static_cast<float>(lp) - 0.5f;
  const float f = floorf(t);
  const int x0 = static_cast<int>(f);  // t lies in [-0.5, L - 0.5]
  const int off = 511 & ~(2 * lp - 1);
  lo = (x0 & (lp - 1)) + off;
  hi = ((x0 + 1) & (lp - 1)) + off;
  w = t - f;
}

// A slot's visibility words: the weights (w00 + px*dx) + py*dy of its three
// edge functions and 1/z, and its bbox.
struct SlotVis {
  float w00[3], dx[3], dy[3], rvz[3];
  int xmin, xmax, ymin, ymax;
};

// From a slot record: r[0] = (w00.x, w00.y, w00.z, dx.x), r[1] = (dx.y,
// dx.z, dy.x, dy.y), r[2] = (dy.z, rvz.x, rvz.y, rvz.z), r[3] = the bbox.
__device__ __forceinline__ SlotVis vis_of_record(const float4* r) {
  const float4 a = r[0], b = r[1], c = r[2];
  const int4 box = reinterpret_cast<const int4*>(r)[3];
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x},
          {c.y, c.z, c.w}, box.x, box.y, box.z, box.w};
}

// A tile's first and last pixel column and framebuffer row.
struct TileBox {
  int x0, x1, y0, y1;
};

// Whether bbox (xmin, xmax, ymin, ymax) meets the tile.
__device__ __forceinline__ bool box_meets(int4 b, TileBox t) {
  return b.x <= t.x1 && b.y >= t.x0 && b.z <= t.y1 && b.w >= t.y0;
}

// Whether a slot may cover a pixel of the tile: its bbox meets the tile, and
// each edge function is >= 0 somewhere in it. Each edge function, rounded as
// the visit rounds it, is monotone in px and in py, so its largest value
// over the tile is at the corner its signs pick: a slot failing this covers
// no pixel here (a NaN keeps it). Both kernels cull with it.
__device__ __forceinline__ bool tile_may_cover(const SlotVis& v, TileBox t) {
  if (!box_meets(make_int4(v.xmin, v.xmax, v.ymin, v.ymax), t)) {
    return false;
  }
  const float x0 = static_cast<float>(t.x0), x1 = static_cast<float>(t.x1);
  const float y0 = static_cast<float>(t.y0), y1 = static_cast<float>(t.y1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if ((v.w00[k] + (v.dx[k] >= 0.0f ? x1 : x0) * v.dx[k])
            + (v.dy[k] >= 0.0f ? y1 : y0) * v.dy[k]
        < 0.0f) {
      return false;
    }
  }
  return true;
}

// 1/z of a slot at pixel (px, py) where it covers it, else 0. Each edge
// function rounds as (w00 + px*dx) + py*dy, as the plain versions do.
__device__ __forceinline__ float vis_ooz(const SlotVis& v, int px, int py,
                                         float pxf, float pyf) {
  const float w0 = v.w00[0] + pxf * v.dx[0] + pyf * v.dy[0];
  const float w1 = v.w00[1] + pxf * v.dx[1] + pyf * v.dy[1];
  const float w2 = v.w00[2] + pxf * v.dx[2] + pyf * v.dy[2];
  const bool cover = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && px >= v.xmin
                     && px <= v.xmax && py >= v.ymin && py <= v.ymax;
  return cover ? w0 * v.rvz[0] + w1 * v.rvz[1] + w2 * v.rvz[2] : 0.0f;
}

// Compaction by ballot over the block: returns how many threads keep, and
// sets ``at`` to this thread's place among them, in lane order. warp_kept
// (kWarps ints of shared memory) may be written again only after every
// thread has passed a later __syncthreads.
__device__ __forceinline__ int block_compact(bool keep, int lane,
                                             int* warp_kept, int& at) {
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane % 32 == 0) warp_kept[lane / 32] = __popc(ballot);
  __syncthreads();
  int kept = 0;
  at = __popc(ballot & ((1u << (lane % 32)) - 1u));
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    at += w < lane / 32 ? warp_kept[w] : 0;
    kept += warp_kept[w];
  }
  return kept;
}

// Phases 2 and 3 for one pixel, and its stores: depth (and, tracking, the
// winner's gid or -1), then the background where nothing won, the winner's
// flat colour pack, or its nearest texel (or bilinear blend of four) times
// the shade. T(r) and I(r) read the winner's f32 and i32 table rows r (only
// where win >= 0); py is the framebuffer row, row = py - y0 the output row.
// The timing forms store the winner itself (kVis) or stop before the fetch,
// a textured winner at the background (kShade).
template <bool kBilinear, bool kTrackIds, int kPhases, class F32, class I32>
__device__ __forceinline__ void shade_and_store(
    F32 T, I32 I, const int* __restrict__ atlas, int num_textures,
    float best, int win, int px, int py, int row, int width, int height,
    int background, int* __restrict__ pix, float* __restrict__ depth,
    int* __restrict__ gid) {
  if (px >= width || row >= height) return;
  const size_t o = static_cast<size_t>(row) * width + px;
  depth[o] = best;
  if constexpr (kTrackIds) gid[o] = win < 0 ? -1 : I(kGID);
  if constexpr (kPhases == kVis) {
    pix[o] = win;
    return;
  }
  if (win < 0) {
    pix[o] = background;
    return;
  }
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);

  // ---- phase 2: shade the winner (render.swift:326-331) ----
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
  if (I(kISTEX) == 0) {
    pix[o] = pack_rgb(sh, cr, cg, cb);
    return;
  }
  if constexpr (kPhases == kShade) {
    pix[o] = background;
    return;
  }

  // ---- phase 3: ripmap level per axis, texel fetch, shade multiply ----
  // (cr, cg) is the perspective-correct (u, v) (render.swift:94-111).
  const float lvl_u = best / fabsf(T(kTPP + 0) - cr * T(kDZV + 0));
  const float lvl_v = best / fabsf(T(kTPP + 1) - cg * T(kDZV + 1));
  const int tex = min(max(I(kTEXBASE) >> 18, 0),
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

// The flat kernels' slot limit: ops/raster.py's FLAT_MAX_SLOTS. A frame's
// table stays in shared memory.
constexpr int kFlatMaxSlots = 125;
// The most tiles a flat block covers, spread over its frame (the launch
// gives each block fewer when the frames have too few tiles to fill the
// card with full blocks), and the blocks a SM it is built for, which caps
// its registers. Chosen on the card (tools/seg_variants.py; PERF.md).
constexpr int kFlatTiles = 16;
constexpr int kFlatBlocksPerSM = 6;
// A staged slot, slot-major and 16-byte aligned, so that a visit reads four
// shared-memory words of 16 bytes and shading reads every row at a constant
// offset: words 0-15 the visibility record (pack_slot_records' layout: the
// f32 rows kW00 .. kRVZ + 2, then the i32 rows kXMIN .. kYMAX), words 16-46
// the f32 rows kCVP .. kDZV + 1, words 47-49 the i32 rows kTEXBASE .. kGID.
constexpr int kFlatRecWords = 52;
constexpr int kFlatRecRows = kF32Rows + kI32Rows;
__device__ __forceinline__ constexpr int flat_word_f32(int r) {
  return r < kVisF32Rows ? r : r + kVisI32Rows;
}
__device__ __forceinline__ constexpr int flat_word_i32(int r) {
  return r < kVisI32Rows ? kVisF32Rows + r : kF32Rows + r;
}

template <bool kBilinear, bool kTrackIds, int kPhases>
__global__ void __launch_bounds__(kThreads, kFlatBlocksPerSM)
raster_flat_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
                   const float* __restrict__ trf, const int* __restrict__ tri,
                   const int* __restrict__ atlas, int num_textures,
                   int* __restrict__ pix, float* __restrict__ depth,
                   int* __restrict__ gid, int S, int width, int height, int y0,
                   int background) {
  static_assert(kFlatTiles <= 32, "one warp scans the tiles' counts");
  static_assert(kFlatMaxSlots <= kThreads, "one slot a thread");
  constexpr int kMaskWords = (kFlatMaxSlots + 31) / 32;
  static_assert(kFlatMaxSlots < 256 && kFlatTiles * kFlatMaxSlots < 32768,
                "slots fit a byte, pairs a short");
  constexpr int kPairs = kFlatTiles * kFlatMaxSlots;
  __shared__ float4 recs[kFlatMaxSlots * kFlatRecWords / 4];
  __shared__ int list_start[kFlatTiles + 1];  // each tile's first pair
  // The tiles' lists, tile-major, then (the cull reads pair p before any
  // survivor lands at or before p) the survivors, tile-major.
  __shared__ unsigned char pairs_then_kept[kPairs];
  __shared__ short kept_before[kPairs + 1];   // survivors before each pair
  __shared__ unsigned listed_mask[kMaskWords];  // slots some tile lists
  __shared__ unsigned char marked_slots[kFlatMaxSlots];  // those, ascending
  __shared__ int warp_kept[kWarps];
  S3D_FRAME_OFFSETS();
  float* const words = reinterpret_cast<float*>(recs);
  auto rec = [&](int s) { return recs + s * (kFlatRecWords / 4); };
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  const int ntx = (width + kTileW - 1) / kTileW;
  const int ntiles = ntx * ((height + kTileH - 1) / kTileH);
  // This block's tiles of frame blockIdx.z: tile(k) = blockIdx.x + k *
  // gridDim.x for k < mine, spread over the frame, so that every block gets
  // a like share of its empty and its drawn tiles.
  const int mine = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto tile = [&](int k) {
    return static_cast<int>(blockIdx.x + k * gridDim.x);
  };
  const int* __restrict__ frame_counts =
      counts + static_cast<size_t>(blockIdx.z) * ntiles;
  const int* __restrict__ frame_ids =
      ids + static_cast<size_t>(blockIdx.z) * ntiles * S;

  // ---- set-up, once for the block: warp 0 reads and scans its tiles'
  // counts; every listed slot id of the tiles, each listed slot marked;
  // then the marked slots' table columns, transposed to slot-major records
  // with cp.async, 4 bytes a copy ----
  if (lane < kMaskWords) listed_mask[lane] = 0u;
  if (lane < 32) {  // warp 0: list_start[k + 1] = counts of tiles 0 .. k
    int c = lane < mine ? frame_counts[tile(lane)] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, c, d);
      c += lane >= d ? up : 0;
    }
    if (lane < mine) list_start[lane + 1] = c;
    if (lane == 0) list_start[0] = 0;
  }
  __syncthreads();
  const int pairs = list_start[mine];
  auto tile_of = [&](int p) {  // the k whose list holds pair p
    int k = 0;
    while (list_start[k + 1] <= p) ++k;
    return k;
  };
  for (int p = lane; p < pairs; p += kThreads) {
    const int k = tile_of(p);
    const int s = frame_ids[static_cast<size_t>(tile(k)) * S
                            + (p - list_start[k])];
    pairs_then_kept[p] = static_cast<unsigned char>(s);
    atomicOr(&listed_mask[s / 32], 1u << (s % 32));
  }
  __syncthreads();
  int at;
  const bool marked_here =
      lane < S && ((listed_mask[lane / 32] >> (lane % 32)) & 1u);
  const int marked = block_compact(marked_here, lane, warp_kept, at);
  if (marked_here) marked_slots[at] = static_cast<unsigned char>(lane);
  __syncthreads();
  for (int e = lane; e < marked * kFlatRecRows; e += kThreads) {
    const int j = e / kFlatRecRows, r = e - j * kFlatRecRows;
    const int s = marked_slots[j];
    if (r < kF32Rows) {
      cp_async4(&words[s * kFlatRecWords + flat_word_f32(r)],
                trf + f32_frame + r * S + s);
    } else {
      const int ri = r - kF32Rows;
      cp_async4(&words[s * kFlatRecWords + flat_word_i32(ri)],
                tri + i32_frame + ri * S + s);
    }
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  // ---- phase 1a: every listed slot culled for its tile, one a thread,
  // the survivors compacted by ballot in the lists' order (so each tile's
  // stay ascending); tile k's survivors are kept[kept_before[list_start[k]]
  // .. kept_before[list_start[k + 1]]) ----
  auto box_of = [&](int k) {
    const int t = tile(k), ty = t / ntx, tx = t - ty * ntx;
    return TileBox{tx * kTileW, tx * kTileW + kTileW - 1, y0 + ty * kTileH,
                   y0 + ty * kTileH + kTileH - 1};
  };
  int total = 0;
  for (int base = 0; base < pairs; base += kThreads) {
    const int p = base + lane;
    const int s = p < pairs ? pairs_then_kept[p] : 0;
    const bool keep =
        p < pairs && tile_may_cover(vis_of_record(rec(s)), box_of(tile_of(p)));
    int at;
    const int kept = block_compact(keep, lane, warp_kept, at);
    if (keep) pairs_then_kept[total + at] = static_cast<unsigned char>(s);
    if (p < pairs) kept_before[p] = static_cast<short>(total + at);
    total += kept;
    __syncthreads();  // warp_kept free again
  }
  if (lane == 0) kept_before[pairs] = static_cast<short>(total);
  __syncthreads();
  const unsigned char* const kept = pairs_then_kept;

  // ---- phases 1b-3 for each tile: each pixel visits its tile's survivors
  // in ascending order; no barrier, so a warp goes on to the next tile
  // while others wait on their texels ----
  for (int k = 0; k < mine; ++k) {
    const TileBox box = box_of(k);
    const int px = box.x0 + threadIdx.x;
    const int py = box.y0 + threadIdx.y;
    const int row = py - y0;
    const float pxf = static_cast<float>(px);
    const float pyf = static_cast<float>(py);
    float best = 0.0f;  // depth cleared to 0: 1/z > 0 wherever a slot covers
    int win = -1;
    const int j1 = kept_before[list_start[k + 1]];
    for (int j = kept_before[list_start[k]]; j < j1; ++j) {
      const int s = kept[j];
      const float ooz = vis_ooz(vis_of_record(rec(s)), px, py, pxf, pyf);
      if (ooz > best) {  // strict: earlier slot wins depth ties
        best = ooz;
        win = s;
      }
    }
    const float* w = words + max(win, 0) * kFlatRecWords;
    shade_and_store<kBilinear, kTrackIds, kPhases>(
        [&](int r) { return w[flat_word_f32(r)]; },
        [&](int r) { return __float_as_int(w[flat_word_i32(r)]); }, atlas,
        num_textures, best, win, px, py, row, width, height, background, pix,
        depth, gid);
  }
}

// Slots staged per chunk of the segmented kernel's lists: 2 x 128 records
// (16 KB) of shared memory. And the blocks a SM it is built for, which caps
// it at 40 registers (uncapped, its inlined lambdas take twice that; chunks
// of 64 or 256, or 8 blocks a SM at 32 registers, ran no faster: PERF.md).
constexpr int kChunk = 128;
constexpr int kSegmentedBlocksPerSM = 6;
// Residual broadband slots a block holds after filtering them by bbox.
constexpr int kHits = 1024;

template <bool kBilinear, bool kTrackIds, int kPhases>
__global__ void __launch_bounds__(kThreads, kSegmentedBlocksPerSM)
raster_segmented_kernel(const int* __restrict__ ids,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const int* __restrict__ bb,
                        const int* __restrict__ bb_count,
                        const int4* __restrict__ bb_box,
                        const float* __restrict__ trf,
                        const int* __restrict__ tri,
                        const float4* __restrict__ rec,
                        const int* __restrict__ atlas, int num_textures,
                        int* __restrict__ pix, float* __restrict__ depth,
                        int* __restrict__ gid, int S, int entries, int g,
                        int width, int height, int y0, int background) {
  __shared__ float4 recs[2][kChunk][kRecPieces];  // double buffered
  __shared__ int slots[2][kChunk];
  __shared__ int order[kChunk];
  __shared__ int hits[kHits];
  __shared__ int warp_kept[kWarps];
  S3D_FRAME_OFFSETS();
  const size_t frame = blockIdx.z;
  ids += frame * entries;
  bb += frame * S;
  bb_box += frame * S;
  rec += frame * S * kRecPieces;
  const int ntx = gridDim.x, ntiles = ntx * gridDim.y;
  const int nsx = (ntx + g - 1) / g;
  // The frame's lists: its tiles', then its super-tiles'.
  const size_t lists = frame * (ntiles + nsx * ((gridDim.y + g - 1) / g));
  const size_t tile = lists + blockIdx.y * ntx + blockIdx.x;
  const size_t super_tile =
      lists + ntiles + (blockIdx.y / g) * nsx + blockIdx.x / g;
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  const int tx0 = blockIdx.x * kTileW, ty0 = y0 + blockIdx.y * kTileH;
  const TileBox box = {tx0, tx0 + kTileW - 1, ty0, ty0 + kTileH - 1};
  const int px = tx0 + threadIdx.x;
  const int row = blockIdx.y * kTileH + threadIdx.y;
  const int py = y0 + row;
  const int a0 = starts[tile], a1 = starts[super_tile];
  const int c0 = counts[tile], c1 = c0 + counts[super_tile];
  const int wide = bb_count[frame];

  // The order-independent form of the strict '>' over ascending slots.
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);
  float best = 0.0f;
  int win = -1;
  auto visit = [&](int s, const float4* r) {
    const float ooz = vis_ooz(vis_of_record(r), px, py, pxf, pyf);
    if (ooz > best || (ooz == best && ooz > 0.0f && s < win)) {
      best = ooz;
      win = s;
    }
  };

  // ---- phase 1a: filter a long residual broadband list ----
  // A list longer than one chunk is filtered into hits[], a window of
  // kThreads slots at a time (one slot a thread, its bbox from bb_box, in
  // the list's order, so the load needs no slot id), while a window still
  // fits; [r, wide) stays unfiltered. A shorter list is walked unfiltered
  // (r = 0): filtering it would cost more than copying it.
  int r = 0, nh = 0;
  if (wide > kChunk) {
    do {
      const int i = r + lane;
      const bool hit = i < wide && box_meets(bb_box[i], box);
      int at;
      const int kept = block_compact(hit, lane, warp_kept, at);
      if (hit) hits[nh + at] = bb[i];
      __syncthreads();  // hits complete; warp_kept free again
      nh += kept;
      r += kThreads;
    } while (r < wide && nh <= kHits - kThreads);
    r = min(r, wide);
  }

  // ---- phase 1b: stage chunk c while culling and visiting chunk c - 1 ----
  // One run of n slots, kChunk at a time: [0, e0) the tile's segment (ids
  // from a0), [e0, e1) its super-tile's (ids from a1), [e1, e2) the hits,
  // [e2, n) the residual list's unfiltered rest (from r).
  const int e0 = c0, e1 = c1, e2 = e1 + nh, n = e2 + (wide - r);
  const int chunks = (n + kChunk - 1) / kChunk;
  // Stage chunk c in buffer ``buf``: its slots in slots[buf] and their
  // records copied to recs[buf] asynchronously, 16 bytes a thread and four
  // threads a record, in one commit group. Returns the number staged.
  auto stage = [&](int c, int buf) {
    const int piece = lane % kRecPieces;
    for (int j = lane / kRecPieces; j < kChunk; j += kThreads / kRecPieces) {
      const int i = c * kChunk + j;
      if (i >= n) break;
      const int s = i < e0   ? ids[a0 + i]
                    : i < e1 ? ids[a1 + (i - e0)]
                    : i < e2 ? hits[i - e1]
                             : bb[r + (i - e2)];
      if (piece == 0) slots[buf][j] = s;
      cp_async16(&recs[buf][j][piece], rec + s * kRecPieces + piece);
    }
    cp_async_commit();
    return min(kChunk, n - c * kChunk);
  };
  int m = 0;
  for (int c = 0; c <= chunks; ++c) {
    const int staged = c < chunks ? stage(c, c & 1) : 0;
    if (c > 0) {
      const int buf = (c - 1) & 1;
      cp_async_wait(c < chunks);  // chunk c - 1's copies have landed ...
      __syncthreads();            // ... in every thread
      // The records that may cover a pixel, compacted by ballot.
      const bool keep =
          lane < m && tile_may_cover(vis_of_record(recs[buf][lane]), box);
      int at;
      const int kept = block_compact(keep, lane, warp_kept, at);
      if (keep) order[at] = lane;
      __syncthreads();
      for (int j = 0; j < kept; ++j) {
        const int k = order[j];
        visit(slots[buf][k], recs[buf][k]);
      }
      __syncthreads();  // buffer buf and order are free again
    }
    m = staged;
  }
  const int f = f32_frame + win, i = i32_frame + win;
  shade_and_store<kBilinear, kTrackIds, kPhases>(
      [&](int r) { return trf[r * S + f]; },
      [&](int r) { return tri[r * S + i]; }, atlas, num_textures, best, win,
      px, py, row, width, height, background, pix, depth, gid);
}

bool bad_frame(int frames, int width, int height, int S) {
  return frames <= 0 || frames > 65535 || width <= 0 || height <= 0 || S < 0;
}

// The segmented kernels' grid: one block a tile.
dim3 tile_grid(int frames, int width, int height) {
  return dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
              frames);
}

// The flat kernels' grid: each frame's tiles dealt to blocks of at most
// kFlatTiles tiles, and no more tiles a block than it takes for the
// launch's blocks to fill the card's SMs once (a band or a small frame gets
// more blocks of fewer tiles).
dim3 flat_grid(int frames, int width, int height) {
  const dim3 tiles = tile_grid(frames, width, height);
  const long long ntiles = static_cast<long long>(tiles.x) * tiles.y;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long slots = static_cast<long long>(sms) * kFlatBlocksPerSM;
  const long long per_block =
      std::min<long long>(kFlatTiles, std::max<long long>(
          1, (ntiles * frames + slots - 1) / slots));
  return dim3(static_cast<unsigned>((ntiles + per_block - 1) / per_block), 1,
              frames);
}

// A launch's arguments, as the C entry points take them.
struct FlatArgs {
  const void *counts, *ids, *trf, *tri, *atlas;
  void *pix, *depth, *gid;
  int frames, S, num_textures, width, height, y0, background;
  void* stream;
};

struct SegmentedArgs {
  const void *ids, *starts, *counts, *bb, *bb_count, *bb_box, *trf, *tri,
      *rec, *atlas;
  void *pix, *depth, *gid;
  int frames, S, entries, g, num_textures, width, height, y0, background;
  void* stream;
};

template <bool kBilinear, bool kTrackIds, int kPhases>
void start_flat(const FlatArgs& a) {
  raster_flat_kernel<kBilinear, kTrackIds, kPhases>
      <<<flat_grid(a.frames, a.width, a.height), dim3(kTileW, kTileH), 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const int*>(a.counts), static_cast<const int*>(a.ids),
          static_cast<const float*>(a.trf), static_cast<const int*>(a.tri),
          static_cast<const int*>(a.atlas), a.num_textures,
          static_cast<int*>(a.pix), static_cast<float*>(a.depth),
          static_cast<int*>(a.gid), a.S, a.width, a.height, a.y0,
          a.background);
}

template <bool kBilinear, bool kTrackIds, int kPhases>
void start_segmented(const SegmentedArgs& a) {
  raster_segmented_kernel<kBilinear, kTrackIds, kPhases>
      <<<tile_grid(a.frames, a.width, a.height), dim3(kTileW, kTileH), 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const int*>(a.ids), static_cast<const int*>(a.starts),
          static_cast<const int*>(a.counts), static_cast<const int*>(a.bb),
          static_cast<const int*>(a.bb_count),
          static_cast<const int4*>(a.bb_box), static_cast<const float*>(a.trf),
          static_cast<const int*>(a.tri), static_cast<const float4*>(a.rec),
          static_cast<const int*>(a.atlas), a.num_textures,
          static_cast<int*>(a.pix), static_cast<float*>(a.depth),
          static_cast<int*>(a.gid), a.S, a.entries, a.g, a.width, a.height,
          a.y0, a.background);
}

// The instances of a form: the tracking one where gid is not null.
template <bool kBilinear, int kPhases>
void start_flat_form(const FlatArgs& a) {
  if (a.gid) {
    start_flat<kBilinear, true, kPhases>(a);
  } else {
    start_flat<kBilinear, false, kPhases>(a);
  }
}

template <bool kBilinear, int kPhases>
void start_segmented_form(const SegmentedArgs& a) {
  if (a.gid) {
    start_segmented<kBilinear, true, kPhases>(a);
  } else {
    start_segmented<kBilinear, false, kPhases>(a);
  }
}

// The timing forms stop before the texel fetch, where alone the samplings
// differ, so both samplings launch the nearest instance of each.

// At most kFlatMaxSlots slots: a frame's rows fit the block's shared memory.
template <bool kBilinear>
int launch_flat(const FlatArgs& a, int phases) {
  if (bad_frame(a.frames, a.width, a.height, a.S) || a.S > kFlatMaxSlots
      || a.y0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (phases) {
    case kFull: start_flat_form<kBilinear, kFull>(a); break;
    case kVis: start_flat_form<false, kVis>(a); break;
    case kShade: start_flat_form<false, kShade>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Boxes and records are read 16 bytes at a time: ``bb_box`` and ``rec``
// must be 16-byte aligned.
template <bool kBilinear>
int launch_segmented(const SegmentedArgs& a, int phases) {
  if (bad_frame(a.frames, a.width, a.height, a.S) || a.entries < 0
      || a.y0 < 0 || a.g < 1 || reinterpret_cast<size_t>(a.rec) % 16 != 0
      || reinterpret_cast<size_t>(a.bb_box) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (phases) {
    case kFull: start_segmented_form<kBilinear, kFull>(a); break;
    case kVis: start_segmented_form<false, kVis>(a); break;
    case kShade: start_segmented_form<false, kShade>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches its kernel on ``stream``, one block a tile (the
// segmented kernels) or up to kFlatTiles tiles (the flat ones, at most
// kFlatMaxSlots slots) of each frame, covering framebuffer rows [y0, y0 + H),
// in the form ``phases`` (kFull, kVis or kShade), and returns
// cudaGetLastError() (0 when the launch was accepted). Per-frame inputs and
// outputs are frame-major: frame b's are at b times one frame's size. With a
// non-null gid the tracking form also writes the winners' gids there; with a
// null gid it is the kernel without them.
extern "C" int raster_flat_nearest(const void* counts, const void* ids,
                                   const void* trf, const void* tri,
                                   const void* atlas, void* pix, void* depth,
                                   void* gid, int frames, int S,
                                   int num_textures, int width, int height,
                                   int y0, int background, int phases,
                                   void* stream) {
  return launch_flat<false>({counts, ids, trf, tri, atlas, pix, depth, gid,
                             frames, S, num_textures, width, height, y0,
                             background, stream},
                            phases);
}

extern "C" int raster_flat_bilinear(const void* counts, const void* ids,
                                    const void* trf, const void* tri,
                                    const void* atlas, void* pix, void* depth,
                                    void* gid, int frames, int S,
                                    int num_textures, int width, int height,
                                    int y0, int background, int phases,
                                    void* stream) {
  return launch_flat<true>({counts, ids, trf, tri, atlas, pix, depth, gid,
                            frames, S, num_textures, width, height, y0,
                            background, stream},
                           phases);
}

extern "C" int raster_segmented_nearest(
    const void* ids, const void* starts, const void* counts, const void* bb,
    const void* bb_count, const void* bb_box, const void* trf, const void* tri,
    const void* rec, const void* atlas, void* pix, void* depth, void* gid,
    int frames, int S, int entries, int g, int num_textures, int width,
    int height, int y0, int background, int phases, void* stream) {
  return launch_segmented<false>(
      {ids, starts, counts, bb, bb_count, bb_box, trf, tri, rec, atlas, pix,
       depth, gid, frames, S, entries, g, num_textures, width, height, y0,
       background, stream},
      phases);
}

extern "C" int raster_segmented_bilinear(
    const void* ids, const void* starts, const void* counts, const void* bb,
    const void* bb_count, const void* bb_box, const void* trf, const void* tri,
    const void* rec, const void* atlas, void* pix, void* depth, void* gid,
    int frames, int S, int entries, int g, int num_textures, int width,
    int height, int y0, int background, int phases, void* stream) {
  return launch_segmented<true>(
      {ids, starts, counts, bb, bb_count, bb_box, trf, tri, rec, atlas, pix,
       depth, gid, frames, S, entries, g, num_textures, width, height, y0,
       background, stream},
      phases);
}

extern "C" const char* s3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
