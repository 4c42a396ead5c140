// The probes of the port: microbenchmarks of the texel fetch's load and
// select pattern, and of a chunk loop whose bound the kernel reads from
// device memory. Each is the counterpart of one Mosaic probe in the repo's
// tools/ (the TPU kernels below); swift3drenderer_tpu_torch/tools/ holds
// their wrappers, plain PyTorch versions and entry points.
//
// Launch shape. probe_gather2d, probe_packed_fetch and fetch_microbench fold
// their iteration axis with XOR or OR, which on int32 are exact, associative
// and commutative, so the axis is cut into contiguous chunks of the global
// counter that run on blocks of their own: the grid is (row groups) x
// (chunks), the chunk count chosen by the Python wrapper (tools/_probe.py,
// chunk_plan) to give the card several waves of resident blocks. A thread
// folds its pixels' iterations of the chunk into partials, and the partials
// meet in the output with one integer atomic a pixel, on an output the entry
// point zeroes first (cudaMemsetAsync): the same bits in any order, one launch
// a call, nothing read on the host. A probe then prices its pattern with the
// whole card busy (L1 or shared-memory wavefronts, bulk copies or int32
// issue, by mode), not one warp's latency. probe_dynamic_grid keeps the TPU
// probe's grid of one block a tile, but issues all of a tile's bulk copies at
// once and waits for them once, so its time is one copy's round trip and the
// launch, whatever the count.
//
// Each mode is a template instance and keeps its own access pattern as the
// card sees it: the same loads, at the same lanes and rows, from global
// memory through L1 (__ldg, ld.global.nc) or from a copy of the block in
// shared memory. Where a body does not depend on the counter, nvcc may
// simplify the loop, as Mosaic could; chip_smoke.py counts each instance's
// loads in its main loop from `cuobjdump -sass` and fails a redesigned mode
// whose loop holds fewer than its loads an iteration times the iterations
// (or pixels) a step covers, or whose time falls under its bound.
//
// Built with the raster kernels' flags (kernels/__init__.py): sm_90a,
// --fmad=false. Integer arithmetic is exact, so every kernel equals its plain
// version bit for bit; the chunk loop's float sums are of small integers.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // a TPU vreg row: one block's threads
constexpr int kBlocks = 64;   // atlas blocks a fetch probe cycles through
constexpr int kRowWords = 8 * kLanes;   // an (8, 128) block of int32
constexpr uint32_t kRowBytes = kRowWords * sizeof(int);

// The TPU probes' 3-level select tree over a block's eight rows: bit 0 of
// `r` picks within pairs, bit 1 within quads, bit 2 the half.
__device__ __forceinline__ int select_tree(const int g[8], int r) {
  const bool b0 = (r & 1) != 0, b1 = (r & 2) != 0, b2 = (r & 4) != 0;
  const int s00 = b0 ? g[1] : g[0], s01 = b0 ? g[3] : g[2];
  const int s02 = b0 ? g[5] : g[4], s03 = b0 ? g[7] : g[6];
  const int s10 = b1 ? s01 : s00, s11 = b1 ? s03 : s02;
  return b2 ? s11 : s10;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Hopper's mbarrier and 1-D bulk copy (the counterparts of Mosaic's DMA
// semaphores and async copies), for the staged gather below.
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Arrive on ``bar`` and add ``bytes`` to the transfer its phase waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy ``bytes`` (a multiple of 16, both ends 16-byte aligned) from global
// to shared memory, counting them on ``bar`` as they land; the arrival that
// expects them is the caller's.
__device__ __forceinline__ void bulk_copy_tx(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One copy that completes the phase of ``bar`` (initialised for one
// arrival) when it has landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  bar_arrive_tx(bar, bytes);
  bulk_copy_tx(dst, src, bytes, bar);
}

// The chunk loop of fetch_microbench, probe_packed_fetch and probe_gather2d's
// sub8 (a body that reads L1 or one block in shared memory). A block of the
// grid (rows, chunks) folds iterations [lo, lo + n) of the global counter,
// n = min(chunk, iters - lo) (0 in the one block of an empty call), with op
// over body(it): kUnroll iterations a step into kUnroll accumulators, so
// their loads are in flight together, then the ragged rest. The step loop stays
// rolled (`#pragma unroll 1`): kUnroll < 64 iterations a step visit kUnroll
// distinct atlas blocks (probe_packed_fetch: lanes shifted by it & mix, a
// runtime value), so nvcc cannot prove two loads of a step share an address
// and merge them (an XOR of a load with itself would cancel both).
constexpr int kUnroll = 4;   // tools/_probe.py UNROLL

template <class Body, class Op>
__device__ __forceinline__ int fold_chunk(int iters, int chunk, Body body,
                                          Op op) {
  const int lo = blockIdx.y * chunk;   // (chunks - 1) * chunk < iters
  const int hi = lo + max(0, min(chunk, iters - lo));
  int acc[kUnroll] = {};
  int it = lo;
#pragma unroll 1
  for (; hi - it >= kUnroll; it += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) acc[j] = op(acc[j], body(it + j));
  }
#pragma unroll 1
  for (; it < hi; ++it) acc[0] = op(acc[0], body(it));
#pragma unroll
  for (int j = 1; j < kUnroll; ++j) acc[0] = op(acc[0], acc[j]);
  return acc[0];
}

// ---------------------------------------------------------------------------
// probe_gather2d: replaces tools/probe_gather2d.py::build (:123,
// pl.pallas_call :124), kernel make_kernel (:40). For it in [0, iters), with
// b = it % 64, XOR-accumulate one texel per pixel out of atlas block b.
// The design: the iterations spread over the whole card, the partials XORed
// into the zeroed output with atomicXor. Each mode reads its blocks the way
// that measured faster on the H100 (tools/probe_variants.py):
// - base8, ta1024, take1024, ta4096 stage them in shared memory
//   (probe_gather2d_staged_kernel): one bulk copy of a block serves a
//   16-row strip, and a warp's scattered load costs its bank conflicts, ~3
//   wavefronts (base8 ~22 an iteration over eight loads), where through L1
//   it costs ~4-29 lines (base8, ta1024) or, for ta4096's 1 MB atlas, misses
//   to L2. Bound: shared-memory wavefronts; ta4096 the copies from L2.
// - sub8 reads through L1 (probe_gather2d_kernel): its load is one row of
//   its own lanes, conflict-free in shared memory, so staging costs more in
//   copies and barriers than it saves. Bound: L1 wavefronts.
// The table's bound (lane operations at the fp32 rate) is below all of them.

enum Gather2dMode { kBase8 = 0, kSub8 = 1, kTa1024 = 2, kTake1024 = 3,
                    kTa4096 = 4 };

// Words of one atlas block: 8 rows of 128 lanes, or of 512 for ta4096.
template <int kMode>
constexpr int kBlockWords = kMode == kTa4096 ? 4096 : 1024;

// Which modes stage the blocks their iterations visit in shared memory
// (bit m for mode m); the others read them through L1 (__ldg).
constexpr unsigned kStagedGather2d = 0x1D;   // all but sub8

// One iteration: the texel the pixel takes from the atlas block at ``blk``
// (block it % 64), each word read with ``load``.
template <int kMode, class Load>
__device__ __forceinline__ int gather2d_texel(const int* blk, int rel, int ln,
                                              int lane, Load load) {
  if constexpr (kMode == kBase8) {
    // eight row loads at the pixel's lane, then the tree.
    int g[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) g[r] = load(blk + r * kLanes + ln);
    return select_tree(g, rel);
  } else if constexpr (kMode == kSub8) {
    return load(blk + rel * kLanes + lane);   // (rel, own lane)
  } else if constexpr (kMode == kTa1024 || kMode == kTake1024) {
    return load(blk + ((rel << 7) | ln));     // the block flattened
  } else {
    return load(blk + ((rel << 9) | ln));     // four lane chunks a row
  }
}

// Through L1: a block of 128 threads, one pixel of one row each.
template <int kMode>
__global__ void __launch_bounds__(kLanes) probe_gather2d_kernel(
    const int* __restrict__ atlas, const int* __restrict__ rel_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters,
    int chunk) {
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kLanes + lane;
  const int rel = rel_in[i];   // [0, 8)
  const int ln = ln_in[i];     // [0, 128), or [0, 512) for ta4096
  const int part = fold_chunk(
      iters, chunk,
      [=](int it) {
        return gather2d_texel<kMode>(
            atlas + (it & (kBlocks - 1)) * kBlockWords<kMode>, rel, ln, lane,
            [](const int* p) { return __ldg(p); });
      },
      [](int a, int v) { return a ^ v; });
  atomicXor(out + i, part);
}

// Staged: a block of kStagedThreads threads covers a 16-row strip, kPixels
// pixels a thread (rows y and y + 8). Thread 0 keeps a ring of kStages
// stages in shared memory, each the blocks of kStageBytes / (block bytes)
// consecutive iterations (4 blocks of 4 KB, or 1 of 16 KB: contiguous, as a
// chunk starts on a multiple of 4), copied by one cp.async.bulk; each warp
// reads a stage with the mode's pattern and frees it when done. One copy of
// a block serves 2,048 pixels, against an L1 line a warp's load; a stage of
// several iterations pays the barriers once for all of them.
// kPixels and kStageBytes are tools/probe_gather2d.py's STAGED_PIXELS and
// STAGE_BYTES, from which chip_smoke.py counts the loads a stage must hold.
constexpr int kStagedThreads = 1024;
constexpr int kPixels = 2;
constexpr int kStagedRows = kPixels * kStagedThreads / kLanes;
constexpr int kStageBytes = 16 * 1024;
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;

template <int kMode>
__global__ void __launch_bounds__(kStagedThreads) probe_gather2d_staged_kernel(
    const int* __restrict__ atlas, const int* __restrict__ rel_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters,
    int chunk) {
  constexpr int kWords = kBlockWords<kMode>;
  constexpr int kGroup = kStageBytes / (kWords * 4);   // iterations a stage
  extern __shared__ __align__(128) int ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int t = threadIdx.x, lane = t & (kLanes - 1);
  const int i = blockIdx.x * kStagedRows * kLanes + t;
  int rel[kPixels], ln[kPixels], acc[kPixels] = {};
#pragma unroll
  for (int p = 0; p < kPixels; ++p) {
    rel[p] = rel_in[i + p * kStagedThreads];
    ln[p] = ln_in[i + p * kStagedThreads];
  }
  const int lo = blockIdx.y * chunk;
  const int n = max(0, min(chunk, iters - lo));
  const int stages = (n + kGroup - 1) / kGroup;
  const auto stage = [&](int g) {   // stage g into slot g % kStages
    const int m = min(kGroup, n - g * kGroup);
    bulk_copy(ring + g % kStages * kGroup * kWords,
              atlas + ((lo + g * kGroup) & (kBlocks - 1)) * kWords,
              m * kWords * 4, &full[g % kStages]);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kStagedThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int g = 0; g < min(stages, kStages); ++g) stage(g);
  }
  __syncthreads();
#pragma unroll 1
  for (int g = 0; g < stages; ++g) {
    const int s = g % kStages;
    const uint32_t parity = (g / kStages) & 1;
    const int m = min(kGroup, n - g * kGroup);
    bar_wait(&full[s], parity);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < m) {
        const int* blk = ring + (s * kGroup + j) * kWords;
#pragma unroll
        for (int p = 0; p < kPixels; ++p)
          acc[p] ^= gather2d_texel<kMode>(blk, rel[p], ln[p], lane,
                                          [](const int* q) { return *q; });
      }
    }
    __syncwarp();
    if ((t & 31) == 0) bar_arrive(&empty[s]);
    if (t == 0 && g + kStages < stages) {
      bar_wait(&empty[s], parity);   // every warp is done with slot s
      stage(g + kStages);
    }
  }
#pragma unroll
  for (int p = 0; p < kPixels; ++p)
    atomicXor(out + i + p * kStagedThreads, acc[p]);
}

// ---------------------------------------------------------------------------
// probe_packed_fetch: replaces tools/probe_packed_fetch.py::run (:102,
// pl.pallas_call :103), kernel make_kernel (:51). OR-accumulate over iters,
// at lane (ln + (it & mix)) & 127 of one (8, 128) block, it the global
// counter. The design: probe_gather2d's, the iterations spread over the
// whole card by fold_chunk and the partials ORed into the zeroed output with
// atomicOr. On the TPU the whole block sits in VMEM (the pallas_call has no
// grid); its counterpart on the card is shared memory: a staged mode's block
// of 128 threads copies the 4 KB block there once (one bulk copy on an
// mbarrier) and reads every iteration from it, a warp's load costing its
// bank conflicts (gather8 ~21.6 wavefronts an iteration over eight loads,
// packed4 ~16.2 over six). Through L1 (__ldg) the same load costs the 128-byte
// lines it touches (32 and 24 an iteration). On the H100 both builds take
// ~2.45 SM cycles a warp-wide load, so each mode's time follows its loads;
// each takes the build that measured faster (tools/probe_variants.py):
// gather8 staged (by 0.3 %), packed4 and packed4sel through L1 (by 1.7 %);
// empty has no load and is held by int32 issue. The table's bound (lane
// operations at the fp32 rate) is below all of them.

enum PackedMode { kGather8 = 0, kPacked4 = 1, kPacked4Sel = 2,
                  kPackedEmpty = 3 };

// Which modes read the block from a copy in shared memory (bit m for mode
// m); the others read it through L1 (__ldg).
constexpr unsigned kStagedPackedFetch = 0x1;   // gather8

// One iteration's value for a pixel whose row is ``row``, at lane ``ln0`` of
// the block ``blk``, each word read with ``load``.
template <int kMode, class Load>
__device__ __forceinline__ int packed_texel(const int* blk, int row, int ln0,
                                            Load load) {
  if constexpr (kMode == kGather8) {
    int g[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) g[r] = load(blk + r * kLanes + ln0);
    return select_tree(g, row);
  } else if constexpr (kMode == kPacked4 || kMode == kPacked4Sel) {
    // blk is pack_block's [R0 R1 G0 G1 B0 B1 0 0]: two loads a channel,
    // the quad word picked per pixel (row >> 2), then its byte.
    const bool q = (row & 4) != 0;
    const int sh8 = (row & 3) << 3;   // byte shift within the quad word
    int packed = 0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int q0 = load(blk + (2 * ch) * kLanes + ln0);
      const int q1 = load(blk + (2 * ch + 1) * kLanes + ln0);
      const int g = q ? q1 : q0;
      int byte;
      if constexpr (kMode == kPacked4) {
        byte = (g >> sh8) & 0xFF;
      } else {
        const int b0 = (row & 1) ? g >> 8 : g;
        byte = ((row & 2) ? b0 >> 16 : b0) & 0xFF;
      }
      packed |= byte << (16 - 8 * ch);
    }
    return packed;
  } else {
    return ln0;   // the loop's cost
  }
}

// Through L1: a block of 128 threads, one pixel of one row each.
template <int kMode>
__global__ void __launch_bounds__(kLanes) probe_packed_fetch_kernel(
    const int* __restrict__ blk, const int* __restrict__ row_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters,
    int chunk, int mix) {
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const int row = row_in[i];   // [0, 8)
  const int ln = ln_in[i];     // [0, 128)
  const int part = fold_chunk(
      iters, chunk,
      [=](int it) {
        return packed_texel<kMode>(blk, row, (ln + (it & mix)) & (kLanes - 1),
                                   [](const int* p) { return __ldg(p); });
      },
      [](int a, int v) { return a | v; });
  atomicOr(out + i, part);
}

// Staged: the same, every iteration reading the block's copy in shared
// memory, made once a block by one bulk copy.
template <int kMode>
__global__ void __launch_bounds__(kLanes) probe_packed_fetch_staged_kernel(
    const int* __restrict__ blk, const int* __restrict__ row_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters,
    int chunk, int mix) {
  __shared__ __align__(128) int block[kRowWords];
  __shared__ __align__(8) uint64_t full;
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const int row = row_in[i];
  const int ln = ln_in[i];
  if (threadIdx.x == 0) {
    bar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_copy(block, blk, kRowBytes, &full);
  }
  __syncthreads();   // the barrier is initialised before anyone waits on it
  bar_wait(&full, 0);
  const int* staged = block;
  const int part = fold_chunk(
      iters, chunk,
      [=](int it) {
        return packed_texel<kMode>(staged, row,
                                   (ln + (it & mix)) & (kLanes - 1),
                                   [](const int* p) { return *p; });
      },
      [](int a, int v) { return a | v; });
  atomicOr(out + i, part);
}

// ---------------------------------------------------------------------------
// fetch_microbench: replaces tools/fetch_microbench.py::run (:72,
// pl.pallas_call :77), kernel make_kernel (:32). The fetch block loop split
// into its parts, OR-accumulated over iters: block b % 64 of a (512, 512)
// atlas is rows (b % 64) * 8 .. + 8 of its first 128 columns, and row r's
// texel counts where key == b * 8 + r (b the global counter). Bound on this
// card: int32 issue, the ALU pipe's compares, selects and ORs at half the
// fp32 lane rate (~20-28 a warp-iteration for full, nogather and noload, a
// few for loadonly and empty); noselect's eight loads sit near the L1 floor
// of one wavefront a load (the tool's ln is the pixel's own lane). The
// design is probe_gather2d's L1 path: the iterations spread over the card
// by fold_chunk, the partials ORed into the zeroed output with atomicOr.
// Staging would save nothing: each load already costs one wavefront.

enum MicroMode { kFull = 0, kNoLoad = 1, kNoGather = 2, kNoSelect = 3,
                 kLoadOnly = 4, kMicroEmpty = 5 };
constexpr int kMicroAtlasW = 512;

// One iteration b: the mode's part of the fetch body over block b % 64.
template <int kMode>
__device__ __forceinline__ int fetch_body(const int* __restrict__ atlas,
                                          int b, int key, int ln, int lane) {
  if constexpr (kMode == kMicroEmpty) {
    return b;
  } else {
    const int* blk = atlas + (b & (kBlocks - 1)) * 8 * kMicroAtlasW;
    if constexpr (kMode == kLoadOnly) {
      return __ldg(blk + lane);   // row 0 at the pixel's own lane
    } else {
      int c[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        int g;
        if constexpr (kMode == kNoLoad) {
          g = 7;                                      // the constant block
        } else if constexpr (kMode == kNoGather) {
          g = __ldg(blk + r * kMicroAtlasW + lane);   // own lane
        } else {
          g = __ldg(blk + r * kMicroAtlasW + ln);     // the pixel's lane
        }
        if constexpr (kMode == kNoSelect) {
          c[r] = g;
        } else {
          c[r] = key == b * 8 + r ? g : 0;
        }
      }
      return ((c[0] | c[1]) | (c[2] | c[3])) | ((c[4] | c[5]) | (c[6] | c[7]));
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kLanes) fetch_microbench_kernel(
    const int* __restrict__ atlas, const int* __restrict__ key_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters,
    int chunk) {
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kLanes + lane;
  const int key = key_in[i];
  const int ln = ln_in[i];
  const int part = fold_chunk(
      iters, chunk,
      [=](int b) { return fetch_body<kMode>(atlas, b, key, ln, lane); },
      [](int a, int v) { return a | v; });
  atomicOr(out + i, part);
}

// ---------------------------------------------------------------------------
// probe_dynamic_grid: replaces tools/probe_dynamic_grid.py::run (:51,
// pl.pallas_call :52), kernel `kernel` (:34). The TPU grid (NT, nc) with a
// traced nc becomes one block per tile t that reads nc from device memory
// (the host never reads it) and clamps it to [0, kNCMax], so nothing outside
// the arrays is read. Thread 0 then issues the copies of hbm rows
// t * kNCMax + c for every c < nc at once, each 4 KB into its own slot of a
// kNCMax-slot buffer in shared memory, with Hopper's 1-D bulk copy
// (cp.async.bulk), their bytes counted on one mbarrier that one arrival
// expects in full (the counterpart of pltpu.make_async_copy and its DMA
// semaphore). While the copies fly every thread loads its tab[c * 8, 0]; the
// block waits once, then adds tab[c * 8, 0] + (float)row_c[0] to a register
// accumulator from 0 in the order c = 0, 1, ... and stores its output word.
// The (8, 128) output block is stored once: on the TPU it is revisited
// across c and zeroed under pl.when(c == 0), but blocks run in no order on
// the card, so the chunk axis lives inside the block. Bound: the bytes (at
// most 48 KB of rows, 12 KB out), a few ns, below any launch; the time is
// the launch and one copy's round trip, and nc = 0 (no copy) its fixed cost.

constexpr int kNT = 3;
constexpr int kNCMax = 4;

__global__ void __launch_bounds__(kRowWords) probe_dynamic_grid_kernel(
    const float* __restrict__ tab, const int* __restrict__ hbm,
    const int* __restrict__ nc_in, float* __restrict__ out) {
  __shared__ __align__(128) int rows[kNCMax * kRowWords];
  __shared__ __align__(8) uint64_t bar;
  const int t = blockIdx.x;
  const int nc = min(max(*nc_in, 0), kNCMax);
  if (threadIdx.x == 0) {
    bar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (nc > 0) {
      // One arrival expects every copy's bytes, so the phase cannot
      // complete before the last copy is issued and has landed.
      bar_arrive_tx(&bar, nc * kRowBytes);
      for (int c = 0; c < nc; ++c)
        bulk_copy_tx(rows + c * kRowWords,
                     hbm + (t * kNCMax + c) * kRowWords, kRowBytes, &bar);
    }
  }
  float tv[kNCMax];
#pragma unroll
  for (int c = 0; c < kNCMax; ++c) tv[c] = c < nc ? tab[c * kRowWords] : 0.0f;
  __syncthreads();   // the barrier is initialised before anyone waits on it
  float acc = 0.0f;
  if (nc > 0) {
    bar_wait(&bar, 0);
#pragma unroll
    for (int c = 0; c < kNCMax; ++c)
      if (c < nc) acc += tv[c] + static_cast<float>(rows[c * kRowWords]);
  }
  out[t * kRowWords + threadIdx.x] = acc;
}

int status() { return static_cast<int>(cudaGetLastError()); }

int bad_mode() { return static_cast<int>(cudaErrorInvalidValue); }

// The launch of a chunked probe: zero the (rows, 128) output, then one
// block per ``shape.rows_a_block`` rows and chunk, at least one chunk (an
// empty call launches one block a row group that folds nothing), so that
// every call is one launch. A kernel takes (atlas or block, two per-pixel
// inputs, out, iters, chunk), then the probe's own ``extra`` arguments.
using FoldKernel = void (*)(const int*, const int*, const int*, int*, int,
                           int);

struct FoldShape {
  int rows_a_block = 1;
  int threads = kLanes;
  int smem = 0;   // dynamic shared memory, bytes
};

template <class... Extra>
int fold_launch(void (*kernel)(const int*, const int*, const int*, int*, int,
                               int, Extra...),
                const void* atlas, const void* a, const void* b, void* out,
                int rows, int iters, int chunks, int chunk, void* stream,
                FoldShape shape, Extra... extra) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows % shape.rows_a_block) return bad_mode();
  const cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int) * rows * kLanes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(rows / shape.rows_a_block, chunks > 1 ? chunks : 1),
           shape.threads, shape.smem, s>>>(
      static_cast<const int*>(atlas), static_cast<const int*>(a),
      static_cast<const int*>(b), static_cast<int*>(out), iters, chunk,
      extra...);
  return status();
}

// Lift ``kernel``'s dynamic shared-memory limit to ``smem`` bytes on the
// current card, once a card: ``done`` holds a bit for each card (ids under
// 64) already set, so later launches make no such host call.
int allow_smem(FoldKernel kernel, int smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

template <int kMode>
int gather2d_launch(const void* atlas, const void* rel, const void* ln,
                    void* out, int rows, int iters, int chunks, int chunk,
                    void* stream) {
  if constexpr ((kStagedGather2d >> kMode) & 1) {
    static std::atomic<uint64_t> smem_set{0};
    if (const int err = allow_smem(probe_gather2d_staged_kernel<kMode>,
                                   kRingBytes, smem_set))
      return err;
    return fold_launch(probe_gather2d_staged_kernel<kMode>, atlas, rel, ln,
                       out, rows, iters, chunks, chunk, stream,
                       FoldShape{kStagedRows, kStagedThreads, kRingBytes});
  } else {
    return fold_launch(probe_gather2d_kernel<kMode>, atlas, rel, ln, out,
                       rows, iters, chunks, chunk, stream, FoldShape{});
  }
}

template <int kMode>
int packed_launch(const void* blk, const void* row, const void* ln, void* out,
                  int rows, int mix, int iters, int chunks, int chunk,
                  void* stream) {
  if constexpr ((kStagedPackedFetch >> kMode) & 1) {
    return fold_launch(probe_packed_fetch_staged_kernel<kMode>, blk, row, ln,
                       out, rows, iters, chunks, chunk, stream, FoldShape{},
                       mix);
  } else {
    return fold_launch(probe_packed_fetch_kernel<kMode>, blk, row, ln, out,
                       rows, iters, chunks, chunk, stream, FoldShape{}, mix);
  }
}

}  // namespace

// Each entry point launches its kernel on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a mode it does not know. The fetch probes take
// their (rows, 128) int32 inputs and output, ``mode`` the index in the
// Python module's MODES, and the chunk plan (``chunks`` blocks a row of
// ``chunk`` iterations, the last ragged), and zero their output first.

extern "C" int probe_gather2d(int mode, const void* atlas, const void* rel,
                              const void* ln, void* out, int rows, int iters,
                              int chunks, int chunk, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, void*);
  const Launch launches[] = {
      gather2d_launch<kBase8>, gather2d_launch<kSub8>,
      gather2d_launch<kTa1024>, gather2d_launch<kTake1024>,
      gather2d_launch<kTa4096>};
  if (mode < 0 || mode >= int(sizeof launches / sizeof launches[0]))
    return bad_mode();
  return launches[mode](atlas, rel, ln, out, rows, iters, chunks, chunk,
                        stream);
}

extern "C" int probe_packed_fetch(int mode, const void* blk, const void* row,
                                  const void* ln, void* out, int rows,
                                  int mix, int iters, int chunks, int chunk,
                                  void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, void*);
  const Launch launches[] = {
      packed_launch<kGather8>, packed_launch<kPacked4>,
      packed_launch<kPacked4Sel>, packed_launch<kPackedEmpty>};
  if (mode < 0 || mode >= int(sizeof launches / sizeof launches[0]))
    return bad_mode();
  return launches[mode](blk, row, ln, out, rows, mix, iters, chunks, chunk,
                        stream);
}

extern "C" int fetch_microbench(int mode, const void* atlas, const void* key,
                                const void* ln, void* out, int rows,
                                int iters, int chunks, int chunk,
                                void* stream) {
  const FoldKernel kernels[] = {
      fetch_microbench_kernel<kFull>, fetch_microbench_kernel<kNoLoad>,
      fetch_microbench_kernel<kNoGather>, fetch_microbench_kernel<kNoSelect>,
      fetch_microbench_kernel<kLoadOnly>, fetch_microbench_kernel<kMicroEmpty>};
  if (mode < 0 || mode >= int(sizeof kernels / sizeof kernels[0]))
    return bad_mode();
  return fold_launch(kernels[mode], atlas, key, ln, out, rows, iters, chunks,
                     chunk, stream, FoldShape{});
}

// tab f32 (kNCMax * 8, 128), hbm i32 (kNT * kNCMax, 8, 128), nc one i32 in
// device memory, out f32 (kNT, 8, 128): kNT blocks of 8 x 128 threads.
extern "C" int probe_dynamic_grid(const void* tab, const void* hbm,
                                  const void* nc, void* out, void* stream) {
  probe_dynamic_grid_kernel<<<kNT, kRowWords, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(hbm),
      static_cast<const int*>(nc), static_cast<float*>(out));
  return status();
}

extern "C" const char* s3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
