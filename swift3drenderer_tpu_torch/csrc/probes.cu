// The probes of the port: microbenchmarks of the texel fetch's load and
// select pattern, and of a chunk loop whose bound the kernel reads from
// device memory. Each is the counterpart of one Mosaic probe in the repo's
// tools/ (the TPU kernels below); swift3drenderer_tpu_torch/tools/ holds
// their wrappers, plain PyTorch versions and entry points.
//
// Launch shape. A probe's shape is its definition, so each keeps the TPU
// probe's: one thread per element of its (16, 128) or (32, 128) int32 output
// (one 128-thread block per row), each thread running the probe's whole
// `iters` loop, in order, with `#pragma unroll 1` as the TPU's fori_loop (no
// unroll). So 16 or 32 of the card's 132 SMs hold one block of four warps
// each, and every iteration waits on its own loads: a probe measures the
// latency of one iteration's pattern, and stays far above a bound that counts
// its work (the bytes, or its lane operations at the card's fp32 lane rate).
//
// Each mode is a template instance and keeps its own access pattern as the
// card sees it: the loads are __ldg (ld.global.nc), which the compiler may
// hoist out of the loop where their address does not depend on the loop
// counter but does not merge across a select. Where a body does not depend on
// the counter, nvcc may simplify the loop, as Mosaic could;
// chip_smoke.py counts each instance's loads inside its loop from
// `cuobjdump -sass`.
//
// Built with the raster kernels' flags (kernels/__init__.py): sm_90a,
// --fmad=false. Integer arithmetic is exact, so every kernel equals its plain
// version bit for bit; the chunk loop's float sums are of small integers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // a TPU vreg row: one block's threads
constexpr int kBlocks = 64;   // atlas blocks a fetch probe cycles through

// The TPU probes' 3-level select tree over a block's eight rows: bit 0 of
// `r` picks within pairs, bit 1 within quads, bit 2 the half.
__device__ __forceinline__ int select_tree(const int g[8], int r) {
  const bool b0 = (r & 1) != 0, b1 = (r & 2) != 0, b2 = (r & 4) != 0;
  const int s00 = b0 ? g[1] : g[0], s01 = b0 ? g[3] : g[2];
  const int s02 = b0 ? g[5] : g[4], s03 = b0 ? g[7] : g[6];
  const int s10 = b1 ? s01 : s00, s11 = b1 ? s03 : s02;
  return b2 ? s11 : s10;
}

// ---------------------------------------------------------------------------
// probe_gather2d: replaces tools/probe_gather2d.py::build (:123,
// pl.pallas_call :124), kernel make_kernel (:40). For it in [0, iters), with
// b = it % 64, XOR-accumulate one texel per pixel out of atlas block b.
// Bound: lane operations (the 256 KB-1 MB atlas is read in L1/L2), ~10-30 a
// pixel-iteration.

enum Gather2dMode { kBase8 = 0, kSub8 = 1, kTa1024 = 2, kTake1024 = 3,
                    kTa4096 = 4 };

template <int kMode>
__global__ void __launch_bounds__(kLanes) probe_gather2d_kernel(
    const int* __restrict__ atlas, const int* __restrict__ rel_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters) {
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kLanes + lane;
  const int rel = rel_in[i];   // [0, 8)
  const int ln = ln_in[i];     // [0, 128), or [0, 512) for ta4096
  int acc = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int b = it & (kBlocks - 1);   // it % 64, it >= 0
    if constexpr (kMode == kBase8) {
      // atlas (512, 128): eight row loads at the pixel's lane, then the tree.
      const int* blk = atlas + b * 8 * kLanes;
      int g[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) g[r] = __ldg(blk + r * kLanes + ln);
      acc ^= select_tree(g, rel);
    } else if constexpr (kMode == kSub8) {
      // atlas (512, 128): one load at (rel, own lane).
      acc ^= __ldg(atlas + (b * 8 + rel) * kLanes + lane);
    } else if constexpr (kMode == kTa1024 || kMode == kTake1024) {
      // atlas (64, 1024), each block flattened: one load at (rel << 7) | ln.
      acc ^= __ldg(atlas + b * 1024 + ((rel << 7) | ln));
    } else {
      // atlas (64, 4096), four lane chunks a row: one load at (rel << 9) | ln.
      acc ^= __ldg(atlas + b * 4096 + ((rel << 9) | ln));
    }
  }
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// probe_packed_fetch: replaces tools/probe_packed_fetch.py::run (:102,
// pl.pallas_call :103), kernel make_kernel (:51). OR-accumulate over iters,
// at lane (ln + (it & mix)) & 127 of one (8, 128) block. Bound: lane
// operations, ~10-45 a pixel-iteration.

enum PackedMode { kGather8 = 0, kPacked4 = 1, kPacked4Sel = 2,
                  kPackedEmpty = 3 };

template <int kMode>
__global__ void __launch_bounds__(kLanes) probe_packed_fetch_kernel(
    const int* __restrict__ blk, const int* __restrict__ row_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int mix,
    int iters) {
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const int row = row_in[i];   // [0, 8)
  const int ln = ln_in[i];     // [0, 128)
  const bool q = (row & 4) != 0;      // quad-word select (row >> 2)
  const int sh8 = (row & 3) << 3;     // byte shift within the quad word
  int acc = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int ln0 = (ln + (it & mix)) & 127;
    if constexpr (kMode == kGather8) {
      int g[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) g[r] = __ldg(blk + r * kLanes + ln0);
      acc |= select_tree(g, row);
    } else if constexpr (kMode == kPacked4 || kMode == kPacked4Sel) {
      // blk is pack_block's [R0 R1 G0 G1 B0 B1 0 0]: two loads a channel,
      // the quad word picked per pixel, then its byte.
      int packed = 0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int q0 = __ldg(blk + (2 * ch) * kLanes + ln0);
        const int q1 = __ldg(blk + (2 * ch + 1) * kLanes + ln0);
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
      acc |= packed;
    } else {
      acc |= ln0;   // loop cost
    }
  }
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// fetch_microbench: replaces tools/fetch_microbench.py::run (:72,
// pl.pallas_call :77), kernel make_kernel (:32). The fetch block loop split
// into its parts, OR-accumulated over iters: block b % 64 of a (512, 512)
// atlas is rows (b % 64) * 8 .. + 8 of its first 128 columns, and row r's
// texel counts where key == b * 8 + r. Bound: lane operations, ~3-45 a
// pixel-iteration.

enum MicroMode { kFull = 0, kNoLoad = 1, kNoGather = 2, kNoSelect = 3,
                 kLoadOnly = 4, kMicroEmpty = 5 };
constexpr int kMicroAtlasW = 512;

template <int kMode>
__global__ void __launch_bounds__(kLanes) fetch_microbench_kernel(
    const int* __restrict__ atlas, const int* __restrict__ key_in,
    const int* __restrict__ ln_in, int* __restrict__ out, int iters) {
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kLanes + lane;
  const int key = key_in[i];
  const int ln = ln_in[i];
  int acc = 0;
#pragma unroll 1
  for (int b = 0; b < iters; ++b) {
    if constexpr (kMode == kMicroEmpty) {
      acc |= b;
    } else {
      const int* blk = atlas + (b & (kBlocks - 1)) * 8 * kMicroAtlasW;
      if constexpr (kMode == kLoadOnly) {
        acc |= __ldg(blk + lane);   // row 0 at the pixel's own lane
      } else {
        int c[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          int g;
          if constexpr (kMode == kNoLoad) {
            g = 7;                                   // the constant block
          } else if constexpr (kMode == kNoGather) {
            g = __ldg(blk + r * kMicroAtlasW + lane);   // own lane
          } else {
            g = __ldg(blk + r * kMicroAtlasW + ln);      // the pixel's lane
          }
          if constexpr (kMode == kNoSelect) {
            c[r] = g;
          } else {
            c[r] = key == b * 8 + r ? g : 0;
          }
        }
        acc |= ((c[0] | c[1]) | (c[2] | c[3])) | ((c[4] | c[5]) | (c[6] | c[7]));
      }
    }
  }
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// probe_dynamic_grid: replaces tools/probe_dynamic_grid.py::run (:51,
// pl.pallas_call :52), kernel `kernel` (:34). The TPU grid (NT, nc) with a
// traced nc becomes one block per tile t whose loop over chunks c < nc reads
// nc from device memory (the host never reads it); each step copies hbm row
// t * kNCMax + c (4 KB) into shared memory with Hopper's 1-D bulk copy
// (cp.async.bulk, completion counted on an mbarrier: the counterpart of
// pltpu.make_async_copy and its DMA semaphore), waits for it, and adds
// tab[c * 8, 0] + (float)row[0] to a register accumulator from 0 in the order
// c = 0, 1, ... The (8, 128) output block is stored once: on the TPU it is
// revisited across c and zeroed under pl.when(c == 0), but blocks run in no
// order on the card, so the chunk axis is the loop inside the block. nc is
// clamped to [0, kNCMax], so nothing outside the arrays is read. Bound: the
// bytes (at most 48 KB of rows, 12 KB out); the time is the copies' latency.

constexpr int kNT = 3;
constexpr int kNCMax = 4;
constexpr int kRowWords = 8 * kLanes;
constexpr uint32_t kRowBytes = kRowWords * sizeof(int);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kRowWords) probe_dynamic_grid_kernel(
    const float* __restrict__ tab, const int* __restrict__ hbm,
    const int* __restrict__ nc_in, float* __restrict__ out) {
  __shared__ __align__(128) int row[kRowWords];
  __shared__ __align__(8) uint64_t bar;
  const int t = blockIdx.x;
  const int nc = min(max(*nc_in, 0), kNCMax);
  const uint32_t bar_a = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    if (threadIdx.x == 0) {
      const int* src = hbm + (t * kNCMax + c) * kRowWords;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar_a), "r"(kRowBytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(smem_addr(row)), "l"(src), "r"(kRowBytes), "r"(bar_a)
          : "memory");
    }
    // Wait for phase c of the barrier: the copy of step c has landed.
    asm volatile(
        "{\n\t.reg .pred done;\n"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
        "@!done bra WAIT;\n}"
        :: "r"(bar_a), "r"(static_cast<uint32_t>(c & 1)) : "memory");
    acc += tab[c * kRowWords] + static_cast<float>(row[0]);
    __syncthreads();   // every thread has read row before the next copy
  }
  out[t * kRowWords + threadIdx.x] = acc;
}

int status() { return static_cast<int>(cudaGetLastError()); }

int bad_mode() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// Each entry point launches its kernel on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a mode it does not know. The fetch probes take
// their (rows, 128) int32 inputs and output and run one 128-thread block per
// row; ``mode`` is the index in the Python module's MODES.

extern "C" int probe_gather2d(int mode, const void* atlas, const void* rel,
                              const void* ln, void* out, int rows, int iters,
                              void* stream) {
  const auto a = static_cast<const int*>(atlas);
  const auto r = static_cast<const int*>(rel);
  const auto l = static_cast<const int*>(ln);
  const auto o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase8:
      probe_gather2d_kernel<kBase8><<<rows, kLanes, 0, s>>>(a, r, l, o, iters);
      break;
    case kSub8:
      probe_gather2d_kernel<kSub8><<<rows, kLanes, 0, s>>>(a, r, l, o, iters);
      break;
    case kTa1024:
      probe_gather2d_kernel<kTa1024><<<rows, kLanes, 0, s>>>(a, r, l, o, iters);
      break;
    case kTake1024:
      probe_gather2d_kernel<kTake1024><<<rows, kLanes, 0, s>>>(a, r, l, o,
                                                               iters);
      break;
    case kTa4096:
      probe_gather2d_kernel<kTa4096><<<rows, kLanes, 0, s>>>(a, r, l, o, iters);
      break;
    default:
      return bad_mode();
  }
  return status();
}

extern "C" int probe_packed_fetch(int mode, const void* blk, const void* row,
                                  const void* ln, void* out, int rows,
                                  int mix, int iters, void* stream) {
  const auto b = static_cast<const int*>(blk);
  const auto r = static_cast<const int*>(row);
  const auto l = static_cast<const int*>(ln);
  const auto o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kGather8:
      probe_packed_fetch_kernel<kGather8><<<rows, kLanes, 0, s>>>(
          b, r, l, o, mix, iters);
      break;
    case kPacked4:
      probe_packed_fetch_kernel<kPacked4><<<rows, kLanes, 0, s>>>(
          b, r, l, o, mix, iters);
      break;
    case kPacked4Sel:
      probe_packed_fetch_kernel<kPacked4Sel><<<rows, kLanes, 0, s>>>(
          b, r, l, o, mix, iters);
      break;
    case kPackedEmpty:
      probe_packed_fetch_kernel<kPackedEmpty><<<rows, kLanes, 0, s>>>(
          b, r, l, o, mix, iters);
      break;
    default:
      return bad_mode();
  }
  return status();
}

extern "C" int fetch_microbench(int mode, const void* atlas, const void* key,
                                const void* ln, void* out, int rows,
                                int iters, void* stream) {
  const auto a = static_cast<const int*>(atlas);
  const auto k = static_cast<const int*>(key);
  const auto l = static_cast<const int*>(ln);
  const auto o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      fetch_microbench_kernel<kFull><<<rows, kLanes, 0, s>>>(a, k, l, o, iters);
      break;
    case kNoLoad:
      fetch_microbench_kernel<kNoLoad><<<rows, kLanes, 0, s>>>(a, k, l, o,
                                                               iters);
      break;
    case kNoGather:
      fetch_microbench_kernel<kNoGather><<<rows, kLanes, 0, s>>>(a, k, l, o,
                                                                 iters);
      break;
    case kNoSelect:
      fetch_microbench_kernel<kNoSelect><<<rows, kLanes, 0, s>>>(a, k, l, o,
                                                                 iters);
      break;
    case kLoadOnly:
      fetch_microbench_kernel<kLoadOnly><<<rows, kLanes, 0, s>>>(a, k, l, o,
                                                                 iters);
      break;
    case kMicroEmpty:
      fetch_microbench_kernel<kMicroEmpty><<<rows, kLanes, 0, s>>>(a, k, l, o,
                                                                   iters);
      break;
    default:
      return bad_mode();
  }
  return status();
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
