"""What the probe modules share: binding and launching a C entry point of
``csrc/probes.cu``, checking its inputs (the raster wrappers' check), the
chunk plan of the probes whose iteration axis is spread over the card,
folding a stack of values with an exact bitwise operation, counting L1 and
shared-memory wavefronts, timing, and the command line."""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
import time

import torch

from .. import kernels
from ..ops.raster import _check as check   # device, dtype, shape, contiguity

P, I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry(name: str, argtypes: tuple):
    fn = getattr(kernels.library(kernels.PROBES), name)
    fn.argtypes = [*argtypes, P]   # the stream last
    fn.restype = ctypes.c_int
    return fn


def launch(wrapper, name: str, argtypes: tuple, args: tuple,
           device: torch.device) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device``; raise if the launch was refused, else count it on
    ``wrapper.launches``."""
    with torch.cuda.device(device):   # the launch goes to the tensors' card
        err = _entry(name, argtypes)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{kernels.error_string(err, kernels.PROBES)}")
    wrapper.launches += 1


def kernel_device(wrapper, t: torch.Tensor) -> bool:
    """True if ``t`` lies on a card (launch the kernel), False on the CPU
    (take the plain version); raise for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cuda"


def check_aligned(t: torch.Tensor, name: str, align: int = 16) -> None:
    """Raise unless ``t`` starts on ``align`` bytes, as a bulk copy of it
    needs (the address alone: no host read)."""
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on {align} bytes for its bulk "
                         f"copy, got address {t.data_ptr():#x}")


def check_iters(iters: int, limit: int = 2 ** 31) -> None:
    if not 0 <= iters < limit:
        raise ValueError(f"iters must be in [0, {limit}), got {iters}")


# The chunk plan of probe_gather2d, probe_packed_fetch and fetch_microbench
# (csrc/probes.cu):
# the iteration axis [0, iters) is cut into chunks of MIN_CHUNK or more
# iterations, enough for WAVES waves of RESIDENT 128-thread blocks on each SM
# of the card, each a multiple of UNROLL (fold_chunk's kUnroll; it also
# starts a staged gather's 4-block stages on a multiple of 4).
UNROLL = 4
MIN_CHUNK = 256
RESIDENT = 16     # 128-thread blocks an SM holds at once (2,048 threads)
WAVES = 4


def chunk_plan(iters: int, rows: int, sms: int) -> tuple[int, int]:
    """(chunks, chunk) for a (rows, 128) probe of ``iters`` iterations on a
    card of ``sms`` SMs: chunk k of a row is iterations [k * chunk,
    min((k + 1) * chunk, iters)) of the global counter, so the ``chunks``
    chunks cover [0, iters) once, the last ragged. No chunk is shorter than
    MIN_CHUNK but the last; 0 iterations give 0 chunks (the kernel then
    runs one block a row group that folds nothing)."""
    target = max(1, sms * RESIDENT * WAVES // rows)
    chunk = max(MIN_CHUNK, -(-iters // target))
    chunk = -(-chunk // UNROLL) * UNROLL
    return -(-iters // chunk), chunk


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def fold(values: torch.Tensor, op) -> torch.Tensor:
    """``op`` (bitwise or / xor: exact, associative, commutative) over the
    leading axis, pairwise."""
    while values.shape[0] > 1:
        half = values.shape[0] // 2
        head = op(values[:half], values[half:2 * half])
        values = torch.cat([head, values[2 * half:]]) if values.shape[0] % 2 else head
    return values[0]


def distinct_lines(words: torch.Tensor) -> int:
    """L1 wavefronts of warp-wide loads at the word offsets ``words``, a row
    of 32 a warp: the distinct 128-byte lines each load touches (the array
    starting on a line)."""
    lines = (words.reshape(-1, 32).long() >> 5).sort(dim=1).values
    return int(lines.shape[0] + (lines[:, 1:] != lines[:, :-1]).sum())


def bank_wavefronts(words: torch.Tensor) -> int:
    """Shared-memory wavefronts of warp-wide loads at the word offsets
    ``words``, a row of 32 a warp: for each load, the most distinct words
    it reads from one of the 32 banks (a word's bank is its offset mod 32;
    lanes reading one word share it)."""
    warps = words.reshape(-1, 32).long().sort(dim=1).values
    first = torch.ones_like(warps, dtype=torch.bool)
    first[:, 1:] = warps[:, 1:] != warps[:, :-1]   # each distinct word once
    per_bank = torch.zeros((warps.shape[0], 32), dtype=torch.long,
                           device=warps.device)
    per_bank.scatter_add_(1, warps % 32, first.long())
    return int(per_bank.max(dim=1).values.sum())


def time_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median ms of one call of ``fn`` after a warm-up call: CUDA events
    around each call on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        spans = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize(device)
        return statistics.median(a.elapsed_time(b) for a, b in spans)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return "cpu (the plain PyTorch versions)"


def cli(main) -> int:
    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels; the default) or cpu (the "
                             "plain versions)")
    main(parser.parse_args().device)
    return 0
