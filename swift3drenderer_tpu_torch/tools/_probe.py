"""What the probe modules share: binding and launching a C entry point of
``csrc/probes.cu``, checking its inputs (the raster wrappers' check),
folding a stack of values with an exact bitwise operation, timing, and the
command line."""

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


def check_iters(iters: int, limit: int = 2 ** 31) -> None:
    if not 0 <= iters < limit:
        raise ValueError(f"iters must be in [0, {limit}), got {iters}")


def fold(values: torch.Tensor, op) -> torch.Tensor:
    """``op`` (bitwise or / xor: exact, associative, commutative) over the
    leading axis, pairwise."""
    while values.shape[0] > 1:
        half = values.shape[0] // 2
        head = op(values[:half], values[half:2 * half])
        values = torch.cat([head, values[2 * half:]]) if values.shape[0] % 2 else head
    return values[0]


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
