"""Captured frames: one CUDA graph per frame shape, the port's counterpart
of the executable cache ``jax.jit`` keeps for the JAX package's frame
(``swift3drenderer_tpu.renderer``: one compile per size, or per resize
bucket).

A frame is some 360 small kernels (PERF.md §5). Launched eagerly they hold
the card idle most of the frame; captured once and replayed, they go to the
card as one graph launch. ``FrameGraphs`` keeps one graph per key (the
renderer's keys: exact (W, H, B) or bucket (bw, bh, B)), each reading one
static input buffer that every call overwrites before the replay.

Capture safety of the frame, which ``run`` relies on:
- every tensor the frame needs is made on the card or cached before the
  capture: the first run of a key is a warm-up on a side stream, which
  builds the kernels' library and fills the cached device constants
  (``ops.raster._level_consts``);
- the frame copies nothing to or from the host, reads no scalar and
  synchronises nothing (``chip_smoke.py`` phase 6 checks the trace);
- the kernels' C entry points launch on ``torch.cuda.current_stream``,
  and the grid they choose from the card's SM count is fixed at capture;
- ``rasterize``'s split of a batch past one launch's limits concatenates
  on the card.
A graph also fixes what the frame read from Python at capture: the scene's
tensors (``Renderer.update_scene`` writes into them in place), the
configuration, and module constants such as ``ops.raster.FLAT_MAX_SLOTS``.

Nothing falls back: a capture that fails raises, and the key stays
uncaptured.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

Frame = Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]


class FrameGraphs:
    """The captured frames of one renderer on one card.

    The graphs share one memory pool: a graph's intermediates may reuse
    memory another graph's replay wrote, which is safe because every replay
    runs on the caller's current stream and ``run``'s caller copies the
    outputs out before the next replay. Do not replay one renderer's graphs
    from two streams at once.

    ``captures`` and ``replays`` count graphs captured and replays launched;
    ``captured[key]`` holds each key's capture time (host ms, warm-up
    excluded) and the device memory the capture reserved (bytes)."""

    def __init__(self, device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a cuda device, not {device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.replays = 0
        self.captured: Dict[tuple, dict] = {}
        self._graphs: Dict[tuple, tuple] = {}

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def run(self, key: tuple, frame: Frame,
            inputs: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Replay ``key``'s graph on the current stream after copying
        ``inputs`` (a flat float32 host array, the same length at every call
        of ``key``) into its static input; capture ``frame(static input)``
        first if ``key`` is new. Returns the graph's static outputs: the next
        replay of ``key`` overwrites them."""
        # A pinned staging copy lets the input travel without a stream
        # synchronisation; PyTorch's pinned allocator keeps the block until
        # the copy has run.
        host = torch.from_numpy(np.ascontiguousarray(inputs, np.float32))
        host = host.pin_memory()
        with torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                static = torch.empty(host.shape, dtype=torch.float32,
                                     device=self.device)
                static.copy_(host, non_blocking=True)
                entry = self._capture(key, frame, static)
            else:
                entry[1].copy_(host, non_blocking=True)
            entry[0].replay()
        self.replays += 1
        return entry[2]

    def _capture(self, key: tuple, frame: Frame, static: torch.Tensor):
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            frame(static)
        stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            outputs = frame(static)
        self.captured[key] = {
            "capture_ms": (time.perf_counter() - t0) * 1e3,
            "reserved_bytes": torch.cuda.memory_reserved(self.device) - reserved}
        entry = (graph, static, tuple(outputs))
        self._graphs[key] = entry
        return entry
