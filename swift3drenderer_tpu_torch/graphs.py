"""Captured frames: one CUDA graph per frame shape, the port's counterpart
of the executable cache ``jax.jit`` keeps for the JAX package's frame
(``swift3drenderer_tpu.renderer``: one compile per size, or per resize
bucket).

A frame is some 40-75 small kernels (the front-end one launch, the binning
and packing the rest; PERF.md §5). Launched eagerly they hold the card idle
most of the frame; captured once and replayed, they go to the card as one
graph launch. ``FrameGraphs`` keeps one graph per key (the
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

``GraphCache`` is the cache a free function keeps, as ``jax.jit`` keeps the
executables of a jitted free function (``parallel.render_scene_sharded``'s
rank range): one ``FrameGraphs`` of one key per (static arguments, the
tensors the frame reads in place), matched by the tensors' identity.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Sequence, Tuple, Union

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
            inputs: Union[np.ndarray, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Replay ``key``'s graph on the current stream after copying
        ``inputs`` (the same number of elements at every call of ``key``)
        into its flat float32 static input: a host array travels through a
        pinned staging copy, a tensor on the card is copied device to device.
        Capture ``frame(static input)`` first if ``key`` is new. Returns the
        graph's static outputs: the next replay of ``key`` overwrites them."""
        if isinstance(inputs, torch.Tensor):
            src = inputs.reshape(-1)
        else:
            # A pinned staging copy lets the input travel without a stream
            # synchronisation; PyTorch's pinned allocator keeps the block
            # until the copy has run.
            src = torch.from_numpy(np.ascontiguousarray(inputs, np.float32))
            src = src.pin_memory()
        with torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                static = torch.empty(src.shape, dtype=torch.float32,
                                     device=self.device)
                static.copy_(src, non_blocking=True)
                entry = self._capture(key, frame, static)
            else:
                entry[1].copy_(src, non_blocking=True)
            entry[0].replay()
        self.replays += 1
        return entry[2]

    def close(self) -> None:
        """Drop every graph once the card has run what they launched, and
        hand the memory their pool reserved back to the card (outputs a
        caller still holds keep their blocks)."""
        torch.cuda.synchronize(self.device)
        self._graphs.clear()
        torch.cuda.empty_cache()

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


class GraphCache:
    """The CUDA graphs a free function keeps, as ``jax.jit`` keeps a jitted
    function's executables: one entry per (``static``, ``tensors``), where
    ``static`` holds the call's static arguments (hashable) and ``tensors``
    the tensors the frame reads in place, whose addresses a graph bakes in.

    An entry matches the same tensor objects (weak references checked with
    ``is``), never their addresses, which a freed tensor hands on: a new
    dict of the same tensors hits, a tensor made again misses. An entry one
    of whose tensors has died is dropped at the next call, and with it its
    graph and the memory its pool reserved; past ``max_entries`` live
    entries the least recently used is dropped. Each entry is a
    ``FrameGraphs`` of one key with a pool of its own, so that dropping it
    frees its memory. Writes into the tensors in place are read by the next
    replay, as ``Renderer.update_scene``'s are.

    ``captures`` and ``replays`` count every capture and every replayed call
    (a call that captures replays too) over the cache's life;
    ``capture_stats`` gives a live entry's capture ms and reserved bytes."""

    def __init__(self, max_entries: int) -> None:
        if max_entries < 1:
            raise ValueError(f"need room for an entry, not {max_entries}")
        self.max_entries = max_entries
        self.captures = 0
        self.replays = 0
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._died = False

    def __len__(self) -> int:
        return len(self._entries)

    def _dead(self, _ref) -> None:
        # A weak reference's callback: it may fire anywhere, a capture
        # included, so it only marks; the next call drops the entry.
        self._died = True

    def _drop(self, key: tuple) -> None:
        _, value = self._entries.pop(key)
        if isinstance(value, FrameGraphs):
            value.close()

    def _find(self, key: tuple, tensors: tuple) -> object:
        found = self._entries.get(key)
        if found is None or any(r() is not t for r, t in zip(found[0],
                                                             tensors)):
            return None
        return found[1]

    def capture_stats(self, static: Hashable,
                      tensors: Sequence[torch.Tensor]) -> dict:
        """The live entry's capture ms and reserved bytes
        (``FrameGraphs.captured``); KeyError if none is captured."""
        tensors = tuple(tensors)
        graphs = self._find((static, tuple(id(t) for t in tensors)), tensors)
        if graphs is None:
            raise KeyError(f"no live entry for {static!r}")
        return graphs.captured[static]

    def entry(self, static: Hashable, tensors: Sequence[torch.Tensor],
              make: Callable[[], object]) -> object:
        """The value of (``static``, ``tensors``): made by ``make()`` on a
        miss, after the dead and the least recently used entries go."""
        if self._died:
            self._died = False
            for key in [k for k, (refs, _) in self._entries.items()
                        if any(r() is None for r in refs)]:
                self._drop(key)
        tensors = tuple(tensors)
        key = (static, tuple(id(t) for t in tensors))
        found = self._find(key, tensors)
        if found is not None:
            self._entries.move_to_end(key)
            return found
        if key in self._entries:     # an id handed on by a dead tensor
            self._drop(key)
        value = make()
        self._entries[key] = (tuple(weakref.ref(t, self._dead)
                                    for t in tensors), value)
        while len(self._entries) > self.max_entries:
            self._drop(next(iter(self._entries)))
        return value

    def run(self, static: Hashable, tensors: Sequence[torch.Tensor],
            frame: Frame, inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``FrameGraphs.run`` of the entry's graph (``static`` is its key),
        on the card of ``tensors[0]``: the first call of an entry captures
        ``frame``, every call replays it. Returns the graph's static
        outputs: the next replay of the entry overwrites them."""
        tensors = tuple(tensors)
        graphs = self.entry(static, tensors,
                            lambda: FrameGraphs(tensors[0].device))
        new = not graphs.captures
        out = graphs.run(static, frame, inputs)
        self.captures += new
        self.replays += 1
        return out
