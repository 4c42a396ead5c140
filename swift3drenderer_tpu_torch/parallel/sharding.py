"""Multi-device rendering over a (frame, fb) grid of torch.distributed ranks:
the counterpart of ``swift3drenderer_tpu.parallel.sharding``, one process per
device.

* axis ``frame`` splits a camera batch (independent frames: multi-view
  rendering, or the serving batch);
* axis ``fb`` splits the framebuffer into horizontal row bands: each rank
  renders its band (``rasterize(y_offset=...)``) from the full setup table;
* ``render_scene_sharded`` splits the scene's triangles instead: each rank
  renders its triangle range over the whole frame with the winners' global
  ids (``renderer.render_range``), and the frames merge by (max 1/z, then
  min global id), a total order per pixel, so the composite is the
  single-device frame bit for bit whatever the split.

Both take ``backend=`` as ``Renderer`` does: ``"cuda"`` (the hand-written
kernels, the port's default) or ``"xla"`` (``ops.raster_xla``). The JAX
functions default to ``"xla"`` (``render_batch_sharded``) and ``"pallas"``
(``render_scene_sharded``); the port's defaults stay ``"cuda"``.

Geometry is recomputed on every rank rather than sent: it is small beside the
pixels. The composite is a butterfly (recursive doubling) of
``batch_isend_irecv`` exchanges when every axis is a power of two, each rank
sending its three planes packed in one int32 tensor log2(n) times; otherwise
an all_gather and a merge in rank order.

Collectives run over NCCL for CUDA tensors and gloo for CPU ones. The caller
initialises the default process group (address, world size, rank);
``make_mesh`` builds the grid's sub-groups on it.

On the card the device work of a rank replays from a CUDA graph, the
counterpart of the JAX functions' compile, and the collectives run eagerly
after the replay, on the current stream: ``ShardedRenderer.render_batch``
replays its rank's block (``graphs.FrameGraphs``, one per (W, H, B)) and
then all_gathers; ``render_scene_sharded`` replays its rank's triangle range
and pack from the graph cache it keeps (``render_scene_sharded.graphs``, a
``graphs.GraphCache``) and then merges. Neither graph holds a collective, so
each is checked on one card: on an NCCL world of one rank, and as each rank
of an emulated mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, RenderConfig
from ..convert import resolve_device
from ..graphs import FrameGraphs, GraphCache
from ..ops import raster_xla
from ..ops.raster import NO_GID
from ..renderer import (build_setup, check_backend, rasterize_backend,
                        render_range, scene_to_device)


@dataclass(frozen=True)
class Mesh:
    """A (frame, fb) grid over ranks 0 .. n_frame * n_fb - 1 of the default
    process group, seen from this process's rank: rank r sits at (r // n_fb,
    r % n_fb). ``group`` spans the grid; ``frame_group`` the ranks that share
    this rank's fb index (its frame axis), ``fb_group`` those that share its
    frame index (its fb axis). A rank outside the grid holds no group and
    renders nothing."""
    n_frame: int
    n_fb: int
    rank: int
    device: torch.device
    group: Optional[object]
    frame_group: Optional[object]
    fb_group: Optional[object]

    @property
    def size(self) -> int:
        return self.n_frame * self.n_fb

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.n_fb)

    def axis_ranks(self, axis: str) -> list:
        """The global ranks along ``axis`` ("frame" or "fb") through this
        rank, in axis order."""
        f, b = self.coords
        if axis == "frame":
            return [i * self.n_fb + b for i in range(self.n_frame)]
        return [f * self.n_fb + i for i in range(self.n_fb)]


def make_mesh(n_frame: int = 1, n_fb: Optional[int] = None, *,
              device="cuda") -> Mesh:
    """A (frame, fb) grid over the first n_frame * n_fb ranks of the
    initialised default process group (``make_mesh`` of the JAX package,
    over ranks instead of devices). ``n_fb`` defaults to the world size over
    ``n_frame``. Every rank of the world calls it, in the same order as its
    other ``new_group`` calls: it makes one group for the grid and, when
    both axes are longer than one, one per row and one per column (an axis
    of one rank needs none, and the other axis is then the grid), with NCCL
    for a CUDA ``device`` and gloo for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_fb is None:
        n_fb = world // max(n_frame, 1)
    n = n_frame * n_fb
    if n_frame < 1 or n_fb < 1:
        raise ValueError(f"need a grid of at least 1 x 1, got {n_frame} x {n_fb}")
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = dist.get_rank()

    groups = {}     # this rank's group of each kind

    def new_group(kind, ranks):
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            groups[kind] = g

    new_group("grid", list(range(n)))
    if n_frame > 1 and n_fb > 1:    # else an axis is the grid or a single rank
        for f in range(n_frame):
            new_group("fb", [f * n_fb + b for b in range(n_fb)])
        for b in range(n_fb):
            new_group("frame", [f * n_fb + b for f in range(n_frame)])
    grid = groups.get("grid")
    return Mesh(n_frame, n_fb, rank, dev, grid,
                groups.get("frame", grid if n_fb == 1 else None),
                groups.get("fb", grid if n_frame == 1 else None))


def _member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not in the {mesh.n_frame} x "
                         f"{mesh.n_fb} mesh")


def merge_depth_gid(pix, ooz, gid, opix, oooz, ogid):
    """Per pixel, the (pixel, 1/z, gid) of the two with the greater 1/z, and
    at equal 1/z > 0 the smaller gid (sharding.py:240-241, 279 of the JAX
    package). (background, 0, NO_GID) is its identity."""
    upd = (oooz > ooz) | ((oooz == ooz) & (oooz > 0) & (ogid < gid))
    return (torch.where(upd, opix, pix), torch.where(upd, oooz, ooz),
            torch.where(upd, ogid, gid))


def _pack(pix, ooz, gid):
    return torch.stack([pix, ooz.view(torch.int32), gid])


def _unpack(packed):
    return packed[0], packed[1].view(torch.float32), packed[2]


def _butterfly_merge(mesh: Mesh, packed: torch.Tensor) -> torch.Tensor:
    """Recursive doubling along each axis in turn: at step k each rank
    exchanges its packed planes with the rank whose axis index differs in
    bit k, in one ``batch_isend_irecv``, and both keep the merge. Every axis
    size must be a power of two. The merge is a total order per pixel, so
    every rank ends with the same frame."""
    for axis, group in (("frame", mesh.frame_group), ("fb", mesh.fb_group)):
        ranks = mesh.axis_ranks(axis)
        me = ranks.index(mesh.rank)
        k = 1
        while k < len(ranks):
            peer = ranks[me ^ k]
            other = torch.empty_like(packed)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, packed, peer, group, tag=k),
                    dist.P2POp(dist.irecv, other, peer, group, tag=k)]):
                req.wait()
            packed = _pack(*merge_depth_gid(*_unpack(packed), *_unpack(other)))
            k *= 2
    return packed


def _gather_merge(mesh: Mesh, packed: torch.Tensor,
                  background: int) -> torch.Tensor:
    """Every rank's packed planes gathered, merged in rank order from the
    identity (the fallback for an axis that is not a power of two)."""
    parts = [torch.empty_like(packed) for _ in range(mesh.size)]
    dist.all_gather(parts, packed, group=mesh.group)
    pix, ooz, gid = _unpack(packed)
    acc = (torch.full_like(pix, background), torch.zeros_like(ooz),
           torch.full_like(gid, NO_GID))
    for part in parts:
        acc = merge_depth_gid(*acc, *_unpack(part))
    return _pack(*acc)


def _xla_range(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, width: int,
               height: int, config: RenderConfig, mesh: Mesh):
    """This rank's part of the ``"xla"`` scene composite (sharding.py:202-220
    of the JAX package): the full setup table, padded with dead slots to 2 *
    ceil(T / n) * n, cut into n equal slot ranges; rank r rasterizes range r
    over the whole frame, and every covered pixel takes the range's first
    slot as its gid. Within a range the earlier slot keeps a tie, and across
    ranges the merge's min gid keeps the lower range, so the composite is
    the single ``"xla"`` frame."""
    t = dev["vert_c"].shape[0]
    local = 2 * math.ceil(t / mesh.size)
    setup = build_setup(dev, m, width=width, height=height, config=config)
    pad = local * mesh.size - 2 * t
    lo = mesh.rank * local
    sub = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
           [lo:lo + local] for k, v in setup.items()}
    pix, ooz = raster_xla.rasterize(
        sub, dev["textures"], width=width, height=height,
        background=config.background_packed, sampling=config.sampling)
    return pix, ooz, torch.where(ooz > 0, lo, NO_GID).to(torch.int32)


def _scene_range(dev: Dict[str, torch.Tensor], m: torch.Tensor, *,
                 width: int, height: int, config: RenderConfig, mesh: Mesh,
                 backend: str) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """This rank's range of the triangle-sharded frame, run eagerly:
    (pixels, 1/z, gid) over the whole frame. ``"cuda"``: triangles [r * L,
    (r + 1) * L), L = ceil(T / n), through ``render_range`` (one tracked
    raster launch); ``"xla"``: ``_xla_range``. The reference every replay of
    the range is held against."""
    if backend == "xla":
        return _xla_range(dev, m, width=width, height=height, config=config,
                          mesh=mesh)
    local_t = math.ceil(dev["vert_c"].shape[0] / mesh.size)
    return render_range(dev, m, lo=mesh.rank * local_t, count=local_t,
                        width=width, height=height, config=config)


# The most rank ranges ``render_scene_sharded`` keeps captured at once, each
# its own graph and memory pool (a stress100k frame's graph reserved 262 MiB
# at 1920x1080, PERF.md §5); the least recently used goes first.
SCENE_GRAPHS_MAX = 32


def _packed_range(dev: Dict[str, torch.Tensor], m: torch.Tensor, *,
                  width: int, height: int, config: RenderConfig, mesh: Mesh,
                  backend: str) -> Tuple[torch.Tensor, bool]:
    """This rank's range packed (``_pack``: (3, H, W) int32) and whether it
    is a replayed graph's output. On the card it replays from
    ``render_scene_sharded.graphs``, keyed by (W, H, config, backend, mesh)
    and the scene's tensors, captured at the key's first call; the next
    replay of the key overwrites the output. On the CPU it runs eagerly.
    Needs no collective, so one rank of an emulated mesh (a ``Mesh`` that
    holds no group) replays it too."""
    def frame(x):
        return (_pack(*_scene_range(dev, x.reshape(3, 4), width=width,
                                    height=height, config=config, mesh=mesh,
                                    backend=backend)),)
    if dev["vert_c"].device.type != "cuda":
        return frame(m)[0], False
    static = ("scene", width, height, config, backend, mesh)
    return render_scene_sharded.graphs.run(
        static, [dev[k] for k in sorted(dev)], frame, m)[0], True


def render_scene_sharded(dev: Dict[str, torch.Tensor], m: torch.Tensor, *,
                         width: int, height: int,
                         config: RenderConfig = DEFAULT_CONFIG, mesh: Mesh,
                         backend: str = "cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangle-sharded rendering, the scene-parallel axis: rank r renders
    triangles [r * L, (r + 1) * L) over the whole frame, L = ceil(T / n)
    (the last ranges padded with dead triangles), with its winners' global
    ids, and the n frames are composited by (max 1/z, then min global id).
    Every rank of the mesh returns the composite (pixels (H, W) int32, depth
    (H, W) f32), equal bit for bit to ``render_frame`` on one device.

    ``backend="xla"`` cuts the full setup table into slot ranges instead
    (``_xla_range``) and gives the single ``render_frame_xla`` frame.

    On the card the rank's range (front-end, tracked raster launch) and its
    pack replay from a CUDA graph, as the JAX function compiles: the graph
    cache ``render_scene_sharded.graphs`` keeps one per (W, H, config,
    backend, mesh and its rank, the scene's tensors by identity), captured
    at its first call from ``m`` (3, 4) float32, which later calls copy in
    on the card. The merge is not captured: the butterfly's
    ``batch_isend_irecv`` or the all_gather runs eagerly after the replay
    on the current stream (NCCL point-to-point under capture cannot be
    checked beyond one rank on one card). What it returns is the caller's:
    a mesh of one rank, which merges nothing, gets a copy of the graph's
    planes. On the CPU every call runs eagerly."""
    _member(mesh)
    check_backend(backend)
    packed, graphed = _packed_range(dev, m, width=width, height=height,
                                    config=config, mesh=mesh, backend=backend)
    out = packed
    if all(s & (s - 1) == 0 for s in (mesh.n_frame, mesh.n_fb)):
        packed = _butterfly_merge(mesh, packed)
    else:
        packed = _gather_merge(mesh, packed, config.background_packed)
    pix, ooz, _ = _unpack(packed)
    if graphed and packed is out:
        pix, ooz = pix.clone(), ooz.clone()
    return pix, ooz


render_scene_sharded.graphs = GraphCache(SCENE_GRAPHS_MAX)


def render_batch_sharded(dev: Dict[str, torch.Tensor], ms: torch.Tensor, *,
                         width: int, height: int,
                         config: RenderConfig = DEFAULT_CONFIG, mesh: Mesh,
                         backend: str = "cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of a camera batch ms (B, 3, 4) rendered over the
    mesh: frames [f * B/n_frame, (f + 1) * B/n_frame) and rows [b * H/n_fb,
    (b + 1) * H/n_fb) for the rank at (f, b), as (pixels (B/n_frame,
    H/n_fb, W) int32, depth f32). ``gather_batch`` assembles the batch.
    ``backend="xla"`` rasterizes each frame's band with ``ops.raster_xla``."""
    _member(mesh)
    if height % mesh.n_fb:
        raise ValueError(f"height {height} not divisible by fb axis {mesh.n_fb}")
    if ms.shape[0] % mesh.n_frame:
        raise ValueError(f"camera batch {ms.shape[0]} not divisible by frame "
                         f"axis {mesh.n_frame}")
    f, b = mesh.coords
    local_b, local_h = ms.shape[0] // mesh.n_frame, height // mesh.n_fb
    setup = build_setup(dev, ms[f * local_b:(f + 1) * local_b], width=width,
                        height=height, config=config)
    return rasterize_backend(setup, dev["textures"], width=width,
                             height=local_h, config=config, backend=backend,
                             y_offset=b * local_h)


def gather_batch(mesh: Mesh, pix: torch.Tensor, depth: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B, H, W) batch from every rank's ``render_batch_sharded`` block,
    on every rank of the mesh (the JAX function's global array)."""
    _member(mesh)
    block = torch.stack([pix, depth.view(torch.int32)])
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(parts, block, group=mesh.group)
    rows = [torch.cat(parts[f * mesh.n_fb:(f + 1) * mesh.n_fb], dim=2)
            for f in range(mesh.n_frame)]
    out = torch.cat(rows, dim=1)
    return out[0], out[1].view(torch.float32)


class ShardedRenderer:
    """Multi-device front-end mirroring ``Renderer``'s API for camera
    batches; the scene stays on ``device`` (NCCL ranks on CUDA, gloo ranks
    on the CPU). ``backend`` picks each rank's rasterizer, as
    ``Renderer(backend=)`` does: ``"cuda"`` (the hand-written kernels; the
    default) or ``"xla"`` (``ops.raster_xla``); the JAX class's default is
    ``"xla"``.

    On the card each ``render_batch`` replays this rank's block from a CUDA
    graph of key ("exact", W, H, B), captured with the renderer's backend
    at the key's first call (``graphs``, as ``Renderer`` keeps them), and
    gathers the blocks eagerly after the replay on the current stream. On
    the CPU every call runs eagerly."""

    def __init__(self, scene, config: RenderConfig = DEFAULT_CONFIG,
                 mesh: Optional[Mesh] = None, device="cuda",
                 backend: str = "cuda") -> None:
        scene.validate()
        check_backend(backend)
        self.config = config
        self.backend = backend
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        if self.mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's collectives run on {self.mesh.device}, "
                             f"the scene on {self.device}")
        self.dev = scene_to_device(scene, self.mesh.device)
        self.graphs = (FrameGraphs(self.mesh.device)
                       if self.mesh.device.type == "cuda" else None)

    def _block(self, ms: np.ndarray, width: int, height: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``render_batch_sharded`` block of the poses ``ms``
        (B, 3, 4): on the card the outputs of the replayed graph, which its
        next replay overwrites. Needs no collective, so a mesh that holds no
        group (one rank of an emulated grid) renders it too."""
        b = ms.shape[0]

        def frame(x):
            return render_batch_sharded(self.dev, x.view(b, 3, 4), width=width,
                                        height=height, config=self.config,
                                        mesh=self.mesh, backend=self.backend)
        inputs = ms.reshape(-1)
        if self.graphs is None:
            return frame(torch.from_numpy(inputs))
        return self.graphs.run(("exact", width, height, b), frame, inputs)

    def render_batch(self, matrices, width: int, height: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render a camera batch ((B, 3, 4)) over the mesh; every rank
        returns the whole batch: pixels (B, H, W) int32, depth f32, new
        tensors that the next call does not touch."""
        ms = np.asarray(matrices, np.float32)
        if ms.ndim != 3 or ms.shape[1:] != (3, 4):
            raise ValueError(f"need a (B, 3, 4) batch of matrices, got {ms.shape}")
        return gather_batch(self.mesh, *self._block(ms, width, height))
