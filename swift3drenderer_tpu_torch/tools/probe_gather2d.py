"""Counterpart of the repo's ``tools/probe_gather2d.py``: gather variants of
the texel fetch over an atlas block.

For ``it`` in [0, iters), with ``b = it % 64``, every pixel of a (16, 128)
strip XOR-accumulates one texel out of atlas block ``b``:

  base8      eight row loads at the pixel's lane and a 3-level select on
             ``rel`` (the TPU kernel's shipped pattern);
  sub8       one load at (rel, the pixel's own lane): ``blk[rel, j]``;
  ta1024     one load in the block flattened to 1024 words, at
             ``(rel << 7) | ln``;
  take1024   the same (on the TPU, ``jnp.take`` instead of
             ``take_along_axis``);
  ta4096     the same over a 4096-word row of four lane chunks, at
             ``(rel << 9) | ln``.

On the TPU only ``base8`` lowered in Mosaic; on the card every mode is one
or eight plain indexed loads (``csrc/probes.cu``), from a copy of the block
staged in shared memory (``probe_gather2d_staged_kernel``) or, for sub8,
through L1 (``probe_gather2d_kernel``). The card runs the iteration axis in
chunks on every SM at once (``_probe.chunk_plan``) and XORs the partials, so
ns an iteration (the launch's ms over ``ITERS``, as the TPU tool prints it)
is the whole strip's cost an iteration at full occupancy, not one thread's
latency.

    python -m swift3drenderer_tpu_torch.tools.probe_gather2d [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import resolve_device
from . import _probe

SPH = 16
ITERS = 200000
NBLK = 64  # blocks in the probe atlas (one 512-row texture, one chunk)
CHECK_ITERS = 3   # the tool's correctness check
MODES = ("base8", "sub8", "ta1024", "take1024", "ta4096")
ATLAS_SHAPES = {"base8": (NBLK * 8, 128), "sub8": (NBLK * 8, 128),
                "ta1024": (NBLK, 1024), "take1024": (NBLK, 1024),
                "ta4096": (NBLK, 4096)}
# Lane operations of one pixel-iteration, counted from the kernel's source:
# one per load, ALU op and select, two for the loop counter. base8: block
# index and offset 2, eight loads, the tree's 3 tests and 7 selects, the XOR;
# the others: block index 1, index arithmetic 4 (sub8: 3), one load, XOR.
OPS_PER_ITER = {"base8": 23, "sub8": 8, "ta1024": 9, "take1024": 9,
                "ta4096": 9}
# The staged kernel's pixels a thread and bytes a stage (csrc/probes.cu's
# kPixels and kStageBytes): a stage holds STAGE_BYTES of consecutive blocks,
# and a thread reads each of them for STAGED_PIXELS pixels.
STAGED_PIXELS = 2
STAGE_BYTES = 16 * 1024


def atlas_for(mode: str, rng: np.random.Generator) -> np.ndarray:
    """The tool's atlas of ``mode``: base8/sub8 (512, 128) rows by one lane
    chunk; ta1024/take1024 (64, 1024), each block flattened; ta4096
    (64, 4096), four lane chunks a block row."""
    rows = rng.integers(0, 1 << 30, size=(NBLK * 8, 512), dtype=np.int32)
    if mode in ("base8", "sub8"):
        return rows[:, :128]
    if mode in ("ta1024", "take1024"):
        return rows[:, :128].reshape(NBLK, 1024)
    return rows.reshape(NBLK, 4096)


def expected(mode: str, atlas: np.ndarray, rel, ln, iters: int) -> np.ndarray:
    """The tool's numpy oracle: the loop, iteration by iteration."""
    acc = np.zeros((SPH, 128), np.int32)
    for it in range(iters):
        b = it % NBLK
        if mode in ("base8", "ta1024", "take1024"):
            if mode == "base8":
                blk = atlas[b * 8: b * 8 + 8]
            else:
                blk = atlas[b].reshape(8, 128)
            acc ^= blk[rel, ln]
        elif mode == "sub8":
            blk = atlas[b * 8: b * 8 + 8]
            src = np.concatenate([blk, blk], axis=0)[:SPH]
            acc ^= np.take_along_axis(src, rel, axis=0)
        else:
            blk = atlas[b].reshape(8, 512)
            acc ^= blk[rel, ln]
    return acc


def inputs(device) -> dict:
    """Each mode's (atlas, rel, ln) on ``device``, drawn from
    ``default_rng(0)`` in the tool's order, so they are the tool's data."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rel = rng.integers(0, 8, size=(SPH, 128)).astype(np.int32)
    lx = rng.integers(0, 512, size=(SPH, 128)).astype(np.int32)
    out = {}
    for mode in MODES:
        atlas = atlas_for(mode, rng)
        ln = lx if mode == "ta4096" else (lx & 127)
        out[mode] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (atlas, rel, ln))
    return out


def _texels(mode: str, atlas, rel, ln) -> torch.Tensor:
    """(64, SPH, 128): the texel each pixel takes from each block."""
    rel, ln = rel.long(), ln.long()
    if mode == "base8":
        return atlas.view(NBLK, 8, 128)[:, rel, ln]
    if mode == "sub8":
        lane = torch.arange(128, device=atlas.device)
        return atlas.view(NBLK, 8, 128)[:, rel, lane]
    shift = 9 if mode == "ta4096" else 7
    return atlas[:, (rel << shift) | ln]


def probe_gather2d_plain(mode: str, atlas: torch.Tensor, rel: torch.Tensor,
                         ln: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of ``probe_gather2d``, bit for bit. XOR cancels
    in pairs, so it visits each block once and keeps those it meets an odd
    number of times: block b is met ``iters // 64 + (b < iters % 64)``
    times. ``expected``, the literal loop, gives the same answer."""
    odd = [b for b in range(NBLK) if (iters // NBLK + (b < iters % NBLK)) & 1]
    if not odd:
        return torch.zeros((SPH, 128), dtype=torch.int32, device=atlas.device)
    return _probe.fold(_texels(mode, atlas, rel, ln)[odd], torch.bitwise_xor)


def probe_gather2d(mode: str, atlas: torch.Tensor, rel: torch.Tensor,
                   ln: torch.Tensor, iters: int) -> torch.Tensor:
    """XOR over ``iters`` iterations of one texel per pixel from atlas block
    ``it % 64``, fetched by ``mode``'s pattern.

    atlas int32 of ``ATLAS_SHAPES[mode]``; rel int32 (16, 128) in [0, 8); ln
    int32 (16, 128) in [0, 128) ([0, 512) for ta4096), not checked on the
    card (a host read). Returns int32 (16, 128). CPU tensors take the plain
    version; CUDA tensors launch ``probe_gather2d_staged_kernel<mode>`` (sub8:
    ``probe_gather2d_kernel<mode>``) over the chunks of
    ``_probe.chunk_plan``, counted in ``probe_gather2d.launches``.
    """
    m = MODES.index(mode)
    dev = rel.device
    _probe.check(atlas, "atlas", torch.int32, ATLAS_SHAPES[mode], dev)
    for t, name in ((rel, "rel"), (ln, "ln")):
        _probe.check(t, name, torch.int32, (SPH, 128), dev)
    _probe.check_iters(iters)
    if not _probe.kernel_device(probe_gather2d, rel):
        return probe_gather2d_plain(mode, atlas, rel, ln, iters)
    chunks, chunk = _probe.chunk_plan(iters, SPH, _probe.sm_count(dev.index))
    out = torch.empty((SPH, 128), dtype=torch.int32, device=dev)
    P, I = _probe.P, _probe.I
    _probe.launch(probe_gather2d, "probe_gather2d",
                  (I, P, P, P, P, I, I, I, I),
                  (m, atlas.data_ptr(), rel.data_ptr(), ln.data_ptr(),
                   out.data_ptr(), SPH, iters, chunks, chunk), dev)
    return out


probe_gather2d.launches = 0


def work(mode: str, atlas: torch.Tensor, rel: torch.Tensor, iters: int):
    """(bytes, lane operations) the probe needs: the atlas blocks it visits,
    rel and ln read once, the output written once; OPS_PER_ITER per
    pixel-iteration."""
    visited = atlas.numel() * 4 * min(iters, NBLK) // NBLK
    nbytes = visited + 3 * rel.numel() * 4
    return nbytes, OPS_PER_ITER[mode] * rel.numel() * iters


def load_words(mode: str, rel: torch.Tensor, ln: torch.Tensor) -> list:
    """The word offsets within an atlas block that each of an iteration's
    loads reads, (16, 128) a load: the access pattern that L1 or shared
    memory sees (the same in every block)."""
    rel, ln = rel.long().cpu(), ln.long().cpu()
    if mode == "base8":
        return [r * 128 + ln for r in range(8)]
    if mode == "sub8":
        return [rel * 128 + torch.arange(128)]
    return [(rel << (9 if mode == "ta4096" else 7)) | ln]


def main(device: str = "cuda") -> dict:
    """Check every gather mode against the tool's oracle and time it."""
    dev = resolve_device(device)
    print(f"torch {torch.__version__}, device {_probe.device_label(dev)}")
    data = inputs(dev)
    results = {}
    for mode in MODES:
        atlas, rel, ln = data[mode]
        before = probe_gather2d.launches
        got = probe_gather2d(mode, atlas, rel, ln, CHECK_ITERS).cpu().numpy()
        want = expected(mode, atlas.cpu().numpy(), rel.cpu().numpy(),
                        ln.cpu().numpy(), CHECK_ITERS)
        if not np.array_equal(got, want):
            raise RuntimeError(f"{mode}: WRONG ({(got != want).mean() * 100:.1f}% "
                               "mismatch)")
        ms = _probe.time_ms(lambda: probe_gather2d(mode, atlas, rel, ln, ITERS),
                            dev)
        ns = ms / ITERS * 1e6
        results[mode] = {"ms": ms, "ns_per_iter": ns,
                         "launches": probe_gather2d.launches - before}
        print(f"{mode:9s}: PASS  {ns:7.3f} ns/iter")
    return results


if __name__ == "__main__":
    raise SystemExit(_probe.cli(main))
