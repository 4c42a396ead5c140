"""Counterpart of the repo's ``tools/fetch_microbench.py``: the texel fetch's
block loop split into its cost components.

Every pixel of a (32, 128) strip OR-accumulates, over ``iters`` iterations
``b``, the fetch body over block ``b % 64`` of an arange (512, 512) atlas
(rows ``(b % 64) * 8 .. + 8``, columns 0..127), where row ``r`` counts for a
pixel whose key is ``b * 8 + r``:

  full       eight row loads at the pixel's lane, compare and OR tree;
  noload     the constant block 7 in place of the loads;
  nogather   the loads at the pixel's own lane;
  noselect   the loads, ORed without the compare;
  loadonly   row 0 at the pixel's own lane;
  empty      the loop alone (OR of b).

Differences between modes isolate each component's cost per iteration.
Kernel: ``csrc/probes.cu``, ``fetch_microbench_kernel``. The card runs the
iteration axis in chunks on every SM at once (``_probe.chunk_plan``) and ORs
the partials, so ns an iteration (the launch's ms over ``ITERS``, as the TPU
tool prints it) is the whole strip's cost an iteration at full occupancy,
not one thread's latency.

    python -m swift3drenderer_tpu_torch.tools.fetch_microbench [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import resolve_device
from . import _probe

SPH = 32          # pixel strip height (the TPU kernel's _FETCH_STRIP_H)
ITERS = 400000
NBLK = 64
CHECK_ITERS = 70
MODES = ("full", "noload", "nogather", "noselect", "loadonly", "empty")
TOOL_ORDER = ("empty", "loadonly", "nogather", "noselect", "full", "noload")
# Lane operations of one pixel-iteration, counted from the kernel's source:
# one per load, ALU op, compare and select, two for the loop counter. The
# block offset takes 2; per row full/nogather load, add r to b * 8, compare
# and select (4, and the shift b * 8 once); noload the same without the load;
# the OR tree 7 and the accumulate 1.
OPS_PER_ITER = {"full": 45, "noload": 35, "nogather": 45, "noselect": 20,
                "loadonly": 6, "empty": 3}
ROWS_READ = {"full": 8, "noload": 0, "nogather": 8, "noselect": 8,
             "loadonly": 1, "empty": 0}


def inputs(device):
    """The tool's (atlas, key, ln) on ``device``: an arange (512, 512)
    atlas, key = arange(32 * 128) % 512 as (32, 128), ln = key & 127."""
    dev = resolve_device(device)
    atlas = torch.arange(512 * 512, dtype=torch.int32).reshape(512, 512)
    key = torch.arange(SPH * 128, dtype=torch.int32).reshape(SPH, 128) % 512
    return atlas.to(dev), key.to(dev), (key & 127).to(dev)


def expected(mode: str, atlas: np.ndarray, key, ln, iters: int) -> np.ndarray:
    """Numpy oracle: the TPU kernel's loop, iteration by iteration."""
    acc = np.zeros((SPH, 128), np.int32)
    lane = np.arange(128)
    for b in range(iters):
        if mode == "empty":
            acc |= b
            continue
        block = (np.full((8, 128), 7, np.int32) if mode == "noload"
                 else atlas[(b % NBLK) * 8: (b % NBLK) * 8 + 8, :128])
        if mode == "loadonly":
            acc |= block[0][lane]
            continue
        for r in range(8):
            g = block[r][lane] if mode == "nogather" else block[r][ln]
            acc |= g if mode == "noselect" else np.where(key == b * 8 + r, g, 0)
    return acc


def fetch_microbench_plain(mode: str, atlas: torch.Tensor, key: torch.Tensor,
                           ln: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of ``fetch_microbench``, bit for bit. OR is
    idempotent, so it visits each distinct iteration once: the blocks
    ``b % 64`` for noselect and loadonly; for full, noload and nogather a
    pixel's compare holds for at most one (b, r), ``b = key >> 3``,
    ``r = key & 7``, where ``0 <= key < 8 * iters``; for empty the OR of
    [0, iters), all bits below the top bit of iters - 1. ``expected``, the
    literal loop, gives the same answer."""
    dev = atlas.device
    if mode == "empty":
        value = (1 << (iters - 1).bit_length()) - 1 if iters else 0
        return torch.full((SPH, 128), value, dtype=torch.int32, device=dev)
    blocks = atlas[:, :128].reshape(NBLK, 8, 128)
    lane = torch.arange(128, device=dev)
    ln = ln.long()
    if mode in ("noselect", "loadonly"):
        seen = blocks[:min(iters, NBLK)]
        if not seen.shape[0]:
            return torch.zeros((SPH, 128), dtype=torch.int32, device=dev)
        if mode == "loadonly":
            row0 = _probe.fold(seen[:, 0], torch.bitwise_or)
            return row0.expand(SPH, 128).contiguous()
        return _probe.fold(seen[:, :, ln].reshape(-1, SPH, 128),
                           torch.bitwise_or)
    hit = (key >= 0) & (key < 8 * iters)
    k = key.clamp(min=0).long()
    b, r = (k >> 3) % NBLK, k & 7
    if mode == "noload":
        g = torch.full_like(key, 7)
    else:
        g = blocks[b, r, lane if mode == "nogather" else ln]
    return torch.where(hit, g, torch.zeros_like(g))


def fetch_microbench(mode: str, atlas: torch.Tensor, key: torch.Tensor,
                     ln: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """OR over ``iters`` iterations of ``mode``'s part of the fetch body.

    atlas int32 (512, 512); key int32 (32, 128); ln int32 (32, 128) in
    [0, 128), not checked on the card (a host read); iters < 2 ** 28, so
    ``b * 8 + r`` stays in int32. Returns int32 (32, 128). CPU tensors take
    the plain version; CUDA tensors launch ``fetch_microbench_kernel<mode>``
    over the chunks of ``_probe.chunk_plan``, counted in
    ``fetch_microbench.launches``.
    """
    m = MODES.index(mode)
    dev = key.device
    _probe.check(atlas, "atlas", torch.int32, (512, 512), dev)
    for t, name in ((key, "key"), (ln, "ln")):
        _probe.check(t, name, torch.int32, (SPH, 128), dev)
    _probe.check_iters(iters, 2 ** 28)
    if not _probe.kernel_device(fetch_microbench, key):
        return fetch_microbench_plain(mode, atlas, key, ln, iters)
    chunks, chunk = _probe.chunk_plan(iters, SPH, _probe.sm_count(dev.index))
    out = torch.empty((SPH, 128), dtype=torch.int32, device=dev)
    P, I = _probe.P, _probe.I
    _probe.launch(fetch_microbench, "fetch_microbench",
                  (I, P, P, P, P, I, I, I, I),
                  (m, atlas.data_ptr(), key.data_ptr(), ln.data_ptr(),
                   out.data_ptr(), SPH, iters, chunks, chunk), dev)
    return out


fetch_microbench.launches = 0


def work(mode: str, key: torch.Tensor, iters: int):
    """(bytes, lane operations) the probe needs: the atlas rows it reads in
    the blocks it visits (128 columns), key and ln read once, the output
    written once; OPS_PER_ITER per pixel-iteration."""
    atlas = ROWS_READ[mode] * min(iters, NBLK) * 128 * 4
    return atlas + 3 * key.numel() * 4, OPS_PER_ITER[mode] * key.numel() * iters


def load_words(mode: str, ln: torch.Tensor) -> list:
    """The word offsets within an atlas block (512 words a row) that each of
    an iteration's ROWS_READ loads reads, (32, 128) a load: the access
    pattern that L1 sees (the same in every block)."""
    own = torch.arange(128).expand(SPH, 128)
    at = own if mode in ("nogather", "loadonly") else ln.long().cpu()
    return [r * 512 + at for r in range(ROWS_READ[mode])]


def main(device: str = "cuda") -> dict:
    """Check every part of the fetch body against the oracle and time it."""
    dev = resolve_device(device)
    print(f"torch {torch.__version__}, device {_probe.device_label(dev)}")
    atlas, key, ln = inputs(dev)
    host = [t.cpu().numpy() for t in (atlas, key, ln)]
    results = {}
    for mode in TOOL_ORDER:
        before = fetch_microbench.launches
        got = fetch_microbench(mode, atlas, key, ln, CHECK_ITERS).cpu().numpy()
        if not np.array_equal(got, expected(mode, *host, CHECK_ITERS)):
            raise RuntimeError(f"{mode}: WRONG at iters={CHECK_ITERS}")
        ms = _probe.time_ms(lambda: fetch_microbench(mode, atlas, key, ln, ITERS),
                            dev)
        ns = ms / ITERS * 1e6
        net = ns - results["empty"]["ns_per_iter"] if mode != "empty" else 0.0
        results[mode] = {"ms": ms, "ns_per_iter": ns, "net_ns_per_iter": net,
                         "launches": fetch_microbench.launches - before}
        print(f"{mode:9s}: {ms:7.3f} ms total, {ns:7.3f} ns/iter"
              + (f"  (net {net:.3f})" if mode != "empty" else ""))
    return results


if __name__ == "__main__":
    raise SystemExit(_probe.cli(main))
