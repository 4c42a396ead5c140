"""Builds of ``probe_gather2d`` and ``probe_packed_fetch`` that differ from
the default in one line of ``csrc/probes.cu``, timed against it on the card.

    python -m swift3drenderer_tpu_torch.tools.probe_variants

``csrc/probes.cu`` picks, mode by mode, whether ``probe_gather2d`` reads the
blocks its iterations visit through L1 (``__ldg``) or stages them in shared
memory by bulk copies (``kStagedGather2d``, a bit a mode), and how deep the
staged ring is (``kStages``); and whether ``probe_packed_fetch`` reads its
one block through L1 or from a copy in shared memory that each block of the
grid makes once (``kStagedPackedFetch``). Each variant is a copy of the
package with one line rewritten (``VARIANTS``: every gather2d mode through
L1, every one staged, a deeper ring, the packed fetch's other build), built
and imported as a package of its own (``seg_variants.load_copy``), so
nothing of this package changes. Every mode of both probes on each build
must equal the default build bit for bit at the tool's full count; then the
builds are timed (``_probe.time_ms``, REPS calls a turn) in ROUNDS rounds of
turns default, variants, variants reversed, default. Prints each build's
ptxas register lines and one JSON line a probe and mode: each build's median
ms over its turns, its lowest and highest turn, and its ratio to the
default's. A variant that rewrites one probe's line leaves the other
probe's code as the default's, so there (and for gather2d's sub8, which only
"all staged" changes) the spread is the noise between identical builds.
Needs a card; the variants are measurements only.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import json
import os
import statistics

import torch

from .. import kernels
from . import _probe, probe_gather2d, probe_packed_fetch, seg_variants

STAGED = "constexpr unsigned kStagedGather2d = 0x1D;   // all but sub8"
PACKED = "constexpr unsigned kStagedPackedFetch = 0x1;   // gather8"
# name: (the default's line in csrc/probes.cu, the variant's)
VARIANTS = {
    "all through L1": (STAGED, "constexpr unsigned kStagedGather2d = 0x00;"),
    "all staged": (STAGED, "constexpr unsigned kStagedGather2d = 0x1F;"),
    "6 stages": ("constexpr int kStages = 4;", "constexpr int kStages = 6;"),
    "8 stages": ("constexpr int kStages = 4;", "constexpr int kStages = 8;"),
    # gather8 through L1, packed4 and packed4sel staged: each mode's other
    # build.
    "packed fetch, other build": (
        PACKED, "constexpr unsigned kStagedPackedFetch = 0x6;"),
}
# The probes each build is timed on: (module, its full-count arguments of a
# mode).
PROBES = {
    "probe_gather2d": (probe_gather2d, lambda data, mode: (
        mode, *data[mode], probe_gather2d.ITERS)),
    "probe_packed_fetch": (probe_packed_fetch, lambda data, mode: (
        mode, *data[mode], probe_packed_fetch.TIMED_MIX,
        probe_packed_fetch.ITERS)),
}
REPS = 20
ROUNDS = 3


def variant_source(name: str) -> str:
    """csrc/probes.cu with variant ``name``'s line rewritten; raises if the
    default's line is not in the source exactly once."""
    with open(os.path.join(kernels.CSRC, kernels.PROBES)) as f:
        src = f.read()
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise ValueError(f"variant {name!r}: {old!r} is not in "
                         f"csrc/{kernels.PROBES} exactly once")
    return src.replace(old, new)


def main() -> list:
    builds = {"default": {name: m for name, (m, _) in PROBES.items()}}
    modules = {"default": kernels}
    for i, name in enumerate(VARIANTS):
        alias = f"s3d_probe_variant{i}"
        seg_variants.load_copy(alias, name, kernels.PROBES, variant_source(name))
        builds[name] = {probe: importlib.import_module(f"{alias}.tools.{probe}")
                        for probe in PROBES}
        modules[name] = importlib.import_module(f"{alias}.kernels")
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        logs = dict(zip(modules, pool.map(lambda k: k.build(k.PROBES),
                                          modules.values())))
    for name, log in logs.items():
        print(f"build {name}: {'compiled' if log else 'already built'}")
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "gather2d" in line
                    or "packed_fetch" in line):
                print(f"  {line.strip()}")
    names = list(builds)
    out = []
    for probe, (module, args_of) in PROBES.items():
        data = module.inputs("cuda")
        for mode in module.MODES:
            args = args_of(data, mode)
            want = getattr(module, probe)(*args)
            spans = {name: [] for name in names}
            for name in (names + names[::-1]) * ROUNDS:
                launch = getattr(builds[name][probe], probe)
                if not torch.equal(launch(*args), want):
                    raise AssertionError(f"{name} build of {probe} {mode} "
                                         "differs from the default")
                spans[name].append(_probe.time_ms(lambda: launch(*args),
                                                  want.device, REPS))
            ms = {name: statistics.median(v) for name, v in spans.items()}
            res = {"probe": probe, "mode": mode, "iters": module.ITERS,
                   "ms": ms,
                   "turns": {name: [min(v), max(v)] for name, v in spans.items()},
                   "ratio": {name: ms[name] / ms["default"] for name in ms}}
            out.append(res)
            print(f"variant: {json.dumps(res)}", flush=True)
    return out


if __name__ == "__main__":
    main()
