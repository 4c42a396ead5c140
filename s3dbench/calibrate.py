"""The readings that a cell's correctness limit is set from.

    python3 s3dbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 3] [--seconds 2]

For each seed, in one process: a run of the cell with a short window at the
cell's own load and sizes (``harness.run_cell``), whose sampled frames are
compared with the reference as every run compares them: the program's
reading. For the first ``--control-seeds`` seeds also the control: the
reference computed one precision down (bfloat16 for the configuration's
float32), put in the program's place on the same sampled poses and held to
the same comparison. The number compared is a run's worst sampled frame
(``mismatch_max``). One JSON line a seed, then a summary: the largest
program reading (the lower reading of the limit) and the smallest control
reading (the upper).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from s3dbench import harness, reference, spec  # noqa: E402


def control_readings(outcome: harness.Outcome, cell: spec.Cell) -> list:
    """The control's reading of every frame the run sampled."""
    tr = cell.traffic
    ref = reference.Reference(outcome.scene, cell.config["render"], "cuda")
    low = reference.Reference(outcome.scene, cell.config["render"], "cuda",
                              dtype=torch.bfloat16)
    out = []
    for ms, _, depth in outcome.sample:
        for m in ms:
            rp, rd, _ = ref.render(m, tr["width"], tr["height"], tr["sampling"])
            cp, cd, _ = low.render(m, tr["width"], tr["height"], tr["sampling"])
            # Compared as the program's frames are: without depth where
            # the program hands back none.
            out.append(harness.compare(cell.check, cp,
                                       None if depth is None else cd,
                                       rp, rd, ref.background))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="s3dbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    program, control = [], []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False)
        row = {"seed": seed, "program_max": max(out.readings),
               "frames": len(out.readings),
               "correct": out.line["correct"]}
        program.append(row["program_max"])
        if i < args.control_seeds:
            c = control_readings(out, cell)
            row.update(control_max=max(c), control_least_frame=min(c))
            control.append(row["control_max"])
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(program),
                      "program_max": max(program),
                      "control_min": min(control) if control else None,
                      "limit": cell.check["mismatch_max"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
