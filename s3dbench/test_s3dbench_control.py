"""The control: the reference one precision down (bfloat16) in the
program's place must come out not correct, on three seeds.

On the CPU, the reference against its bfloat16 self at a size a test run
holds; on the card (``-m cuda``) at each cell's own size, in a whole run,
with the program's runs held to the same limit (``calibrate.py`` prints
the same readings for a dozen seeds).
"""

import pytest
import torch

from s3dbench import calibrate, flight, harness, reference, scenegen, spec

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
W, H = 64, 40


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_control_is_not_correct_on_the_cpu(workload):
    cell = spec.cell(workload)
    tr, check = cell.traffic, cell.check
    poses = flight.walk(tr["flight"])
    for seed in SEEDS:
        scene = scenegen.build(cell.config, seed)
        ref = reference.Reference(scene, cell.config["render"], "cpu")
        low = reference.Reference(scene, cell.config["render"], "cpu",
                                  dtype=torch.bfloat16)
        order = flight.order(len(poses), seed)
        worst = 0.0
        for m in poses[order[:4]]:
            rp, rd, _ = ref.render(m, W, H, tr["sampling"])
            cp, cd, _ = low.render(m, W, H, tr["sampling"])
            worst = max(worst, reference.mismatch(cp, cd, rp, rd, check["tol"],
                                                  check["rtol"]))
        assert worst > check["mismatch_max"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs the "
                    "program's CUDA kernels")
    cell = spec.cell(workload)
    limit = cell.check["mismatch_max"]
    for seed in SEEDS:
        out = harness.run_cell(workload, seed, 1.0, False)
        assert out.line["correct"] is True
        assert max(calibrate.control_readings(out, cell)) > limit
