"""``swift3drenderer_tpu_torch.entry.dryrun_multichip``, the counterpart of
``__graft_entry__.dryrun_multichip``, on gloo ranks of the CPU: n = 2 (a 1
x 2 mesh) and n = 4 (2 x 2), each rank holding the gathered batch and the
triangle-sharded composites of both backends to the single-device frames
bit for bit; and ``device="cuda"`` with fewer cards than ranks raising
before any rank starts. About 8 s and 12 s (the spawned ranks' imports) on
one process.
"""

import pytest
import torch
import torch.multiprocessing as mp

from swift3drenderer_tpu_torch import entry

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n, capsys):
    out = entry.dryrun_multichip(n, device="cpu")
    n_frame = 2 if n == 4 else 1
    n_fb = n // n_frame
    assert out["mesh"] == (n_frame, n_fb) == entry.dryrun_mesh(n)
    assert out["batch"] == (2 * n_frame, 8 * n_fb, 128)
    assert out["scene"] == (8 * n_fb, 128)
    assert len(out["launches"]) == n
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip OK: mesh=(frame={n_frame}, "
                           f"fb={n_fb}), pixels {out['batch']} sharded over "
                           f"{n} devices, cuda+xla backends")


def test_dryrun_multichip_needs_a_card_a_rank(monkeypatch):
    """device="cuda" with fewer cards than ranks raises, saying how many it
    found, and starts no rank (no fallback to gloo ranks)."""
    def no_rank(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(mp, "start_processes", no_rank)
    found = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"found {found}"):
        entry.dryrun_multichip(found + 1, device="cuda")
    with pytest.raises(ValueError):
        entry.dryrun_multichip(0, device="cpu")
