"""The port's twin of __graft_entry__.py::dryrun_multichip on the CPU: two
spawned gloo ranks run its four parts (a data-parallel train step, a
draw-sharded explanation, a sample-sharded group, a tensor-parallel
forward), and a rank that raises makes the launch raise with that rank's
traceback. The spawned ranks import this module for the failing body."""

import pytest
import torch.distributed as dist

from asr_shap_torch import dryrun


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["phi_shape"] == (1600, dryrun.TINY.frames_for_samples(1600))
    assert out["group_shape"][0] == 2 and out["tp_mesh"] == {"data": 1, "model": 2}
    assert out["tp_max_abs_err"] <= 1e-5
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dryrun_multichip: 2 gloo ranks, on the CPU"
    assert lines[-1].startswith("dryrun_multichip OK on 2 devices: train loss=")


def _rank_1_raises(n, device):
    """Rank 1 raises before its first collective; rank 0 waits in one."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 refuses the dryrun")
    dist.barrier()
    return {}


def test_a_failed_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="(?s)rank 1: Traceback.*rank 1 refuses the dryrun"):
        dryrun._launch(2, "cpu", _rank_1_raises)
    with pytest.raises(ValueError, match="an even n >= 2"):
        dryrun.dryrun_multichip(3, device="cpu")
