"""The port's graft entry points (coloc_tpu_torch/graft_entry.py, the
counterpart of __graft_entry__.py) on the CPU: the single-device forward,
the multi-chip dry run on 2 gloo ranks, and that both raise with no card
unless the CPU is asked for."""

import numpy as np
import pytest
import torch

from coloc_tpu_torch import graft_entry
from port_harness import one_torch_thread, time_limit  # noqa: F401


def test_entry_forward_on_cpu():
    """entry(device="cpu"): the forward runs on its example arguments and
    gives the centre, rotation, covariance and success of the tiny frame,
    finite, on the CPU."""
    fn, args = graft_entry.entry(device="cpu")
    C, R, cov, success = fn(*args)
    assert [tuple(t.shape) for t in (C, R, cov, success)] == [(3,), (3, 3), (6, 6), ()]
    assert all(t.device.type == "cpu" for t in (C, R, cov, success))
    assert success.dtype == torch.bool
    assert all(np.isfinite(t.numpy()).all() for t in (C, R, cov))


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    """dryrun_multichip(2, device="cpu"): two ranks spawned over gloo run
    the step, the scan and sharded serving, rank 0 prints each program's
    line; the map2d program needs an even n >= 4."""
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    for program in ("step", "scan", "serving"):
        assert f"dryrun[{program}] ok" in out, out
    assert "dryrun[map2d]" not in out
    assert "backend gloo" in out and "dryrun_multichip(2) ok" in out


def test_no_card_and_no_device_raises(monkeypatch):
    """With no CUDA device and no device asked for, both entry points
    raise before anything runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
