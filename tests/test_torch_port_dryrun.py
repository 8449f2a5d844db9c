"""The port's dry run (playaid_core_torch/parallel/dryrun.py) on the CPU,
as ``__graft_entry__.dryrun_multichip`` checks the JAX package: the
ResFormer's training step on a (2, 2) mesh of four gloo ranks, at 32-px
crops and T 3 (the flagship's 128 px and T 7 are for the card).

It asserts what the JAX dry run asserts: the loss falls over three steps;
the first step's loss and grad norm are within 2e-4 relative of one rank
on the whole batch; a checkpoint written on the mesh continues on half the
ranks within 2e-4; VodAnalyzer on a single-process mesh of four positions
gives the labels of one device.
"""

import numpy as np
import pytest
import torch

from playaid_core_torch.parallel import dryrun


def test_dryrun_multichip_on_four_gloo_ranks():
    line = dryrun.dryrun_multichip(4, backend="gloo", device="cpu", crop_size=32,
                                   sequence_length=3, timeout_s=300)
    assert line.startswith("dryrun_multichip(4): mesh=(2, 2)")
    assert "restored on (1, 2)" in line and "vod: sharded labels identical over 24" in line


def test_entry_is_the_flagship_forward():
    fn, args = dryrun.entry("cpu")
    (frames,) = args
    assert tuple(frames.shape) == (2, 7, 128, 128, 3)
    out = fn(*args)
    assert tuple(out.shape) == (2, 7, 63) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)


def test_run_train_case_runs_on_the_card_unless_given_a_device(monkeypatch):
    """With no ``device`` the rank's work asks for the card, and raises
    where there is none, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_train_case({"family": "cnn", "num_actions": 4, "sequence_length": 3,
                               "crop_size": 32, "frames": np.zeros((2, 3, 32, 32, 3), np.uint8),
                               "labels": np.zeros((2, 3), np.int64)})
