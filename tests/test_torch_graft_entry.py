"""The port's top-level entry points (``kubeflow_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``: ``entry()``'s ResNet-50 forward and its
example input, and ``dryrun_multichip`` on gloo CPU ranks, 8 through the
function and 2 through ``python -m kubeflow_tpu_torch.graft_entry 2 --device
cpu``. Each run must print every section the reference prints for that
number of ranks, with the reference's plans, in its order; its parity asserts
(sharded vs one-device loss and gradient norm, rtol 2e-4) run inside the
ranks and fail the call."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch import graft_entry

REPO = Path(__file__).resolve().parents[1]

# the sections __graft_entry__.py prints for 8 and for 2 devices
SECTIONS = {
    8: ["resnet dp=2 fsdp=4: loss=",
        "parity dp=2 fsdp=4 vs 1-device: loss ",
        "resnet dcn=2 fsdp=4 (2-slice multislice): loss=",
        "transformer fsdp=2 tensor=2 seq=2 (ring attention): loss=",
        "moe data=2 expert=2 tensor=2: loss=",
        "moe-a2a data=2 expert=4: loss=",
        "pipeline stage=2 data=2 fsdp=2 (2 microbatches): loss="],
    2: ["resnet dp=2 fsdp=1: loss=",
        "parity dp=2 fsdp=1 vs 1-device: loss ",
        "resnet dcn=2 fsdp=1 (2-slice multislice): loss=",
        "transformer fsdp=1 tensor=1 seq=2 (ring attention): loss=",
        "moe data=1 expert=2 tensor=1: loss=",
        "pipeline stage=2 data=1 fsdp=1 (2 microbatches): loss="],
}


def _check_lines(out: str, n: int):
    lines = [line[len("[dryrun] "):] for line in out.splitlines() if line.startswith("[dryrun] ")]
    assert len(lines) == len(SECTIONS[n]), lines
    for line, want in zip(lines, SECTIONS[n]):
        assert line.startswith(want), (line, want)
        if want.endswith("loss="):
            loss = float(line[len(want):])
            # seeded inits at flax's scale: near ln(classes) or ln(vocab)
            assert np.isfinite(loss) and 1.0 < loss < 7.0, line
    got, ref = re.findall(r"loss ([\d.]+)~([\d.]+)", lines[1])[0]
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-4)


def test_dryrun_on_8_gloo_ranks_prints_every_section(capfd):
    graft_entry.dryrun_multichip(8, device="cpu")
    _check_lines(capfd.readouterr().out, 8)


def test_dryrun_on_2_gloo_ranks_from_the_command_line():
    proc = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.graft_entry", "2", "--device",
                           "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _check_lines(proc.stdout, 2)


def test_dryrun_refuses_cards_it_does_not_have():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"takes {n} cards.*pass device='cpu'"):
        graft_entry.dryrun_multichip(n)
    with pytest.raises(ValueError, match="device must be 'cuda' .* or 'cpu'"):
        graft_entry.dryrun_multichip(2, device="tpu")


def test_entry_is_the_resnet50_forward_on_its_example_input():
    fn, (model, x) = graft_entry.entry(device="cpu")
    assert model.stage_sizes == [3, 4, 6, 3] and model.num_classes == 1000
    assert x.shape == (8, 224, 224, 3) and x.dtype == torch.bfloat16 and bool((x == 1).all())
    logits = fn(model, x)
    assert logits.shape == (8, 1000) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()
