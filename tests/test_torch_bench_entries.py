"""The port's bench entry points (``kubeflow_tpu_torch/benchmarks/*_bench.py``)
on the CPU at small configurations: each ``main`` prints one JSON line
whose keys are its reference's (the dict its reference prints, read from
the reference's source), less ``vs_baseline`` (a ratio to a TPU target),
plus ``card`` and ``power_limit_w``; the CPU run names the CPU and leaves
the device-only MFU empty. The CPU's timings are noise at these sizes and
the fewest windows (long minus short may come out negative), so the rates
are held to be numbers only. Without a card and without ``device="cpu"``
each entry point stops with a message."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from kubeflow_tpu_torch.benchmarks import decode_bench, moe_bench, resnet_bench, transformer_bench

REPO = Path(__file__).resolve().parents[1]
WINDOWS = (1, 2, 1)
LM = dict(device="cpu", num_layers=1, num_heads=2, embed_dim=64, mlp_dim=128, vocab_size=128,
          attention_block_size=32)
MOE = dict(device="cpu", seq=32, batch=2, num_layers=1, num_heads=2, embed_dim=64,
           expert_hidden_dim=128, vocab_size=128, attention_block_size=32)
DECODE = dict(device="cpu", num_layers=1, num_heads=2, num_kv_heads=1, embed_dim=64, mlp_dim=128,
              vocab_size=128, max_seq_len=256)
RESNET = dict(device="cpu", batch=4, image=32, stage_sizes=[1, 1, 1, 1], width=8, num_classes=10,
              dtype=torch.float32)


def _reference_keys(path: str, function: str) -> list[str]:
    """The keys of the last dict with a "metric" key that ``function`` of
    the reference file builds: the line it prints."""
    tree = ast.parse((REPO / path).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    return [k.value for k in dicts[-1].keys]


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def _check(line, printed, ref_path, ref_function):
    want = [k for k in _reference_keys(ref_path, ref_function) if k != "vs_baseline"]
    assert list(line) == want + ["card", "power_limit_w"]
    assert printed == line
    assert line["card"] == "cpu" and line["power_limit_w"] is None
    assert "value" not in line or isinstance(line["value"], float)
    return line


@pytest.mark.parametrize("argv,head", [([], "chunked"), (["--head", "fused"], "fused")])
def test_transformer_bench_prints_the_reference_line(capsys, argv, head):
    line = transformer_bench.main(argv + ["--seq", "32"], cell=LM, windows=WINDOWS)
    _check(line, _line(capsys), "benchmarks/transformer_bench.py", "main")
    assert line["metric"] == "transformer_train_tokens_per_sec_per_chip"
    assert isinstance(line["value_best"], float)
    assert (line["seq_len"], line["per_chip_batch"], line["head"]) == (32, 4, head)
    assert line["mfu"] is None


@pytest.mark.parametrize("argv", [[], ["--dispatch", "einsum", "--fused-head"]])
def test_moe_bench_prints_the_reference_line(capsys, argv):
    line = moe_bench.main(argv, cell=MOE, windows=WINDOWS)
    _check(line, _line(capsys), "benchmarks/moe_bench.py", "main")
    assert line["metric"] == "moe_train_tokens_per_sec_per_chip"
    assert line["dispatch"] == (argv[1] if argv else "gather")
    assert 0 < line["active_params_m"] < line["params_m"]
    assert (line["seq_len"], line["per_chip_batch"]) == (32, 2)


def test_moe_bench_a2a_names_its_slice():
    """On one device ``--dispatch a2a`` stops with the reference's error:
    the a2a dispatch needs an expert axis (slice 5c, which brought it)."""
    with pytest.raises(ValueError, match="requires cfg.mesh with an expert axis"):
        moe_bench.main(["--dispatch", "a2a"], cell=MOE, windows=WINDOWS)


def test_decode_bench_prints_the_reference_line(capsys):
    line = decode_bench.main([], cell=DECODE, windows=WINDOWS)
    _check(line, _line(capsys), "benchmarks/decode_bench.py", "main")
    assert line["metric"] == "decode_tokens_per_sec_per_row"
    assert (line["kv_heads"], line["batch"], line["prompt_len"], line["new_tokens"]) == (1, 4, 128, 128)
    assert line["batch_tok_per_sec"] == pytest.approx(4 * line["value"], abs=0.25)


def test_decode_bench_long_mode_prints_the_reference_table(capsys):
    cell = {k: v for k, v in DECODE.items() if k != "max_seq_len"}
    line = decode_bench.main(["--long"], cell=dict(cell, cache=96, positions=(32, 48)),
                             windows=WINDOWS)
    printed = capsys.readouterr().out.strip().splitlines()
    _check(line, json.loads(printed[-1]), "benchmarks/decode_bench.py", "long_mode")
    assert line["cache_len"] == 96 and len(printed) == 1 + 2 * 4
    assert [(r["impl"], r["seq"]) for r in line["results"]] == [
        ("flash", 32), ("xla", 32), ("flash", 48), ("xla", 48)]
    assert all(isinstance(r["ms"], float) for r in line["results"] + line["prefill"])


def test_decode_bench_cpu_smoke_prints_the_reference_line(capsys):
    line = decode_bench.main(["--cpu-smoke"], windows=WINDOWS)
    _check(line, _line(capsys), "benchmarks/decode_bench.py", "cpu_smoke")
    assert line["impl"] == "cpu-smoke"


def test_resnet_bench_prints_the_reference_line(capsys):
    line = resnet_bench.main([], cell=RESNET, windows=WINDOWS)
    _check(line, _line(capsys), "bench.py", "main")
    assert line["metric"] == "resnet50_train_imgs_per_sec_per_chip"
    assert (line["per_chip_batch"], line["n_chips"], line["windows"]) == (4, 1, 2)


@pytest.mark.parametrize("bench", [transformer_bench, moe_bench, decode_bench, resnet_bench])
def test_without_a_card_the_entry_points_stop_with_a_message(bench):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would measure it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
