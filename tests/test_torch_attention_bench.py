"""The port's attention shootout (``kubeflow_tpu_torch/benchmarks/
attention_bench.py``) on the CPU: its lines at S 64 and 128 (the
reference's per-case and final keys, read from its source, plus ``card``
and ``power_limit_w``; the reference's ``xla`` is the port's ``naive``, and
``library`` is the port's addition), its windows and blocks the
reference's, each impl's gradients of the bench's loss (the sum of the fp32
output) against the JAX impl's ``jax.grad`` (flash: the Pallas kernels in
interpret mode; library: JAX's naive oracle) at the bench's B2 H8 D128 in
fp32, and the one exception the bench turns into a note."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import attention_bench as ref_bench
from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops import pallas_attention as jpa
from kubeflow_tpu_torch.benchmarks import attention_bench

REPO = Path(__file__).resolve().parents[1]
# fp32 on both sides: the impls differ from JAX's in summation order only
# (the scores over D 128, the softmax sums, the products over S keys); every
# gradient element within 2e-5 of the largest gradient magnitude
REL = 2e-5


def _reference_dict_keys(function: str) -> list[list[str]]:
    tree = ast.parse((REPO / "benchmarks/attention_bench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    return [[k.value for k in n.keys] for n in ast.walk(fn) if isinstance(n, ast.Dict)]


def test_shootout_prints_the_reference_lines(capsys):
    line = attention_bench.main([], device="cpu", seqs=(64, 128), windows=(1, 2, 1))
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    cases = [json.loads(x) for x in printed[:-1]]
    assert cases == line["results"]
    ref = _reference_dict_keys("main")
    final = next(keys for keys in ref if "metric" in keys)
    case = next(keys for keys in ref if "ms" in keys and "note" not in keys)
    assert list(line) == final + ["card", "power_limit_w"]
    assert line["metric"] == "attention_fwd_bwd_ms"
    assert line["card"] == "cpu" and line["power_limit_w"] is None
    impls = ["naive", "block", "flash", "library"]
    assert [(c["impl"], c["seq"]) for c in cases] == [(i, s) for s in (64, 128) for i in impls]
    assert all(list(c) == case and isinstance(c["ms"], float) for c in cases)
    assert list(ref_bench.impls(16)) == ["xla", "block", "flash"]     # naive stands for xla


def test_windows_blocks_and_shape_are_the_references():
    assert (attention_bench.B, attention_bench.H, attention_bench.D) == (
        ref_bench.B, ref_bench.H, ref_bench.D)
    assert attention_bench.REPEATS == ref_bench.REPEATS
    assert attention_bench.SEQS == (2048, 8192, 16384, 32768)
    for seq in (64, 2048, 2049, 8192, 8193, 16384, 32768):
        assert attention_bench.windows_for(seq) == ref_bench.windows_for(seq)
        assert attention_bench.block_for(seq) == min(1024, seq // 4)


def _jax_fns(block):
    return {
        "naive": lambda q, k, v: jattn.naive_attention(q, k, v, causal=True),
        "block": lambda q, k, v: jattn.blockwise_attention(q, k, v, causal=True,
                                                           block_size=block),
        "flash": lambda q, k, v: jpa.flash_attention(q, k, v, True, block, block),
        "library": lambda q, k, v: jattn.naive_attention(q, k, v, causal=True),
    }


@pytest.mark.parametrize("seq", [64, 128])
def test_each_impl_gradient_matches_the_jax_impl(seq):
    rng = np.random.default_rng(seq)
    B, H, D = attention_bench.B, attention_bench.H, attention_bench.D
    qkv = [rng.standard_normal((B, seq, H, D)).astype(np.float32) for _ in range(3)]
    block = attention_bench.block_for(seq)
    for name, fn in attention_bench.impls(block).items():
        want_fn = _jax_fns(block)[name]
        want_o = np.asarray(want_fn(*map(jnp.asarray, qkv)))
        want = jax.grad(lambda q, k, v: jnp.sum(want_fn(q, k, v).astype(jnp.float32)),
                        argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
        o, got = attention_bench.fwd_bwd(fn, *map(torch.from_numpy, qkv))
        np.testing.assert_allclose(o.numpy(), want_o, rtol=0,
                                   atol=REL * np.abs(want_o).max(), err_msg=name)
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL * np.abs(w).max(),
                                       err_msg=f"{name} {what}")


def test_only_out_of_memory_on_the_card_becomes_a_note():
    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    def other():
        raise RuntimeError("a kernel failed")

    assert attention_bench.run_case("naive", 32768, oom, "cuda") == {
        "impl": "naive", "seq": 32768, "ms": None, "note": "OutOfMemoryError"}
    assert attention_bench.run_case("flash", 64, lambda: 0.00123, "cuda") == {
        "impl": "flash", "seq": 64, "ms": 1.23}
    with pytest.raises(RuntimeError, match="a kernel failed"):
        attention_bench.run_case("flash", 32768, other, "cuda")
    with pytest.raises(torch.cuda.OutOfMemoryError):          # the CPU catches nothing
        attention_bench.run_case("naive", 64, oom, "cpu")


def test_without_a_card_the_shootout_stops_with_a_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would measure it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        attention_bench.main([])
