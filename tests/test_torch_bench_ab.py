"""The port's A/B bench modes on the CPU at small configurations:
``_timing.ab_palindrome`` against the reference's, call for call and bit
for bit; ``transformer_bench --ab-head``, ``moe_bench --ab`` and
``--ab-dispatch`` print the reference's A/B line (its dict literal, the
extra key and each side's keys, read from the reference's source; the
reference's ``xla`` side is the port's ``library`` side) plus ``card`` and
``power_limit_w``, after a line of each side's launches; each side's first
step equals the one-head cell's. The MoE library route (``moe_dispatch.
library_route``) against JAX's ``_gather_ref`` and its ``jax.grad``, and a
whole MoE loss and gradient under it against the default route (fp32: loss
within 1e-4, gradient norm within 1e-5 of itself, the two-rank bounds),
with its counters moving and the kernel wrappers not called.

The CPU's timings are noise at these sizes, so rates are held to be numbers
only; the launch counters stay 0 on the CPU (the kernels run on the card)."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeflow_tpu_torch as kt
from benchmarks import _timing as ref_timing
from kubeflow_tpu.ops import moe_dispatch as jmd
from kubeflow_tpu_torch.benchmarks import _cells, _timing, moe_bench, transformer_bench
from kubeflow_tpu_torch.ops import moe_dispatch as md

REPO = Path(__file__).resolve().parents[1]
WINDOWS = (1, 2, 1)
LM = dict(device="cpu", num_layers=1, num_heads=2, embed_dim=64, mlp_dim=128, vocab_size=128,
          attention_block_size=32)
MOE = dict(device="cpu", seq=32, batch=2, num_layers=2, num_heads=2, embed_dim=64,
           expert_hidden_dim=128, vocab_size=128, attention_block_size=32)


def _scripted(log, name, script):
    """A window function that logs its calls and returns the next scripted time."""
    it = iter(script)

    def window(n):
        log.append((name, n))
        return next(it)

    return window


@pytest.mark.parametrize("repeats", [1, 3])
def test_ab_palindrome_matches_the_reference_call_for_call(repeats):
    rng = np.random.default_rng(repeats)
    times = {n: [float(t) for t in rng.uniform(0.1, 2.0, 4 * repeats)] for n in ("A", "B")}
    logs, results = [], []
    for fn in (ref_timing.ab_palindrome, _timing.ab_palindrome):
        log = []
        results.append(fn({n: _scripted(log, n, times[n]) for n in ("A", "B")}, 3, 13, repeats))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][:8] == [("A", 3), ("A", 13), ("B", 3), ("B", 13),
                           ("B", 3), ("B", 13), ("A", 3), ("A", 13)]
    assert results[0] == results[1]             # bit for bit
    with pytest.raises(ValueError, match="two windows"):
        _timing.ab_palindrome({"A": None}, 1, 2, 1)


def _function(path: str, name: str):
    tree = ast.parse((REPO / path).read_text())
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _reference_ab_keys(path: str, literal_fn: str, sides_fn: str) -> list[str]:
    """The keys of the reference's A/B line: the dict literal with "metric"
    in ``literal_fn``, the extra dict ``sides_fn`` passes to ``_ab_run``
    (moe_bench), each side of ``sides_fn``'s loop with its ``_mfu``, then
    ``A_over_B``."""
    lit = next(n for n in ast.walk(_function(path, literal_fn)) if isinstance(n, ast.Dict)
               and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys))
    keys = [k.value for k in lit.keys if isinstance(k, ast.Constant)]
    fn = _function(path, sides_fn)
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple))
    sides = [e.value for e in loop.iter.elts]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "_ab_run"]
    if calls:
        keys += [k.value for k in calls[0].args[2].keys]
    sides = ["library" if s == "xla" else s for s in sides]
    return keys + [k for s in sides for k in (s, f"{s}_mfu")] + [f"{sides[0]}_over_{sides[1]}"]


def _check(line, capsys, want_keys, metric):
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    assert list(line) == want_keys + ["card", "power_limit_w"]
    assert line["metric"] == metric and "vs_baseline" not in line
    assert line["card"] == "cpu" and line["power_limit_w"] is None
    a, b = want_keys[-5], want_keys[-3]
    assert isinstance(line[a], float) and isinstance(line[b], float)
    assert line[f"{a}_mfu"] is None and line[f"{b}_mfu"] is None
    assert line[f"{a}_over_{b}"] == round(line[a] / line[b], 4)
    return json.loads(printed[-2])["launches"]


def test_transformer_ab_head_prints_the_reference_line(capsys):
    line = transformer_bench.main(["--ab-head", "--seq", "32"], cell=LM, windows=WINDOWS)
    want = _reference_ab_keys("benchmarks/transformer_bench.py", "_ab_head", "_ab_head")
    launches = _check(line, capsys, want, "transformer_head_ab")
    assert (line["seq_len"], line["per_chip_batch"]) == (32, 4)
    steps = WINDOWS[0] + 2 * WINDOWS[2] * (WINDOWS[0] + WINDOWS[1])     # warm + A B B A
    assert {s: t["steps"] for s, t in launches.items()} == {"fused": steps, "chunked": steps}
    assert all(n == 0 for t in launches.values() for k, n in t.items() if k != "steps")


@pytest.mark.parametrize("argv,metric,extra", [
    (["--ab"], "moe_head_ab", ("dispatch", "gather")),
    (["--ab", "--dispatch", "einsum", "--remat"], "moe_head_ab", ("dispatch", "einsum")),
    (["--ab-dispatch"], "moe_dispatch_ab", ("head", "chunked")),
    (["--ab-dispatch", "--fused-head"], "moe_dispatch_ab", ("head", "fused")),
])
def test_moe_ab_modes_print_the_reference_line(capsys, argv, metric, extra):
    line = moe_bench.main(argv, cell=MOE, windows=WINDOWS)
    sides_fn = "_ab_dispatch_main" if "--ab-dispatch" in argv else "_ab_main"
    want = _reference_ab_keys("benchmarks/moe_bench.py", "_ab_run", sides_fn)
    launches = _check(line, capsys, want, metric)
    assert (line["seq_len"], line["per_chip_batch"], line[extra[0]]) == (32, 2, extra[1])
    rows = 3 * MOE["num_layers"]                # the dispatch and k = 2 combines a layer
    for side, t in launches.items():
        library = rows * t["steps"] if side == "library" else 0
        assert (t["library_gather"], t["library_scatter"]) == (library, library), side
        assert (t["moe_gather"], t["moe_scatter"]) == (0, 0)


def _first_loss(c):
    _, metrics = c.bundle.step(c.bundle.init(), c.tokens)
    return metrics["loss"]


def test_ab_sides_take_the_one_head_cells_first_steps():
    """Each side's first step equals the single-head cell's on the same seed:
    the sides share the weights and differ only in the head or the route."""
    sides = transformer_bench.ab_sides(transformer_bench._args(["--ab-head", "--seq", "32"]),
                                       dict(LM))
    losses = {h: _first_loss(c) for h, c in sides.items()}
    for head, loss in losses.items():
        one = _cells.dense_train(seq=32, head=head, remat=False, remat_policy="dots", **LM)
        assert torch.equal(loss, _first_loss(one)), head
    torch.testing.assert_close(losses["fused"], losses["chunked"], rtol=2e-2, atol=0)

    sides = moe_bench.ab_sides(moe_bench._args(["--ab"]), dict(MOE))
    for head, c in sides.items():
        one = _cells.moe_train(head=head, dispatch="gather", remat=False, **MOE)
        assert torch.equal(_first_loss(c), _first_loss(one)), head

    sides = moe_bench.ab_sides(moe_bench._args(["--ab-dispatch"]), dict(MOE))
    kernel = _first_loss(sides["kernel"])
    with md.library_route():
        library = _first_loss(sides["library"])
    # the forward's gathers copy the same rows on both routes
    assert torch.equal(kernel, library)
    assert torch.equal(kernel, _first_loss(_cells.moe_train(head="chunked", **MOE)))


@pytest.mark.parametrize("B,R,M,J,unique", [(2, 7, 16, 12, False), (1, 5, 8, 5, True),
                                           (3, 1, 4, 6, False)])
def test_library_route_matches_jax_gather_ref_and_its_grad(B, R, M, J, unique):
    """fp32, indices in [0, R] (R reads the zero row): the forward equal,
    the gradient (a scatter-add in x's dtype on both sides) within fp32
    summation order."""
    rng = np.random.default_rng(B * 100 + R)
    x = rng.standard_normal((B, R, M)).astype(np.float32)
    idx = rng.integers(0, R + 1, (B, J)).astype(np.int32)
    dy = rng.standard_normal((B, J, M)).astype(np.float32)
    want = np.asarray(jmd._gather_ref(jnp.asarray(x), jnp.asarray(idx)))
    _, vjp = jax.vjp(lambda x: jmd._gather_ref(x, jnp.asarray(idx)), jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(dy))[0])

    xt = torch.from_numpy(x).requires_grad_()
    before = (md.gather_rows.library_gathers, md.gather_rows.library_scatters)
    with md.library_route():
        out = md.gather_rows(xt, torch.from_numpy(idx), unique_indices=unique)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-6, atol=1e-6)
    assert xt.grad.dtype == torch.float32
    assert (md.gather_rows.library_gathers - before[0],
            md.gather_rows.library_scatters - before[1]) == (1, 1)


def _moe_loss_and_grads(model, tokens):
    loss = kt.moe_lm_loss_chunked(model, tokens, chunk=32, compute_dtype=torch.float32)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def test_moe_step_under_the_library_route_matches_the_default(monkeypatch):
    """One fp32 MoE loss and gradient with the route and without: within the
    two-rank bounds; under the route only its counters move and neither
    kernel wrapper is called; outside it nothing of it runs."""
    cfg = kt.MoEConfig(vocab_size=128, num_layers=2, num_heads=2, embed_dim=64,
                       expert_hidden_dim=128, num_experts=4, experts_per_token=2,
                       capacity_factor=1.0, max_seq_len=32, dispatch="gather",
                       attention_impl="flash", attention_block_size=16, dtype=torch.float32)
    model = kt.MoETransformerLM(cfg, device="cpu")
    model.load_state_dict(kt.moe_init_state_dict(cfg, seed=0, device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 32)))
    calls = {"gather": 0, "scatter": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(md, "gather", spy("gather", md.gather))
    monkeypatch.setattr(md, "scatter", spy("scatter", md.scatter))

    def counters():
        return md.gather_rows.library_gathers, md.gather_rows.library_scatters

    start = counters()
    loss, grads = _moe_loss_and_grads(model, tokens)
    rows = 3 * cfg.num_layers
    assert calls == {"gather": rows, "scatter": rows} and counters() == start
    with md.library_route():
        loss_l, grads_l = _moe_loss_and_grads(model, tokens)
    assert calls == {"gather": rows, "scatter": rows}
    assert counters() == (start[0] + rows, start[1] + rows)
    assert abs(float(loss_l) - float(loss)) <= 1e-4
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads))
    norm_l = torch.sqrt(sum(g.double().pow(2).sum() for g in grads_l))
    assert abs(float(norm_l / norm) - 1) <= 1e-5
    assert not md._library                      # the route ends with its block


def test_ab_modes_without_a_card_stop_with_a_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would measure it")
    for bench, argv in ((transformer_bench, ["--ab-head"]), (moe_bench, ["--ab"]),
                        (moe_bench, ["--ab-dispatch"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main(argv)
