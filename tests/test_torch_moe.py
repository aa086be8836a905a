"""PyTorch port's MoE LM training slice against the JAX package on the CPU.

One small configuration at which the JAX model really takes its Pallas
kernels (interpret mode): capacity C = 128 and E * C = 512 slots, so the
dispatch (J = 512) and the combine (J = S = 256) gather at M = 128, and the
flash attention forward and backward. Both sides run fp32 on the same weights
(``moe_params_from_flax``); each JAX reference is computed once."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.ops import optimizers as jopt
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import moe as tm

SMALL = dict(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128, expert_hidden_dim=256,
             num_experts=4, experts_per_token=2, capacity_factor=1.0, max_seq_len=256,
             attention_impl="flash", attention_block_size=128)
B, S, CHUNK = 2, 256, 128
LR = 1e-3
TOKENS = np.random.default_rng(0).integers(0, SMALL["vocab_size"], (B, S)).astype(np.int32)


def _close(got, want, rel, what=""):
    """Every element within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


@functools.cache
def _flax_params():
    """One flax init; the params depend neither on the dispatch mode nor on
    the attention impl ('einsum' and 'xla' init fast)."""
    model = jm.MoETransformerLM(jm.MoEConfig(**dict(SMALL, attention_impl="xla"), dtype=jnp.float32))
    return jax.jit(lambda key: model.init(key, jnp.asarray(TOKENS))["params"])(jax.random.PRNGKey(0))


@functools.cache
def _jax_reference(dispatch):
    """Everything the tests compare, each from one jitted JAX program: the
    chunked loss and its gradients, the unchunked loss, the logits."""
    cfg = jm.MoEConfig(**SMALL, dispatch=dispatch, dtype=jnp.float32)
    model = jm.MoETransformerLM(cfg)
    tokens = jnp.asarray(TOKENS)
    params = _flax_params()
    loss_c, grads = jax.jit(jax.value_and_grad(lambda p: jm.moe_lm_loss_chunked(
        model, p, tokens, chunk=CHUNK, compute_dtype=jnp.float32)))(params)
    loss = jax.jit(lambda p: jm.moe_lm_loss(model, p, tokens))(params)
    logits = jax.jit(lambda p: model.apply({"params": p}, tokens))(params)
    out = jax.tree_util.tree_map(np.asarray, (loss_c, grads, loss, logits))
    return dict(zip(("loss_chunked", "grads", "loss", "logits"), out))


def _port_model(dispatch, dtype=torch.float32):
    cfg = kt.MoEConfig(**SMALL, dispatch=dispatch, dtype=dtype)
    model = kt.MoETransformerLM(cfg, device="cpu")
    model.load_state_dict(kt.moe_params_from_flax(
        jax.tree_util.tree_map(np.asarray, _flax_params())))
    return model


def _chunked(model, tokens):
    return kt.moe_lm_loss_chunked(model, tokens, chunk=CHUNK, compute_dtype=torch.float32)


_jax_route = jax.jit(lambda logits, k, C: dataclasses.asdict(jm.route_top_k(logits, k, C)),
                     static_argnums=(1, 2))


def test_routing_plan_matches_jax():
    """Each layer's plan from the port model's own MoE input (router logits
    from fp32 operands) through both ``route_top_k``s: experts, slots and
    keep exactly equal, gates and aux loss to 1e-6 (fp32 softmax, summation
    order). The run drops choices and leaves slots empty."""
    model = _port_model("gather")
    C = model.cfg.capacity(S)
    inputs = []
    hooks = [layer.moe.register_forward_hook(lambda m, inp, out: inputs.append(inp[0]))
             for layer in model.layers]
    with torch.no_grad():
        model(torch.from_numpy(TOKENS).long())
        for h in hooks:
            h.remove()
        for layer, x in zip(model.layers, inputs):
            logits = torch.einsum("bsm,me->bse", x.float(), layer.moe.router)
            plan = tm.route_top_k(logits, model.cfg.experts_per_token, C)
            want = _jax_route(jnp.asarray(logits.numpy()), model.cfg.experts_per_token, C)
            for name in ("experts", "pos", "keep"):
                np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                              np.asarray(want[name]), err_msg=name)
            np.testing.assert_allclose(plan.gates.numpy(), np.asarray(want["gates"]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(plan.aux_loss.item(), float(want["aux_loss"]), rtol=1e-6)
            kept = plan.keep > 0
            assert not kept.all(), "no choice was dropped"
            per_expert = torch.stack([(plan.experts[kept] == e).sum() for e in range(4)])
            assert (per_expert < B * C).any(), "no slot was left empty"


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_logits_losses_and_gradients_match_jax(dispatch):
    """fp32 on both sides: logits and both losses to 1e-5, every parameter's
    gradient to 1e-5 of its largest magnitude (summation order only, measured
    1.5e-6; the routing is equal, so no choice flips)."""
    want = _jax_reference(dispatch)
    model = _port_model(dispatch)
    tokens = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        _close(model(tokens).numpy(), want["logits"], 1e-5, "logits")
        np.testing.assert_allclose(kt.moe_lm_loss(model, tokens).item(), want["loss"], rtol=1e-5)
    loss = _chunked(model, tokens)
    np.testing.assert_allclose(loss.item(), want["loss_chunked"], rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    want_g = kt.moe_params_from_flax(want["grads"])
    assert set(names) == set(want_g)
    for name, g in zip(names, grads):
        _close(g.numpy(), want_g[name].numpy(), 1e-5, name)


def _check_adam_step(want_loss, want_grads, loss_fn):
    """One ``make_lm_train_step`` step with ``adamw_lowmem`` through
    ``loss_fn`` against the optax update of the JAX gradients from the same
    weights.

    Adam's first update is ~lr * g / (|g| + eps) per element. Where the
    gradient is above 1e-4 of its table's largest (~70x the two sides'
    fp32 gradient difference, measured 1.5e-6) the update is well
    conditioned: held to lr / 100 (the bf16 moments may round one side's g
    or g^2 a step apart, 2^-8 of an update). Below that, a gradient of
    ~1e-9 can differ in sign between the sides, and the update only to its
    own bound, 2 lr."""
    params = _flax_params()
    jtx = jopt.adamw_lowmem(LR, b2=0.99, weight_decay=0.1)
    updates, _ = jtx.update(jax.tree_util.tree_map(jnp.asarray, want_grads),
                            jtx.init(params), params)
    want_p = kt.moe_params_from_flax(
        jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates)))
    want_g = kt.moe_params_from_flax(want_grads)

    model = _port_model("gather")
    bundle = kt.make_lm_train_step(model, kt.adamw_lowmem(LR, b2=0.99, weight_decay=0.1),
                                   loss_fn=loss_fn)
    state, metrics = bundle.step(bundle.init(), torch.from_numpy(TOKENS).long())
    assert state["step"] == 1
    np.testing.assert_allclose(metrics["loss"].item(), want_loss, rtol=1e-5)
    n_ill = 0
    for name, p in model.named_parameters():
        g = np.abs(want_g[name].numpy())
        well = g > 1e-4 * g.max()
        n_ill += (~well).sum()
        diff = np.abs(p.detach().numpy() - want_p[name].numpy())
        assert diff[well].max(initial=0) <= LR / 100, name
        assert diff.max() <= 2 * LR, name
    assert n_ill < 1e-2 * sum(p.numel() for p in model.parameters())


def test_train_step_matches_the_jax_step():
    """The chunked loss's step against the JAX step (``jax.value_and_grad``
    + the optax update, as ``benchmarks/moe_bench.py`` builds it)."""
    want = _jax_reference("gather")
    _check_adam_step(want["loss_chunked"], want["grads"], _chunked)


@functools.cache
def _jax_fused(compute):
    """``moe_lm_loss_fused`` and its gradients in JAX (the fused head's three
    Pallas kernels in interpret mode: T = 512, V = 512), gather dispatch."""
    model = jm.MoETransformerLM(jm.MoEConfig(**SMALL, dispatch="gather", dtype=jnp.float32))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.moe_lm_loss_fused(
        model, p, jnp.asarray(TOKENS), compute_dtype=compute)))(_flax_params())
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("compute,rel", [
    # fp32 head operands: summation order only (measured 1.7e-6)
    (torch.float32, 1e-5),
    # bf16 head operands on fp32 activations: the dlogits and dh round to
    # bf16 on both sides, and a last-bit difference before a rounding moves
    # that element one bf16 step (measured 1.5e-4, on embed.weight)
    (torch.bfloat16, 1e-3),
])
def test_fused_loss_and_gradients_match_jax(compute, rel):
    """``moe_lm_loss_fused`` against the JAX one on the same weights: the
    loss to 1e-6 and every parameter's gradient to ``rel`` of its largest."""
    want_loss, want = _jax_fused({torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[compute])
    model = _port_model("gather")
    loss = kt.moe_lm_loss_fused(model, torch.from_numpy(TOKENS).long(), compute_dtype=compute)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    names, params = zip(*model.named_parameters())
    want_g = kt.moe_params_from_flax(want)
    assert set(names) == set(want_g)
    for name, g in zip(names, torch.autograd.grad(loss, params)):
        assert g.dtype == torch.float32
        _close(g.numpy(), want_g[name].numpy(), rel, name)


def test_fused_train_step_matches_the_jax_step():
    """The same AdamW step through ``moe_lm_loss_fused`` (fp32 head)."""
    want_loss, want_grads = _jax_fused(jnp.float32)
    _check_adam_step(want_loss, want_grads, functools.partial(
        kt.moe_lm_loss_fused, compute_dtype=torch.float32))


def test_bf16_model_trains():
    """bf16 activations through the gather kernels' plain versions: finite
    loss near ln V and falling over three AdamW steps."""
    model = _port_model("gather", torch.bfloat16)
    bundle = kt.make_lm_train_step(model, kt.adamw_lowmem(3e-3, b2=0.99, weight_decay=0.1),
                                   loss_fn=functools.partial(kt.moe_lm_loss_chunked, chunk=CHUNK))
    state = bundle.init()
    tokens = torch.from_numpy(TOKENS).long()
    losses = [bundle.step(state, tokens)[1]["loss"].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and abs(losses[0] - np.log(SMALL["vocab_size"])) < 1.0
    assert losses[2] < losses[0]


def test_remat_gives_the_same_gradients():
    """Each block under ``torch.utils.checkpoint`` recomputes its routing and
    returns its aux loss again: the same loss and gradients."""
    tokens = torch.from_numpy(TOKENS).long()
    plain = _port_model("gather")
    remat = _port_model("gather")
    remat.cfg = dataclasses.replace(plain.cfg, remat=True)
    got = torch.autograd.grad(_chunked(remat, tokens), list(remat.parameters()))
    want = torch.autograd.grad(_chunked(plain, tokens), list(plain.parameters()))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_init_matches_flax_scale():
    """Per table kind, pooled over layers: the seeded init's std within 5% of
    flax's. The expert tables' fan-in counts the expert dim (std
    sqrt(1/(E*M)), not sqrt(1/M))."""
    cfg = kt.MoEConfig(**SMALL, dtype=torch.float32)
    port = kt.moe_init_state_dict(cfg, seed=0, device="cpu")
    flax_sd = kt.moe_params_from_flax(jax.tree_util.tree_map(np.asarray, _flax_params()))
    kinds = ("embed.weight", "q_proj", "o_proj", "moe.router", "moe.experts_wi", "moe.experts_wo")
    for kind in kinds:
        p = torch.cat([v.flatten() for k, v in port.items() if kind in k])
        f = torch.cat([v.flatten() for k, v in flax_sd.items() if kind in k])
        assert abs(p.std().item() / f.std().item() - 1) < 0.05, kind
    E, M = SMALL["num_experts"], SMALL["embed_dim"]
    wi = torch.cat([v.flatten() for k, v in port.items() if "experts_wi" in k])
    assert abs(wi.std().item() * np.sqrt(E * M) - 1) < 0.05
    assert all((v == 1).all() for k, v in port.items() if "norm" in k)
    assert set(port) == set(flax_sd)


def test_unported_paths_and_bad_configs_raise(monkeypatch):
    with pytest.raises(ValueError, match="requires cfg.mesh with an expert axis"):
        kt.MoETransformerLM(kt.MoEConfig(**SMALL, dispatch="a2a"), device="cpu")
    with pytest.raises(ValueError, match="unknown dispatch"):
        kt.MoETransformerLM(kt.MoEConfig(**SMALL, dispatch="onehot"), device="cpu")
    with pytest.raises(ValueError, match="exceeds num_experts"):
        tm.route_top_k(torch.zeros((1, 8, 4)), 5, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.MoETransformerLM(kt.MoEConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.moe_init_state_dict(kt.MoEConfig(**SMALL), seed=0)


def test_capacity_and_top_k_routing_match_jax():
    """``capacity`` (a multiple of 8, at least 8) and the dense combine
    tensor of the einsum path, on random logits with a dropped choice."""
    for seq, cf in ((256, 1.0), (2048, 1.25), (3, 1.25), (100, 0.5)):
        kw = dict(num_experts=8, experts_per_token=2, capacity_factor=cf)
        assert kt.MoEConfig(**kw).capacity(seq) == jm.MoEConfig(**kw).capacity(seq)
    logits = np.random.default_rng(1).standard_normal((2, 64, 4)).astype(np.float32) * 2
    want, want_aux = jax.jit(jm.top_k_routing, static_argnums=(1, 2))(jnp.asarray(logits), 2, 24)
    got, aux = tm.top_k_routing(torch.from_numpy(logits), 2, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    # gates sum to 1 over the k choices: a token short of that lost a choice
    assert (np.asarray(want).sum(axis=(2, 3)) < 0.999).any()
