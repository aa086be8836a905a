"""PyTorch port's training slice vs the JAX package on the CPU: blockwise
attention, the losses, whole-model gradients, the low-memory optimizers, the
train step, and remat."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.ops import attention as jatt
from kubeflow_tpu.ops import optimizers as jopt
from kubeflow_tpu.parallel import mesh as meshlib
from kubeflow_tpu.parallel.train import make_lm_train_step as jax_train_step
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.ops import attention as att
from kubeflow_tpu_torch.ops import optimizers as topt
from kubeflow_tpu_torch.ops import pallas_attention as pa

SMALL = dict(vocab_size=97, num_layers=2, num_heads=4, embed_dim=64, mlp_dim=128,
             max_seq_len=32, attention_block_size=8)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _close(got, want, rel, what=""):
    """Every element within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _vjp(fn, primals, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, primals))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


# ------------------------------------------------------------- blockwise


@pytest.mark.parametrize("causal,block", [(True, 8), (False, 16), (True, 32)])
def test_blockwise_attention_matches_jax(causal, block):
    """fp32 on both sides; summation order only (max error ~1e-6)."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((2, 32, 4, 16)).astype(np.float32) for _ in range(4))
    want, want_g = _vjp(lambda q, k, v: jatt.blockwise_attention(
        q, k, v, causal=causal, block_size=block), (q, k, v), do)
    qt, kt_, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = att.blockwise_attention(qt, kt_, vt, causal=causal, block_size=block)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    for x, w in zip((qt, kt_, vt), want_g):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        att.blockwise_attention(qt, kt_, vt, block_size=12)


# ------------------------------------------------------------- losses


def test_lm_loss_matches_jax():
    """fp32 log-softmax on both sides: loss and logits grad to 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 16, 97)).astype(np.float32) * 3
    tokens = rng.integers(0, 97, (2, 16))
    want, want_g = _vjp(lambda lg: jt.lm_loss(lg, jnp.asarray(tokens)), (logits,), 1.0)
    lg = torch.from_numpy(logits).requires_grad_()
    got = tt.lm_loss(lg, torch.from_numpy(tokens))
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), want_g[0], atol=1e-7)


@pytest.mark.parametrize("compute,h_dtype,rel", [
    # fp32 operands: summation order only
    (torch.float32, torch.float32, 1e-5),
    # bf16 operands, products exact and summed in fp32 on both sides; both
    # round the operand gradients to bf16 at the same point, so only a
    # last-bit difference before that rounding shows (measured 5.4e-6)
    (torch.bfloat16, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 1e-4),
])
def test_lm_loss_chunked_matches_jax(compute, h_dtype, rel):
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 16, 32)).astype(np.float32)
    emb = (rng.standard_normal((97, 32)) * 0.2).astype(np.float32)
    tokens = rng.integers(0, 97, (2, 16))
    hidden = torch.from_numpy(hidden).to(h_dtype).float().numpy()   # same values both sides

    def jloss(h, e):
        return jt.lm_loss_chunked(h.astype(JDT[h_dtype]), e, jnp.asarray(tokens), chunk=4,
                                  compute_dtype=JDT[compute])

    want, (want_h, want_e) = _vjp(jloss, (hidden, emb), 1.0)
    h = torch.from_numpy(hidden).to(h_dtype).requires_grad_()
    e = torch.from_numpy(emb).requires_grad_()
    got = tt.lm_loss_chunked(h, e, torch.from_numpy(tokens), chunk=4, compute_dtype=compute)
    got.backward()
    assert got.dtype == torch.float32 and h.grad.dtype == h_dtype
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    _close(h.grad.float().numpy(), want_h, rel, "d hidden")
    _close(e.grad.numpy(), want_e, rel, "d embedding")


def test_chunked_logits_are_fp32_and_equal_the_unchunked_loss():
    h = torch.randn(6, 32, dtype=torch.bfloat16)
    e = torch.randn(97, 32, dtype=torch.bfloat16)
    assert tt._LogitsF32.apply(h, e).dtype == torch.float32
    hidden = torch.randn(2, 16, 32)
    emb = torch.randn(97, 32) * 0.2
    tokens = torch.randint(0, 97, (2, 16))
    chunked = tt.lm_loss_chunked(hidden, emb, tokens, chunk=4, compute_dtype=torch.float32)
    full = tt.lm_loss(hidden @ emb.T, tokens)
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="must divide"):
        tt.lm_loss_chunked(hidden, emb, tokens, chunk=5)


# ------------------------------------------------------------- whole model


def _configs(dtype, **kw):
    return (jt.TransformerConfig(**dict(SMALL, **kw), dtype=JDT[dtype]),
            tt.TransformerConfig(**dict(SMALL, **kw), dtype=dtype))


@functools.cache
def _flax_params(**kw):
    """One flax init per head layout. The fp32 params depend neither on the
    attention impl ('xla' inits fast) nor on ``dtype``."""
    cfg = jt.TransformerConfig(**dict(SMALL, **kw, attention_impl="xla"))
    return jt.TransformerLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))["params"]


def _carried(jcfg, tcfg):
    params = _flax_params(num_kv_heads=jcfg.num_kv_heads)
    model = tt.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(kt.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return params, model


@pytest.mark.parametrize("impl", ["xla", "flash", "block"])
@pytest.mark.parametrize("dtype,rel", [
    # fp32 activations and head: summation order only (measured 3.1e-6)
    (torch.float32, 2e-5),
    # bf16 activations: the two frameworks round the same values to bf16 at
    # the same points but sum in other orders, so an early one-step flip
    # (2^-8) travels through two layers and the backward; and the embedding
    # gradient is a bf16 scatter-add in flax but an fp32-accumulated
    # embedding_dense_backward in torch (measured 2.1e-2)
    (torch.bfloat16, 5e-2),
])
def test_model_gradients_match_jax(impl, dtype, rel):
    """jax.grad of the JAX chunked loss vs the port's, on the same weights
    (fp32 parameters on both sides, ``cfg.dtype`` activations, GQA 4/2)."""
    jcfg, tcfg = _configs(dtype, attention_impl=impl, num_kv_heads=2)
    tokens = np.random.default_rng(2).integers(0, 97, (2, 16))
    params, model = _carried(jcfg, tcfg)
    jmodel = jt.TransformerLM(jcfg)

    def jloss(p):
        hidden = jmodel.apply({"params": p}, jnp.asarray(tokens), return_hidden=True)
        return jt.lm_loss_chunked(hidden, p["embed"]["embedding"], jnp.asarray(tokens), chunk=8)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    want = kt.params_from_flax(jax.tree_util.tree_map(np.asarray, want))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    hidden = model(torch.from_numpy(tokens), return_hidden=True)
    assert hidden.dtype == dtype
    loss = tt.lm_loss_chunked(hidden, model.embed.weight, torch.from_numpy(tokens), chunk=8)
    names, params_t = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params_t)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=rel / 10)
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32
        _close(g.numpy(), want[name].numpy(), rel, name)


# ------------------------------------------------------------- optimizers


def _opt_params(rng, dtype=np.float32):
    return [rng.standard_normal(s).astype(dtype) for s in [(7, 5), (5,), (3, 4, 2)]]


@pytest.mark.parametrize("master", [False, True])
def test_adamw_lowmem_trajectory_matches_optax(master):
    """Five steps on the same numpy gradients. The moment math is fp32 on
    both sides and stores to bf16 at the same points; an fp32 difference in
    the last bit can flip one bf16 rounding of mu or nu (2^-8 relative),
    which moves that step's update by < 1% of lr (1e-2 here)."""
    rng = np.random.default_rng(3)
    params = _opt_params(rng)
    grads = [_opt_params(rng) for _ in range(5)]
    dtype = (jnp.bfloat16, torch.bfloat16) if master else (jnp.float32, torch.float32)
    jtx = jopt.adamw_lowmem(1e-2, b2=0.99, weight_decay=0.1)
    ttx = topt.adamw_lowmem(1e-2, b2=0.99, weight_decay=0.1)
    if master:
        jtx, ttx = jopt.with_f32_master(jtx), topt.with_f32_master(ttx)
    jp = [jnp.asarray(p).astype(dtype[0]) for p in params]
    tp = [torch.from_numpy(p).to(dtype[1]) for p in params]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        updates, jstate = jtx.update([jnp.asarray(x).astype(dtype[0]) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.apply_updates(tp, ttx.update([torch.from_numpy(x).to(dtype[1]) for x in g], tstate, tp))
        for a, b in zip(tp, jp):
            assert a.dtype == dtype[1]
            # bf16 params (master): plus one bf16 step of the param itself
            atol = 2e-4 + (2 ** -8 * float(np.abs(np.asarray(b, np.float32)).max()) if master else 0)
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=atol, rtol=0)
    inner = tstate["inner"] if master else tstate
    assert inner[0]["count"] == 5
    assert all(m.dtype == torch.bfloat16 for m in inner[0]["mu"] + inner[0]["nu"])
    if master:
        assert all(m.dtype == torch.float32 for m in tstate["master"])


def test_bf16_nu_guard():
    with pytest.raises(ValueError, match="rounding floor"):
        topt.adamw_lowmem(1e-3, b2=0.999)
    topt.adamw_lowmem(1e-3, b2=0.999, nu_dtype=None)        # f32 nu is fine
    with pytest.raises(ValueError, match="requires params"):
        topt.with_f32_master(topt.sgd(0.1)).update([torch.ones(2)], None, None)


# ------------------------------------------------------------- train step


def _train_setups(accum_steps):
    """(JAX bundle, state, tokens), (port bundle, model): one flax init on a
    one-device mesh, SGD (so Adam's sign flips on near-zero gradients do not
    decide the tolerance), fp32 head as in the JAX package's own test."""
    jcfg, tcfg = _configs(torch.float32, attention_impl="flash")
    mesh = meshlib.create_mesh(meshlib.MeshPlan(data=1), devices=jax.devices()[:1])
    tokens = np.random.default_rng(4).integers(0, 97, (8, 32))
    jb = jax_train_step(jt.TransformerLM(jcfg), optax.sgd(0.1), mesh, accum_steps=accum_steps,
                        donate=False, loss_dtype=jnp.float32, chunk=16)
    jstate = jb.init(jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32))
    model = tt.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(kt.params_from_flax(jax.tree_util.tree_map(np.asarray, jstate["params"])))
    tb = kt.make_lm_train_step(model, topt.sgd(0.1), accum_steps=accum_steps,
                               loss_dtype=torch.float32, chunk=16)
    return (jb, jstate, tokens), (tb, model)


@pytest.mark.parametrize("accum_steps", [1, 4])
def test_train_step_matches_jax(accum_steps):
    """fp32 model and head: loss to 1e-5 and every updated parameter to
    1e-5 of its scale (summation order only)."""
    (jb, jstate, tokens), (tb, model) = _train_setups(accum_steps)
    jstate, jm = jb.step(jstate, jnp.asarray(tokens, jnp.int32))
    state = tb.init()
    state, m = tb.step(state, torch.from_numpy(tokens))
    assert state["step"] == 1 and m["loss"].dtype == torch.float32
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want = kt.params_from_flax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    for name, p in model.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), 1e-5, name)


def test_train_step_accum_divisibility():
    model = tt.TransformerLM(_configs(torch.float32)[1], device="cpu")
    tb = kt.make_lm_train_step(model, topt.sgd(0.1), accum_steps=3)
    with pytest.raises(ValueError, match="accum_steps 3 must divide batch 8"):
        tb.step(tb.init(), torch.zeros((8, 16), dtype=torch.long))


def test_train_step_with_adamw_lowers_the_loss():
    model = tt.TransformerLM(_configs(torch.bfloat16, attention_impl="flash")[1], device="cpu")
    model.load_state_dict(kt.init_state_dict(model.cfg, seed=0, device="cpu"))
    tb = kt.make_lm_train_step(model, kt.adamw_lowmem(3e-3, b2=0.99, weight_decay=0.1), chunk=16)
    state = tb.init()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 97, (4, 32)))
    losses = [tb.step(state, tokens)[1]["loss"].item() for _ in range(5)]
    # tied head at flax's init scale: logits ~ N(0, 1), so the first loss is
    # ~ln(V) + 1/2
    assert abs(losses[0] - (np.log(97) + 0.5)) < 0.25
    assert losses[-1] < losses[0] and state["step"] == 5


# ------------------------------------------------------------- remat


def test_resolve_remat_policy():
    assert kt.resolve_remat_policy("full") is None
    assert kt.resolve_remat_policy("flash") == [torch.ops.kubeflow_tpu_torch.flash_attention_fwd.default]
    assert torch.ops.aten.mm.default in kt.resolve_remat_policy("dots")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        kt.resolve_remat_policy("offload")


@pytest.mark.parametrize("policy,fwd_calls", [("full", 4), ("dots", 4), ("flash", 2)])
def test_remat_policies_match_no_remat(monkeypatch, policy, fwd_calls):
    """Same gradients as without remat (to 1e-6: the replay recomputes the
    same fp32 numbers), and the flash forward's call count per step: 2 layers
    once each under 'flash' (its out and lse are kept), twice under 'full'
    and 'dots' (the replay runs it again)."""
    calls = []
    plain = pa.flash_attention_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 97, (2, 16)))
    sd = kt.init_state_dict(_configs(torch.float32)[1], seed=1, device="cpu")

    def grads(**kw):
        model = tt.TransformerLM(_configs(torch.float32, attention_impl="flash", **kw)[1],
                                 device="cpu")
        model.load_state_dict(sd)
        calls.clear()
        loss = tt.lm_loss_chunked(model(tokens, return_hidden=True), model.embed.weight, tokens)
        return torch.autograd.grad(loss, list(model.parameters())), len(calls)

    monkeypatch.setattr(pa, "flash_attention_plain", counted)
    want, n_plain = grads()
    got, n_remat = grads(remat=True, remat_policy=policy)
    assert n_plain == 2 and n_remat == fwd_calls
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
