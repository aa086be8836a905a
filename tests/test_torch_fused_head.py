"""PyTorch port's fused tied head (``ops/fused_head_loss.py``) against the JAX
package on the CPU.

The JAX side runs its three Pallas kernels in interpret mode at shapes its
guard sends to them (T a multiple of 256; V 512 and 1024, which have
128-multiple divisors under every block limit), as ``tests/test_fused_head.py``
runs them; the port runs its plain versions, which its wrappers take for CPU
tensors. Inputs come from numpy seeds; each JAX reference is computed once."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.ops import fused_head_loss as jfh
from kubeflow_tpu.parallel import mesh as meshlib
from kubeflow_tpu.parallel.train import make_lm_train_step as jax_train_step
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.ops import fused_head_loss as fh
from kubeflow_tpu_torch.ops import optimizers as topt

E = 128
SHAPES = {"t256_v512": (256, 512), "t512_v1024": (512, 1024)}
COTANGENTS = {"dlse-only": (1.0, 0.0), "dgold-only": (0.0, 1.0), "mixed": (0.7, -1.3)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(T, V, seed=0):
    """h [T, E], emb [V, E] (flax-like scale: logits ~ N(0, 0.5)), targets
    [T] and a row weight [T], as numpy fp32 / int."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, E)).astype(np.float32)
    emb = (rng.standard_normal((V, E)) * 0.05).astype(np.float32)
    tgt = rng.integers(0, V, (T,)).astype(np.int32)
    w = rng.standard_normal((T,)).astype(np.float32)
    return h, emb, tgt, w


def _bf16_exact(x):
    """Share of the elements of an fp32 array that bf16 represents exactly."""
    x = torch.from_numpy(np.array(x, np.float32))
    return (x.to(torch.bfloat16).float() == x).float().mean().item()


def _close(got, want, rel, what="", rtol=0.0):
    """Every element within ``rel`` of the reference's largest magnitude
    (plus ``rtol`` of itself)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel * np.abs(want).max(), err_msg=what)


@functools.cache
def _jax_reference(shape, dtype, cot):
    """lse, gold and (dh, dE) of sum(w * (a * lse + b * gold)) through the JAX
    kernels: fp32 leaves, cast to the compute dtype inside the function (as
    ``fused_head_nll`` casts), so dE reaches the fp32 table as the JAX
    backward hands it over."""
    T, V = SHAPES[shape]
    h, emb, tgt, w = _inputs(T, V)
    a, b = COTANGENTS[cot]
    dt = JDT[dtype]

    def f(h, emb):
        lse, gold = jfh.fused_lse_gold(h.astype(dt), emb.astype(dt), jnp.asarray(tgt))
        return jnp.sum(jnp.asarray(w) * (a * lse + b * gold)), (lse, gold)

    (_, (lse, gold)), (dh, de) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(emb))
    return tuple(np.asarray(x) for x in (lse, gold, dh, de))


def _port(shape, dtype, cot):
    T, V = SHAPES[shape]
    h, emb, tgt, w = _inputs(T, V)
    a, b = COTANGENTS[cot]
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    lse, gold = kt.fused_lse_gold(ht.to(dtype), et, torch.from_numpy(tgt).long())
    torch.sum(torch.from_numpy(w) * (a * lse + b * gold)).backward()
    return lse.detach(), gold.detach(), ht.grad, et.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lse_and_gold_match_jax(shape, dtype):
    """fp32 logits on both sides from the same operands (bf16 products are
    exact in fp32): lse and gold differ by summation order only, held to
    1e-5 absolute (|lse| ~ 6.3, |gold| <= ~2)."""
    lse_j, gold_j, _, _ = _jax_reference(shape, dtype, "mixed")
    lse, gold, _, _ = _port(shape, dtype, "mixed")
    assert lse.dtype == gold.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gold.numpy(), gold_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cot", list(COTANGENTS))
@pytest.mark.parametrize("dtype,rel,dh_rtol", [
    # fp32: summation order only
    (torch.float32, 1e-5, 0.0),
    # bf16: dlogits round to bf16 on both sides, and p = exp(logit - lse)
    # may differ in its last fp32 bits, which moves a dlogit one bf16 step
    # (2^-8 of itself) now and then; summed over V terms, that is far below
    # 1e-3 of the largest gradient. dh is rounded to bf16 at the end, so a
    # sum a last fp32 bit apart may land one bf16 step (2^-8) apart
    (torch.bfloat16, 1e-3, 2.0 ** -8),
])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gradients_match_jax(shape, dtype, rel, dh_rtol, cot):
    """dh and dE under each cotangent alone and both together."""
    _, _, dh_j, de_j = _jax_reference(shape, dtype, cot)
    _, _, dh, de = _port(shape, dtype, cot)
    assert dh.dtype == de.dtype == torch.float32
    _close(dh.numpy(), dh_j, rel, "dh", rtol=dh_rtol)
    _close(de.numpy(), de_j, rel, "dE")


def test_bf16_dh_is_rounded_and_de_reaches_the_fp32_table_unrounded():
    """As in JAX: dh comes back in h's dtype (bf16-exact), while dE reaches
    the fp32 table in fp32. Almost no element of an unrounded sum of many
    products is bf16-exact (JAX measured 0.006% at T 256, E 128, V 512)."""
    _, _, dh_j, de_j = _jax_reference("t256_v512", torch.bfloat16, "mixed")
    _, _, dh, de = _port("t256_v512", torch.bfloat16, "mixed")
    assert _bf16_exact(dh_j) == 1.0 and _bf16_exact(dh) == 1.0
    assert _bf16_exact(de_j) < 0.01 and _bf16_exact(de) < 0.01
    # the table held in bf16 gets a bf16 gradient (autograd casts it)
    T, V = SHAPES["t256_v512"]
    h, emb, tgt, _ = _inputs(T, V)
    eb = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_()
    lse, gold = kt.fused_lse_gold(torch.from_numpy(h).to(torch.bfloat16), eb,
                                  torch.from_numpy(tgt))
    (lse - gold).sum().backward()
    assert eb.grad.dtype == torch.bfloat16


def test_jax_fallback_shape_rounds_de_and_the_port_does_not():
    """At V 97 (no 128-multiple divisor) the JAX function falls back to its
    einsum reference, whose autodiff rounds dE to bf16; the port keeps the
    kernels' semantics at every shape. The two agree to bf16 rounding."""
    rng = np.random.default_rng(7)
    B, S, V = 2, 128, 97
    hidden = rng.standard_normal((B, S, E)).astype(np.float32)
    emb = (rng.standard_normal((V, E)) * 0.05).astype(np.float32)
    tokens = rng.integers(0, V, (B, S))
    want = jax.grad(lambda e: jfh.fused_head_nll(jnp.asarray(hidden), e, jnp.asarray(tokens)))(
        jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_()
    kt.fused_head_nll(torch.from_numpy(hidden), et, torch.from_numpy(tokens)).backward()
    assert _bf16_exact(want) == 1.0
    assert _bf16_exact(et.grad) < 0.05
    _close(et.grad.numpy(), np.asarray(want), 2 ** -7, "dE")


@functools.cache
def _jax_nll(B, S, V, seed):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, E)).astype(np.float32)
    emb = (rng.standard_normal((V, E)) * 0.05).astype(np.float32)
    tokens = rng.integers(0, V, (B, S))
    loss, grads = jax.value_and_grad(lambda h, e: jfh.fused_head_nll(
        h, e, jnp.asarray(tokens), compute_dtype=jnp.float32), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(emb))
    return (hidden, emb, tokens), (float(loss), *map(np.asarray, grads))


def test_fused_head_nll_matches_jax_and_the_chunked_loss_f32():
    """fp32 operands: the fused loss and its gradients equal the JAX fused
    loss's (kernels in interpret mode) and the port's ``lm_loss_chunked``,
    to summation order (1e-6 on the loss, 1e-5 of the largest gradient)."""
    (hidden, emb, tokens), (want, want_h, want_e) = _jax_nll(2, 256, 512, 5)
    grads = {}
    for name, fn in (("fused", lambda h, e, t: kt.fused_head_nll(h, e, t, compute_dtype=torch.float32)),
                     ("chunked", lambda h, e, t: tt.lm_loss_chunked(h, e, t, chunk=128,
                                                                   compute_dtype=torch.float32))):
        h = torch.from_numpy(hidden).requires_grad_()
        e = torch.from_numpy(emb).requires_grad_()
        loss = fn(h, e, torch.from_numpy(tokens))
        loss.backward()
        np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
        _close(h.grad.numpy(), want_h, 1e-5, f"{name} d hidden")
        _close(e.grad.numpy(), want_e, 1e-5, f"{name} d embedding")
        grads[name] = (h.grad, e.grad)
    for a, b in zip(grads["fused"], grads["chunked"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_any_shape_and_targets_outside_the_vocabulary():
    """No shape guard: T 300, V 97, E 40 run through the wrappers; a target
    outside [0, V) has gold 0 and no one-hot term in the backward."""
    rng = np.random.default_rng(3)
    T, V, E_ = 300, 97, 40
    h = torch.from_numpy(rng.standard_normal((T, E_)).astype(np.float32))
    emb = torch.from_numpy((rng.standard_normal((V, E_)) * 0.1).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, V, (T,)))
    tgt[::7] = V
    tgt[3::11] = -1
    lse, gold = fh.fused_head_fwd(h, emb, tgt)
    logits = h @ emb.t()
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=0, atol=1e-5)
    valid = (tgt >= 0) & (tgt < V)
    want_gold = torch.where(valid, logits.gather(1, tgt.clamp(0, V - 1)[:, None])[:, 0], 0.0)
    torch.testing.assert_close(gold, want_gold, rtol=0, atol=1e-5)
    dlse, dgold = torch.randn(T, dtype=torch.float64).float(), torch.ones(T)
    dh = fh.fused_head_bwd_dh(h, emb, tgt, lse, dlse, dgold)
    de = fh.fused_head_bwd_de(h, emb, tgt, lse, dlse, dgold)
    y = torch.nn.functional.one_hot(tgt.clamp(0, V - 1), V).float() * valid[:, None]
    dl = dlse[:, None] * torch.softmax(logits, -1) + dgold[:, None] * y
    torch.testing.assert_close(dh, dl @ emb, rtol=0, atol=1e-5)
    torch.testing.assert_close(de, dl.t() @ h, rtol=0, atol=1e-5)


def test_cpu_wrappers_count_no_launch_and_card_operands_are_checked():
    """CPU tensors take the plain versions and count no launch. Off the CPU
    the wrappers check the operands before any build: h and emb other than
    bf16 or fp32 (or of two dtypes), other dtypes of the row vectors, and a
    device other than CUDA raise (the checks run on meta tensors here, as no
    card is present). fp32 h and emb pass the dtype check: they take the
    scalar kernels on the card."""
    counters = (fh.fused_head_fwd, fh.fused_head_bwd_dh, fh.fused_head_bwd_de)
    before = [c.launches for c in counters]
    h, emb, tgt, _ = _inputs(64, 128)
    hb = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    lse, gold = kt.fused_lse_gold(hb, torch.from_numpy(emb).requires_grad_(), torch.from_numpy(tgt))
    (lse - gold).sum().backward()
    assert [c.launches for c in counters] == before

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    rows = [meta(8, dtype=torch.float32) for _ in range(3)]
    tg = meta(8, dtype=torch.int64)
    f32 = torch.float32
    with pytest.raises(TypeError, match="takes CUDA tensors"):
        fh.fused_head_fwd(meta(8, 16, dtype=f32), meta(5, 16, dtype=f32), tg)
    with pytest.raises(TypeError, match="takes CUDA tensors"):
        fh.fused_head_bwd_dh(meta(8, 16, dtype=f32), meta(5, 16, dtype=f32), tg, *rows)
    with pytest.raises(TypeError, match="takes bf16 or fp32 h and emb of one dtype"):
        fh.fused_head_bwd_de(meta(8, 16), meta(5, 16, dtype=torch.float16), tg, *rows)
    with pytest.raises(TypeError, match="takes bf16 or fp32 h and emb of one dtype"):
        fh.fused_head_fwd(meta(8, 16, dtype=torch.float16), meta(5, 16, dtype=torch.float16), tg)
    with pytest.raises(TypeError, match="takes bf16 or fp32 h and emb of one dtype"):
        fh.fused_head_bwd_dh(meta(8, 16), meta(5, 16, dtype=f32), tg, *rows)
    with pytest.raises(TypeError, match="must be float32"):
        fh.fused_head_bwd_dh(meta(8, 16), meta(5, 16), tg, rows[0], rows[1].half(), rows[2])
    with pytest.raises(TypeError, match="takes CUDA tensors"):
        fh.fused_head_fwd(meta(8, 16), meta(5, 16), tg)
    with pytest.raises(ValueError, match="expected h"):
        fh.fused_head_fwd(torch.zeros(8, 16), torch.zeros(5, 12), torch.zeros(8, dtype=torch.long))


DENSE = dict(vocab_size=512, num_layers=2, num_heads=4, embed_dim=64, mlp_dim=128,
             max_seq_len=32, attention_impl="flash", attention_block_size=8)


def test_dense_train_step_through_the_fused_head_matches_jax():
    """The dense LM's one SGD step with the head the way the dense bench
    composes it (``transformer_bench.py:149-158``: ``fused_head_nll`` of the
    hidden states and the tied table, bf16 head operands) against the same
    composition in JAX on a one-device mesh, from one flax init. T = 8 x 32
    = 256 and V = 512 take the JAX kernels. The loss to 1e-5; every updated
    parameter to 1e-4 of its scale (0.1 x a gradient difference of bf16
    rounding flips, as in the MoE fused-head check)."""
    jcfg = jt.TransformerConfig(**DENSE, dtype=jnp.float32)
    tokens = np.random.default_rng(8).integers(0, DENSE["vocab_size"], (8, 32))
    jmodel = jt.TransformerLM(jcfg)

    def jloss(params, toks):
        hidden = jmodel.apply({"params": params}, toks, return_hidden=True)
        return jfh.fused_head_nll(hidden, params["embed"]["embedding"], toks)

    mesh = meshlib.create_mesh(meshlib.MeshPlan(data=1), devices=jax.devices()[:1])
    jb = jax_train_step(jmodel, optax.sgd(0.1), mesh, loss_fn=jloss, donate=False)
    jstate = jb.init(jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32))
    model = tt.TransformerLM(tt.TransformerConfig(**DENSE, dtype=torch.float32), device="cpu")
    model.load_state_dict(kt.params_from_flax(jax.tree_util.tree_map(np.asarray, jstate["params"])))
    jstate, jm = jb.step(jstate, jnp.asarray(tokens, jnp.int32))

    tb = kt.make_lm_train_step(model, topt.sgd(0.1), loss_fn=lambda m, t: kt.fused_head_nll(
        m(t, return_hidden=True), m.embed.weight, t))
    state, m = tb.step(tb.init(), torch.from_numpy(tokens))
    assert state["step"] == 1
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want = kt.params_from_flax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    for name, p in model.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), 1e-4, name)
