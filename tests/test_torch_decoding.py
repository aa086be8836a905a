"""PyTorch port's KV-cache decoding vs the JAX package's, on weights carried
over by ``params_from_flax`` (CPU, plain kernel versions, fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decoding as jd
from kubeflow_tpu.models import transformer as jt
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import decoding as td
from kubeflow_tpu_torch.models import transformer as tt

SMALL = dict(vocab_size=97, num_layers=2, num_heads=4, embed_dim=64, mlp_dim=128,
             max_seq_len=64, attention_block_size=8)


def pair(**kw):
    """(JAX decode model, its params, port decode model) on one flax init."""
    jcfg = jt.TransformerConfig(**dict(SMALL, **kw), dtype=jnp.float32)
    tcfg = tt.TransformerConfig(**dict(SMALL, **kw), dtype=torch.float32)
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = tt.TransformerLM(kt.decode_config(tcfg), device="cpu")
    model.load_state_dict(kt.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jt.TransformerLM(jd.decode_config(jcfg)), params, model


def port_model(**kw):
    """A port decode model on the port's own seeded init (no JAX side)."""
    tcfg = tt.TransformerConfig(**dict(SMALL, **kw), dtype=torch.float32)
    model = tt.TransformerLM(kt.decode_config(tcfg), device="cpu")
    model.load_state_dict(kt.init_state_dict(tcfg, seed=0, device="cpu"))
    return model


def prompt(B, P, seed):
    return np.random.default_rng(seed).integers(0, 97, (B, P)).astype(np.int32)


@pytest.mark.parametrize("impl,kv_heads", [("flash", None), ("flash", 2), ("xla", 2)])
def test_greedy_generate_matches_jax(impl, kv_heads):
    jmodel, params, model = pair(attention_impl=impl, num_kv_heads=kv_heads)
    p = prompt(2, 8, 5)
    want = np.asarray(jd.generate(jmodel, params, jnp.asarray(p), max_new_tokens=9))
    got = kt.generate(model, torch.from_numpy(p), max_new_tokens=9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_prefill_matches_jax():
    jmodel, params, model = pair(attention_impl="flash", num_kv_heads=2)
    p = prompt(2, 16, 2)
    jcache, jlogits = jd.prefill(jmodel, params, jnp.asarray(p))
    cache, logits = kt.prefill(model, torch.from_numpy(p))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    for i, (k, v) in enumerate(cache):
        layer = jcache[f"layer_{i}"]["attn"]
        np.testing.assert_allclose(k.numpy(), np.asarray(layer["cached_key"]), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(layer["cached_value"]), atol=1e-5)


def test_flash_decode_honors_sliding_window():
    jmodel, params, model = pair(attention_impl="flash", attention_window=16)
    p = prompt(2, 24, 6)
    want = np.asarray(jd.generate(jmodel, params, jnp.asarray(p), max_new_tokens=6))
    got = kt.generate(model, torch.from_numpy(p), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_decode_steps_matches_generate(kv_heads):
    model = port_model(attention_impl="flash", num_kv_heads=kv_heads)
    p = torch.from_numpy(prompt(2, 8, 1))
    want = kt.generate(model, p, max_new_tokens=6)
    cache, last = kt.prefill(model, p)
    tok0 = last.argmax(-1)
    toks, cache_out = kt.decode_steps(model, cache, tok0, 8, n=5)
    assert cache_out is cache                       # updated in place
    got = torch.cat([p, tok0[:, None].int(), toks], dim=1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_untileable_cache_takes_the_einsum_path():
    """max_seq_len not a multiple of decode_block_k decodes through the
    einsum branch, as in the JAX package, and gives the xla path's tokens."""
    flash = port_model(attention_impl="flash", max_seq_len=96, decode_block_k=64)
    xla = port_model(attention_impl="xla", max_seq_len=96)
    p = torch.from_numpy(prompt(2, 7, 7))
    np.testing.assert_array_equal(
        kt.generate(flash, p, max_new_tokens=5).numpy(),
        kt.generate(xla, p, max_new_tokens=5).numpy())


def test_eos_freezes_finished_rows():
    model = port_model(attention_impl="flash")
    p = torch.from_numpy(prompt(2, 4, 2))
    eos = int(kt.generate(model, p, max_new_tokens=1)[0, 4])
    out = kt.generate(model, p, max_new_tokens=6, eos_id=eos)
    row = out[0, 4:].numpy()
    assert row[0] == eos and (row == eos).all()
    # with every row done after its first token the loop ends at once and
    # the rest stays eos padding
    all_done = kt.generate(model, p[:1], max_new_tokens=6, eos_id=eos)
    assert (all_done[0, 4:] == eos).all()


def test_top_k_sampling_is_reproducible_and_inside_top_k():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 97)).astype(np.float32))
    allowed = torch.topk(logits, 5, dim=-1).indices
    g = torch.Generator().manual_seed(11)
    draws = torch.stack([td._sample(logits, 1.0, 5, g) for _ in range(200)])
    assert (draws[..., None] == allowed[None]).any(-1).all()
    assert len(torch.unique(draws[:, 0])) > 1       # it does sample
    assert torch.equal(td._sample(logits, 0.0, 5, g), logits.argmax(-1).int())

    model = port_model(attention_impl="flash")
    p = torch.from_numpy(prompt(2, 4, 3))
    runs = [kt.generate(model, p, max_new_tokens=5, temperature=0.8, top_k=8,
                        generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < 97


def test_generate_rejects_cache_overflow():
    model = port_model()
    with pytest.raises(ValueError, match="exceeds the cache"):
        kt.generate(model, torch.zeros((1, 60), dtype=torch.int32), max_new_tokens=10)


def test_decode_mode_needs_a_cache():
    model = port_model()
    with pytest.raises(ValueError, match="needs a cache"):
        model(torch.zeros((1, 4), dtype=torch.long))
