"""PyTorch port's TransformerLM vs the JAX module on weights carried over by
``params_from_flax``; the port's seeded init; the port's import boundary."""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jt
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import transformer as tt

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=97, num_layers=2, num_heads=4, embed_dim=64, mlp_dim=128,
             max_seq_len=64, attention_block_size=8)


def configs(**kw):
    """(JAX config, port config) at the test size, fp32."""
    return (jt.TransformerConfig(**dict(SMALL, **kw), dtype=jnp.float32),
            tt.TransformerConfig(**dict(SMALL, **kw), dtype=torch.float32))


def carried(jcfg, tcfg, tokens):
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    model = tt.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(kt.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return params, model


@pytest.mark.parametrize("impl,kv_heads,window", [
    ("xla", None, None), ("xla", 2, 5), ("flash", None, None), ("flash", 2, 5),
])
def test_logits_match_jax(impl, kv_heads, window):
    jcfg, tcfg = configs(attention_impl=impl, num_kv_heads=kv_heads, attention_window=window)
    tokens = np.random.default_rng(0).integers(0, 97, (2, 16))
    params, model = carried(jcfg, tcfg, tokens)
    want = np.asarray(jt.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_state_dict_carries_every_weight():
    jcfg, tcfg = configs(num_kv_heads=2)
    params, model = carried(jcfg, tcfg, np.zeros((1, 8), np.int64))
    sd = kt.params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    # q_proj [E, H, D] -> [H*D, E]: output feature h*D + d reads kernel[:, h, d]
    q_kernel = np.asarray(params["layer_1"]["attn"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(
        sd["layers.1.attn.q_proj.weight"][2 * 16 + 3].numpy(), q_kernel[:, 2, 3])


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    positions = np.arange(5, 11)
    want = np.asarray(jt.rope(jnp.asarray(x), jnp.asarray(positions), 10_000.0))
    got = tt.rope(torch.from_numpy(x), torch.from_numpy(positions), 10_000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)

    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jnorm = jt.RMSNorm()
    nparams = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(h))
    norm = tt.RMSNorm(16, device="cpu")
    with torch.no_grad():
        got = norm(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnorm.apply(nparams, jnp.asarray(h))),
                               atol=1e-6, rtol=1e-6)


def test_seeded_init_matches_flax_scale():
    cfg = tt.TransformerConfig(vocab_size=512, num_layers=1, num_heads=4, num_kv_heads=2,
                               embed_dim=256, mlp_dim=512)
    a = kt.init_state_dict(cfg, seed=3, device="cpu")
    b = kt.init_state_dict(cfg, seed=3, device="cpu")
    assert all(torch.equal(a[name], b[name]) for name in a)
    # lecun normal: std sqrt(1/fan_in), truncated at 2 std of the pre-cut normal
    for name, fan_in in [("layers.0.attn.q_proj.weight", 256),
                         ("layers.0.mlp.down_proj.weight", 512)]:
        w = a[name]
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.03
        assert w.abs().max().item() <= 2 * (1 / fan_in) ** 0.5 / 0.87962566103423978
    assert abs(a["embed.weight"].std().item() * 256 ** 0.5 - 1.0) < 0.03
    assert torch.equal(a["final_norm.weight"], torch.ones(256))
    # training keeps flax's fp32 params; a decode model stores cfg.dtype
    for model_cfg, want in [(cfg, torch.float32), (kt.decode_config(cfg), torch.bfloat16)]:
        model = tt.TransformerLM(model_cfg, device="cpu")
        model.load_state_dict(a)
        assert model.layers[0].attn.q_proj.weight.dtype == want
        assert model.embed.weight.dtype == want
        assert model.final_norm.weight.dtype == torch.float32


def test_training_slice_paths_raise():
    """'ring' without a mesh raises the reference's error (it runs over
    cfg.mesh's seq axis: tests/test_torch_ring_attention.py); the 'block'
    impl and remat run."""
    _, tcfg = configs(attention_impl="ring")
    with pytest.raises(ValueError, match="attention_impl='ring' requires cfg.mesh"):
        tt.TransformerLM(tcfg, device="cpu")(torch.zeros((1, 8), dtype=torch.long))
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for kw in (dict(attention_impl="block"), dict(attention_impl="flash", remat=True)):
        _, tcfg = configs(**kw)
        logits = tt.TransformerLM(tcfg, device="cpu")(tokens)
        assert logits.shape == (1, 8, 97) and torch.isfinite(logits).all()


def test_entry_points_without_a_device_raise(monkeypatch):
    """No card and no device given: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.TransformerLM(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.init_state_dict(tcfg, seed=0)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|kubeflow_tpu)(\.|\s|$)", re.M)


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX, flax, optax or
    the JAX package: read from every source, then imported, every module."""
    files = sorted((REPO / "kubeflow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(f.relative_to(REPO / "kubeflow_tpu_torch")) for f in files[:-1]}
    assert {"models/resnet.py", "ops/bn_pallas.py", "benchmarks/bn_stats_probe.py",
            "benchmarks/pallas_bwd_probe.py", "benchmarks/_timing.py", "parallel/mesh.py",
            "parallel/bootstrap.py", "benchmarks/_cells.py", "benchmarks/transformer_bench.py",
            "benchmarks/moe_bench.py", "benchmarks/decode_bench.py",
            "benchmarks/resnet_bench.py"} <= names
    offenders = [str(f.relative_to(REPO)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    modules = sorted(("kubeflow_tpu_torch." + n[:-3].replace("/", ".")).removesuffix(".__init__")
                     for n in names)
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'optax', 'kubeflow_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_decode_config_maps_impls():
    for impl, want in [("flash", "flash"), ("xla", "xla"), ("block", "xla"), ("ring", "xla")]:
        _, tcfg = configs(attention_impl=impl, remat=True)
        dec = kt.decode_config(tcfg)
        assert (dec.attention_impl, dec.decode, dec.remat) == (want, True, False)
