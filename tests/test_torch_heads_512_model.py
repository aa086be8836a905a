"""A model of heads of 512 (two query heads of 512 over one KV head, at the
flagships' width E 1024) against the JAX model on the CPU.

The JAX model runs its Pallas flash kernels in interpret mode, the port its
plain versions, which on the card are the width-512 kernels: bf16 on the
tensor-core route (two warpgroups each owning half of an accumulator's
columns), fp32 on the FMA forward, dq and dk/dv. One
flax init for the file, carried by ``interop.params_from_flax``. fp32 on
both sides, so the two differ in summation order only: logits, loss,
gradient norm and every updated parameter within 1e-4 relative (the dense
model's bound is of that order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel import mesh as meshlib
from kubeflow_tpu.parallel.train import make_lm_train_step as jax_train_step
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.ops import optimizers as topt
from kubeflow_tpu_torch.ops import pallas_attention as pa

WIDE = dict(vocab_size=97, num_layers=2, num_heads=2, num_kv_heads=1, embed_dim=1024,
            mlp_dim=1024, max_seq_len=64, attention_impl="flash")
B, S, LR, CHUNK = 2, 64, 0.1, 32
REL = 1e-4


@functools.cache
def _jax_side():
    """(JAX train step, its initial state, tokens): one flax init on a
    one-device mesh, SGD so the update is the gradient times the rate."""
    cfg = jt.TransformerConfig(**WIDE, dtype=jnp.float32)
    mesh = meshlib.create_mesh(meshlib.MeshPlan(data=1), devices=jax.devices()[:1])
    tokens = np.random.default_rng(23).integers(0, WIDE["vocab_size"], (B, S))
    bundle = jax_train_step(jt.TransformerLM(cfg), optax.sgd(LR), mesh, donate=False,
                            loss_dtype=jnp.float32, chunk=CHUNK)
    state = bundle.init(jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32))
    return bundle, state, tokens


def _port_model():
    _, state, _ = _jax_side()
    model = tt.TransformerLM(tt.TransformerConfig(**WIDE, dtype=torch.float32), device="cpu")
    model.load_state_dict(kt.params_from_flax(jax.tree_util.tree_map(np.asarray, state["params"])))
    return model


def _close(got, want, what=""):
    """Every element within REL of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dtype,routes", [
    (torch.bfloat16, {"fwd": "wgmma", "dq": "wgmma", "dkv": "wgmma"}),
    (torch.float32, {"fwd": "fma", "dq": "fma", "dkv": "fma"}),
])
def test_heads_of_512_take_their_routes(dtype, routes):
    """The model's attention shapes at width 512: bf16 on the tensor-core
    route (the forward in 64-row tiles, two warpgroups each owning half of
    O's columns; dq in 64-row tiles and dk/dv in 64-key blocks, each a
    cluster of two blocks, one a half of dQ's or of dK's and dV's columns);
    fp32 on the FMA kernels (the forward 64 query rows and 32-key tiles,
    dq 32 query rows and 32-key tiles, dk/dv 32 keys and 32-row tiles, each
    a cluster of two blocks, one a column half)."""
    model = _port_model()
    assert model.cfg.head_dim == 512 and model.cfg.kv_heads == 1
    for kernel, route in routes.items():
        plan = pa._plan(kernel, B, S, S, WIDE["num_heads"], 1, 512, dtype)
        assert (plan.route, plan.width) == (route, 512), kernel
        if route == "wgmma":
            cluster = 1 if kernel == "fwd" else 2
            grid = (1, B, 2) if kernel == "dkv" else (WIDE["num_heads"], B, cluster)
            assert (plan.block, plan.threads, plan.grid, plan.cluster) == (64, 256, grid, cluster)
            assert plan.smem_bytes == pa._wgmma_sums(kernel, 64, 512)[0]
        if route == "fma" and kernel == "fwd":
            # the width-256 forward on each column half: 64 rows a block, a
            # cluster of two blocks a query tile
            assert (plan.block, plan.threads, plan.grid, plan.cluster) == (
                64, 256, (WIDE["num_heads"], B, 2 * -(-S // 64)), 2)
            assert plan.smem_bytes == pa._fma_fwd_bytes(512)
        elif route == "fma":
            # the width-256 FMA kernels on each column half: 32 rows or keys
            # a block, a cluster of two blocks a tile
            heads = 1 if kernel == "dkv" else WIDE["num_heads"]
            assert (plan.block, plan.threads, plan.grid, plan.cluster) == (
                32, 256, (heads, B, 2 * -(-S // 32)), 2)
            assert plan.smem_bytes == pa._fma_bwd_bytes(kernel, 512)


def test_logits_match_jax():
    _, state, tokens = _jax_side()
    cfg = jt.TransformerConfig(**WIDE, dtype=jnp.float32)
    want = jt.TransformerLM(cfg).apply({"params": state["params"]}, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = _port_model()(torch.from_numpy(tokens))
    assert got.shape == (B, S, WIDE["vocab_size"]) and bool(torch.isfinite(got).all())
    _close(got.numpy(), np.asarray(want), "logits")


def test_train_step_loss_and_gradient_norm_match_jax():
    """One SGD step through each package's train step: the loss, the
    global gradient norm (the update over the rate) and every parameter."""
    bundle, state, tokens = _jax_side()
    before = kt.params_from_flax(jax.tree_util.tree_map(np.asarray, state["params"]))
    jstate, jm = bundle.step(state, jnp.asarray(tokens, jnp.int32))
    want = kt.params_from_flax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    model = _port_model()
    step = kt.make_lm_train_step(model, topt.sgd(LR), loss_dtype=torch.float32, chunk=CHUNK)
    _, m = step.step(step.init(), torch.from_numpy(tokens))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=REL)

    def norm(params):
        return float(np.sqrt(sum(((params[n].double() - before[n].double()) ** 2).sum().item()
                                 for n in before))) / LR

    got = dict(model.named_parameters())
    g_port, g_jax = norm({n: p.detach() for n, p in got.items()}), norm(want)
    assert g_jax > 0
    np.testing.assert_allclose(g_port, g_jax, rtol=REL)
    for name, p in got.items():
        _close(p.detach().numpy(), want[name].numpy(), name)
