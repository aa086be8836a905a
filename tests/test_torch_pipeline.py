"""The port's pipeline (``parallel/pipeline.py``) on gloo CPU ranks, against
its sequential reference and the JAX pipeline (``kubeflow_tpu/parallel/pipeline.py``).

Weights: one flax ``init_pipeline_lm`` at 4 stages of one block
(``tests/test_pipeline.py``'s ``small_cfg``, fp32), carried across with
``interop.pipeline_params_from_flax``; layer l is the same weight at every
stage count (``_restack`` lays it out for 2 stages of two blocks), so every
plan computes the same model. The sequential reference applies those blocks
in order (``interop.pipeline_to_lm_state_dict`` on ``TransformerLM``'s
blocks), with the table of the lookup and the table of the tied head kept
apart, so that each part of the embedding's gradient is checked on its own.

One module fixture spawns a world of 4 ranks (stage=4; stage=2 x data=2) and
a world of 2 (stage=2); each rank runs the forward and ``pipeline_value_and_grad``
at 1, 2 and 4 microbatches and reports its logits, loss, gradients and the
embedding's parts before the stage sum; the 4-rank world also runs 5 steps of
``make_pipeline_train_step`` with the JAX package's ``adamw_lowmem`` settings
(fp32 moments) on stage=2 x data=2, and the microbatch refusal; the 2-rank
world a seeded fault, the embedding's head part left out of the stage sum.
Tolerances: the forward against both references atol 2e-4, rtol 1e-4
(``tests/test_pipeline.py``'s); gradients and losses against the sequential
reference atol 1e-5 (summation order only) and against JAX ``jax.grad`` rtol
2e-4 on every stage's and the embedding's gradient; the 5 training losses
rtol 2e-4 of the JAX step's on the same plan; the in-process walk (a
``MeshPlan``: every stage in one process, the same tick loop) against the
ranked run atol 1e-6."""
from __future__ import annotations

import functools
import multiprocessing as mp

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import pipeline as tpipe

SMALL = dict(vocab_size=64, num_layers=4, num_heads=4, embed_dim=64, mlp_dim=128,
             max_seq_len=16, attention_impl="xla")
BATCH, MICRO, TRAIN_STEPS, TRAIN_MICRO, LR = 8, (1, 2, 4), 5, 2, 1e-2
PLANS = {"stage4": (4, dict(stage=4)), "stage2_data2": (4, dict(stage=2, data=2)),
         "stage2": (2, dict(stage=2))}
TRAIN_PLAN = "stage2_data2"


def _cfg():
    return kt.TransformerConfig(**SMALL, dtype=torch.float32)


def _adamw():
    return kt.adamw_lowmem(LR, b2=0.999, weight_decay=1e-4, mu_dtype=None, nu_dtype=None)


def _restack(stages4, n_stages):
    """The flax stacked ``stages`` of 4 stages of one block, laid out for
    ``n_stages`` stages of 4 / n_stages blocks (layer l = block l % nb of
    stage l // nb)."""
    nb = 4 // n_stages

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return np.stack([tree[s * nb + i] for s in range(n_stages)])

    return {f"block_{i}": pick(stages4["block_0"], i) for i in range(nb)}


@functools.cache
def _inputs():
    """(flax params of 4 stages as numpy trees, tokens [8, 16])."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.transformer import TransformerConfig
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.pipeline import init_pipeline_lm

    cfg = TransformerConfig(**SMALL, dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(0, SMALL["vocab_size"], (BATCH, 16)).astype(np.int32)
    mesh = jmesh.create_mesh(jmesh.MeshPlan(stage=4), devices=jax.devices()[:4])
    params = init_pipeline_lm(cfg, mesh, jax.random.PRNGKey(0), jnp.asarray(tokens))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params)), tokens


def _flax(n_stages):
    params, _ = _inputs()
    return dict(params, stages=_restack(params["stages"], n_stages))


def _state_dict(n_stages):
    return kt.pipeline_params_from_flax(_flax(n_stages))


# ------------------------------------------------------------------ the ranks


def _run_plan(key, rank, sd, tokens):
    """One plan's reports on this rank (``sd``: the whole pipeline's weights
    at the plan's stage count)."""
    _, plan = PLANS[key]
    cfg, mesh = _cfg(), tmesh.create_mesh(tmesh.MeshPlan(**plan))
    tokens = torch.from_numpy(tokens).long()
    params = kt.PipelineLM(cfg, mesh, device="cpu")
    params.load_pipeline_state_dict(sd)
    parts = []
    stage_sum = tpipe._Layout.stage_sum

    def recording(self, t):
        parts.append(t.clone())
        return stage_sum(self, t)

    out = {"forward": {}, "grads": {}, "parts": {}, "loss": {}}
    for nm in MICRO:
        out["forward"][nm] = kt.pipeline_forward(cfg, mesh, params, tokens, num_microbatches=nm)
        parts.clear()
        tpipe._Layout.stage_sum = recording
        try:
            loss, grads = kt.pipeline_value_and_grad(cfg, mesh, params, tokens,
                                                     num_microbatches=nm)
        finally:
            tpipe._Layout.stage_sum = stage_sum
        out["loss"][nm], out["grads"][nm] = loss.item(), grads
        # the embedding's and final norm's parts on this rank, before the sum
        out["parts"][nm] = parts[:2] if plan["stage"] > 1 else []
    if key == TRAIN_PLAN:
        _, step = kt.make_pipeline_train_step(cfg, mesh, _adamw(), num_microbatches=TRAIN_MICRO)
        params.load_pipeline_state_dict(sd)
        opt_state = _adamw().init(list(params.parameters()))
        losses = []
        for _ in range(TRAIN_STEPS):
            params, opt_state, loss = step(params, opt_state, tokens)
            losses.append(loss.item())
        out["train"] = losses
        errors = []
        for nm in (8, 3):
            try:
                kt.pipeline_forward(cfg, mesh, params, tokens, num_microbatches=nm)
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = errors
    if key == "stage2":
        # the seeded fault: the embedding's gradient (the one 2-d sum) left
        # out of the stage sum
        tpipe._Layout.stage_sum = lambda self, t: t if t.dim() == 2 else stage_sum(self, t)
        try:
            params.load_pipeline_state_dict(sd)
            out["fault"] = kt.pipeline_value_and_grad(cfg, mesh, params, tokens,
                                                      num_microbatches=2)[1]
        finally:
            tpipe._Layout.stage_sum = stage_sum
    out["stages"] = params.layout.local
    return out


def _rank_main(rank, world, store, inputs, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save({k: _run_plan(k, rank, *args) for k, args in inputs.items()},
                   f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{plan key: [each rank's report]} from one spawn of each world."""
    tokens = _inputs()[1]
    ctx = mp.get_context("spawn")
    procs, dirs = [], {}
    for world in (4, 2):
        d = dirs[world] = tmp_path_factory.mktemp(f"world{world}")
        inputs = {k: (_state_dict(plan["stage"]), tokens) for k, (w, plan) in PLANS.items()
                  if w == world}
        procs += [ctx.Process(target=_rank_main, args=(r, world, str(d / "store"), inputs,
                                                       str(d)))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.exitcode, p.is_alive()) for p in procs]
    out = {}
    for world, d in dirs.items():
        reports = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
        for key in reports[0]:
            out[key] = [rep[key] for rep in reports]
    return out


# ------------------------------------------------------------------ references


@functools.cache
def _sequential():
    """The sequential reference: the blocks in order, the lookup's table and
    the head's apart. {"logits", "loss", "grads": TransformerLM names,
    "lookup", "head": the embedding's two parts} (the loss and gradients
    are the same at any microbatch count)."""
    cfg = _cfg()
    lm = kt.TransformerLM(cfg, device="cpu")
    lm.load_state_dict(kt.pipeline_to_lm_state_dict(_state_dict(4)))
    tokens = torch.from_numpy(_inputs()[1]).long()
    table_in = lm.embed.weight.detach().clone().requires_grad_()
    table_out = lm.embed.weight.detach().clone().requires_grad_()
    x = F.embedding(tokens, table_in)
    rope_cs = kt.models.transformer.rope_tables(torch.arange(16), cfg.head_dim, cfg.rope_theta)
    for layer in lm.layers:
        x = layer(x, rope_cs)
    logits = F.linear(lm.final_norm(x), table_out)
    loss = kt.lm_loss(logits, tokens)
    named = [(n, p) for n, p in lm.named_parameters() if n != "embed.weight"]
    grads = torch.autograd.grad(loss, [table_in, table_out] + [p for _, p in named])
    out = dict(zip([n for n, _ in named], grads[2:]))
    out["embed.weight"] = grads[0] + grads[1]
    return dict(logits=logits.detach(), loss=loss.item(), grads=out, lookup=grads[0],
                head=grads[1])


@functools.cache
def _jax_forward(nm):
    """JAX ``pipeline_forward`` at stage=4 x data=2 (``tests/test_pipeline.py``'s plan)."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.transformer import TransformerConfig
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.pipeline import pipeline_forward

    params, tokens = _inputs()
    mesh = jmesh.create_mesh(jmesh.MeshPlan(stage=4, data=2))
    cfg = TransformerConfig(**SMALL, dtype=jnp.float32)
    return np.asarray(pipeline_forward(cfg, mesh, params, jnp.asarray(tokens),
                                       num_microbatches=nm))


@functools.cache
def _jax_grads():
    """JAX ``jax.grad`` of ``lm_loss(pipeline_forward(...))`` at stage=4 x
    data=2 with 2 microbatches, as a port state dict of the whole pipeline
    at 4 stages."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.transformer import TransformerConfig, lm_loss
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.pipeline import pipeline_forward

    params, tokens = _inputs()
    mesh = jmesh.create_mesh(jmesh.MeshPlan(stage=4, data=2))
    cfg = TransformerConfig(**SMALL, dtype=jnp.float32)
    tok = jnp.asarray(tokens)
    grads = jax.grad(lambda p: lm_loss(pipeline_forward(cfg, mesh, p, tok, num_microbatches=2),
                                       tok))(params)
    return kt.pipeline_to_lm_state_dict(
        kt.pipeline_params_from_flax(jax.tree_util.tree_map(np.asarray, grads)))


@functools.cache
def _jax_train():
    """The JAX ``make_pipeline_train_step``'s 5 losses on the training plan."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.transformer import TransformerConfig
    from kubeflow_tpu.ops.optimizers import adamw_lowmem
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.pipeline import make_pipeline_train_step

    _, plan = PLANS[TRAIN_PLAN]
    _, tokens = _inputs()
    mesh = jmesh.create_mesh(jmesh.MeshPlan(**plan), devices=jax.devices()[:4])
    cfg = TransformerConfig(**SMALL, dtype=jnp.float32)
    tx = adamw_lowmem(LR, b2=0.999, weight_decay=1e-4, mu_dtype=None, nu_dtype=None)
    _, step = make_pipeline_train_step(cfg, mesh, tx, num_microbatches=TRAIN_MICRO)
    params = jax.tree_util.tree_map(jnp.asarray, _flax(plan["stage"]))
    opt_state = tx.init(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses


def _lm_names(grads, n_stages):
    """A rank's gradients under TransformerLM's names (its stages' blocks)."""
    nb = 4 // n_stages
    out = {}
    for k, v in grads.items():
        if k.startswith("stages."):
            _, s, _, i, rest = k.split(".", 4)
            k = f"layers.{int(s) * nb + int(i)}.{rest}"
        out[k] = v
    return out


# ------------------------------------------------------------------ checks


@pytest.mark.parametrize("nm", MICRO)
@pytest.mark.parametrize("key", PLANS)
def test_forward_matches_the_sequential_reference(ranks, key, nm):
    want = _sequential()["logits"].numpy()
    for rep in ranks[key]:
        np.testing.assert_allclose(rep["forward"][nm].numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("nm", MICRO)
@pytest.mark.parametrize("key", PLANS)
def test_forward_matches_the_jax_pipeline(ranks, key, nm):
    want = _jax_forward(nm)
    for rep in ranks[key]:
        np.testing.assert_allclose(rep["forward"][nm].numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("nm", MICRO)
@pytest.mark.parametrize("key", PLANS)
def test_gradients_match_the_sequential_reference(ranks, key, nm):
    """Every rank's loss and the gradients of the blocks it holds, the
    embedding (both parts summed) and the final norm."""
    ref = _sequential()
    n_stages = PLANS[key][1]["stage"]
    seen = set()
    for rep in ranks[key]:
        np.testing.assert_allclose(rep["loss"][nm], ref["loss"], rtol=1e-5)
        for n, g in _lm_names(rep["grads"][nm], n_stages).items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][n].numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)
            seen.add(n)
    assert seen == set(ref["grads"]), "a parameter got no gradient on any rank"


@pytest.mark.parametrize("key", ["stage4", "stage2"])
def test_the_embeddings_two_parts(ranks, key):
    """Before the stage sum, stage 0 holds the lookup's part of the tied
    embedding's gradient, the last stage the head's, and a stage between
    them none."""
    ref = _sequential()
    reps = ranks[key]
    for rep in reps:
        (stage,) = rep["stages"]
        embed = rep["parts"][2][0]
        want = (ref["lookup"] if stage == 0 else 0) + (ref["head"] if stage == len(reps) - 1 else 0)
        np.testing.assert_allclose(embed.numpy(), np.broadcast_to(want, embed.shape), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("key", PLANS)
def test_gradients_match_jax_grad(ranks, key):
    """Each stage's, the embedding's and the final norm's gradient at 2
    microbatches against JAX's ``jax.grad`` through its pipeline."""
    want = _jax_grads()
    n_stages = PLANS[key][1]["stage"]
    for rep in ranks[key]:
        for n, g in _lm_names(rep["grads"][2], n_stages).items():
            np.testing.assert_allclose(g.numpy(), want[n], rtol=2e-4, atol=2e-6, err_msg=n)


def test_training_matches_the_jax_step(ranks):
    """5 steps of ``make_pipeline_train_step`` (AdamW, fp32 moments) against
    the JAX step on the same plan: the same loss on every rank, falling."""
    want = _jax_train()
    reports = ranks[TRAIN_PLAN]
    for rep in reports:
        assert rep["train"] == reports[0]["train"]
        np.testing.assert_allclose(rep["train"], want, rtol=2e-4)
    assert want[-1] < want[0]


def test_a_microbatch_the_batch_ranks_cannot_split_is_refused(ranks):
    for rep in ranks[TRAIN_PLAN]:
        assert rep["errors"] == [
            "a microbatch of tokens [1, 16] (batch [8, 16] in 8) cannot be split over the 2 "
            "batch ranks (data x fsdp)",
            "batch 8 not divisible by 3 microbatches"]


def test_the_reference_refusals():
    cfg = _cfg()
    with pytest.raises(ValueError, match="not divisible by 3 pipeline stages"):
        kt.init_pipeline_lm(cfg, tmesh.MeshPlan(stage=3), device="cpu")
    params = kt.init_pipeline_lm(cfg, tmesh.MeshPlan(stage=2), device="cpu")
    with pytest.raises(ValueError, match="batch 8 not divisible by 3 microbatches"):
        kt.pipeline_forward(cfg, tmesh.MeshPlan(stage=2), params, torch.zeros((8, 16), dtype=torch.long),
                            num_microbatches=3)
    with pytest.raises(ValueError, match="runs every stage in this process"):
        kt.init_pipeline_lm(cfg, tmesh.MeshPlan(stage=2, data=2), device="cpu")


def test_the_head_part_left_out_of_the_stage_sum_is_caught(ranks):
    """The seeded fault: the embedding's gradient not summed over the stage
    group (stage 0 keeps the lookup's part alone, the last stage the
    head's) fails the check against the sequential reference."""
    ref = _sequential()["grads"]["embed.weight"].numpy()
    got = [rep["fault"]["embed.weight"].numpy() for rep in ranks["stage2"]]
    for g in got:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("key", ["stage4", "stage2"])
def test_the_in_process_walk_matches_the_ranks(ranks, key):
    """A ``MeshPlan`` of the same stages runs them all in this process
    through the same tick loop (how one card walks the pipeline): its
    logits, loss and gradients against the ranked run's."""
    n_stages = PLANS[key][1]["stage"]
    cfg, plan = _cfg(), tmesh.MeshPlan(stage=n_stages)
    params = kt.PipelineLM(cfg, plan, device="cpu")
    params.load_pipeline_state_dict(_state_dict(n_stages))
    tokens = torch.from_numpy(_inputs()[1]).long()
    for nm in MICRO:
        logits = kt.pipeline_forward(cfg, plan, params, tokens, num_microbatches=nm)
        loss, grads = kt.pipeline_value_and_grad(cfg, plan, params, tokens, num_microbatches=nm)
        for rep in ranks[key]:
            np.testing.assert_allclose(logits.numpy(), rep["forward"][nm].numpy(), atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(loss.item(), rep["loss"][nm], rtol=1e-6)
            for n, g in rep["grads"][nm].items():
                np.testing.assert_allclose(grads[n].numpy(), g.numpy(), atol=1e-6, rtol=0,
                                           err_msg=n)
