"""Autoregressive decoding with a KV cache; counterpart of ``kubeflow_tpu/models/decoding.py``.

- prefill: one forward over the whole prompt fills every layer's KV cache
  (with ``attention_impl='flash'`` through the flash-attention kernel);
- decode: single-token steps, the cache updated in place; with 'flash' each
  step runs the flash-decode kernel, which reads only the live cache slots;
- sampling: greedy (temperature 0), temperature, and top-k inside the k
  candidates, drawn from an explicit ``torch.Generator``;
- early exit: generation stops when every row has emitted ``eos_id`` (the
  emitted suffix stays padded with eos).

The JAX package's compiled ``while_loop``/``fori_loop`` become Python loops
that launch eagerly. Every entry point runs under ``torch.inference_mode``
on the model's device.
"""
from __future__ import annotations

import dataclasses

import torch

from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM


def decode_config(cfg: TransformerConfig) -> TransformerConfig:
    """The decoding twin of a training config (same params, cache on).

    'flash' survives into decode — single-token steps then use the
    flash-decode kernel. Every other impl falls back to the cache-masked
    einsum path ('xla')."""
    impl = "flash" if cfg.attention_impl == "flash" else "xla"
    return dataclasses.replace(cfg, decode=True, remat=False, attention_impl=impl)


def _sample(logits, temperature: float, top_k: int | None, generator: torch.Generator):
    """logits [B, V] f32 -> token ids [B] int32.

    With top-k, sampling happens INSIDE the candidate set: a Gumbel-max draw
    over the k kept logits, then an index gather — the same distribution as
    masking the vocab and sampling [B, V], for B*k random numbers instead of
    B*V."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if top_k is not None:
        vals, idx = torch.topk(logits, top_k, dim=-1)            # [B, k] each
        choice = _categorical(vals / temperature, generator)
        return idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)
    return _categorical(logits / temperature, generator).to(torch.int32)


def _categorical(logits, generator):
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _generator(model: TransformerLM, generator):
    if generator is None:
        generator = torch.Generator(device=model.device)
        generator.manual_seed(0)
    return generator


@torch.inference_mode()
def prefill(model: TransformerLM, prompt: torch.Tensor):
    """Fill a fresh KV cache from a prompt [B, P]; returns (cache, last_logits).

    ``last_logits`` [B, V] are fp32. Only the last position goes through the
    tied head (the JAX package computes the head for every position and
    slices; the rows kept are the same)."""
    prompt = prompt.to(model.device)
    cache = model.init_cache(prompt.shape[0])
    hidden = model(prompt, start=0, cache=cache, return_hidden=True)
    return cache, model.head(hidden[:, -1]).float()


@torch.inference_mode()
def decode_steps(
    model: TransformerLM,
    cache,
    first_token: torch.Tensor,
    start_pos: int,
    *,
    n: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    generator: torch.Generator | None = None,
):
    """Run exactly ``n`` single-token decode steps from ``start_pos``.

    ``first_token`` [B] is the token at position ``start_pos`` (e.g. sampled
    from prefill's last_logits). Returns (tokens [B, n], cache); the cache is
    the one passed in, updated in place."""
    generator = _generator(model, generator)
    cur = first_token.to(model.device, torch.int64)
    tokens = torch.zeros((cur.shape[0], n), dtype=torch.int32, device=model.device)
    for i in range(n):
        logits = model(cur[:, None], start=start_pos + i, cache=cache)
        nxt = _sample(logits[:, -1].float(), temperature, top_k, generator)
        tokens[:, i] = nxt
        cur = nxt.long()
    return tokens, cache


@torch.inference_mode()
def generate(
    model: TransformerLM,
    prompt: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    eos_id: int | None = None,
    generator: torch.Generator | None = None,
):
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, P].

    ``model`` must be built with ``decode_config(cfg)``. Returns
    [B, P + max_new_tokens] tokens in the prompt's dtype on the model's
    device."""
    cfg = model.cfg
    B, P = prompt.shape
    if P + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {P} + new {max_new_tokens} exceeds the cache "
            f"(max_seq_len={cfg.max_seq_len})"
        )
    generator = _generator(model, generator)
    prompt = prompt.to(model.device)

    cache, last_logits = prefill(model, prompt)
    next_tok = _sample(last_logits, temperature, top_k, generator)

    # pad with eos (not 0 — a real token id) so rows that finish early
    # carry an eos suffix
    pad_id = eos_id if eos_id is not None else 0
    tokens = torch.cat(
        [prompt, torch.full((B, max_new_tokens), pad_id, dtype=prompt.dtype, device=prompt.device)],
        dim=1,
    )
    tokens[:, P] = next_tok.to(prompt.dtype)
    done = next_tok == eos_id if eos_id is not None else None

    for step in range(max_new_tokens - 1):
        # the early exit reads `done` on the host: one sync per step, only
        # when an eos id can end rows
        if done is not None and bool(done.all()):
            break
        pos = P + step
        logits = model(tokens[:, pos:pos + 1], start=pos, cache=cache)
        nxt = _sample(logits[:, -1].float(), temperature, top_k, generator)
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tokens[:, pos + 1] = nxt.to(tokens.dtype)
    return tokens
