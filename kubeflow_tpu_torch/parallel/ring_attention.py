"""Ring attention over the ``seq`` mesh axis; counterpart of ``kubeflow_tpu/parallel/ring_attention.py``.

Exact causal (or full) attention over sequences cut into n chunks, one a
rank of the mesh's ``seq`` group. K and V rotate around the ring, rank i
sending to rank i + 1, while each rank's queries run the flash kernels
(``ops/pallas_attention.py``) on the chunk it holds. At step r rank ``my``
holds chunk ``src = (my - r) % n`` (:func:`_schedule`):

- ``src < my``: every key is visible, the non-causal kernel;
- ``src == my``: the diagonal, the causal kernel;
- ``src > my``: every key is masked, no launch (o = 0, lse = +inf),

so the causal ring launches n(n+1)/2 forward kernels over its n ranks
where the non-causal one launches n². The chunks' partials (o, lse) merge
by streaming logsumexp (:func:`_merge`; an lse of +inf is an empty
partial). The ring is one ``torch.autograd.Function`` that saves only (q,
k, v, o, lse): O(S/n) a rank, never S×S. Its backward walks the ring again
and runs the dq and dk/dv kernels on each chunk with the merged o and the
*global* lse, so each chunk's probabilities are the global ones, asking for
fp32 gradients; fp32 dk/dv accumulators rotate with K and V through all n
steps, so each chunk's gradient arrives back at its owner.

The transport is ``torch.distributed.batch_isend_irecv`` to the next rank
of the group and from the previous one, every rank posting its sends and
then its receives in one batch, in the same order; the next step's K and V
are in flight while the current chunk computes. A group of one rank sends
nothing.

The JAX function takes the global arrays and cuts them with ``shard_map``;
here :func:`ring_attention` takes the rank's chunk, in the port's [B, S, H,
D] layout throughout, and :func:`ring_attention_rows` the whole rows that
every rank of the axis holds (the train steps' whole-row route): it cuts
the rank's chunk, runs the ring and all-gathers o, the reshard GSPMD puts
around the JAX ``shard_map``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops.pallas_attention import (
    _block_plan,
    _group_of,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)

FULL, DIAG = "full", "diag"


def _schedule(my: int, n: int, causal: bool) -> list:
    """[(src, kind)] for the ring steps r = 0 .. n-1 of rank ``my``: the
    chunk it holds, and the kernel that runs on it (FULL: non-causal, DIAG:
    causal, None: no launch)."""
    out = []
    for r in range(n):
        src = (my - r) % n
        out.append((src, FULL if not causal or src < my else DIAG if src == my else None))
    return out


def _merge(o, lse, o_r, lse_r):
    """Streaming-softmax merge of two normalized partials: o, o_r [B, S, H,
    D] fp32; lse, lse_r [B, H, S] fp32, +inf meaning empty (the kernels'
    value for a row that sees no key). Forward only: the ring's backward
    never differentiates through it."""
    inf = float("inf")
    a = torch.where(torch.isposinf(lse), -inf, lse)
    b = torch.where(torch.isposinf(lse_r), -inf, lse_r)
    lse_new = torch.logaddexp(a, b)
    w_a = torch.where(torch.isneginf(a), 0.0, torch.exp(a - lse_new)).transpose(1, 2)[..., None]
    w_b = torch.where(torch.isneginf(b), 0.0, torch.exp(b - lse_new)).transpose(1, 2)[..., None]
    return o * w_a + o_r * w_b, lse_new


def _chunk_fwd(q, k, v, causal: bool, block: int):
    """One chunk's flash forward: (o in fp32, cast after the kernel, whose
    o is in q's dtype; lse [B, H, S])."""
    o, lse = flash_attention(q, k, v, causal, block, block, return_lse=True)
    return o.float(), lse


def _chunk_bwd(q, k, v, o, lse, do, causal: bool):
    """One chunk's dq and (dk, dv) in fp32 against the merged ``o`` and the
    global ``lse``: the partials feed accumulators, so rounding them to the
    operand dtype would compound with the ring's size."""
    kw = dict(causal=causal, grad_dtype=torch.float32)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))


def _backward_lse(lse):
    """The kernels' lse for the backward: a row that sees no key at all
    (only possible non-causally with nothing to attend) as +inf, not -inf."""
    return torch.where(torch.isneginf(lse), float("inf"), lse)


class _Ring:
    """The rank's place in the ring: its index and size in ``group``, and
    the global ranks it sends to and receives from."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.my = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.my + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.my - 1) % self.n)

    def start(self, tensors):
        """Send ``tensors`` to the next rank and receive the previous rank's
        into new buffers: (buffers, requests)."""
        tensors = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, self.next, self.group) for t in tensors]
               + [dist.P2POp(dist.irecv, r, self.prev, self.group) for r in recv])
        return recv, dist.batch_isend_irecv(ops)

    @staticmethod
    def finish(pending):
        recv, requests = pending
        for req in requests:
            req.wait()
        return recv


def _ring_forward(q, k, v, ring: _Ring, causal: bool, block: int):
    """(o in q's dtype, lse [B, H, S] fp32) of this rank's queries over
    every chunk of the ring. Step 0 always runs (the rank's own chunk), and
    its partial is the merged state as it stands: merging it into the empty
    state (o 0, lse +inf), as the JAX scan does, gives it back exactly."""
    kv = [k, v]
    for r, (_, kind) in enumerate(_schedule(ring.my, ring.n, causal)):
        pending = ring.start(kv) if r < ring.n - 1 else None
        if kind is not None:
            part = _chunk_fwd(q, *kv, kind == DIAG, block)
            o, lse = part if r == 0 else _merge(o, lse, *part)
        if pending is not None:
            kv = ring.finish(pending)
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, o, lse, do, ring: _Ring, causal: bool):
    """(dq, dk, dv) of this rank's chunk, in its operands' dtypes. The
    accumulators start as step 0's partials (each rank's own chunk, which
    always runs): the JAX scan's zeros plus them, exactly."""
    lse = _backward_lse(lse)
    kv = [k, v]
    for r, (_, kind) in enumerate(_schedule(ring.my, ring.n, causal)):
        pending = ring.start(kv) if r < ring.n - 1 else None
        if r == 0:
            dq, *dkv = _chunk_bwd(q, *kv, o, lse, do, kind == DIAG)
        elif kind is not None:
            dq_r, dk_r, dv_r = _chunk_bwd(q, *kv, o, lse, do, kind == DIAG)
            dq += dq_r
            dkv[0] += dk_r
            dkv[1] += dv_r
        if ring.n > 1:                          # the accumulators follow their chunk
            dkv = ring.finish(ring.start(dkv))
        if pending is not None:
            kv = ring.finish(pending)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, block):
        ring = _Ring(group)
        o, lse = _ring_forward(q, k, v, ring, causal, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring, ctx.causal = ring, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, o, lse, do.contiguous(), ctx.ring, ctx.causal)
        return (*grads, None, None, None)


def ring_attention(q, k, v, mesh, *, axis_name: str = "seq", causal: bool = True,
                   block: int = 512):
    """Exact attention over a sequence cut into chunks over the mesh axis
    ``axis_name`` (a ``DeviceMesh`` from ``parallel/mesh.create_mesh``).

    q [B, S/n, H, D] and k, v [B, S/n, KV, D] are this rank's chunk: rank
    i of the axis's group holds positions i·S/n .. (i+1)·S/n - 1 (GQA as in
    ``flash_attention``: H a multiple of KV). Returns this rank's o [B, S/n,
    H, D]. The chunk length must divide into ``block`` (the flash kernels'
    tiling contract). Every rank of the group calls it together.
    """
    _group_of(q, k, v)
    S = q.shape[1]
    if k.shape[1] != S or v.shape[1] != S:
        raise ValueError(f"q, k and v must be chunks of one length, got {S}, {k.shape[1]}, "
                         f"{v.shape[1]}")
    _block_plan(S, S, block, block)
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                mesh.get_group(axis_name), causal, block)


class _SpanOf(torch.autograd.Function):
    """The rank's chunk of whole rows along dim 1. Every rank of the group
    holds the same rows and gets its own chunk's gradient, so the backward
    all-gathers the chunks' gradients: each rank's is then the whole rows'
    gradient, the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, my = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim=1)[my].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _rows_of(g, ctx.group), None


class _RowsOf(torch.autograd.Function):
    """Whole rows from each rank's chunk along dim 1 (an all-gather). The
    gradient that comes back is already the whole rows', the same on every
    rank, so the backward takes the rank's chunk of it: summing it over the
    group would count it once a rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rows_of(x, group)

    @staticmethod
    def backward(ctx, g):
        n, my = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=1)[my].contiguous(), None


def _rows_of(x, group):
    """[B, S/n, ...] chunks of the n ranks of ``group`` -> [B, S, ...], rank
    i's chunk at positions i·S/n .."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(n, *x.shape).transpose(0, 1).flatten(1, 2)


def ring_attention_rows(q, k, v, mesh, *, axis_name: str = "seq", causal: bool = True,
                        block: int = 512):
    """:func:`ring_attention` on whole rows that every rank of the axis
    holds: q [B, S, H, D], k, v [B, S, KV, D], the same on every rank. Each
    rank runs the ring on its chunk of S/n positions, and o [B, S, H, D] is
    all-gathered back, the same on every rank; so are the gradients of q, k
    and v. Every rank of the group calls it together."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"rows of {q.shape[1]} positions do not cut into {n} equal chunks")
    q, k, v = (_SpanOf.apply(t, group) for t in (q, k, v))
    return _RowsOf.apply(ring_attention(q, k, v, mesh, axis_name=axis_name, causal=causal,
                                        block=block), group)
