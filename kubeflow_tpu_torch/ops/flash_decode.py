"""Single-query (flash-decode) attention over the grouped KV cache.

Counterpart of ``kubeflow_tpu/ops/flash_decode.py``. The CUDA kernel
(``csrc/flash_decode.cuh``, launched from ``csrc/flash_decode.cu`` at head
widths 64, 128 and 256 and from ``csrc/flash_decode_512.cu`` at 512)
replaces the Pallas ``_decode_kernel``
(``kubeflow_tpu/ops/flash_decode.py:53``).

What bounds it on an H100: bytes. One decode step per layer reads the live
K/V slots of every (row, group) — ``2 * B * G * (pos + 1) * D`` bf16 values —
and does 4 FLOPs per value read, far below the ~295 FLOP/byte the card needs
before compute matters. At the flagship shape (B4 G4 R2 D128, pos ~190) that
is ~1.6 MB, under a microsecond of HBM time, so in practice the step is
bounded by latency: how many SMs load at once, and how many dependent round
trips each makes.

What the design does about it (the source's header has the details):

- each row's live range ``[lo, hi]`` (from ``pos[b]`` and the window) is
  cut across the blocks of its (row, group): the grid is (S, chunks of up
  to 8 query heads, B * G), S from :func:`_plan` so that the grid fills
  about two waves of the card's SMs, and the kernel gives block ``s`` the
  ``s``-th run of ``per`` keys, the range's length over S rounded up to 16
  (:func:`_row_splits`; the plan cannot read ``pos``, which lives on the
  card). Every position keeps every block busy, and dead slots are never
  read: the counterpart of the TPU kernel's scalar-prefetch clamp
  (``flash_decode.py:131-142``);
- a block issues all of its run's loads at once, then scores, folds and
  multiplies from shared memory; the heads of a chunk share each K/V row,
  so the cache is read once per group for R <= 8;
- each run keeps a streaming-softmax partial (m, l, o) in fp32 with its
  probabilities rounded to the operands' dtype against the run's own max
  (the TPU kernel rounds against its running max after each 256-key block:
  the same class of rounding); the partials of a (row, group, chunk) are
  combined in block order in the same launch (through distributed shared
  memory when its blocks form a cluster of at most 16, else by the last
  block to finish, through a workspace: the plan's ``cluster`` picks), so
  the result is the same on every run. Only the runs that hold a live key
  (the first ``n_live``, :func:`_live_runs`) write a partial and take part
  in the combine. On the workspace route a row of more than 32 live runs
  at width 512 is combined in two levels (:func:`_combine_groups`):
  the last block of each group of 16 runs folds them into one partial, and
  the last of those folds the groups' partials, so no block reads every
  partial of a long row alone. :func:`_split_reference` is that order in plain
  PyTorch, a witness for the tests and the chip smoke.

bf16 and fp32 operands (one dtype). The kernel is compiled for head widths 64,
128, 256 and 512 (at 256 a thread takes two output columns of the value
product, at 512 four, and the cluster combine loads a thread's (head,
column) pairs four at a time, 16 of them at 256 and 32 at 512 for 8 heads;
a block's 64 KB of K and V hold 32 bf16 or 16 fp32 keys at 512); any head size D up to 512
runs at D padded to the next width: the wrapper
zero-pads q (one row a head) and cuts o, and the kernel reads the cache at
its true D and zero-fills the columns past D in shared memory, so no step
copies the cache. D above 512 is a stated refusal
(:func:`_wide_head_refusal`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from kubeflow_tpu_torch.ops import _build, _workspace
from kubeflow_tpu_torch.ops.attention import NEG_INF
from kubeflow_tpu_torch.ops.pallas_attention import _wide_head_refusal as _flash_refusal

_KERNEL_D = (64, 128, 256, 512)  # head widths the kernel is compiled for
MAX_R = 8              # query heads a block holds (csrc/flash_decode.cuh)
THREADS = 128          # threads a block (csrc/flash_decode.cuh)
SPLIT_UNIT = 16        # a row's split is a multiple of this many keys
_WAVES = 2             # the grid should fill about this many waves of SMs
_KV_BYTES_MAX = 65536  # K and V of one block, staged whole: 3 blocks fit an SM
MAX_CLUSTER = 16       # a thread-block cluster's most blocks on Hopper (non-portable above 8)
COMBINE_GROUP = 16     # runs a first-level group of the workspace combine folds (GROUP)
FOLD_RUNS = 32         # live runs one block combines alone at width 512, at most (FOLD_RUNS)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the kernel launches: ``splits`` blocks a (row, group, chunk of up
    to 8 query heads), ``grid`` (splits, chunks, B * G); a block takes at
    most ``split`` keys (a multiple of 16; ``splits * split >= L``). With
    ``cluster`` (at most 16 splits) the splits of a (row, group, chunk) form
    a thread-block cluster and combine through distributed shared memory,
    else through a workspace in global memory and an atomic ticket.
    ``smem_bytes`` each block's dynamic shared memory: K and V rows of
    ``split`` keys (``kv_bytes``), the chunk's queries (``q_bytes``), the
    scores in fp32 (``score_bytes``) and the combine's weights in fp32
    (``weight_bytes``), all at ``width``, the head size padded to 64, 128,
    256 or 512."""

    split: int
    splits: int
    chunks: int
    grid: tuple[int, int, int]
    cluster: bool
    kv_bytes: int
    q_bytes: int
    score_bytes: int
    weight_bytes: int
    smem_bytes: int
    width: int


def _wide_head_refusal(D: int) -> str:
    return (f"flash_decode kernel takes head_dim up to {_KERNEL_D[-1]} (zero-padded to 64, 128, "
            f"256 or 512), got {D}: its cache is filled by a prefill through the flash kernels, "
            f"and they stop there. " + _flash_refusal(D))


def _kernel_width(D: int) -> int:
    """The head width the kernel runs at: D zero-padded to 64, 128, 256 or 512."""
    if not 1 <= D <= _KERNEL_D[-1]:
        raise ValueError(_wide_head_refusal(D))
    return next(w for w in _KERNEL_D if D <= w)


@functools.lru_cache(maxsize=256)
def _plan(B: int, G: int, R: int, L: int, D: int, dtype, sms: int) -> DecodePlan:
    """The kernel's grid and shared memory for a cache of ``L`` slots of
    head size ``D``, planned at its padded width (:func:`_kernel_width`).

    Enough blocks a (row, group, chunk) that the grid fills about two waves
    of ``sms`` SMs, each holding at most 64 KB of K and V (staged whole, so
    three blocks fit an SM; at width 256 that is 64 bf16 or 32 fp32 keys a
    block, at 512 32 or 16, so long caches take more blocks than two waves
    and combine through the workspace). The plan is made at the cache's full length;
    the kernel cuts each row's live range itself (:func:`_row_splits`),
    since the positions live on the card."""
    width = _kernel_width(D)
    elem = 4 if dtype == torch.float32 else 2
    chunks = -(-R // MAX_R)
    want = max(1, -(-_WAVES * sms // (B * G * chunks)))
    splits = min(want, -(-L // SPLIT_UNIT))
    split = -(-(-(-L // splits)) // SPLIT_UNIT) * SPLIT_UNIT
    cap = _KV_BYTES_MAX // (2 * width * elem) // SPLIT_UNIT * SPLIT_UNIT
    split = min(split, cap)
    splits = -(-L // split)
    kv, q_bytes, scores = 2 * split * width * elem, MAX_R * width * elem, MAX_R * split * 4
    weights = MAX_R * splits * 4
    return DecodePlan(split, splits, chunks, (splits, chunks, B * G), splits <= MAX_CLUSTER, kv,
                      q_bytes, scores, weights, kv + q_bytes + scores + weights, width)


def _row_splits(pos: int, L: int, window, splits: int):
    """The kernel's cut of one row's live range ``[lo, hi]``: block ``s``
    takes keys ``[lo + s * per, min(hi, lo + (s + 1) * per - 1)]``, ``per``
    the range's length over ``splits`` rounded up to 16. Returns (lo, hi,
    per); ``per`` is 0 when no key is live."""
    hi = min(pos, L - 1)
    lo = 0 if window is None else max(0, pos - window + 1)
    n = hi - lo + 1
    per = -(-(-(-n // splits)) // SPLIT_UNIT) * SPLIT_UNIT if n > 0 else 0
    return lo, hi, per


def _live_runs(lo: int, hi: int, per: int) -> int:
    """The kernel's ``n_live`` for a row cut as :func:`_row_splits` says:
    runs ``0 .. n_live - 1`` hold its live keys, at least one each, and the
    runs past them hold none, write no partial and take no part in the
    combine. 0 when no key is live."""
    return -(-(hi - lo + 1) // per) if per else 0


def _combine_groups(n_live: int, cluster: bool, width: int):
    """The workspace combine's first level: the runs ``0 .. n_live - 1`` cut
    into groups of :data:`COMBINE_GROUP` (each folded into one partial by
    its last block, then the groups' partials by the last of those), or
    ``None`` where one block combines the runs directly: on the cluster
    route, below width 512, and for at most :data:`FOLD_RUNS` runs."""
    if cluster or width != 512 or n_live <= FOLD_RUNS:
        return None
    return [range(g, min(g + COMBINE_GROUP, n_live)) for g in range(0, n_live, COMBINE_GROUP)]


def _check(q, k_cache, v_cache, block_k):
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    if tuple(k_cache.shape) != (B, G, L, D) or tuple(v_cache.shape) != (B, G, L, D):
        raise ValueError(
            f"cache must be [B={B}, G={G}, L, D={D}], got {tuple(k_cache.shape)}"
        )
    bk = min(block_k, L)
    if L % bk:
        raise ValueError(
            f"cache length {L} must be a multiple of block_k {bk}"
        )


def flash_decode_plain(q, k_cache, v_cache, pos, *, window=None, scale=None):
    """Plain PyTorch version of the kernel: same contract as ``flash_decode``
    (``scale`` defaults to ``D ** -0.5``; a padded head passes its true D's).

    Follows ``decode_attention_reference`` (``flash_decode.py:176-189``) with
    the kernel's own two guarantees made explicit: dead slots contribute
    nothing (not even a NaN that lies there), and a row with no live key
    (``pos < 0``) gives 0, as the TPU kernel's ``l_safe`` does.
    """
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    kpos = torch.arange(L, device=q.device)[None, :]
    pos = pos.to(device=q.device, dtype=torch.int64)
    live = kpos <= pos[:, None]                              # [B, L]
    if window is not None:
        live = live & (kpos > pos[:, None] - window)
    live4 = live[:, None, :, None]                           # [B, 1, L, 1]
    k = torch.where(live4, k_cache, 0).float()
    v = torch.where(live4, v_cache, 0)
    s = torch.einsum("bgrd,bgkd->bgrk", q.float(), k) * (D ** -0.5 if scale is None else scale)
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * live[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrk,bgkd->bgrd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, 1.0, l)
    return o.to(q.dtype)


def _split_reference(q, k_cache, v_cache, pos, window, plan):
    """The kernel's order of operations in plain PyTorch (a witness, never
    on the main path): each row's live range is cut into ``plan.splits``
    runs (:func:`_row_splits`), of which the first ``n_live``
    (:func:`_live_runs`) hold its keys; live run ``s`` folds its keys into
    (m_s, l_s, o_s) in fp32, its probabilities rounded to the operands'
    dtype against m_s; the combine takes the live runs in block order,
    rescales each by exp(m_s - m) and divides by the rescaled sum of l (0
    where no key is live). Where the plan's workspace combine cuts the runs
    into groups (:func:`_combine_groups`), each group is first folded so
    into (m_g, l_g, o_g), o_g unnormalized, and the groups' partials then
    combine the same way. Sums differ from the kernel's in order only."""
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    S = plan.splits
    out = torch.zeros_like(q)
    for b, p in enumerate(pos.tolist()):
        lo, hi, per = _row_splits(p, L, window, S)
        if per == 0:
            continue
        n_live = _live_runs(lo, hi, per)
        idx = lo + torch.arange(n_live * per, device=q.device)
        live = idx <= hi                                       # [n_live * per]
        idx = idx.clamp(max=hi)
        k = torch.where(live[:, None], k_cache[b][:, idx], 0).float()   # [G, n_live * per, D]
        v = torch.where(live[:, None], v_cache[b][:, idx], 0)
        s = torch.einsum("grd,gkd->grk", q[b].float(), k) * (D ** -0.5)
        live_s = live.view(n_live, per)
        s = s.view(G, R, n_live, per).masked_fill(~live_s, NEG_INF)
        m_s = s.amax(dim=-1, keepdim=True)                     # [G, R, n_live, 1]
        pr = torch.exp(s - m_s) * live_s
        l_s = pr.sum(dim=-1)                                   # [G, R, n_live]
        o_s = torch.einsum("grsk,gskd->grsd", pr.to(v.dtype).float(),
                           v.float().view(G, n_live, per, D))
        m_s = m_s.squeeze(-1)
        groups = _combine_groups(n_live, plan.cluster, plan.width)
        if groups is not None:
            folded = [_fold(m_s[..., g.start:g.stop], l_s[..., g.start:g.stop],
                            o_s[..., g.start:g.stop, :]) for g in groups]
            m_s, l_s, o_s = (torch.stack(t, dim=d) for t, d in zip(zip(*folded), (-1, -1, -2)))
        m, l, o = _fold(m_s, l_s, o_s)
        out[b] = (o / l[..., None]).to(q.dtype)
    return out


def _fold(m_s, l_s, o_s):
    """Partials (m_s, l_s, o_s) [..., n], [..., n], [..., n, D] folded into
    one, as the kernel's combine does: m the largest m_s of a partial with
    l_s > 0, the weights exp(m_s - m) (0 where l_s is 0), l and o their
    weighted sums (o unnormalized)."""
    m = torch.where(l_s > 0, m_s, -torch.inf).amax(dim=-1)
    w = torch.where(l_s > 0, torch.exp(m_s - m[..., None]), 0.0)
    return m, (w * l_s).sum(dim=-1), (w[..., None] * o_s).sum(dim=-2)


def flash_decode(q, k_cache, v_cache, pos, *, window=None, block_k: int = 256):
    """Attend one query token per row against the grouped KV cache.

    Args:
      q: ``[B, G, R, D]`` — this step's queries, grouped (R = H // G).
      k_cache, v_cache: ``[B, G, L, D]`` — the rolling cache, all slots.
      pos: ``[B]`` int — the current token's position; cache slots
        ``0..pos`` are live (slot ``pos`` holds this step's own k/v).
      window: optional sliding-window size (keys ``(pos-window, pos]``).
      block_k: the cache must tile into blocks of this many slots, as for
        the TPU kernel; the CUDA kernel splits the cache by its own plan.
    Returns:
      ``[B, G, R, D]`` context in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    _check(q, k_cache, v_cache, block_k)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos, window=window)
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    operands = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache))
    for name, t in operands:
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"flash_decode kernel takes bf16 or fp32 operands of one dtype; "
                            f"{name} is {t.dtype}, q {q.dtype}")
    _kernel_width(D)
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    for name, t in operands:
        if t.device.type != "cuda":
            raise TypeError(f"flash_decode kernel takes CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel needs {name} contiguous and 16-byte aligned")
    if pos.device != q.device or pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be an int32 [B={B}] tensor on {q.device}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return _launch(q, k_cache, v_cache, pos, window, _plan(B, G, R, L, D, q.dtype, sms))


def _launch(q, k_cache, v_cache, pos, window, plan):
    """One launch of the kernel on checked operands, as ``plan`` says (its
    ``cluster`` picks the combine; the chip smoke times both at one shape).
    q is padded to the plan's width and o cut back to D; the cache is read
    as it is."""
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    W = plan.width
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_part = B * G * R * plan.splits
    # a ticket a (row, group, chunk), and one a group of runs of its combine
    n_tickets = B * G * plan.chunks * (1 + -(-plan.splits // COMBINE_GROUP))
    ws, tickets = _workspace.workspace(q.device, stream, n_part * (W + 2), n_tickets)
    qp = q if W == D else torch.nn.functional.pad(q, (0, W - D))
    out = torch.empty_like(qp)
    _build.launch(
        "flash_decode_512" if W == 512 else "flash_decode",   # two sources, built in parallel
        qp.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * n_part * W, tickets.data_ptr(),
        B, G, R, L, W, D, window or 0, D ** -0.5, int(q.dtype == torch.float32), plan.splits,
        plan.split, int(plan.cluster), plan.smem_bytes, stream,
    )
    flash_decode.launches += 1
    return out if W == D else out[..., :D].contiguous()


flash_decode.launches = 0
