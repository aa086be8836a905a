"""Flash attention for the PyTorch port: forward and backward.

Counterpart of ``kubeflow_tpu/ops/pallas_attention.py``. Three CUDA kernels
replace the three Pallas kernels of that module:

- ``csrc/flash_attention_fwd.cu`` replaces ``_fwd_kernel`` (``:160``);
- ``csrc/flash_attention_bwd_dq.cu`` replaces ``_dq_kernel`` (``:290``);
- ``csrc/flash_attention_bwd_dkv.cu`` replaces ``_dkv_kernel`` (``:336``).

What bounds them on an H100: at the serving path's prefill shape (B4 H8 KV4
S128 D128, causal) the forward moves ~3 MB and does ~0.14 GFLOP, so HBM bytes
and launch latency bound it; at the training shape (B4 H8 S2048 D128, causal)
all three are bound by FLOPs (forward 2, dq 3, dk/dv 4 causal matmuls of
1.7e10 FLOP each, against ~84 MB of bf16 operands).

Two routes, chosen by :func:`_plan` from the operands' dtype:

- **bf16: tensor cores.** A producer (a warpgroup for the forward and dq,
  thread 0 for dk/dv) keeps tiles in flight by TMA into a 2-stage
  shared-memory ring; one or two consumer warpgroups (64 rows each)
  multiply with ``wgmma`` (bf16 operands, fp32 accumulators) and
  keep P (forward), dS (dq) or P^T and dS^T (dk/dv) in registers as the next
  product's operand. The forward and dq hold a query tile and stream K/V
  tiles of 64 keys; ``_plan`` takes 128-row query tiles where they still
  give every SM a block, else 64. dk/dv holds 64 or 128 keys (by the same
  rule) and streams the Q, dO and O tiles of 64 query rows that can see
  them, over every query head of the GQA group.
- **fp32, and both types at head width 256: scalar kernels.** Tiles staged
  as fp32 in shared memory (bf16 converted as it is staged) and fp32 FMAs,
  256 threads; 64-row tiles where they fit the block's shared memory, else
  32 (dq and dk/dv at width 256). The TPU kernels' rounding points are kept
  in the operands' type (the identity in fp32).

The kernels are compiled for head widths 64, 128 and 256: the tensor-core
route for 64 and 128 (at 256 its accumulators would not fit beside a
producer warpgroup, :func:`_wgmma_sums`), the scalar route for all three.
Any head size D up to 256 runs on them: :func:`_pad_heads` zero-pads the head
axis to the next width and launches with the true ``D ** -0.5`` as the
softmax scale, so the scores, the softmax and delta = rowsum(dO·O) are the
unpadded ones, and cuts the padded columns off o, dq, dk and dv (products
with zero columns). At D 64, 128 and 256 nothing is copied. D above 256 is a
stated refusal: the message gives the shared memory the scalar kernels
would need at the next width against the card's limit.

What every kernel does:

- one thread block per query tile (key tile for dk/dv), head and batch row;
  a loop inside the block over the other side's tiles takes the place of the
  TPU kernels' sequential grid axis, and the accumulators stay in fp32
  registers across it;
- causal and sliding-window tile skipping: a tile that no row of the block
  can see is never loaded;
- GQA: query head ``h`` reads kv head ``h // group``; grouped K/V are never
  expanded. The dk/dv kernel owns one kv head and loops over its group's
  query heads, so it sums the group in fp32 inside the block: no per-head
  partials, no atomics, a deterministic result;
- the TPU kernels' rounding points: probabilities rounded to the operands'
  dtype before the value products, ``ds`` before the key and query products.

Autograd: :func:`flash_attention` always calls the custom op
``kubeflow_tpu_torch::flash_attention_fwd`` (the forward kernel with lse), so
that selective checkpointing can see it and keep its outputs (the ``flash``
remat policy). The op's registered backward launches the dq and dk/dv
kernels.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF

_KERNEL_D = (64, 128, 256)   # head widths the kernels are compiled for
_WGMMA_D = (64, 128)         # the widths of the bf16 tensor-core route


def _group_of(q, k, v):
    """GQA group size from [B, S, H, D] operands; validates head divisibility."""
    H, KV = q.shape[2], k.shape[2]
    if v.shape[2] != KV:
        raise ValueError(
            f"k and v must carry the same head count, got {KV} vs {v.shape[2]}"
        )
    if H % KV:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {KV}")
    return H // KV


def _block_plan(Sq, Sk, block_q, block_k):
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq lengths ({Sq},{Sk}) must divide blocks ({bq},{bk})")
    return bq, bk


def _keep_mask(Sq, Sk, causal, window, device):
    """[Sq, Sk] bool: key k is visible to query q (positions from 0 on both)."""
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


_SMS = 132                  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448        # bytes of shared memory a block may take on Hopper
_REGS_BESIDE_PRODUCER = 168  # registers a thread keeps beside a producer warpgroup (CUDA 12.8 ptxas)
_REGS_MAX = 255             # registers a thread may hold
_TILE_K = 64                # keys a tile on both routes
_STAGES = 2                 # ring tiles in flight on the tensor-core route
_QROWS = 64                 # query rows of a dk/dv ring tile
_SCALAR_TILES = (64, 32)    # the scalar kernels' tile rows (and keys), largest that fits first


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one flash kernel launches. ``route`` "wgmma" is the bf16
    tensor-core kernel, "scalar" the fp32-FMA kernel; ``block`` is the query
    rows a block (forward, dq) or the keys a block (dk/dv); ``width`` the
    head width the kernel runs at (the head size zero-padded to 64, 128 or
    256)."""

    route: str
    block: int
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int
    width: int


def _wgmma_sums(kernel: str, block: int, width: int) -> tuple[int, int]:
    """(shared-memory bytes, fp32 accumulator registers of a consumer
    thread) of the bf16 tensor-core ``kernel`` with ``block`` query rows
    (forward, dq) or keys (dk/dv) at head width ``width``.

    Shared memory: 1024 bytes of alignment slack and the mbarriers; the
    forward and dq hold the Q (and dO) tile, ``_STAGES`` K and V tiles of 64
    keys and dq's delta row; dk/dv holds its K and V, ``_STAGES`` Q, dO and O
    tiles of 64 rows and each consumer warpgroup's two delta/lse rows. The
    launchers check the same sums. Registers: a consumer warpgroup's 64 rows
    of fp32 accumulators over its 128 threads: O and S (forward), dQ, S and
    dP (dq), dK, dV, S^T and dP^T (dk/dv)."""
    bars = 8 * (1 + 2 * _STAGES)
    slabs = width // 64                     # 64-column bf16 slabs of a row
    if kernel in ("fwd", "dq"):
        tiles = (1 if kernel == "fwd" else 2) * slabs * 64 * 2 * block
        kv = 2 * _STAGES * slabs * _TILE_K * 128
        delta = 4 * block if kernel == "dq" else 0
        return 1024 + tiles + kv + delta + bars, width // 2 + (32 if kernel == "fwd" else 64)
    kv = 2 * slabs * block * 128                   # resident K and V
    ring = 3 * _STAGES * slabs * _QROWS * 128      # Q, dO, O tiles
    rows = (block // 64) * 2 * 2 * _QROWS * 4      # [2][delta | lse] a consumer
    return 1024 + kv + ring + rows + bars, width + 64


def _scalar_floats(kernel: str, width: int, tile: int) -> int:
    """fp32 words of shared memory of the scalar ``kernel`` at head width
    ``width`` with ``tile``-row tiles (and ``tile`` keys a tile): transposed
    tiles of leading dimension ``tile + 4``; the launchers check the same
    sums (``smem_floats`` in each source)."""
    ld = tile + 4
    return {"fwd": 2 * width * ld + tile * width + tile * ld,
            "dq": 4 * width * ld + tile * width + tile * ld,
            "dkv": 4 * width * ld + 2 * tile * width + tile * ld + 2 * tile}[kernel]


def _wide_head_refusal(D: int) -> str:
    width = -(-D // 64) * 64
    tile = _SCALAR_TILES[-1]
    need = "; ".join(f"{name} {4 * _scalar_floats(k, width, tile):,}" for k, name in
                     (("fwd", "forward"), ("dq", "dq"), ("dkv", "dk/dv")))
    return (f"flash kernels take head_dim up to {_KERNEL_D[-1]} (zero-padded to 64, 128 or "
            f"256), got {D}. At width {width} the scalar kernels would need, at their "
            f"smallest tiles ({tile} rows), shared memory bytes a block of: {need}; the card "
            f"gives a block {SMEM_LIMIT:,} bytes, and a train step needs all three")


def _kernel_width(D: int) -> int:
    """The head width the kernels run at: D zero-padded to 64, 128 or 256."""
    if not 1 <= D <= _KERNEL_D[-1]:
        raise ValueError(_wide_head_refusal(D))
    return next(w for w in _KERNEL_D if D <= w)


def _plan(kernel: str, B: int, Sq: int, Sk: int, H: int, KV: int, D: int, dtype,
          sms: int = _SMS) -> Plan:
    """The launch of ``kernel`` ("fwd", "dq" or "dkv") for these shapes, at
    head size ``D`` (planned at its padded ``width``, :func:`_kernel_width`).

    bf16 takes the tensor-core route: ``block // 64`` consumer warpgroups,
    with a producer warpgroup beside them for the forward and dq (for dk/dv
    thread 0 produces). The forward and dq: a grid of (H, B, query tiles),
    128-row tiles where ``B * H * ceil(Sq / 128)`` blocks still fill
    ``sms`` SMs (the training shape: 512 blocks), else 64-row tiles (the
    serving prefill B4 H8 S128: 64 blocks where 128 rows would give 32).
    dk/dv: a grid of (KV, B, key blocks), 128 keys a block where ``B * KV *
    ceil(Sk / 128)`` blocks fill the SMs, else 64. Shared memory as
    :func:`_wgmma_sums` counts it. fp32, and bf16 at width 256, take the
    scalar route: 256 threads, the largest tile of ``_SCALAR_TILES`` whose
    shared memory (:func:`_scalar_floats`) fits a block.
    """
    width = _kernel_width(D)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernels take bf16 or fp32 operands, got {dtype}")
    if dtype == torch.bfloat16 and width in _WGMMA_D and kernel in ("fwd", "dq"):
        rows = 128 if B * H * -(-Sq // 128) >= sms else 64
        smem, _ = _wgmma_sums(kernel, rows, width)
        return Plan("wgmma", rows, (H, B, -(-Sq // rows)), 128 * (rows // 64 + 1), smem, width)
    if dtype == torch.bfloat16 and width in _WGMMA_D:
        keys = 128 if B * KV * -(-Sk // 128) >= sms else 64
        smem, _ = _wgmma_sums(kernel, keys, width)
        return Plan("wgmma", keys, (KV, B, -(-Sk // keys)), 128 * (keys // 64), smem, width)
    t = next(t for t in _SCALAR_TILES if 4 * _scalar_floats(kernel, width, t) <= SMEM_LIMIT)
    grid = (-(-Sk // t), KV, B) if kernel == "dkv" else (-(-Sq // t), H, B)
    return Plan("scalar", t, grid, 256, 4 * _scalar_floats(kernel, width, t), width)


def _pad_heads(inner, heads, width: int):
    """``inner(*heads, scale=D ** -0.5)`` with every tensor of ``heads``
    zero-padded on its last axis from the head size D to ``width``; of the
    tuple ``inner`` returns, the 4-D tensors (o, dq, dk, dv: head axis last)
    come back cut to D and the rest (lse) as they are.

    A zero column adds nothing to a score q·k or to delta = rowsum(dO·O),
    and the padded columns of o, dq, dk and dv are products with zero
    columns, so with the true D's scale the cut outputs are the unpadded
    ones. At D == width nothing is copied. ``inner`` is the kernel launch on
    the card and the plain version in the CPU tests."""
    D = heads[0].shape[-1]
    if D == width:
        return inner(*heads, scale=D ** -0.5)
    out = inner(*(F.pad(t, (0, width - D)) for t in heads), scale=D ** -0.5)
    return tuple(t[..., :D].contiguous() if t.dim() == 4 else t for t in out)


def _query_tiles(k0: int, keys: int, Sq: int, Sk: int, causal: bool,
                 window: int | None) -> tuple[int, int]:
    """(first, count) of the ``_QROWS``-row query tiles that can see keys
    ``k0 .. k0 + keys - 1``: the dk/dv kernel's walk (``query_tiles`` in
    ``csrc/flash_common.cuh``, mirrored here for the CPU tests). Causal
    starts at the diagonal; the window ends ``window - 1`` rows after the
    last key."""
    k_last = min(k0 + keys - 1, Sk - 1)
    q_lo = k0 if causal else 0
    q_hi = min(Sq - 1, k_last + window - 1) if causal and window else Sq - 1
    first = q_lo // _QROWS
    return first, (q_hi // _QROWS - first + 1 if q_hi >= q_lo else 0)


@functools.cache
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_kernel_inputs(what, **tensors):
    """The CUDA kernels take contiguous CUDA operands of one dtype, bf16 or
    fp32, 16-byte aligned (the tensor maps' rule); :func:`_plan` checks D."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{what} kernel takes bf16 or fp32 CUDA tensors; {name} is {t.dtype} on {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what} kernel takes operands of one dtype; {name} is {t.dtype}, not {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs {name} contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs {name} 16-byte aligned")


def _acc(t):
    """The plain versions' working type: fp32, or fp64 for fp64 inputs
    (``torch.autograd.gradcheck``)."""
    return t if t.dtype == torch.float64 else t.float()


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """Plain PyTorch version of the kernel: (o [B,Sq,H,D], lse [B,H,Sq] f32).

    ``scale`` defaults to ``D ** -0.5`` (a padded head passes its true D's).
    Scores and softmax in fp32; unnormalized probabilities are cast to v's
    dtype before the value product and divided by the fp32 row sum after it,
    as the TPU kernel does. A row that sees no key gives output 0 and lse
    +inf (the TPU kernel's ``l_safe`` rule, ``pallas_attention.py:200-204``).
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    # fold query heads into [KV, group] so grouped K/V are read as they are
    qg = _acc(q).reshape(B, Sq, KV, group, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, _acc(k)) * (D ** -0.5 if scale is None else scale)
    keep = _keep_mask(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgd->bqgrd", _acc(p.to(v.dtype)), _acc(v))
    l_q = l.squeeze(-1).permute(0, 3, 1, 2)[..., None]     # [B, Sq, KV, group, 1]
    o = (o / torch.where(l_q == 0, 1.0, l_q)).reshape(B, Sq, H, D)
    lse = torch.where(l == 0, torch.inf, m + torch.log(torch.where(l == 0, 1.0, l)))
    return o.to(q.dtype), lse.reshape(B, H, Sq)


def _forward(q, k, v, causal, window):
    """(o, lse) from the plain version on the CPU or the kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_kernel_inputs("flash_attention", q=q, k=k, v=v)
    return _pad_heads(functools.partial(_launch_forward, causal=causal, window=window),
                      (q, k, v), _kernel_width(q.shape[-1]))


def _launch_forward(q, k, v, *, scale, causal, window):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    plan = _plan("fwd", B, Sq, Sk, H, KV, D, q.dtype, _sms_of(q.device.index))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _build.launch(
        "flash_attention_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, KV, D, int(causal), window or 0, scale,
        int(q.dtype == torch.float32), plan.block, plan.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention.launches += 1
    return o, lse


def flash_attention_backward_plain(q, k, v, o, lse, do, *, causal=True, window=None,
                                   grad_dtype=None, scale=None):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv).
    ``scale`` defaults to ``D ** -0.5``, as in the forward.

    An explicit formula with the TPU kernels' rounding points, not autograd
    through the forward:

    - ``delta = rowsum(do * o)`` in fp32 from the stored dtypes (``:300-304``);
    - ``p = exp(s - lse)`` in fp32; a masked score or an lse of +inf gives 0;
    - ``p`` rounded to do's dtype before ``p^T do`` (``:363-365``);
    - ``ds = p * (dp - delta) * scale`` rounded to the operand dtype before
      ``ds k`` (``:325-327``) and ``ds^T q`` (``:370-372``);
    - fp32 accumulation; under GQA dk and dv sum the group in fp32
      (``:454-456``);
    - outputs in ``grad_dtype`` or else each input's dtype.

    Layouts as the forward: q, o, do [B, Sq, H, D]; k, v [B, Sk, KV, D];
    lse [B, H, Sq] fp32.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = D ** -0.5 if scale is None else scale
    qg = _acc(q).reshape(B, Sq, KV, group, D)
    dog = _acc(do).reshape(B, Sq, KV, group, D)
    delta = (_acc(do) * _acc(o)).sum(-1)                   # [B, Sq, H]
    delta = delta.permute(0, 2, 1).reshape(B, KV, group, Sq, 1)
    lse = lse.reshape(B, KV, group, Sq, 1)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, _acc(k)) * scale
    keep = _keep_mask(Sq, Sk, causal, window, q.device)
    p = torch.where(keep, torch.exp(s - lse), 0.0)             # [B, KV, group, Sq, Sk]
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, _acc(v))
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", _acc(ds.to(k.dtype)), _acc(k))
    dv = torch.einsum("bgrqk,bqgrd->bkgd", _acc(p.to(do.dtype)), dog)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", _acc(ds.to(q.dtype)), qg)
    return (dq.reshape(B, Sq, H, D).to(grad_dtype or q.dtype),
            dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype))


def _check_backward(q, k, v, o, lse, do, causal, window, grad_dtype):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _group_of(q, k, v)
    if tuple(k.shape) != (B, Sk, KV, D) or tuple(v.shape) != (B, Sk, KV, D):
        raise ValueError(f"k and v must be [B={B}, Sk, KV, D={D}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be shaped like q {tuple(q.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse must be [B={B}, H={H}, Sq={Sq}], got {tuple(lse.shape)}")
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    if grad_dtype not in (None, torch.float32, q.dtype):
        raise ValueError(f"grad_dtype must be None, fp32 or {q.dtype}, got {grad_dtype}")


def _check_backward_inputs(name, q, k, v, o, lse, do):
    _check_kernel_inputs(name, q=q, k=k, v=v, o=o, do=do)
    if lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name} kernel needs lse fp32 and contiguous on {q.device}")
    return _kernel_width(q.shape[-1])


def _launch_backward(name, q, k, v, o, do, *, lse, scale, causal, window, grad_dtype):
    """One backward kernel on (padded) operands: (dq,) or (dk, dv)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kernel = "dq" if name == "flash_attention_bwd_dq" else "dkv"
    plan = _plan(kernel, B, Sq, Sk, H, KV, D, q.dtype, _sms_of(q.device.index))
    outs = ((torch.empty(q.shape, dtype=grad_dtype or q.dtype, device=q.device),)
            if kernel == "dq" else
            tuple(torch.empty(t.shape, dtype=grad_dtype or t.dtype, device=t.device)
                  for t in (k, v)))
    _build.launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), *(t.data_ptr() for t in outs),
        B, Sq, Sk, H, KV, D, int(causal), window or 0, scale,
        int(outs[0].dtype == torch.float32), int(q.dtype == torch.float32),
        plan.block, plan.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if kernel == "dq":
        flash_attention_bwd_dq.launches += 1
    else:
        flash_attention_bwd_dkv.launches += 1
    return outs


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal=True, window=None,
                           grad_dtype=None):
    """dq [B, Sq, H, D] in ``grad_dtype`` (default q's dtype).

    CPU tensors take the plain version; CUDA tensors launch the dq kernel
    or raise."""
    _check_backward(q, k, v, o, lse, do, causal, window, grad_dtype)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, window=window, grad_dtype=grad_dtype)[0]
    name = "flash_attention_bwd_dq"
    width = _check_backward_inputs(name, q, k, v, o, lse, do)
    (dq,) = _pad_heads(functools.partial(_launch_backward, name, lse=lse, causal=causal,
                                         window=window, grad_dtype=grad_dtype),
                       (q, k, v, o, do), width)
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, *, causal=True, window=None,
                            grad_dtype=None):
    """(dk, dv), each [B, Sk, KV, D] in ``grad_dtype`` (default k's dtype).

    CPU tensors take the plain version; CUDA tensors launch the dk/dv kernel
    or raise."""
    _check_backward(q, k, v, o, lse, do, causal, window, grad_dtype)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, window=window, grad_dtype=grad_dtype)[1:]
    name = "flash_attention_bwd_dkv"
    width = _check_backward_inputs(name, q, k, v, o, lse, do)
    return _pad_heads(functools.partial(_launch_backward, name, lse=lse, causal=causal,
                                        window=window, grad_dtype=grad_dtype),
                      (q, k, v, o, do), width)


@torch.library.custom_op(
    "kubeflow_tpu_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window) -> (Tensor, Tensor)",
)
def flash_attention_fwd_op(q, k, v, causal, window):
    """The forward with lse as one dispatcher op (``window`` 0 = none), so a
    selective-checkpoint policy can name it (``models/transformer.py``)."""
    return _forward(q, k, v, causal, window or None)


@flash_attention_fwd_op.register_fake
def _(q, k, v, causal, window):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=_acc(q).dtype)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.window = causal, window or None


def _backward(ctx, do, _):
    """The op's backward (``jax.custom_vjp`` there): the residuals are the
    ones the TPU op saves, (q, k, v, o, lse), and the dq and dk/dv kernels
    recompute block scores from them, so no [S, S] tensor is ever kept."""
    q, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    kw = dict(causal=ctx.causal, window=ctx.window)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    return dq, dk, dv, None, None


flash_attention_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, window: int | None = None, *,
                    return_lse: bool = False):
    """Fused attention. Layout [B, S, H, D] (matching ops/attention.py).

    GQA/MQA: pass k/v with fewer heads than q (H % KV == 0); query head h
    reads kv head h // (H // KV).

    ``window``: sliding-window (local) attention — position q attends
    [q - window + 1, q]. ``block_q``/``block_k`` keep the TPU op's tiling
    contract (the sequence lengths must divide them); the CUDA kernels' tiles
    are :func:`_plan`'s, whatever they are.

    ``return_lse`` also returns the row logsumexp [B, H, Sq] in fp32 (+inf on
    rows that see no key; it carries no gradient). When an input requires
    grad, the call saves the backward's residuals; under ``inference_mode``,
    as in serving, it is the forward kernel alone.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _group_of(q, k, v)
    _block_plan(Sq, Sk, block_q, block_k)
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    if q.device.type != "cpu" and (
            tuple(k.shape) != (B, Sk, KV, D) or tuple(v.shape) != (B, Sk, KV, D)):
        raise ValueError(f"k and v must be [B={B}, Sk, KV, D={D}], got {tuple(k.shape)}, {tuple(v.shape)}")
    o, lse = flash_attention_fwd_op(q, k, v, causal, window or 0)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
