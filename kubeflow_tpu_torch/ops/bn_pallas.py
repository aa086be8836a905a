"""BatchNorm statistics and gradient reductions; counterpart of ``kubeflow_tpu/ops/bn_pallas.py``.

Train-mode BatchNorm needs four per-channel reductions over the ``[rows, C]``
view of an NHWC activation: Σx and Σx² forward, Σdy and Σdy·x̂ backward. Two
CUDA kernels replace the two Pallas kernels of the JAX module:

- ``csrc/bn_moments.cu`` replaces ``_moments_kernel`` (``:96``): Σx and Σx²
  in one sweep, fp32 sums;
- ``csrc/bn_grad_sums.cu`` replaces ``_bn_bwd_kernel`` (``:140``): Σdy and
  Σdy·(x − mean)·rinv in one sweep over dy and x, x̂ recomputed from x.

The normalisation itself (``y = x·a + b``) and dx stay elementwise tensor
code, as they stay in XLA in the JAX module.

What bounds the kernels on an H100: bytes. Each activation is read once (two
of them backward) and 2·C floats come out, so the least time is the
activation's size over 3.35 TB/s: 123 µs for the ResNet-50 stem's
``[256·112², 64]`` bf16 tensor forward, twice that backward.

What the design does (``csrc/bn_common.cuh``): the TPU grid is sequential and
carries the two ``[1, C]`` sums in VMEM from block to block. Here the rows
are split over ``gy`` thread blocks that run in parallel; C is the
contiguous dimension, so neighbouring threads take neighbouring 16-byte
vectors of channels (8 bf16 or 4 fp32 values; single elements where C does
not allow the vector) and each keeps fp32 partial sums of its channels over
its rows. A block adds its threads' partials through shared memory in a
fixed order and writes one row of partial sums. No atomics on the sums: the
result is the same on every run, as the TPU kernel's is.

- The moments kernel is one launch (:func:`_moments_plan`): each thread
  issues eight row loads before it adds them, two blocks of 256 threads an
  SM sweep the rows, and the last block of each column group to finish (an
  atomic ticket, cached zeroed per stream and left zeroed by the kernel)
  adds the group's partial rows in a fixed order.
- The grad-sums kernel writes ``[2, gy, C]`` partials and a second, small
  kernel adds the ``gy`` rows in order; :func:`_plan` picks its split so
  that both ends of the ResNet zoo fill the card: ``[B·112², 64]`` is one
  column group and hundreds of row groups, ``[B·7², 2048]`` eight column
  groups and fewer row groups.

``_pick_block_rows`` and ``_rows_view`` of the JAX module are helpers for the
TPU's (8, 128) tiling and its conv layout and are not carried over: the
kernels take any ``m`` and ``C`` (ragged tails masked), so there is no shape
fallback either, where the JAX functions fall back to XLA
(``:116-119, 162-165``). What the port asks for instead is that the
``[rows, C]`` view is free: an input that is not contiguous raises rather
than being copied, because a silent copy of every activation is exactly what
made this path a net loss on the TPU (module docstring of the JAX file).

The ``mxu`` strategy computes the same four reductions as plain matrix
products (``ones @ x`` and the diagonal of ``xᵀ x``), outside any kernel in
the JAX module too, so here they are ``torch`` matmuls with fp32 accumulation.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import dataclasses

import torch

from kubeflow_tpu_torch.models.transformer import matmul_f32
from kubeflow_tpu_torch.ops import _build, _workspace

THREADS = 256            # threads a block (csrc/bn_common.cuh)
_MAX_TX = 32             # column vectors a block spans at most
_BLOCKS_PER_SM = 4       # row groups are cut so that about this many blocks run per SM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions


def _rows(x):
    """The free ``[rows, C]`` view of ``x``; raises where it needs a copy."""
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"expected a non-empty [..., C] tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"the [rows, C] view of a tensor with shape {tuple(x.shape)} and strides "
            f"{x.stride()} needs a copy: pass a contiguous [..., C] tensor (an NHWC "
            "activation, e.g. permute(0, 2, 3, 1) of a channels_last conv output)")
    return x.view(-1, x.shape[-1])


def moments_sums_plain(x, c: float = 1.0):
    """(Σ(c·x), Σ(c·x)²) per channel over the rows of ``x`` [..., C], fp32
    [C] each: what the moments kernel computes (``_moments_kernel``)."""
    xf = _rows(x).float() * c
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def _mean_var(s, q, m: int):
    mean = s / m
    return mean, torch.clamp(q / m - mean * mean, min=0.0)


def channel_moments_plain(x):
    """Plain version of :func:`channel_moments`: (mean, biased var clamped
    at 0) from Σx and Σx² (``channel_moments``, ``:136-137``)."""
    s, q = moments_sums_plain(x)
    return _mean_var(s, q, x.numel() // x.shape[-1])


def bn_grad_sums_plain(dy, x, mean, rinv):
    """Plain version of :func:`bn_grad_sums`: (Σdy, Σdy·x̂) per channel with
    x̂ = (x − mean)·rinv in fp32 (``_bn_bwd_kernel``, ``:148-151``)."""
    dyf = _rows(dy).float()
    xhat = (_rows(x).float() - mean) * rinv
    return dyf.sum(dim=0), (dyf * xhat).sum(dim=0)


# ------------------------------------------------------------ kernels


def _plan(m: int, ch: int, dtype, sms: int):
    """How the two reduction kernels cut ``[m, ch]``: (vec, tx, gx, gy).

    ``vec`` channels a thread (one 16-byte load where ``ch`` allows it, else
    single elements), ``tx`` column vectors and ``THREADS // tx`` rows a
    block, ``gx`` column groups, and ``gy`` row groups, each writing one row
    of partial sums."""
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    vec = wide if ch % wide == 0 else 1
    cols = ch // vec
    tx = 1
    while tx < min(cols, _MAX_TX):
        tx *= 2
    gx = -(-cols // tx)
    ty = THREADS // tx
    gy = max(1, min(-(-m // ty), (_BLOCKS_PER_SM * sms) // gx))
    return vec, tx, gx, gy


_MOM_MAX_TX = 16         # column vectors a moments block spans at most ...
_MOM_WIDE_TX = 32        # ... and at rows of 256 vectors or more (2,048 bf16 channels)
_MOM_BLOCKS_PER_SM = 2   # moments blocks an SM: 8 row loads of 16 bytes in flight a thread
_MOM_UNROLL = 8          # row loads a thread issues before adding them (ONCE_UNROLL)
_MOM_MIN_SWEEPS = 2      # a block's threads take at least this many batches of 8 rows


@dataclasses.dataclass(frozen=True)
class MomentsPlan:
    """How the one-launch moments kernel cuts ``[m, ch]``: ``vec`` channels a
    thread, ``tx`` column vectors and ``ty`` rows a block step, ``gx`` column
    groups of ``width`` channels, ``gy`` row groups; each block leaves a
    partial row of 2 ``width4`` floats (``width`` padded to 4) in ``part``
    (``part_floats`` in all), and ``gx`` tickets pick each group's last
    block."""

    vec: int
    tx: int
    ty: int
    gx: int
    gy: int
    width: int
    width4: int
    part_floats: int


def _moments_plan(m: int, ch: int, dtype, sms: int) -> MomentsPlan:
    """The moments kernel's split: 16-byte vectors where ``ch`` allows, up to
    16 column vectors a block (so that a group's finish reads at most 2 x 128
    floats a partial row; 32 where a row holds 256 vectors or more, whose
    wider slices of each row read faster), and ``gy`` row groups: enough for
    two blocks an SM across the column groups, but no more than leave each
    thread two batches of 8 rows, so a small activation takes fewer, fuller
    blocks and its finish few partial rows."""
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    vec = wide if ch % wide == 0 else 1
    cols = ch // vec
    tx = 1
    while tx < min(cols, _MOM_WIDE_TX if cols >= 256 else _MOM_MAX_TX):
        tx *= 2
    gx = -(-cols // tx)
    ty = THREADS // tx
    gy = max(1, min(-(-m // (ty * _MOM_UNROLL * _MOM_MIN_SWEEPS)),
                    -(-(_MOM_BLOCKS_PER_SM * sms) // gx)))
    width = tx * vec
    width4 = max(width, 4)
    return MomentsPlan(vec, tx, ty, gx, gy, width, width4, gx * gy * 2 * width4)


def _moments_split_reference(x, c: float, plan: MomentsPlan):
    """The moments kernel's order of operations in plain PyTorch (a witness,
    never on the main path): thread (row group y, row lane ry) adds the terms
    of rows y ty + ry, + gy ty, ... in row order; a block adds its ty lanes in
    lane order; the finish lane l adds the partial rows y = l, l + lanes, ...
    (lanes = 256 // (width4 / 2)) in order, then the lanes in lane order. fp32
    throughout; the kernel may fuse a square and its add into one rounding,
    so the sums of squares may differ in their last bits."""
    x2 = _rows(x).float() * c
    m, ch = x2.shape
    step = plan.gy * plan.ty
    cols = plan.gx * plan.width
    xp = torch.zeros((-(-m // step) * step, cols), dtype=torch.float32)
    xp[:m, :ch] = x2
    rows = xp.view(-1, plan.gy, plan.ty, cols)
    lanes = THREADS // (plan.width4 // 2)
    out = []
    for terms in (rows, rows * rows):
        thread = torch.zeros((plan.gy, plan.ty, cols), dtype=torch.float32)
        for k in range(terms.shape[0]):
            thread = thread + terms[k]
        block = thread[:, 0]
        for ry in range(1, plan.ty):
            block = block + thread[:, ry]
        part = [None] * lanes
        for y in range(plan.gy):
            part[y % lanes] = block[y] if part[y % lanes] is None else part[y % lanes] + block[y]
        total = part[0]
        for p in part[1:]:
            if p is not None:
                total = total + p
        out.append(total[:ch])
    return out[0], out[1]


def _check_kernel_operand(what, name, t, like=None):
    if t.device.type != "cuda":
        raise TypeError(f"{what} kernel takes CUDA tensors; {name} is on {t.device}")
    if like is not None and (t.device != like.device or t.shape != like.shape
                             or t.dtype != like.dtype):
        raise ValueError(
            f"{what}: {name} must match x in device, shape and dtype; got "
            f"{t.device} {tuple(t.shape)} {t.dtype} for {like.device} {tuple(like.shape)} "
            f"{like.dtype}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes {list(_DTYPE_CODES)}, got {t.dtype} for {name}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs {name} 16-byte aligned")


def _channel_vector(what, name, v, x2):
    if v.shape != (x2.shape[1],) or v.dtype != torch.float32 or v.device != x2.device:
        raise ValueError(
            f"{what}: {name} must be float32 [{x2.shape[1]}] on {x2.device}, got "
            f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return v.contiguous()


def _launch_sums(name, x2, extra_ptrs, scalars, counter):
    """Launch reduction kernel ``name`` over ``x2`` [m, C]: returns the two
    fp32 [C] sums. ``extra_ptrs`` and ``scalars`` go between x and the
    outputs in the launcher's signature; the launch is counted in
    ``counter.launches``, the wrapper the caller came through."""
    m, ch = x2.shape
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    vec, tx, gx, gy = _plan(m, ch, x2.dtype, sms)
    out = torch.empty((2, ch), dtype=torch.float32, device=x2.device)
    part = torch.empty((2, gy, ch), dtype=torch.float32, device=x2.device)
    _build.launch(
        name, x2.data_ptr(), *extra_ptrs, part.data_ptr(), out.data_ptr(), m, ch,
        _DTYPE_CODES[x2.dtype], vec, tx, gy, *scalars,
        torch.cuda.current_stream(x2.device).cuda_stream)
    counter.launches += 1
    return out[0], out[1]


def _launch_moments(x2, c: float, counter):
    """Launch the moments kernel over ``x2`` [m, C] with multiplier ``c``,
    one launch with the cached scratch of :func:`_moments_plan`: returns the
    two fp32 [C] sums; the launch is counted in ``counter.launches``."""
    m, ch = x2.shape
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    plan = _moments_plan(m, ch, x2.dtype, sms)
    part, tickets = _workspace.workspace(x2.device, stream, plan.part_floats, plan.gx)
    out = torch.empty((2, ch), dtype=torch.float32, device=x2.device)
    _build.launch("bn_moments", x2.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                  out.data_ptr(), m, ch, _DTYPE_CODES[x2.dtype], plan.vec, plan.tx, plan.gy,
                  float(c), stream)
    counter.launches += 1
    return out[0], out[1]


def moments_sums(x, c: float, counter):
    """(Σ(c·x), Σ(c·x)²) per channel, fp32 [C] each: the moments kernel on a
    CUDA tensor, the plain version on a CPU tensor. The two wrappers of the
    one kernel call it, each passing itself as ``counter`` so that the launch
    is counted as its own: :func:`channel_moments` with c = 1, the stats
    probe's ``moments_scaled`` (``benchmarks/bn_stats_probe.py``) with its
    multiplier."""
    x2 = _rows(x)
    if x.device.type == "cpu":
        return moments_sums_plain(x, c)
    _check_kernel_operand("bn_moments", "x", x2)
    return _launch_moments(x2, c, counter)


def channel_moments(x):
    """(mean, biased var) over all leading dims of ``x`` [..., C], fp32 [C]
    each, the variance clamped at 0 (cancellation in E[x²] − mean² goes
    negative for a channel of large mean and low variance)."""
    s, q = moments_sums(x, 1.0, channel_moments)
    return _mean_var(s, q, x.numel() // x.shape[-1])


def bn_grad_sums(dy, x, mean, rinv):
    """(Σdy, Σdy·x̂) per channel in one sweep over dy and x [..., C], fp32
    [C] each; mean and rinv fp32 [C]. The grad-sums kernel on CUDA tensors,
    the plain version on CPU tensors."""
    x2, dy2 = _rows(x), _rows(dy)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} differ in shape")
    if x.device.type == "cpu":
        return bn_grad_sums_plain(dy, x, mean, rinv)
    _check_kernel_operand("bn_grad_sums", "x", x2)
    _check_kernel_operand("bn_grad_sums", "dy", dy2, like=x2)
    mean = _channel_vector("bn_grad_sums", "mean", mean, x2)
    rinv = _channel_vector("bn_grad_sums", "rinv", rinv, x2)
    return _launch_sums("bn_grad_sums", x2, (dy2.data_ptr(), mean.data_ptr(), rinv.data_ptr()), (),
                        bn_grad_sums)


channel_moments.launches = 0
bn_grad_sums.launches = 0


# ------------------------------------------------------------ MXU stats
# Reductions as matrix products: sum(x) is a ones-vector product and the
# (sum x_i x_j) family a Gram product. Plain dots in the JAX module (no Pallas
# kernel), so plain matmuls with fp32 accumulation here. Worthwhile when
# rows >= channels (the [C, C] Gram write is then bounded by the data read).


def _mxu_ok(m: int, ch: int) -> bool:
    return m >= ch


def _moment_sums_mxu(x):
    """(Σx, Σx²) fp32 [C] via matrix products: sum = ones @ x, sumsq =
    diag(xᵀ x). Operands of x's dtype multiply exactly into the fp32 sum."""
    ch = x.shape[-1]
    m = x.numel() // ch
    xt = x.reshape(m, ch).t()
    ones = torch.ones((1, m), dtype=x.dtype, device=x.device)
    return matmul_f32(ones, xt)[0], torch.diagonal(matmul_f32(xt, xt))


def channel_moments_mxu(x):
    """(mean [C], var [C]) fp32 from :func:`_moment_sums_mxu`."""
    return _mean_var(*_moment_sums_mxu(x), x.numel() // x.shape[-1])


def _bn_grad_sums_mxu(dy, x, mean, rinv):
    """(dbeta, dgamma) via matrix products on the raw tensors: sum(dy) =
    ones @ dy and sum(dy·x̂) = (diag(dyᵀ x) − mean·sum(dy))·rinv."""
    ch = x.shape[-1]
    m = x.numel() // ch
    dyt = dy.reshape(m, ch).to(x.dtype).t()
    xt = x.reshape(m, ch).t()
    ones = torch.ones((1, m), dtype=x.dtype, device=x.device)
    dbeta = matmul_f32(ones, dyt)[0]
    sum_dyx = torch.diagonal(matmul_f32(dyt, xt))
    return dbeta, (sum_dyx - mean * dbeta) * rinv


def _moment_sums(x, strategy: str):
    """(Σx, Σx²) per channel, fp32 [C] each, by ``strategy``."""
    ch = x.shape[-1]
    if strategy == "mxu" and _mxu_ok(x.numel() // ch, ch):
        return _moment_sums_mxu(x)
    if strategy == "mxu":
        # small-m/large-C tail: a plain reduction is already cheap there
        return moments_sums_plain(x)
    return moments_sums(x, 1.0, channel_moments)


def _grad_sums(dy, x, mean, rinv, strategy: str):
    ch = x.shape[-1]
    if strategy == "mxu" and _mxu_ok(x.numel() // ch, ch):
        return _bn_grad_sums_mxu(dy, x, mean, rinv)
    if strategy == "mxu":
        return bn_grad_sums_plain(dy, x, mean, rinv)
    return bn_grad_sums(dy, x, mean, rinv)


def _all_reduce(group, *ts):
    """``ts`` summed over ``group``'s ranks, in one collective."""
    import torch.distributed as dist

    flat = torch.stack(ts)
    dist.all_reduce(flat, group=group)
    return flat.unbind(0)


class _BatchNormTrain(torch.autograd.Function):
    """``_bn_train_vjp`` of the JAX module: forward ``_bn_train_fwd``
    (``:281-287``), backward ``_bn_train_bwd`` (``:290-303``). The statistics
    carry no gradient.

    With a process ``group`` (the ranks that hold the global batch, each an
    equal shard of it) the statistics are the global batch's, as they are
    in the reference's SPMD step: the forward all-reduces Σx and Σx² (the
    row count is the rank's times the group's size) before the mean and
    variance, and the backward all-reduces Σdy and Σdy·x̂ before dx. dscale
    and dbias stay this rank's own sums: each rank's gradients are of its
    own mean loss, and the train step averages them over the ranks."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, strategy, group):
        s, q = _moment_sums(x, strategy)
        m = x.numel() // x.shape[-1]
        if group is not None:
            import torch.distributed as dist

            # equal shards: the global row count is an int, as it is on one
            # device, so the mean and dx divide as they do there
            s, q = _all_reduce(group, s, q)
            m *= dist.get_world_size(group)
        mean, var = _mean_var(s, q, m)
        rinv = torch.rsqrt(var + eps)
        a = (scale * rinv).float()
        b = bias - mean * a
        y = (x.float() * a + b).to(x.dtype)
        ctx.save_for_backward(x, mean, rinv, scale)
        ctx.strategy, ctx.group, ctx.m = strategy, group, m
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rinv, scale = ctx.saved_tensors
        m = ctx.m
        dbeta, dgamma = _grad_sums(dy, x, mean, rinv, ctx.strategy)
        sum_dy, sum_dyx = (dbeta, dgamma) if ctx.group is None else \
            _all_reduce(ctx.group, dbeta, dgamma)
        g = (scale * rinv).float()
        # dx = g * (dy - Σdy/m - xhat * Σdy·xhat/m), all elementwise
        xhat_coeff = (rinv * sum_dyx) / m
        dx = (g * (dy.float() - sum_dy / m) - g * xhat_coeff * (x.float() - mean)).to(x.dtype)
        return dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype), None, None, None


def batch_norm_train(x, scale, bias, eps: float = 1e-5, strategy: str = "pallas", group=None):
    """Train-mode BN over the leading dims of ``x`` [..., C]: returns
    ``(y, (mean, var))``, y in x's dtype; the statistics carry no gradient
    (they exist to update the running averages). ``strategy``: 'pallas' (the
    single-sweep kernels) or 'mxu' (the reductions as matrix products).
    ``group``: the process group over which the batch is sharded (equal
    shards); its sums are all-reduced, so the statistics are the global
    batch's (``_BatchNormTrain``). None is one device."""
    if strategy not in ("pallas", "mxu"):
        # anything else would silently fall through to the kernels
        raise ValueError(f"strategy must be 'pallas' or 'mxu', got {strategy!r}")
    y, mean, var = _BatchNormTrain.apply(x, scale, bias, eps, strategy, group)
    return y, (mean, var)
