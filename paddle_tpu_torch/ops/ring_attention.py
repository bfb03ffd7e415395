"""Ring attention: context parallelism over the ``sep`` mesh axis, on the
flash kernels.

Port of ``paddle_tpu/ops/ring_attention.py``. The sequence is split over
``sep``: each rank keeps its chunk of Q and K/V rotate ``n - 1`` hops
around the ring (``torch.distributed.batch_isend_irecv``, one batch a hop,
the next hop in flight while the current block computes). Block ``(i,
src)``, rank ``i``'s queries against rank ``src``'s keys, is full
attention when ``src < i``, causal on the diagonal and skipped when ``src
> i`` (without ``causal`` every block is full).

- **Forward.** Each block runs :func:`~.flash_attention.flash_attention_fwd`,
  which returns ``(out, lse)``; the partials merge in float32 with the
  reference's ``_merge`` (``lse`` is ``(B, H, S)``, the kernels' layout,
  swapped to ``(B, S, H, 1)`` for the weights).
- **Backward**, the ring-flash form: ``delta = rowsum(dO * O)`` in float32
  from the merged output; each block's dq, dk and dv come from the
  backward kernels (``_launch_dq``/``_launch_dkv``) called with the GLOBAL
  ``lse`` and ``delta``, so the probabilities they recompute are the
  global ones. dq accumulates in float32; the float32 dk/dv accumulators
  rotate with K/V and reach their owner after ``n`` hops.
- **Error bar.** Each block's kernel output is rounded to the inputs'
  dtype once (out before the merge, dq/dk/dv before the float32 sums).
  A row's merged output is a convex combination of its block outputs
  (weights ``exp(lse_j - LSE)`` sum to 1), so its error is within one
  rounding of the largest block output, ``2**-8 * max|o_j|`` in bfloat16;
  a gradient sums at most ``n`` block terms, each within one rounding of
  itself, so ``|err| <= 2**-8 * sum_j |g_j|``, at most ``n`` times the
  rounding of the largest term. The kernels over the whole sequence round
  their output once: they and the ring differ by these bounds plus each
  kernel's own error against exact arithmetic.

- **The op.** The ring is a library op (``paddle_tpu_torch::
  ring_attention``, :data:`RING_OP`) with its backward registered, so a
  ``jit.to_static`` graph holds it as one node and keeps the backward.

On the CPU each block takes the kernels' plain versions (the CPU twin); on
a CUDA tensor every block launches the kernels: a chunk the kernels' gate
(:func:`~.flash_attention.flash_gate` at 128 rows) refuses raises, and no
block gives way to the plain version. Chunks must be of equal length, so
that the kernels' top-left causal alignment is the diagonal's.

:func:`ring_attention_local` drives the same block steps over ``n``
chunks of one sequence on one device, the hops as indexing: the one-card
form ``chip_smoke.py`` measures.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .flash_attention import (NEG_INF, _check, _delta, _launch_dkv,
                              _launch_dq, _lens, _plain_dkv, _plain_dq,
                              _scale, _scores, flash_attention,
                              flash_attention_fwd, flash_gate,
                              flash_supported)

__all__ = ["SEP_AXIS", "RING_MIN_SEQ", "ring_flash_attention",
           "ring_attention_local", "block_forward", "block_backward",
           "merge"]

SEP_AXIS = "sep"
# the kernels' own gate: a chunk of at least this many rows runs them
RING_MIN_SEQ = 128


def _gate(q):
    """On a CUDA tensor the block must meet the kernels' gate, else raise
    (no fallback); CPU tensors take the plain versions."""
    if q.device.type == "cuda" and not flash_gate(
            "cuda", q.dtype, tuple(q.shape), min_seq=RING_MIN_SEQ):
        raise ValueError(f"ring attention: a chunk {tuple(q.shape)} "
                         f"{q.dtype} does not meet the flash kernels' gate "
                         f"(>= {RING_MIN_SEQ} rows, head_dim 64/128/256, "
                         f"bfloat16 or float32)")


def merge(o1, lse1, o2, lse2):
    """The reference's ``_merge``: two normalized partials (B, S, H, D)
    float32 with their lse (B, H, S) -> the merged pair."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse).transpose(1, 2)[..., None]
    return o1 * w1 + o2 * w2, lse


def _mode(i: int, src: int, causal: bool) -> Optional[bool]:
    """The block's causal flag, or None when it is skipped."""
    if not causal or src < i:
        return False
    return True if src == i else None


def block_forward(q, k, v, causal: bool, sm_scale: float):
    """One block: ``(out, lse)`` of the forward kernel (plain on the
    CPU); out in q's dtype, lse (B, H, S) float32."""
    _gate(q)
    return flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=causal)


def block_backward(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """One block's ``(dq, dk, dv)`` in the inputs' dtype, from the global
    ``lse`` and ``delta`` (B, H, S) float32: the dq and dk/dv kernels on a
    CUDA tensor, their plain versions on the CPU."""
    _gate(q)
    if q.device.type == "cuda":
        q, k, v, do = _check(q, k, v, do.to(q.dtype))
        rest = (None, 0, sm_scale, causal)
        return (_launch_dq(q, k, v, do, lse, delta, *rest),
                *_launch_dkv(q, k, v, do, lse, delta, *rest))
    b, sk = q.shape[0], k.shape[1]
    s = _scores(q, k, _lens(None, b, sk, q.device), sm_scale, causal)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    return (_plain_dq(ds, q, k, sm_scale),
            *_plain_dkv(ds, p, q, k, v, do, sm_scale))


def _fwd_step(q, k, v, i, src, causal, sm_scale, acc):
    """Merge block (i, src) into ``acc`` ((o, lse) float32, or None)."""
    mode = _mode(i, src, causal)
    if mode is None:
        return acc
    o, lse = block_forward(q, k, v, mode, sm_scale)
    if acc is None:            # merging into the empty partial is exact
        return o.float(), lse
    return merge(acc[0], acc[1], o.float(), lse)


def _bwd_step(q, k, v, do, lse, delta, i, src, causal, sm_scale, dq, dk,
              dv):
    """Add block (i, src)'s gradients into the float32 ``dq``, ``dk``
    and ``dv`` (in place)."""
    mode = _mode(i, src, causal)
    if mode is None:
        return
    g = block_backward(q, k, v, do, lse, delta, mode, sm_scale)
    dq += g[0].float()
    dk += g[1].float()
    dv += g[2].float()


def _hop(sends, recv_like, nxt, prv):
    """Post one hop: ``sends`` to ``nxt``, as many buffers like
    ``recv_like`` from ``prv``, as one batch -> (requests, buffers)."""
    bufs = [torch.empty_like(t) for t in recv_like]
    ops = [dist.P2POp(dist.isend, t, nxt) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv) for t in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _ring_fwd(q, k, v, causal, sm_scale, n, i, nxt, prv):
    """The ring's forward: n block steps, K/V handed on each hop ->
    ``(out, lse)``."""
    kv = (k.contiguous(), v.contiguous())
    acc = None
    for j in range(n):
        reqs = bufs = None
        if j < n - 1:
            reqs, bufs = _hop(kv, kv, nxt, prv)
        acc = _fwd_step(q, kv[0], kv[1], i, (i - j) % n, causal,
                        sm_scale, acc)
        if reqs is not None:
            for r in reqs:
                r.wait()
            kv = tuple(bufs)
    return acc[0].to(q.dtype), acc[1].contiguous()


def _ring_setup_context(ctx, inputs, output):
    q, k, v, causal, sm_scale, n, i, nxt, prv = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (causal, sm_scale, n, i, nxt, prv)


def _ring_backward(ctx, do, _dlse):
    """The ring's backward: the block gradients, the dk/dv accumulators
    travelling every hop back to their owners; lse has no gradient."""
    q, k, v, out, lse = ctx.saved_tensors
    causal, sm_scale, n, i, nxt, prv = ctx.args
    do = do.contiguous()
    delta = _delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = (k.contiguous(), v.contiguous())
    dkv = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device))
    for j in range(n):
        _bwd_step(q, kv[0], kv[1], do, lse, delta, i, (i - j) % n,
                  causal, sm_scale, dq, *dkv)
        # the accumulators travel every hop, K/V all but the last:
        # after n hops each dk/dv is back at its owner
        send = (kv + dkv) if j < n - 1 else dkv
        reqs, bufs = _hop(send, send, nxt, prv)
        for r in reqs:
            r.wait()
        if j < n - 1:
            kv, dkv = tuple(bufs[:2]), tuple(bufs[2:])
        else:
            dkv = tuple(bufs)
    return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
            None, None, None, None, None, None)


# a library op with its autograd: a staged graph holds the ring as one
# node (its hops run when the node runs) and keeps its backward
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("ring_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "float sm_scale, int n, int i, int nxt, int prv) -> "
            "(Tensor, Tensor)")
_LIB.impl("ring_attention", _ring_fwd, "CompositeExplicitAutograd")


@torch.library.register_fake("paddle_tpu_torch::ring_attention", lib=_LIB)
def _(q, k, v, causal, sm_scale, n, i, nxt, prv):
    b, s, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


torch.library.register_autograd("paddle_tpu_torch::ring_attention",
                                _ring_backward,
                                setup_context=_ring_setup_context, lib=_LIB)

#: ``torch.ops.paddle_tpu_torch.ring_attention``
RING_OP = torch.ops.paddle_tpu_torch.ring_attention


def _plain_attention(q, k, v, causal, sm_scale):
    """The reference's ``_partial_attn`` output at ``n == 1`` off the
    kernels: float32 softmax attention, cast back."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2:]
        ok = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def ring_flash_attention(q, k, v, axis_name: str = SEP_AXIS, causal=False,
                         sm_scale=None):
    """q/k/v: (B, S_local, H, D), this rank's chunks of a sequence split
    over the current mesh's ``axis_name`` -> (B, S_local, H, D). At one
    rank it is the flash op (its gate permitting) or plain attention, as
    the reference."""
    from ..distributed.mesh import get_mesh
    sm_scale = _scale(q.shape[-1], sm_scale)
    mesh = get_mesh()
    n = 1 if mesh is None else mesh.shape[axis_name]
    if n == 1:
        if flash_supported(q, k):
            return flash_attention(q, k, v, causal=causal,
                                   sm_scale=sm_scale)
        return _plain_attention(q, k, v, causal, sm_scale)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ring attention: query chunk {q.shape[1]} and "
                         f"key chunk {k.shape[1]} differ; the diagonal "
                         f"block needs equal chunks")
    return RING_OP(q, k, v, bool(causal), float(sm_scale), n,
                   mesh.coord[axis_name], mesh.neighbor(axis_name, 1),
                   mesh.neighbor(axis_name, -1))[0]


def ring_attention_local(q, k, v, n: int, causal: bool = False,
                         sm_scale=None, do=None):
    """The ring's block steps over ``n`` equal chunks of one sequence on
    one device, each hop an index (block ``(i, src)`` for ``src = (i - j)
    mod n``, in the distributed ring's order) -> ``(out, lse)``, and with
    ``do`` also ``(dq, dk, dv)``: what ``n`` ranks compute, concatenated."""
    sm_scale = _scale(q.shape[-1], sm_scale)
    if q.shape[1] % n:
        raise ValueError(f"ring attention: {q.shape[1]} rows do not split "
                         f"into {n} equal chunks")
    qs, ks, vs = (t.chunk(n, dim=1) for t in (q, k, v))
    # hop-major, as the ranks run it: every sum is taken in the ring's
    # order (each dk/dv accumulator visits ranks src, src + 1, ...)
    accs = [None] * n
    for j in range(n):
        for i in range(n):
            src = (i - j) % n
            accs[i] = _fwd_step(qs[i], ks[src], vs[src], i, src, causal,
                                sm_scale, accs[i])
    outs = [a[0].to(q.dtype) for a in accs]
    lses = [a[1] for a in accs]
    out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=2)
    if do is None:
        return out, lse
    dos = do.contiguous().chunk(n, dim=1)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = [torch.zeros(t.shape, **f32) for t in qs]
    dk = [torch.zeros(t.shape, **f32) for t in ks]
    dv = [torch.zeros(t.shape, **f32) for t in vs]
    deltas = [_delta(o, g) for o, g in zip(outs, dos)]
    for j in range(n):
        for i in range(n):
            src, delta = (i - j) % n, deltas[i]
            _bwd_step(qs[i], ks[src], vs[src], dos[i], lses[i], delta, i,
                      src, causal, sm_scale, dq[i], dk[src], dv[src])
    return out, lse, tuple(torch.cat(g, dim=1).to(t.dtype)
                           for g, t in ((dq, q), (dk, k), (dv, v)))
