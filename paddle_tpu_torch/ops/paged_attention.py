"""Paged (block-table) decode attention: the Hopper kernel, its plain
PyTorch version, and the gather paths.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``. Each sequence's
keys/values live scattered across fixed-size pool pages
(``inference/kv_cache.py``); a per-sequence block table names the pages in
order.

- **The kernels** (decode steps Tq == 1, and uniform multi-token chunks
  1 < Tq <= 32: speculative-verify windows and same-width prefill chunks):
  ``csrc/paged_attention.cu`` for ``sm_90a``, with Tq as a parameter,
  replacing the TPU's ``_paged_decode_kernel`` and
  ``_paged_verify_kernel``. :func:`paged_attention` is their wrapper and
  returns the *unnormalized* online-softmax stats ``(acc, m, l)``;
  :func:`paged_attention_plain` computes the same in plain PyTorch. Two
  routes (:func:`paged_route`): ``"split"``, the split-context kernel over
  :func:`route_splits` splits a row (the tuning DB's count for the card
  and shape, else the :func:`paged_splits` formula; ``SPLITS`` counts
  launches by it), each block fed by a ``cp.async`` ring,
  then an ordered merge kernel (:func:`paged_attention_split_plain` is that
  plan in plain PyTorch), taken whenever q and the pools start on 16-byte
  boundaries; ``"simple"``, the first design (one block a (row, head),
  scalar loads), for a pointer off those boundaries. The wrapper takes the
  plain version only for tensors on the CPU; on a CUDA tensor it launches
  a kernel or raises. ``LAUNCHES`` counts calls (``"decode"`` for
  Tq == 1, ``"verify"`` for Tq > 1), ``ROUTES`` the route each took.
- **The epilogue** folds the chunk tokens' own self-attention term (one
  score for a decode step, a causal (Tq, Tq) block for a chunk) into the
  stats and divides, in PyTorch, as the JAX package does it in jnp outside
  its kernel; the new K/V never has to reach the pool before attention
  reads it.
- **The gather path** (:func:`_gather_paged_decode`) is the JAX package's
  XLA baseline in PyTorch: ``pool[tables]`` into a rectangular view,
  masked to each row's length. ``paged_decode_attention(kernel="auto")``
  takes it only for shapes the kernel's gate rejects (Tq > 32, head_dim
  not in {32, 64, 128, 256}, page size not a multiple of 8) and counts
  ``record_fallback("paged_attention")``.
- :func:`paged_prefill_attention` is the ragged mixed prefill/decode
  path, plain PyTorch as it is XLA in the JAX package.

Layouts are the JAX package's: q ``(B, Tq, H, D)``, pools
``(P, page_size, H, D)``, tables ``(B, W)`` int32, lens ``(B,)`` int32.
"""
from __future__ import annotations

import collections
import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build
from .tuner import (PAGED_SPLIT_KERNEL, paged_split_dims, record_fallback,
                    resolve_splits)

__all__ = ["NEG_INF", "MAX_VERIFY_TQ", "LAUNCHES", "ROUTES",
           "SPLIT_BLOCKS_PER_SM", "MIN_SPLIT_KEYS", "paged_decode_supported",
           "paged_route", "paged_splits", "route_splits", "SPLITS",
           "paged_attention",
           "paged_attention_plain", "paged_attention_split_plain",
           "load_kernel", "paged_decode_attention", "paged_prefill_attention",
           "PAGED_OP"]

NEG_INF = -1e30          # finite mask value, as the JAX package's kernels use
MAX_VERIFY_TQ = 32       # widest multi-query chunk the kernel takes
HEAD_DIMS = (32, 64, 128, 256)

# the split route's grid aims at this many blocks an SM (a block is 4
# warps), and gives no split fewer than MIN_SPLIT_KEYS keys of a full table
SPLIT_BLOCKS_PER_SM = 4
MIN_SPLIT_KEYS = 64

LAUNCHES = {"decode": 0, "verify": 0}
ROUTES = {"decode_split": 0, "decode_simple": 0, "verify_split": 0,
          "verify_simple": 0}
# split-route launches by (decode or verify, the splits a row they took)
SPLITS: "collections.Counter[Tuple[str, int]]" = collections.Counter()
_launch_lock = threading.Lock()


def paged_decode_supported(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """The kernel's shape gate, the JAX package's conditions: 1..32 query
    tokens per row, head_dim in {32, 64, 128, 256}, page size a multiple
    of 8. The backend condition of the JAX gate becomes the wrapper's
    device dispatch."""
    return (q.dim() == 4 and 1 <= q.shape[1] <= MAX_VERIFY_TQ and
            q.shape[-1] in HEAD_DIMS and k_pool.shape[1] % 8 == 0)


def _gather_ctx(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(P, ps, H, D) pool + (B, n) tables -> (B, n*ps, H, D) context.
    Table slots are clamped into the pool: padded slots may hold any id
    and are masked by the row's length."""
    b, n = tables.shape
    p, ps, h, d = pool.shape
    idx = tables.to(device=pool.device, dtype=torch.long).clamp(0, p - 1)
    return pool[idx].reshape(b, n * ps, h, d)


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return float(1.0 / math.sqrt(d) if sm_scale is None else sm_scale)


# ---------------------------------------------------------------------------
# the kernel's plain version and its wrapper
# ---------------------------------------------------------------------------

def paged_attention_plain(q, k_pool, v_pool, tables, lens,
                          sm_scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain PyTorch: the unnormalized
    ``acc (B, H, Tq, D)``, running max ``m (B, H, Tq)`` and sum
    ``l (B, H, Tq)`` over each row's cached context, all float32. Table
    slots are clamped into the pool and lens capped at the table's
    capacity; a row with no context gives ``m = NEG_INF``, ``l = 0``,
    ``acc = 0``."""
    b, tq, h, d = q.shape
    ps = k_pool.shape[1]
    s_len = tables.shape[1] * ps
    scale = _scale(d, sm_scale)
    kc = _gather_ctx(k_pool, tables).float()                 # (B, S, H, D)
    vc = _gather_ctx(v_pool, tables).float()
    lens = lens.to(device=q.device, dtype=torch.long).clamp(max=s_len)
    s = torch.einsum("bqhd,bshd->bhqs", q.float() * scale, kc)
    cols = torch.arange(s_len, device=q.device)
    s = torch.where(cols[None, None, None, :] < lens[:, None, None, None],
                    s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * (s > NEG_INF * 0.5)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqs,bshd->bhqd", p, vc)
    return acc, m, l


def paged_attention_split_plain(q, k_pool, v_pool, tables, lens, splits: int,
                                sm_scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The split route's plan in plain PyTorch: each row's
    ``ceil(len / page_size)`` pages cut into ``splits`` runs of
    ``ceil(pages / splits)`` whole pages (the last ones short or empty); per
    split the max ``m_s``, sum ``l_s`` and unnormalized ``acc_s`` of the
    split's keys (an empty split gives ``NEG_INF``, 0, 0); the splits
    merged in the order 0..splits-1 with ``alpha_s = exp(m_s - m)``.
    Returns ``(acc, m, l)`` as :func:`paged_attention_plain` defines
    them. Used by the tests."""
    if splits < 1:
        raise ValueError(f"paged_attention: {splits} splits")
    b, tq, h, d = q.shape
    ps = k_pool.shape[1]
    s_len = tables.shape[1] * ps
    scale = _scale(d, sm_scale)
    kc = _gather_ctx(k_pool, tables).float()                 # (B, S, H, D)
    vc = _gather_ctx(v_pool, tables).float()
    lens = lens.to(device=q.device, dtype=torch.long).clamp(0, s_len)
    pages = (lens + ps - 1) // ps
    per_split = (pages + splits - 1) // splits
    s = torch.einsum("bqhd,bshd->bhqs", q.float() * scale, kc)
    cols = torch.arange(s_len, device=q.device)[None, :]
    parts = []
    for k in range(splits):
        lo = torch.minimum(k * per_split * ps, lens)[:, None]
        hi = torch.minimum((k + 1) * per_split * ps, lens)[:, None]
        mine = (cols >= lo) & (cols < hi)                     # (B, S)
        sk = torch.where(mine[:, None, None, :], s,
                         torch.full_like(s, NEG_INF))
        mk = sk.amax(dim=-1)
        pk = torch.exp(sk - mk[..., None]) * (sk > NEG_INF * 0.5)
        parts.append((mk, pk.sum(dim=-1),
                      torch.einsum("bhqs,bshd->bhqd", pk, vc)))
    m = torch.stack([mk for mk, _, _ in parts]).amax(dim=0)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for mk, lk, acck in parts:
        alpha = torch.exp(mk - m)
        acc = acc + alpha[..., None] * acck
        l = l + alpha * lk
    return acc, m, l


def paged_route(dtype, d: int, aligned: bool) -> str:
    """The kernel route for pools of ``dtype`` at head dim ``d``:
    ``"split"`` when q and both pools start on 16-byte boundaries (the
    split kernel's ``cp.async`` copies need it), else ``"simple"``.
    ValueError for a type or head dim that neither kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16) or d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: pools {dtype}, "
                         f"head dim {d}")
    return "split" if aligned else "simple"


def paged_splits(b: int, h: int, width: int, page_size: int,
                 sm_count: int) -> int:
    """Context splits a row for the split route, from shapes only (the
    host never reads ``lens``): the most that keep the ``b * h * splits``
    blocks within :data:`SPLIT_BLOCKS_PER_SM` blocks an SM (a partial
    second wave costs more than a few idle slots), 1 when ``b * h``
    blocks already reach that, and never more than the table's ``width``
    pages (each split at least one page) or than leave a full table's
    split fewer than :data:`MIN_SPLIT_KEYS` keys."""
    fill = SPLIT_BLOCKS_PER_SM * sm_count // max(1, b * h)
    cap = min(width, width * page_size // MIN_SPLIT_KEYS)
    return max(1, min(fill, cap))


def route_splits(dtype, b: int, tq: int, h: int, d: int, page_size: int,
                 width: int, sm_count: int) -> int:
    """The splits a row a split-route launch takes: the tuning DB's row
    for this card, shape and pool dtype (``tuner.resolve`` of
    ``paged_split``), else :func:`paged_splits`."""
    return resolve_splits(PAGED_SPLIT_KERNEL, dtype,
                          paged_split_dims(b, h, d, page_size, width, tq),
                          paged_splits(b, h, width, page_size, sm_count))


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded build of
    ``csrc/paged_attention.cu``."""
    fn = lib.paged_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.paged_attention_split_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, with nvcc) and load the kernel library. The
    decode executor calls this when it is made, so no build happens inside
    a serving step's deadline."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(_build.load("paged_attention"))
        return _lib


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


_SMS: dict = {}


def _sm_count(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def paged_attention(q, k_pool, v_pool, tables, lens,
                    sm_scale: Optional[float] = None,
                    route: Optional[str] = None,
                    splits: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' wrapper: ``(acc, m, l)`` as :func:`paged_attention_plain`
    defines them. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/paged_attention.cu`` on the current stream, or raise. The call
    goes through the registered op :data:`PAGED_OP`, so a traced step holds
    it as one node.

    route: None (the route :func:`paged_route` names), ``"split"`` (raises
    where q or a pool is off a 16-byte boundary) or ``"simple"``. splits:
    the split route's splits a row, None for :func:`route_splits`."""
    if route not in (None, "split", "simple"):
        raise ValueError(f"paged_attention: unknown route {route!r}")
    return PAGED_OP(q, k_pool, v_pool, tables, lens,
                    _scale(q.shape[-1], sm_scale), route,
                    None if splits is None else int(splits))


# a plain library op (no autograd: the kernel's callers run under no_grad):
# the dispatcher calls the body directly, at a fraction of a
# ``custom_op``'s host cost a call
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("paged_attention(Tensor q, Tensor k_pool, Tensor v_pool, "
            "Tensor tables, Tensor lens, float sm_scale, str? route, "
            "int? splits) -> (Tensor, Tensor, Tensor)")


@torch.library.register_fake("paddle_tpu_torch::paged_attention", lib=_LIB)
def _(q, k_pool, v_pool, tables, lens, sm_scale, route, splits):
    b, tq, h, d = q.shape
    f32 = torch.float32
    return (q.new_empty((b, h, tq, d), dtype=f32),
            q.new_empty((b, h, tq), dtype=f32),
            q.new_empty((b, h, tq), dtype=f32))


#: ``torch.ops.paddle_tpu_torch.paged_attention``
PAGED_OP = torch.ops.paddle_tpu_torch.paged_attention


def _paged_attention(q, k_pool, v_pool, tables, lens, sm_scale, route,
                     splits):
    """The body of :data:`PAGED_OP` (the route checked by
    :func:`paged_attention`; ``sm_scale`` resolved)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, lens,
                                     sm_scale)
    b, tq, h, d = q.shape
    num_pages, ps = k_pool.shape[:2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if not paged_decode_supported(q, k_pool):
        raise ValueError("paged_attention kernel: unsupported shape "
                         f"q={tuple(q.shape)} pool={tuple(k_pool.shape)}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
        if t.shape != (num_pages, ps, h, d):
            raise ValueError(f"paged_attention: {name} shape "
                             f"{tuple(t.shape)} != {(num_pages, ps, h, d)}")
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != k_pool.dtype:
            raise ValueError("paged_attention: pools must both be float32 "
                             "or both bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if tables.dim() != 2 or tables.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} / "
                         f"lens {tuple(lens.shape)} do not match batch {b}")
    width = tables.shape[1]
    qf = q.to(torch.float32).contiguous()
    aligned = _aligned(qf, k_pool, v_pool)
    picked = paged_route(k_pool.dtype, d, aligned)
    if route == "split" and not aligned:
        raise ValueError("paged_attention split route: q and the pools must "
                         "start on 16-byte boundaries")
    route = route or picked
    if route == "split":
        n_split = (route_splits(k_pool.dtype, b, tq, h, d, ps, width,
                                _sm_count(dev))
                   if splits is None else int(splits))
        if n_split < 1:
            raise ValueError(f"paged_attention: {n_split} splits")
    elif splits is not None:
        raise ValueError("paged_attention: splits apply to the split route")
    tab = tables.to(device=dev, dtype=torch.int32).contiguous()
    ln = lens.to(device=dev, dtype=torch.int32).contiguous()
    acc = torch.empty((b, h, tq, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    if b == 0:
        return acc, m, l
    lib = load_kernel()
    ptrs = (qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tab.data_ptr(), ln.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr())
    bf16 = int(k_pool.dtype == torch.bfloat16)
    scale = _scale(d, sm_scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "split":
            ws = (torch.empty((b, h, n_split, tq, d + 2), dtype=torch.float32,
                              device=dev) if n_split > 1 else None)
            err = lib.paged_attention_split_fwd(
                *ptrs, None if ws is None else ws.data_ptr(), b, tq, h, d,
                num_pages, ps, width, bf16, n_split, scale, stream)
        else:
            err = lib.paged_attention_fwd(
                *ptrs, b, tq, h, d, num_pages, ps, width, bf16, scale,
                stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention {route} kernel launch failed: "
                           f"{msg} (cudaError {err})")
    key = "decode" if tq == 1 else "verify"
    with _launch_lock:
        LAUNCHES[key] += 1
        ROUTES[f"{key}_{route}"] += 1
        if route == "split":
            SPLITS[(key, n_split)] += 1
    return acc, m, l


_LIB.impl("paged_attention", _paged_attention, "CompositeExplicitAutograd")


# ---------------------------------------------------------------------------
# epilogue and gather paths
# ---------------------------------------------------------------------------

def _causal(tq: int, device) -> torch.Tensor:
    return torch.ones(tq, tq, dtype=torch.bool, device=device).tril()


def _finish(q, acc, m, l, k_new, v_new, sm_scale: float) -> torch.Tensor:
    """Fold the chunk tokens' causal self-attention term into the kernel's
    stats and normalize: (acc, m, l) + (k_new, v_new) -> (B, Tq, H, D)."""
    tq = q.shape[1]
    if k_new is None:
        out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    else:
        s_self = torch.einsum("bqhd,buhd->bhqu", q.float() * sm_scale,
                              k_new.float())                # (B, H, Tq, Tq)
        s_self = torch.where(_causal(tq, q.device), s_self,
                             torch.full_like(s_self, NEG_INF))
        m2 = torch.maximum(m, s_self.amax(dim=-1))
        alpha = torch.exp(m - m2)      # finite NEG_INF -> underflows to 0
        p_self = torch.exp(s_self - m2[..., None]) * (s_self > NEG_INF * 0.5)
        l2 = l * alpha + p_self.sum(dim=-1)
        out = (acc * alpha[..., None] +
               torch.einsum("bhqu,buhd->bhqd", p_self, v_new.float())
               ) / l2[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _gather_paged_decode(q, k_pool, v_pool, tables, lens, k_new, v_new,
                         sm_scale: float) -> torch.Tensor:
    """The JAX package's XLA gather baseline, in PyTorch."""
    tq = q.shape[1]
    kc = _gather_ctx(k_pool, tables).float()                 # (B, S, H, D)
    vc = _gather_ctx(v_pool, tables).float()
    s_len = kc.shape[1]
    qf = q.float() * sm_scale
    s_ctx = torch.einsum("bqhd,bshd->bhqs", qf, kc)
    cols = torch.arange(s_len, device=q.device)
    lens = lens.to(device=q.device, dtype=torch.long)
    s_ctx = torch.where(cols[None, None, None, :] < lens[:, None, None, None],
                        s_ctx, torch.full_like(s_ctx, NEG_INF))
    if k_new is not None:
        s_new = torch.einsum("bqhd,buhd->bhqu", qf, k_new.float())
        s_new = torch.where(_causal(tq, q.device), s_new,
                            torch.full_like(s_new, NEG_INF))
        s = torch.cat([s_ctx, s_new], dim=-1)
    else:
        s = s_ctx
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (s > NEG_INF * 0.5)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqs,bshd->bqhd", p[..., :s_len], vc)
    if v_new is not None:
        out = out + torch.einsum("bhqu,buhd->bqhd", p[..., s_len:],
                                 v_new.float())
    return out.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           k_new=None, v_new=None, sm_scale=None,
                           kernel: str = "auto", q_pad=None) -> torch.Tensor:
    """Decode attention through a block table.

    q: (B, Tq, H, D) queries of the chunk tokens (Tq == 1 for a decode
    step; a speculative-verify window or a uniform prefill chunk has
    Tq > 1 and every query attends the full cached context plus the
    chunk's earlier tokens causally). k_pool/v_pool: (P, page_size, H, D).
    block_tables: (B, W) page ids (padded slots may hold any value; only
    the first ceil(len/page_size) are read). context_lens: (B,) cached
    tokens per row. k_new/v_new: optional (B, Tq, H, D) K/V of the chunk
    tokens themselves, not yet written to the pool.

    kernel: ``"auto"`` (the kernel where its gate allows, else the gather
    path), ``"gather"``, or ``"kernel"`` (raises on a shape the gate
    rejects). q_pad: kept for signature parity with the JAX package, where
    it picks the TPU kernel's sublane padding; it has no effect here.
    """
    del q_pad
    if kernel not in ("auto", "gather", "kernel"):
        raise ValueError(f"unknown kernel {kernel!r}")
    scale = _scale(q.shape[-1], sm_scale)
    supported = paged_decode_supported(q, k_pool)
    if kernel == "kernel" and not supported:
        raise ValueError("paged attention kernel unsupported for this "
                         f"shape: q={tuple(q.shape)} "
                         f"pool={tuple(k_pool.shape)}")
    if kernel == "kernel" or (kernel == "auto" and supported):
        acc, m, l = paged_attention(q, k_pool, v_pool, block_tables,
                                    context_lens, scale)
        return _finish(q, acc, m, l, k_new, v_new, scale)
    if kernel == "auto":
        record_fallback("paged_attention")
    return _gather_paged_decode(q, k_pool, v_pool, block_tables,
                                context_lens, k_new, v_new, scale)


def paged_prefill_attention(q, k_new, v_new, row_id, positions, valid,
                            k_pool, v_pool, block_tables, context_lens,
                            sm_scale=None) -> torch.Tensor:
    """Ragged mixed-batch attention: prefill chunks and decode steps
    flattened onto one token axis.

    q/k_new/v_new: (T, H, D), the chunk tokens of all rows concatenated.
    row_id: (T,) batch row of each token; positions: (T,) absolute
    position in its sequence; valid: (T,) 1 for real tokens. block_tables:
    (R, W); context_lens: (R,). Each token attends to its row's cached
    context plus same-row chunk tokens at positions <= its own. Returns
    (T, H, D).
    """
    d = q.shape[-1]
    scale = _scale(d, sm_scale)
    dev = q.device
    row_id = row_id.to(device=dev, dtype=torch.long)
    positions = positions.to(device=dev, dtype=torch.long)
    valid = valid.to(device=dev)
    kc = _gather_ctx(k_pool, block_tables).float()           # (R, S, H, D)
    vc = _gather_ctx(v_pool, block_tables).float()
    s_len = kc.shape[1]
    kct = kc[row_id]                                         # (T, S, H, D)
    vct = vc[row_id]
    qf = q.float() * scale
    s_ctx = torch.einsum("thd,tshd->ths", qf, kct)           # (T, H, S)
    cols = torch.arange(s_len, device=dev)
    ctx_len_t = context_lens.to(device=dev, dtype=torch.long)[row_id]
    s_ctx = torch.where(cols[None, None, :] < ctx_len_t[:, None, None],
                        s_ctx, torch.full_like(s_ctx, NEG_INF))
    s_new = torch.einsum("thd,uhd->thu", qf, k_new.float())  # (T, H, T)
    ok = ((row_id[:, None] == row_id[None, :]) &
          (positions[None, :] <= positions[:, None]) &
          (valid[None, :] > 0))
    s_new = torch.where(ok[:, None, :], s_new, torch.full_like(s_new, NEG_INF))
    s = torch.cat([s_ctx, s_new], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (s > NEG_INF * 0.5)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    out = (torch.einsum("ths,tshd->thd", p[..., :s_len], vct) +
           torch.einsum("thu,uhd->thd", p[..., s_len:], v_new.float()))
    return out.to(q.dtype)
