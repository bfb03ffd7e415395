"""Fused LM-head cross entropy: the three Hopper kernels, their plain
PyTorch versions, and the ``torch.autograd.Function`` that reaches them.

Port of ``paddle_tpu/ops/pallas/fused_ce.py``. Public API:
``fused_lm_ce(hidden, weight, labels, block_tokens=None, block_vocab=None,
ignore_index=-100, interpret=None)``: hidden ``(..., H)``, weight ``(H, V)``,
labels ``(...)``; the mean float32 softmax cross entropy of
``hidden @ weight`` over the labels that are not ``ignore_index``, with
gradients to hidden and weight. The ``(tokens, vocab)`` logits never reach
device memory.

- **The kernels** are ``csrc/fused_ce.cu`` for ``sm_90a``: ``ce_fwd``
  (per-token lse and target logit by an online logsumexp over vocab tiles),
  ``ce_dh`` and ``ce_dw`` (the two gradients, each recomputing its logits
  tiles), replacing the TPU's ``_ce_fwd_kernel``, ``_ce_bwd_dh_kernel`` and
  ``_ce_bwd_dw_kernel``. Logits are float32; on bfloat16 inputs the
  products run on the tensor cores (exact bfloat16 products, float32 sums),
  on float32 inputs as float32 FMAs. ``weight`` is read through its
  strides, so the tied head's ``embedding.weight.T`` needs no copy; ``dw``
  is written as a ``(V, H)`` buffer and returned as its ``(H, V)`` view.
- **Two forward routes**, chosen by :func:`fwd_route` from the dtype and
  H alone: ``"tiled"`` (bfloat16 at any H that is a multiple of 64: an
  ``mma.sync`` GEMM over token tiles x vocab splits, the online
  logsumexp on its accumulators, the splits merged in order by a second
  kernel) and ``"staged"`` (float32 and every other H: the first design).
  The split count is the tuning DB's row for the card and shape
  (:func:`tiled_splits`, measured by ``python -m
  paddle_tpu_torch.ops.tuner``), else the :func:`fwd_splits` formula;
  ``SPLITS`` counts tiled launches by the count they took. A count changes
  the float32 summation order of ``lse``, not its bar.
- **Two backward routes**, chosen by :func:`bwd_route` from the dtype and
  H alone: ``"tiled"`` (bfloat16 at H in :data:`TILED_HIDDEN`: own rows
  resident, each streamed tile read once by ``cp.async``, the sums in
  registers) and ``"staged"`` (everything else up to
  :data:`STAGED_MAX_HIDDEN`: the first design, sums in shared memory).
  ``ROUTES`` counts the launches of each route, forward and backward.
- **The plain versions** :func:`fused_ce_plain_fwd`,
  :func:`fused_ce_plain_dh` and :func:`fused_ce_plain_dw` compute the same
  over the full float32 logits; :func:`fused_ce_plain_fwd_split` models
  the tiled forward's split-and-merge in float32.
- **Dispatch.** :func:`ce_fwd`, :func:`ce_dh` and :func:`ce_dw` take the
  plain versions only for tensors on the CPU; on a CUDA tensor they launch
  the kernels or raise. ``LAUNCHES`` counts launches per kernel. The gate
  :func:`fused_ce_supported` (:func:`fused_ce_gate` on device type, dtypes
  and H) admits only what the kernels take, so a caller can send the rest
  to the chunked path.
- **Host epilogue**, as the reference's ``_ce_fwd``: ``valid = labels !=
  ignore_index``, ``loss = sum(valid * (lse - tgt)) / max(sum(valid), 1)``;
  the backward scale ``g * valid / denom`` makes ignored rows exact zeros.
- **Blocks.** ``block_tokens``/``block_vocab`` resolve from the tuning-DB
  rows (``ops/tuner.py``) and are clamped as the reference does
  (:func:`resolve_blocks`), but they change no result: the kernels' own
  tiles are fixed by the card's shared memory.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build
from .tuner import CE_SPLIT_KERNEL, ce_dims, resolve, resolve_splits

__all__ = ["DEFAULT_BLOCK_TOKENS", "DEFAULT_BLOCK_VOCAB", "LANES", "LAUNCHES",
           "ROUTES", "STAGED_MAX_HIDDEN", "TILED_HIDDEN", "bwd_route",
           "fwd_route", "fwd_splits", "tiled_splits", "SPLITS",
           "fused_lm_ce", "fused_ce_gate",
           "fused_ce_supported", "resolve_blocks", "ce_fwd",
           "ce_dh", "ce_dw", "fused_ce_plain_fwd", "fused_ce_plain_fwd_split",
           "fused_ce_plain_dh", "fused_ce_plain_dw", "load_kernel",
           "max_hidden"]

# the reference's interpret-validated defaults (a DB miss resolves to them)
DEFAULT_BLOCK_TOKENS = 256
DEFAULT_BLOCK_VOCAB = 1024
LANES = 128
# the reference's finite mask value (paddle_tpu/ops/pallas/flash_attention.py)
NEG_INF = -1e30

LAUNCHES = {"ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}
ROUTES = {"ce_fwd_tiled": 0, "ce_fwd_staged": 0, "ce_dh_tiled": 0,
          "ce_dh_staged": 0, "ce_dw_tiled": 0, "ce_dw_staged": 0}
# tiled forward launches by the vocab splits they took
SPLITS: "collections.Counter[int]" = collections.Counter()
_launch_lock = threading.Lock()

# the H the tiled backward kernel is instantiated for (bfloat16 only)
TILED_HIDDEN = (768, 1024)
# the tiled forward's tiles (csrc/fused_ce.cu FT_BT, FT_BV, FT_KC): tokens
# a block, vocab columns a tile, the H chunk (H must be a multiple of it)
FWD_TILE_TOKENS, FWD_TILE_VOCAB, FWD_CHUNK = 128, 128, 64
# the split rule: blocks an SM holds (the kernel's launch bounds and shared
# memory give two), and the fewest vocab tiles a split may have, so that a
# small vocabulary is not cut into splits that each hold a few columns
FWD_BLOCKS_PER_SM = 2
FWD_MIN_SPLIT_TILES = 4
# the largest H (a multiple of 64) whose float32 sums of 16 rows fit a
# block's shared memory in the staged backward kernels; the library's
# fused_ce_max_hidden reports the same numbers
STAGED_MAX_HIDDEN = {torch.bfloat16: 2816, torch.float32: 2496}


def fused_ce_gate(device_type: str, dtype, h: int, weight_dtype) -> bool:
    """What the kernels take, from the device type, the hidden states'
    dtype, H and the weight's dtype alone: a CUDA tensor of a dtype that
    :func:`bwd_route` takes, H at most :func:`max_hidden`, and a weight of
    the same dtype."""
    return (device_type == "cuda" and dtype in STAGED_MAX_HIDDEN and
            h <= max_hidden(dtype) and weight_dtype == dtype)


def fused_ce_supported(t: torch.Tensor, weight: torch.Tensor) -> bool:
    """The kernels' gate: :func:`fused_ce_gate` on the hidden states ``t``
    (..., H) and the (H, V) weight. What it rejects goes to the caller's
    chunked path."""
    return fused_ce_gate(t.device.type, t.dtype, t.shape[-1], weight.dtype)


def _clamp_blocks(n, v, block_tokens, block_vocab):
    """The reference's clamp: token blocks on the sublane quantum (8),
    vocab blocks on the lane quantum (128), no larger than the problem."""
    bt = max(8, min(int(block_tokens), int(-(-n // 8) * 8)))
    bt = (bt // 8) * 8
    bv = max(LANES, min(int(block_vocab), int(-(-v // LANES) * LANES)))
    bv = (bv // LANES) * LANES
    return bt, bv


def resolve_blocks(dtype, n: int, h: int, v: int,
                   block_tokens: Optional[int] = None,
                   block_vocab: Optional[int] = None) -> Tuple[int, int]:
    """The reference's effective (block_tokens, block_vocab) for a call:
    explicit values, else the tuning-DB row (defaults on a miss), then
    clamped. The port's kernels do not read them."""
    if block_tokens is None or block_vocab is None:
        cfg, _ = resolve("fused_ce", dtype, ce_dims(h, v, n),
                         {"block_tokens": DEFAULT_BLOCK_TOKENS,
                          "block_vocab": DEFAULT_BLOCK_VOCAB})
        block_tokens = block_tokens or cfg["block_tokens"]
        block_vocab = block_vocab or cfg["block_vocab"]
    return _clamp_blocks(n, v, block_tokens, block_vocab)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _logits(hid, w):
    return hid.float() @ w.float()


def _in_vocab(lbl, v):
    return (lbl >= 0) & (lbl < v)


def fused_ce_plain_fwd(hid, w, labels):
    """What ``ce_fwd`` computes, over the full float32 logits: per-token
    ``lse`` and target logit ``tgt`` (0 for a label outside [0, V)), both
    (N,) float32."""
    logits = _logits(hid, w)
    v = logits.shape[1]
    m = logits.amax(dim=1, keepdim=True)
    s = torch.exp(logits - m).sum(dim=1)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    lse = m[:, 0] + torch.log(s)
    lbl = labels.long()
    ok = _in_vocab(lbl, v)
    picked = logits.gather(1, torch.where(ok, lbl, 0)[:, None])[:, 0]
    return lse, torch.where(ok, picked, torch.zeros_like(picked))


def fused_ce_plain_fwd_split(hid, w, labels, splits):
    """What the tiled forward computes, in its order, over float32 logits:
    the vocabulary cut into ``splits`` runs of whole
    :data:`FWD_TILE_VOCAB`-column tiles as the kernel's grid cuts it; per
    split the max ``m``, the sum ``s`` of ``exp(x - m)`` and the
    label's logit ``t``; the splits merged in increasing order. Returns
    ``(lse, tgt)`` as :func:`fused_ce_plain_fwd` defines them."""
    logits = _logits(hid, w)
    n, v = logits.shape
    tiles = -(-v // FWD_TILE_VOCAB)
    if not 1 <= splits <= tiles:
        raise ValueError(f"fused_ce: {splits} splits of {tiles} vocab tiles")
    lbl = labels.long()
    ok = _in_vocab(lbl, v)
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=logits.device)
    s = torch.zeros_like(m)
    tgt = torch.zeros_like(m)
    for k in range(splits):
        lo = k * tiles // splits * FWD_TILE_VOCAB
        hi = min((k + 1) * tiles // splits * FWD_TILE_VOCAB, v)
        x = logits[:, lo:hi]
        mk = x.amax(dim=1)
        sk = torch.exp(x - mk[:, None]).sum(dim=1)
        hit = ok & (lbl >= lo) & (lbl < hi)
        tk = x.gather(1, torch.where(hit, lbl - lo, 0)[:, None])[:, 0]
        m_new = torch.maximum(m, mk)
        s = s * torch.exp(m - m_new) + sk * torch.exp(mk - m_new)
        m = m_new
        tgt = tgt + torch.where(hit, tk, torch.zeros_like(tk))
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return m + torch.log(s), tgt


def _plain_dl(logits, labels, lse, scale):
    """d loss / d logits = (softmax - onehot) * scale, (N, V) float32."""
    v = logits.shape[1]
    lbl = labels.long()
    p = torch.exp(logits - lse.float()[:, None])
    cols = torch.arange(v, device=logits.device)
    onehot = (cols[None, :] == lbl[:, None]) & _in_vocab(lbl, v)[:, None]
    return (p - onehot.float()) * scale.float()[:, None]


def fused_ce_plain_dh(hid, w, labels, lse, scale):
    """What ``ce_dh`` computes: ``dl @ w^T`` in hid's dtype."""
    dl = _plain_dl(_logits(hid, w), labels, lse, scale)
    return (dl @ w.float().T).to(hid.dtype)


def fused_ce_plain_dw(hid, w, labels, lse, scale):
    """What ``ce_dw`` computes: ``hid^T @ dl`` in w's dtype, (H, V)."""
    dl = _plain_dl(_logits(hid, w), labels, lse, scale)
    return (hid.float().T @ dl).to(w.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, with nvcc) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("fused_ce")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            head = [p, p, ll, ll, p]
            tail = [i, i, i, i, p]
            lib.fused_ce_fwd.argtypes = head + [p, p] + tail
            lib.fused_ce_dh.argtypes = head + [p, p, p] + tail
            lib.fused_ce_dw.argtypes = head + [p, p, p] + tail
            lib.fused_ce_dh_tiled.argtypes = head + [p, p, p] + tail
            lib.fused_ce_dw_tiled.argtypes = head + [p, p, p] + tail
            lib.fused_ce_fwd_tiled.argtypes = \
                head + [p, p, p] + [i, i, i, i, i, p]
            for fn in (lib.fused_ce_fwd, lib.fused_ce_dh, lib.fused_ce_dw,
                       lib.fused_ce_dh_tiled, lib.fused_ce_dw_tiled,
                       lib.fused_ce_fwd_tiled):
                fn.restype = ctypes.c_int
            lib.fused_ce_max_hidden.argtypes = [ctypes.c_int]
            lib.fused_ce_max_hidden.restype = ctypes.c_int
            lib.fused_ce_error_string.argtypes = [ctypes.c_int]
            lib.fused_ce_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def bwd_route(dtype, h: int) -> str:
    """The backward route for inputs of ``dtype`` and hidden size ``h``:
    ``"tiled"`` for bfloat16 at an H of :data:`TILED_HIDDEN`, else
    ``"staged"`` up to :data:`STAGED_MAX_HIDDEN`; past that, ValueError."""
    if dtype not in STAGED_MAX_HIDDEN:
        raise ValueError(f"fused_ce kernel: dtype {dtype}")
    if dtype == torch.bfloat16 and h in TILED_HIDDEN:
        return "tiled"
    if h <= STAGED_MAX_HIDDEN[dtype]:
        return "staged"
    raise ValueError(f"fused_ce kernel: H {h} > {max_hidden(dtype)}")


def fwd_route(dtype, h: int) -> str:
    """The forward route for inputs of ``dtype`` and hidden size ``h``:
    ``"tiled"`` for bfloat16 at an H that is a multiple of
    :data:`FWD_CHUNK`, ``"staged"`` for float32 and every other H;
    ValueError for any other dtype."""
    if dtype not in STAGED_MAX_HIDDEN:
        raise ValueError(f"fused_ce kernel: dtype {dtype}")
    if dtype == torch.bfloat16 and h > 0 and h % FWD_CHUNK == 0:
        return "tiled"
    return "staged"


def fwd_splits(n: int, v: int, sms: int) -> int:
    """The tiled forward's vocab splits for N tokens, V columns and a card
    of ``sms`` SMs: as many as keep the grid (token tiles x splits) within
    one wave of :data:`FWD_BLOCKS_PER_SM` blocks an SM, at least 1, and no
    more than leave each split :data:`FWD_MIN_SPLIT_TILES` vocab tiles (so
    none is empty)."""
    token_tiles = -(-n // FWD_TILE_TOKENS)
    vocab_tiles = -(-v // FWD_TILE_VOCAB)
    fill = FWD_BLOCKS_PER_SM * sms // max(token_tiles, 1)
    return max(1, min(fill, vocab_tiles // FWD_MIN_SPLIT_TILES))


def tiled_splits(dtype, n: int, h: int, v: int, sms: int) -> int:
    """The vocab splits a tiled forward launch takes: the tuning DB's row
    for this card, shape and dtype (``tuner.resolve`` of
    ``fused_ce_fwd_tiled``), else :func:`fwd_splits`."""
    return resolve_splits(CE_SPLIT_KERNEL, dtype, ce_dims(h, v, n),
                          fwd_splits(n, v, sms))


def max_hidden(dtype) -> int:
    """The largest H the backward kernels take, over both routes."""
    tiled = max(TILED_HIDDEN) if dtype == torch.bfloat16 else 0
    return max(STAGED_MAX_HIDDEN[dtype], tiled)


def _check(hid, w, labels):
    dev = hid.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {dev}")
    if hid.dim() != 2 or w.dim() != 2 or w.shape[0] != hid.shape[1]:
        raise ValueError(f"fused_ce: hid {tuple(hid.shape)} and w "
                         f"{tuple(w.shape)} are not (N, H) and (H, V)")
    if hid.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ce kernel: dtype {hid.dtype}")
    if w.dtype != hid.dtype:
        raise ValueError(f"fused_ce kernel: w is {w.dtype}, hid is "
                         f"{hid.dtype}")
    for name, t in (("w", w), ("labels", labels)):
        if t.device != dev:
            raise ValueError(f"fused_ce: {name} on {t.device}, hid on {dev}")
    if labels.shape != hid.shape[:1]:
        raise ValueError("fused_ce: labels do not match hid's rows")
    bwd_route(hid.dtype, hid.shape[1])       # raises past both routes' H
    return hid.contiguous(), labels.to(torch.int32).contiguous()


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.fused_ce_error_string(err).decode()
        raise RuntimeError(f"fused_ce {what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def _count(key, route=None, splits=None):
    with _launch_lock:
        LAUNCHES[key] += 1
        if route is not None:
            ROUTES[f"{key}_{route}"] += 1
        if splits is not None:
            SPLITS[splits] += 1


def _aligned(t):
    return t.data_ptr() % 16 == 0


def _tiled_operands(hid, w):
    """hid and w as the tiled kernel reads them: w with H the unit stride
    (the tied ``.T`` view already is; a contiguous (H, V) w is copied to
    that layout), rows on 16-byte boundaries for cp.async. A misaligned
    tensor raises."""
    if w.stride(0) != 1:
        w = w.T.contiguous().T
    if not (_aligned(hid) and _aligned(w) and w.stride(1) % 8 == 0):
        raise ValueError("fused_ce tiled kernel: hid and w must start on "
                         "16-byte boundaries with rows a multiple of 8 "
                         "elements apart")
    return hid, w


def _launch(entry, key, hid, w, lbl, extra, route=None, ints=(),
            splits=None):
    n, h = hid.shape
    v = w.shape[1]
    lib = load_kernel()
    with torch.cuda.device(hid.device):
        stream = torch.cuda.current_stream(hid.device).cuda_stream
        err = getattr(lib, entry)(
            hid.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
            lbl.data_ptr(), *[t.data_ptr() for t in extra], n, h, v,
            int(hid.dtype == torch.bfloat16), *ints, stream)
    _raise_on(lib, err, key)
    _count(key, route, splits)


def ce_fwd(hid, w, labels, splits: Optional[int] = None):
    """The forward kernel's wrapper: ``(lse, tgt)`` as
    :func:`fused_ce_plain_fwd` defines them, on the route
    :func:`fwd_route` names. CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise. ``splits``: the tiled route's
    vocab splits, None for :func:`tiled_splits`."""
    if hid.device.type == "cpu":
        return fused_ce_plain_fwd(hid, w, labels)
    hid, lbl = _check(hid, w, labels)
    n, h = hid.shape
    v = w.shape[1]
    lse = torch.empty(n, dtype=torch.float32, device=hid.device)
    tgt = torch.empty(n, dtype=torch.float32, device=hid.device)
    if n and v:
        route = fwd_route(hid.dtype, h)
        if route == "tiled":
            hid, w = _tiled_operands(hid, w)
            if splits is None:
                splits = tiled_splits(hid.dtype, n, h, v,
                                      torch.cuda.get_device_properties(
                                          hid.device).multi_processor_count)
            splits = int(splits)
            if splits < 1:
                raise ValueError(f"fused_ce: {splits} vocab splits")
            work = torch.empty((3, splits, n), dtype=torch.float32,
                               device=hid.device)
            _launch("fused_ce_fwd_tiled", "ce_fwd", hid, w, lbl,
                    (lse, tgt, work), route, ints=(splits,), splits=splits)
        else:
            _launch("fused_ce_fwd", "ce_fwd", hid, w, lbl, (lse, tgt), route)
    else:
        lse.zero_()
        tgt.zero_()
    return lse, tgt


def _bwd(entry, key, plain, hid, w, labels, lse, scale):
    if hid.device.type == "cpu":
        return plain(hid, w, labels, lse, scale)
    hid, lbl = _check(hid, w, labels)
    n, h = hid.shape
    v = w.shape[1]
    lse = lse.to(device=hid.device, dtype=torch.float32).contiguous()
    scale = scale.to(device=hid.device, dtype=torch.float32).contiguous()
    if key == "ce_dh":
        out = torch.empty((n, h), dtype=hid.dtype, device=hid.device)
    else:   # written (V, H), handed back as its (H, V) view
        out = torch.empty((v, h), dtype=w.dtype, device=hid.device)
    if out.numel() == 0 or n == 0 or v == 0:
        out.zero_()
    else:
        route = bwd_route(hid.dtype, h)
        if route == "tiled":
            hid, w = _tiled_operands(hid, w)
            entry += "_tiled"
        _launch(entry, key, hid, w, lbl, (lse, scale, out), route)
    return out if key == "ce_dh" else out.T


def ce_dh(hid, w, labels, lse, scale):
    """The dh kernel's wrapper: (N, H) in hid's dtype, as
    :func:`fused_ce_plain_dh` defines it."""
    return _bwd("fused_ce_dh", "ce_dh", fused_ce_plain_dh, hid, w, labels,
                lse, scale)


def ce_dw(hid, w, labels, lse, scale):
    """The dw kernel's wrapper: (H, V) in w's dtype, as
    :func:`fused_ce_plain_dw` defines it (on the card, the ``.T`` view of
    a contiguous (V, H) buffer)."""
    return _bwd("fused_ce_dw", "ce_dw", fused_ce_plain_dw, hid, w, labels,
                lse, scale)


class _FusedCE(torch.autograd.Function):
    """loss = mean CE over valid labels; the backward runs the dh and dw
    kernels on the saved (hid, w, labels, lse)."""

    @staticmethod
    def forward(ctx, hid, w, lbl, ignore_index):
        lse, tgt = ce_fwd(hid, w, lbl)
        valid = (lbl != ignore_index).float()
        denom = valid.sum().clamp(min=1.0)
        loss = (valid * (lse - tgt)).sum() / denom
        ctx.save_for_backward(hid, w, lbl, lse, valid, denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        hid, w, lbl, lse, valid, denom = ctx.saved_tensors
        scale = (g.float() / denom) * valid
        dh = ce_dh(hid, w, lbl, lse, scale) \
            if ctx.needs_input_grad[0] else None
        dw = ce_dw(hid, w, lbl, lse, scale) \
            if ctx.needs_input_grad[1] else None
        return dh, dw, None, None


def fused_lm_ce(hidden, weight, labels, block_tokens=None, block_vocab=None,
                ignore_index=-100, interpret=None):
    """Fused LM-head softmax cross entropy (mean over valid labels).

    hidden: (..., H) activations; weight: (H, V) LM-head matrix (any
    strides); labels: (...) int targets (int32 or int64), ``ignore_index``
    entries excluded from the mean. Returns a 0-d float32 loss; gradients
    flow to hidden and weight. ``block_tokens``/``block_vocab`` resolve and
    clamp as the reference's (:func:`resolve_blocks`) and change no result;
    ``interpret`` is the reference's Pallas switch, accepted and ignored.
    """
    del interpret
    h = hidden.shape[-1]
    hid = hidden.reshape(-1, h)
    lbl = torch.as_tensor(labels).to(device=hid.device).reshape(-1)
    if weight.dim() != 2 or weight.shape[0] != h:
        raise ValueError(
            f"weight must be (H, V) with H={h}, got {tuple(weight.shape)}")
    if lbl.shape[0] != hid.shape[0]:
        raise ValueError(f"labels hold {lbl.shape[0]} entries for "
                         f"{hid.shape[0]} tokens")
    resolve_blocks(hid.dtype, hid.shape[0], h, weight.shape[1],
                   block_tokens, block_vocab)
    loss = _FusedCE.apply(hid, weight, lbl.to(torch.int32),
                          int(ignore_index))
    return loss
