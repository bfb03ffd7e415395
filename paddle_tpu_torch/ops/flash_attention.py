"""Flash attention: the three Hopper kernels, their plain PyTorch versions,
and the registered op (with its backward) that reaches them.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. Public API:
``flash_attention(q, k, v, causal=False, sm_scale=None, kv_lens=None,
dropout_rate=0.0, dropout_seed=None, block_q=None, block_k=None)`` with
q/k/v ``(batch, seq, heads, head_dim)``, as the JAX package has it.

- **The kernels** are ``csrc/flash_attention.cu``: a forward (out, lse), a
  dq kernel and a dk/dv kernel for ``sm_90a``, replacing the TPU's
  ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. They read
  q/k/v through their strides, so the non-contiguous views that the GPT
  QKV split makes need no copy and no ``(B*H, S, D)`` transpose. Ragged
  tails are masked, not padded.
- **Two routes for each kernel**, chosen by :func:`fwd_route` and
  :func:`bwd_route` from the dtype, the head dim and the rows' alignment
  alone: ``"mma"`` (bfloat16 at D in :data:`MMA_HEAD_DIMS`, rows on
  16-byte boundaries: tensor-core ``mma.sync`` with a ``cp.async`` ring;
  the forward rounds p to bfloat16 before P·V, the backward p and ds
  before the products they feed) and ``"scalar"`` (everything else:
  float32 FMAs). ``ROUTES`` counts the launches of each kernel on each
  route.
- **The plain versions** :func:`flash_attention_plain_fwd` and
  :func:`flash_attention_plain_bwd` are the same maths over the full
  ``S x S`` scores, with the same masks and the same dropout mask
  (:func:`dropout_mask`, a PyTorch copy of the reference's
  ``_dropout_mask``).
- **Dispatch.** :func:`flash_attention_fwd` and :func:`flash_attention_bwd`
  take the plain versions only for tensors on the CPU; on a CUDA tensor
  they launch the kernels or raise. ``LAUNCHES`` counts launches
  (``flash_fwd``, ``flash_dq``, ``flash_dkv``). The gate
  :func:`flash_supported` (:func:`flash_gate` on device type, dtype and
  shape) admits only what the kernels take, so a caller can send the rest
  to its plain path.
- **The registered op.** The forward is also the custom op
  ``paddle_tpu_torch::flash_attention_fwd`` (:data:`FLASH_FWD_OP`), so that
  ``torch.export`` carries it into an exported program: its fake
  implementation gives out and lse shapes from q alone (a symbolic batch
  stays symbolic), and its body is :func:`flash_attention_fwd`, which
  launches (and counts) at call time, never at trace time.
  :func:`flash_attention` reaches the kernel through the op alone: its
  registered autograd runs the backward kernels on the saved (q, k, v,
  out, lse), so one call serves training, inference and export.
  Under :func:`exporting` the gate takes CPU tensors as the card's, so a
  program exported on the CPU holds the same op as one exported on the
  card; the op's CPU body is the plain version.
- **Dropout keying.** The mask is keyed on the reference's blocks for the
  call: ``block_q``/``block_k`` resolved from the tuning DB rows
  (``ops/tuner.py``) and clamped as the reference clamps them on the
  128-padded lengths. The kernels' own tiles are free; the keying blocks
  only feed the hash.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build
from .tuner import flash_dims, resolve

__all__ = ["NEG_INF", "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K", "LANES",
           "HEAD_DIMS", "MMA_HEAD_DIMS", "KERNEL_DTYPES", "MAX_BATCH_HEADS",
           "LAUNCHES", "ROUTES", "flash_gate", "flash_supported", "fwd_route",
           "bwd_route",
           "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_plain_fwd", "flash_attention_plain_bwd",
           "dropout_mask", "keying_blocks", "load_kernel", "FLASH_FWD_OP",
           "exporting"]

# the reference's swept defaults (a miss in the tuning DB resolves to them)
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512
LANES = 128
NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the launch grid of the scalar and backward kernels has b*h as its y
MAX_BATCH_HEADS = 65535
# the head dims the tensor-core kernels are instantiated for (bfloat16 only)
MMA_HEAD_DIMS = (64, 128)

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
ROUTES = {f"{key}_{route}": 0 for key in LAUNCHES
          for route in ("mma", "scalar")}
_launch_lock = threading.Lock()

_MASK32 = 0xFFFFFFFF


def flash_gate(device_type: str, dtype, shape, min_seq: int = 128) -> bool:
    """What the kernels take, from the device type, q's dtype and q's
    shape alone: a CUDA tensor (B, S, H, D) with at least ``min_seq`` query
    positions, D in :data:`HEAD_DIMS`, a dtype of :data:`KERNEL_DTYPES` and
    B*H at most :data:`MAX_BATCH_HEADS`. Ragged sequence lengths are fine
    (the kernels mask the tail)."""
    if device_type != "cuda" or len(shape) != 4:
        return False
    b, s, h, d = shape
    return (s >= min_seq and d in HEAD_DIMS and dtype in KERNEL_DTYPES and
            b * h <= MAX_BATCH_HEADS)


_export_state = threading.local()


@contextlib.contextmanager
def exporting():
    """While a program is exported: :func:`flash_supported` reads a CPU
    tensor as the card's, so the exported graph holds the registered op on
    either device (its CPU body is the plain version)."""
    prev = getattr(_export_state, "on", False)
    _export_state.on = True
    try:
        yield
    finally:
        _export_state.on = prev


def flash_supported(q: torch.Tensor, k: torch.Tensor, min_seq: int = 128
                    ) -> bool:
    """The kernels' gate, shared by every caller: :func:`flash_gate` on
    q. What it rejects goes to the caller's plain path."""
    dev = q.device.type
    if dev == "cpu" and getattr(_export_state, "on", False):
        dev = "cuda"
    return flash_gate(dev, q.dtype, tuple(q.shape), min_seq)


def fwd_route(dtype, d: int, aligned: bool) -> str:
    """The forward's route: ``"mma"`` (the tensor-core kernel) for
    bfloat16 at a head dim of :data:`MMA_HEAD_DIMS` whose q/k/v rows start
    on 16-byte boundaries (``aligned``: base pointers and (b, s, h) strides),
    else ``"scalar"``."""
    if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS and aligned:
        return "mma"
    return "scalar"


def bwd_route(dtype, d: int, aligned: bool) -> str:
    """The backward's route, for the dq and the dk/dv kernel alike:
    ``"mma"`` (the tensor-core kernels) for bfloat16 at a head dim of
    :data:`MMA_HEAD_DIMS` whose q/k/v/do rows start on 16-byte boundaries
    (``aligned``), else ``"scalar"``: the forward's rule, with do's rows
    counted too."""
    return fwd_route(dtype, d, aligned)


# ---------------------------------------------------------------------------
# dropout keying
# ---------------------------------------------------------------------------

def _clamp(block: int, seq: int) -> int:
    """The reference's block clamp: LANES-aligned, the largest such block
    that divides ``seq``; below one lane tile the whole sequence."""
    if seq < LANES:
        return seq
    bb = (min(block, seq) // LANES) * LANES
    while bb > LANES and seq % bb:
        bb -= LANES
    return bb


def keying_blocks(dtype: torch.dtype, d: int, sq: int, sk: int,
                  block_q: Optional[int] = None,
                  block_k: Optional[int] = None) -> Tuple[int, int]:
    """The reference's effective (block_q, block_k) for a call: explicit
    values, else the tuning-DB lookup (defaults 256/512 on a miss), then
    clamped on the 128-padded lengths. They key the dropout mask."""
    if block_q is None or block_k is None:
        cfg, _ = resolve("flash_attention", dtype, flash_dims(d, sq, sk),
                         {"block_q": DEFAULT_BLOCK_Q,
                          "block_k": DEFAULT_BLOCK_K})
        block_q = block_q or cfg["block_q"]
        block_k = block_k or cfg["block_k"]
    sq_pad = -(-sq // LANES) * LANES
    sk_pad = -(-sk // LANES) * LANES
    return _clamp(int(block_q), sq_pad), _clamp(int(block_k), sk_pad)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32), without int64
    overflow: the product is split at 16 bits."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _threshold(rate: float) -> int:
    return int(min(rate, 1.0) * 4294967295.0) & _MASK32


def dropout_mask(rate: float, seed: int, bh: int, rows: torch.Tensor,
                 cols: torch.Tensor, block_q: int, block_k: int
                 ) -> torch.Tensor:
    """Inverted-dropout multiplier in {0, 1/(1-rate)} (float32) at GLOBAL
    positions ``rows[:, None]`` x ``cols[None, :]`` of head ``bh = b*H + h``:
    bit-equal to the reference's ``_dropout_mask`` with
    ``(iq, r) = divmod(row, block_q)`` and ``(ik, c) = divmod(col, block_k)``.
    ``bh`` may be an int or an int64 tensor broadcast against the grid."""
    rows = rows.to(torch.int64)
    cols = cols.to(torch.int64)
    iq, r = rows // block_q, rows % block_q
    ik, c = cols // block_k, cols % block_k
    bh = torch.as_tensor(bh, dtype=torch.int64, device=rows.device)
    seed = torch.as_tensor(int(seed) & _MASK32, dtype=torch.int64,
                           device=rows.device)
    h = (_mul32(seed, 2654435761) ^ _mul32(bh, 0x9E3779B1)
         ^ _mul32(iq, 0x85EBCA77)[:, None] ^ _mul32(ik, 0xC2B2AE3D)[None, :])
    h = h ^ _mul32(r, 0x27D4EB2F)[:, None] ^ ((c + 0x165667B1) & _MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    keep = h >= _threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(keep, scale.to(rows.device),
                       torch.zeros((), dtype=torch.float32,
                                   device=rows.device))


def _full_dropout_mask(b, h, sq, sk, rate, seed, blocks, device):
    """(B, H, Sq, Sk) multiplier of the whole call."""
    bh = torch.arange(b * h, dtype=torch.int64, device=device)
    m = dropout_mask(rate, seed, bh[:, None, None],
                     torch.arange(sq, device=device),
                     torch.arange(sk, device=device), *blocks)
    return m.reshape(b, h, sq, sk)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, lens, sm_scale, causal):
    """(B, H, Sq, Sk) float32 scores of (q*scale) k^T, masked with
    NEG_INF: columns >= lens[b] and, when causal, columns > row."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, k.float())
    rows = torch.arange(sq, device=q.device)
    cols = torch.arange(sk, device=q.device)
    ok = cols[None, :] < lens.to(device=q.device, dtype=torch.long)[:, None]
    ok = ok[:, None, None, :]
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])[None, None]
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def _lens(lens, b, sk, device):
    if lens is None:
        return torch.full((b,), sk, dtype=torch.int32, device=device)
    return lens.to(device=device, dtype=torch.int32).reshape(b).clamp(0, sk)


def flash_attention_plain_fwd(q, k, v, lens=None, seed=0, sm_scale=None,
                              causal=False, dropout_rate=0.0,
                              blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """What the forward kernel computes, over the full S x S scores:
    ``out`` (B, Sq, H, D) in q's dtype and ``lse`` (B, H, Sq) float32. A row
    with no visible key gives out 0 and lse 0."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale(d, sm_scale)
    s = _scores(q, k, _lens(lens, b, sk, q.device), scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (s > NEG_INF * 0.5)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * _full_dropout_mask(b, h, sq, sk, dropout_rate, int(seed),
                                   blocks, q.device)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / \
        l_safe.squeeze(-1).transpose(1, 2)[..., None]
    lse = torch.where(l == 0.0, torch.zeros_like(l), m + torch.log(l_safe))
    return out.to(q.dtype), lse.squeeze(-1)


def _delta(out, do):
    """delta = rowsum(do * out) in float32, from out AS STORED, (B, H, Sq)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _plain_ds(q, k, v, out, lse, do, lens=None, seed=0, sm_scale=None,
              causal=False, dropout_rate=0.0,
              blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """What both backward kernels recompute, over the full scores:
    ``(ds, p_drop, scale)`` with p = exp(s - lse), ds = p * (m*dp - delta)
    and p_drop = m*p, both (B, H, Sq, Sk) float32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale(d, sm_scale)
    s = _scores(q, k, _lens(lens, b, sk, q.device), scale, causal)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    if dropout_rate > 0.0:
        mask = _full_dropout_mask(b, h, sq, sk, dropout_rate, int(seed),
                                  blocks, q.device)
        dp = dp * mask
        p_drop = p * mask
    else:
        p_drop = p
    return p * (dp - _delta(out, do)[..., None]), p_drop, scale


def _plain_dq(ds, q, k, scale):
    """The dq kernel's plain version, from :func:`_plain_ds`."""
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(q.dtype)


def _plain_dkv(ds, p_drop, q, k, v, do, scale):
    """The dk/dv kernel's plain version, from :func:`_plain_ds`."""
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_plain_bwd(q, k, v, out, lse, do, lens=None, seed=0,
                              sm_scale=None, causal=False, dropout_rate=0.0,
                              blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """What the dq and dk/dv kernels compute: ``(dq, dk, dv)`` in the
    inputs' dtypes, recomputing p = exp(s - lse) over the full scores."""
    ds, p_drop, scale = _plain_ds(q, k, v, out, lse, do, lens, seed,
                                  sm_scale, causal, dropout_rate, blocks)
    return (_plain_dq(ds, q, k, scale),
            *_plain_dkv(ds, p_drop, q, k, v, do, scale))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and return types of the C entry points of a
    loaded build of ``csrc/flash_attention.cu``; returns ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 6 + [f, i, i, ctypes.c_uint, f, i, i, p]
    lib.flash_attention_fwd.argtypes = [p] * 8 + tail
    lib.flash_attention_fwd_mma.argtypes = [p] * 8 + tail
    lib.flash_attention_dq.argtypes = [p] * 10 + tail
    lib.flash_attention_dq_mma.argtypes = [p] * 10 + tail
    lib.flash_attention_dkv.argtypes = [p] * 11 + tail
    lib.flash_attention_dkv_mma.argtypes = [p] * 11 + tail
    for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_mma,
               lib.flash_attention_dq, lib.flash_attention_dq_mma,
               lib.flash_attention_dkv, lib.flash_attention_dkv_mma):
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build (at first use, with nvcc) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(_build.load("flash_attention"))
        return _lib


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return float(1.0 / math.sqrt(d) if sm_scale is None else sm_scale)


def _check(q, k, v, do=None):
    """Device, dtype and shape checks for a launch; returns the inputs with
    a unit-stride last dim (a copy only where it is not)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention kernel: batch*heads {b * h} > "
                         f"{MAX_BATCH_HEADS}")
    named = [("k", k), ("v", v)] + ([("do", do)] if do is not None else [])
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if do is not None and do.shape != q.shape:
        raise ValueError("flash_attention: do does not match q")
    return [t if t.stride(-1) == 1 else t.contiguous()
            for t in (q, k, v) + ((do,) if do is not None else ())]


def _strides(*ts):
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _drop_args(rate, blocks):
    if rate > 0.0:
        return [1, _threshold(rate), float(1.0 / (1.0 - rate)),
                int(blocks[0]), int(blocks[1])]
    return [0, 0, 1.0, 1, 1]


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {what} kernel launch failed: "
                           f"{msg} (cudaError {err})")


def _count(key, route):
    with _launch_lock:
        LAUNCHES[key] += 1
        ROUTES[f"{key}_{route}"] += 1


def _rows_aligned(*ts):
    """Every tensor starts on a 16-byte boundary and its (b, s, h) strides
    are whole multiples of 8 elements (16 bytes of bfloat16): what the
    tensor-core kernels' 16-byte ``cp.async`` needs (q, k, v; and do for
    the backward)."""
    return all(t.data_ptr() % 16 == 0 and
               all(st % 8 == 0 for st in t.stride()[:3]) for t in ts)


def _device_args(lens, seed, b, dev, dropout_rate):
    """lens and the seed as int32 device tensors; None where the kernels
    take a null pointer (no lens: every key valid; no dropout: the seed is
    never read)."""
    ln = None if lens is None else \
        lens.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    sd = None if dropout_rate <= 0.0 else \
        torch.as_tensor(seed, dtype=torch.int32, device=dev).reshape(1)
    return ln, sd


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pick_route(route, auto, what, dtype, d):
    """``route`` as asked (None: ``auto``, the route function's pick);
    ValueError for an unknown route, or for ``"mma"`` where ``auto`` is
    not ``"mma"``."""
    if route is None:
        return auto
    if route not in ("mma", "scalar") or (route == "mma" and auto != "mma"):
        raise ValueError(f"flash_attention {what}: route {route!r} does not "
                         f"take {dtype} at head_dim {d} with these rows "
                         f"(the route function gives {auto!r})")
    return route


def flash_attention_fwd(q, k, v, lens=None, seed=0, sm_scale=None,
                        causal=False, dropout_rate=0.0,
                        blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K), route=None):
    """The forward kernels' wrapper: ``(out, lse)`` as
    :func:`flash_attention_plain_fwd` defines them. CPU tensors take the
    plain version; CUDA tensors launch a kernel, or raise. ``seed`` may
    be an int or a device int32 tensor (read on the device, no sync).
    ``route``: None picks :func:`fwd_route`'s; ``"scalar"`` forces the
    scalar kernel; ``"mma"`` raises ValueError where :func:`fwd_route`
    would not pick it. No route gives way to another on an error."""
    if q.device.type == "cpu":
        return flash_attention_plain_fwd(q, k, v, lens, seed, sm_scale,
                                         causal, dropout_rate, blocks)
    q, k, v = _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    route = _pick_route(route, fwd_route(q.dtype, d, _rows_aligned(q, k, v)),
                        "forward", q.dtype, d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse.zero_()
    ln, sd = _device_args(lens, seed, b, dev, dropout_rate)
    lib = load_kernel()
    entry = lib.flash_attention_fwd_mma if route == "mma" else \
        lib.flash_attention_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
            out.data_ptr(), lse.data_ptr(), _ptr(ln), _ptr(sd),
            b, h, sq, sk, d, int(q.dtype == torch.bfloat16),
            _scale(d, sm_scale), int(bool(causal)),
            *_drop_args(dropout_rate, blocks), stream)
    _raise_on(lib, err, f"forward ({route})")
    _count("flash_fwd", route)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, lens=None, seed=0,
                        sm_scale=None, causal=False, dropout_rate=0.0,
                        blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K), route=None):
    """The dq and dk/dv kernels' wrapper: ``(dq, dk, dv)`` as
    :func:`flash_attention_plain_bwd` defines them. CPU tensors take the
    plain version; CUDA tensors compute delta = rowsum(do*out) in float32
    from ``out`` as stored, then launch both kernels, or raise. ``route``:
    None picks :func:`bwd_route`'s; ``"scalar"`` forces the scalar
    kernels; ``"mma"`` raises ValueError where :func:`bwd_route` would not
    pick it. No route gives way to another on an error."""
    if q.device.type == "cpu":
        return flash_attention_plain_bwd(q, k, v, out, lse, do, lens, seed,
                                         sm_scale, causal, dropout_rate,
                                         blocks)
    q, k, v, do = _check(q, k, v, do.to(q.dtype))
    delta = _delta(out, do)
    args = (q, k, v, do, lse, delta, lens, seed, sm_scale, causal,
            dropout_rate, blocks)
    return (_launch_dq(*args, route=route),
            *_launch_dkv(*args, route=route))


def _launch_dq(q, k, v, do, lse, delta, *rest, route=None):
    """The dq kernel on inputs that passed :func:`_check`, given lse and
    delta (B, H, Sq) float32 -> dq; ``route`` as in
    :func:`flash_attention_bwd`."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_attention_dq", "flash_dq", (dq,), route, q, k, v, do,
                lse, delta, *rest)
    return dq


def _launch_dkv(q, k, v, do, lse, delta, *rest, route=None):
    """The dk/dv kernel on inputs that passed :func:`_check`, given lse
    and delta (B, H, Sq) float32 -> (dk, dv); ``route`` as in
    :func:`flash_attention_bwd`."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_attention_dkv", "flash_dkv", (dk, dv), route, q, k, v,
                do, lse, delta, *rest)
    return dk, dv


def _launch_bwd(entry, key, outs, route, q, k, v, do, lse, delta, lens=None,
                seed=0, sm_scale=None, causal=False, dropout_rate=0.0,
                blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """Launch the C entry point ``entry`` (``entry + "_mma"`` on the mma
    route) writing ``outs``; counts under ``key`` and its route."""
    b, sq, h, d = q.shape
    route = _pick_route(route, bwd_route(q.dtype, d,
                                         _rows_aligned(q, k, v, do)),
                        f"backward ({key})", q.dtype, d)
    if q.numel() == 0 or k.numel() == 0:
        for o in outs:
            o.zero_()
        return
    sk = k.shape[1]
    dev = q.device
    lse = lse.to(device=dev, dtype=torch.float32).contiguous()
    delta = delta.to(device=dev, dtype=torch.float32).contiguous()
    ln, sd = _device_args(lens, seed, b, dev, dropout_rate)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry + "_mma" if route == "mma" else entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _strides(q, k, v, do), lse.data_ptr(), delta.data_ptr(),
            *[o.data_ptr() for o in outs], _ptr(ln), _ptr(sd), b, h, sq, sk,
            d, int(q.dtype == torch.bfloat16), _scale(d, sm_scale),
            int(bool(causal)), *_drop_args(dropout_rate, blocks), stream)
    _raise_on(lib, err, f"{key} ({route})")
    _count(key, route)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? lens, Tensor? seed, "
           "float sm_scale, bool causal, float dropout_rate, int block_q, "
           "int block_k) -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, lens, seed, sm_scale, causal, dropout_rate,
                  block_q, block_k):
    """The registered forward: :func:`flash_attention_fwd` (the kernel on
    a CUDA tensor, the plain version on a CPU one). ``seed`` is None
    without dropout. Outputs are contiguous, as the fake ones are (the
    kernel's already are; the plain version's out is a permuted view)."""
    out, lse = flash_attention_fwd(q, k, v, lens,
                                   0 if seed is None else seed, sm_scale,
                                   causal, dropout_rate, (block_q, block_k))
    return out.contiguous(), lse.contiguous()


@_flash_fwd_op.register_fake
def _(q, k, v, lens, seed, sm_scale, causal, dropout_rate, block_q,
      block_k):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq), dtype=torch.float32))


#: ``torch.ops.paddle_tpu_torch.flash_attention_fwd``
FLASH_FWD_OP = torch.ops.paddle_tpu_torch.flash_attention_fwd


def _op_seed(seed, dropout_rate):
    """The op's seed argument: None without dropout, else a tensor (an
    int seed becomes a host int64 tensor; a device seed stays as it is)."""
    if dropout_rate <= 0.0:
        return None
    if isinstance(seed, torch.Tensor):
        return seed
    return torch.tensor(int(seed), dtype=torch.int64)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, lens, seed, sm_scale, causal, dropout_rate, bq, bk = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.extra = (lens, 0 if seed is None else seed, sm_scale, causal,
                 dropout_rate, (bq, bk))


def _flash_backward(ctx, dout, dlse):
    """The dq and dk/dv kernels on the saved (q, k, v, out, lse); lse has
    no gradient (no caller differentiates it)."""
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.extra)
    return dq, dk, dv, None, None, None, None, None, None, None


_flash_fwd_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)


def flash_attention(q, k, v, causal=False, sm_scale=None, kv_lens=None,
                    dropout_rate=0.0, dropout_seed=None, block_q=None,
                    block_k=None):
    """q/k/v: (batch, seq, num_heads, head_dim) -> same-shaped output.

    kv_lens: optional (batch,) count of VALID key/value positions per row
    (capped at the key length; columns at or past it are masked).
    dropout_rate/dropout_seed: attention-probability dropout inside the
    kernels (seed an int or a 0-d/1-element int32 tensor, drawn anew per
    step). block_q/block_k: the reference's blocks, which key the dropout
    mask; ``None`` resolves them from the tuning DB as the reference does.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if dropout_rate >= 1.0:
        # everything dropped (common.dropout's p == 1.0 semantics)
        return torch.zeros_like(q)
    if dropout_rate < 0.0:
        raise ValueError(f"dropout_rate must be in [0, 1], got {dropout_rate}")
    blocks = keying_blocks(q.dtype, d, sq, sk, block_q, block_k)
    lens = None if kv_lens is None else \
        torch.as_tensor(kv_lens).to(device=q.device,
                                    dtype=torch.int32).reshape(b).clamp(max=sk)
    seed = 0 if dropout_seed is None else dropout_seed
    return FLASH_FWD_OP(q, k, v, lens, _op_seed(seed, dropout_rate),
                        _scale(d, sm_scale), bool(causal),
                        float(dropout_rate), *blocks)[0]
