"""Toy autoregressive LM + the DecodeServer executor contract.

Port of ``paddle_tpu/inference/decode_model.py``: a single-layer
transformer LM (embedding + learned positions, one attention layer with
residual, greedy argmax head) whose decode step runs against the paged KV
cache on the card.

Executor contract (``make_step_fn``): the DecodeServer hands the step its
flattened varlen batch, host arrays
``[tokens (T,), row_id (T,), positions (T,), valid (T,),
block_tables (R, W), ctx_lens (R,), last_idx (R,)]``, and gets
``[next_tokens (T,), k_new (1, T, H, D), v_new (1, T, H, D)]`` back.
``next_tokens[t]`` is the greedy argmax AT flattened slot ``t`` (garbage
on padded slots). Only ``next_tokens`` comes back to the host (a numpy
array); ``k_new``/``v_new`` stay on the cache's device and go from there
into ``cache.append``. The step only computes: attention reads cached KV
through the block tables, and the server commits the chunk's K/V after
the batch finishes, so a failover re-runs a step idempotently.

Routing, decided on the host from the batch layout as in the JAX package:
pure-decode batches (every context-bearing row carries one token) and
uniform multi-token batches (speculative-verify windows, same-width
prefill chunks, repacked to a rectangular (R, S) layout with S bucketed
to a power of two) go to :func:`~paddle_tpu_torch.ops.paged_attention.
paged_decode_attention`, i.e. the Hopper kernel with Tq = 1 or Tq = S;
everything else takes the ragged plain path
(:func:`~paddle_tpu_torch.ops.paged_attention.paged_prefill_attention`).

Each path's device side (device tensors in and out, no host read) is
``step.executors[path]``; :func:`executor_family` traces them as the
declared family of the router (``analysis/schedule.py``), on example
arguments from :func:`executor_args`.

PyTorch runs eagerly and has no compile cache. ``step.jit_fns`` keeps the
JAX package's attribute: one record per path (mixed, decode, verify) whose
``_cache_size()`` counts the distinct input shapes that path has run, so
a check that the shape set closes after warm-up keeps its meaning.

:func:`dense_generate` is the oracle: same parameters, full dense
recompute each step, no cache. Paged serving must reproduce its token
stream exactly.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Union

import numpy as np
import torch

from .._device import resolve_device
from ..ops import paged_attention as _pa

__all__ = ["init_decode_model", "params_from_jax", "make_step_fn",
           "executor_args", "executor_family", "dense_generate"]

_MATRICES = ("embed", "pos", "wq", "wk", "wv", "wo", "head")


def init_decode_model(vocab: int = 128, num_heads: int = 2,
                      head_dim: int = 32, max_len: int = 512,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Parameters of the toy LM (embed dim = num_heads * head_dim), drawn
    exactly as the JAX package draws them, so one seed gives one model in
    both packages."""
    e = num_heads * head_dim
    rs = np.random.RandomState(seed)
    s = 1.0 / math.sqrt(e)
    return {
        "embed": rs.randn(vocab, e).astype(np.float32) * 0.5,
        "pos": rs.randn(max_len, e).astype(np.float32) * 0.1,
        "wq": rs.randn(e, e).astype(np.float32) * s,
        "wk": rs.randn(e, e).astype(np.float32) * s,
        "wv": rs.randn(e, e).astype(np.float32) * s,
        "wo": rs.randn(e, e).astype(np.float32) * s,
        "head": rs.randn(e, vocab).astype(np.float32) * s,
        "num_heads": np.int32(num_heads),
        "head_dim": np.int32(head_dim),
    }


def params_from_jax(params: Dict[str, object], device=None
                    ) -> Dict[str, Union[torch.Tensor, int]]:
    """The JAX package's parameter dict (numpy arrays, or anything numpy
    can read) as the port's: float32 tensors on ``device`` plus the two
    int widths. ``device=None`` means the card."""
    dev = resolve_device(device)
    out: Dict[str, Union[torch.Tensor, int]] = {
        name: torch.as_tensor(params[name], dtype=torch.float32, device=dev)
        for name in _MATRICES}
    out["num_heads"] = int(params["num_heads"])
    out["head_dim"] = int(params["head_dim"])
    return out


def _on_device(params, dev: torch.device):
    """``params`` as tensors on ``dev`` (numpy dicts are converted)."""
    if all(isinstance(params[n], torch.Tensor) and params[n].device == dev
           for n in _MATRICES):
        return params
    return params_from_jax(params, dev)


def _qkv(params, x):
    h, d = params["num_heads"], params["head_dim"]
    t = x.shape[0]
    q = (x @ params["wq"]).reshape(t, h, d)
    k = (x @ params["wk"]).reshape(t, h, d)
    v = (x @ params["wv"]).reshape(t, h, d)
    return q, k, v


class _ShapeSet:
    """The distinct input shapes one executor path has run, and how many
    steps took it (``calls``)."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self._seen = set()
        self._lock = threading.Lock()

    def note(self, *arrays):
        with self._lock:
            self.calls += 1
            self._seen.add(tuple(tuple(a.shape) for a in arrays))

    def shapes(self):
        with self._lock:
            return sorted(self._seen)

    def _cache_size(self) -> int:
        with self._lock:
            return len(self._seen)


def make_step_fn(params, cache, device=None):
    """Build a DecodeServer executor over ``cache`` (single layer).

    ``device=None`` means the card (and raises without one); it must be
    the cache's device. Decode and uniform batches go through
    ``paged_decode_attention``'s dispatcher; mixed batches take the ragged
    plain path. On the card the kernel is built and loaded here, before
    any server deadline runs.
    """
    if cache.num_layers != 1:
        raise ValueError("the toy decode model is single-layer")
    dev = resolve_device(device)
    if dev != cache.device:
        raise ValueError(f"executor device {dev} != cache device "
                         f"{cache.device}")
    if dev.type == "cuda":
        _pa.load_kernel()
    p = _on_device(params, dev)
    h, d = p["num_heads"], p["head_dim"]
    e = h * d
    max_len = p["pos"].shape[0]
    paths = {name: _ShapeSet(name) for name in ("mixed", "decode", "verify")}

    def dev_i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    def head(y):
        return torch.argmax(y @ p["head"], dim=-1)

    # the device side of each path: device tensors in, device tensors out
    # (``step.executors``; ``executor_family`` traces them)
    @torch.no_grad()
    def mixed_exec(kp, vp, tok, row_id, pos_t, valid, tables, ctx_lens):
        x = p["embed"][tok] + p["pos"][pos_t]                   # (T, E)
        q, k, v = _qkv(p, x)
        o = _pa.paged_prefill_attention(
            q, k, v, row_id, pos_t, valid, kp, vp, tables, ctx_lens)
        y = x + o.reshape(-1, e) @ p["wo"]
        return head(y).to(torch.int32), k[None], v[None]

    @torch.no_grad()
    def decode_exec(kp, vp, tok, pos_t, tables, ctx_lens):
        x = p["embed"][tok] + p["pos"][pos_t]                   # (R, E)
        q, k, v = _qkv(p, x)
        o = _pa.paged_decode_attention(
            q[:, None], kp, vp, tables, ctx_lens,
            k_new=k[:, None], v_new=v[:, None])                 # (R,1,H,D)
        y = x + o[:, 0].reshape(-1, e) @ p["wo"]
        return head(y).to(torch.int32), k, v

    @torch.no_grad()
    def verify_exec(kp, vp, tok2d, posn, tables, ctx_lens):
        r_b, s_b = tok2d.shape
        x = p["embed"][tok2d] + p["pos"][posn]
        q, k, v = _qkv(p, x.reshape(r_b * s_b, e))
        q4 = q.reshape(r_b, s_b, h, d)
        k4 = k.reshape(r_b, s_b, h, d)
        v4 = v.reshape(r_b, s_b, h, d)
        o = _pa.paged_decode_attention(
            q4, kp, vp, tables, ctx_lens, k_new=k4, v_new=v4)   # (R,S,H,D)
        y = x + o.reshape(r_b, s_b, e) @ p["wo"]
        return head(y).to(torch.int32), k4, v4                  # (R, S)

    def _mixed(kp, vp, tokens, row_id, positions, valid, tables, ctx_lens):
        nxt, k, v = mixed_exec(
            kp, vp, dev_i32(tokens).long(), dev_i32(row_id),
            dev_i32(positions).long(), dev_i32(valid), dev_i32(tables),
            dev_i32(ctx_lens))
        return nxt.cpu().numpy(), k, v

    def _decode(kp, vp, tokens, positions, tables, ctx_lens, last_idx):
        t_b = tokens.shape[0]
        nxt, k, v = decode_exec(
            kp, vp, dev_i32(tokens[last_idx]).long(),
            dev_i32(positions[last_idx]).long(), dev_i32(tables),
            dev_i32(ctx_lens))
        nxt = nxt.cpu().numpy()
        # scatter each real row's next token and K/V back to its flattened
        # token slot; padded rows (ctx_lens == 0) are dropped
        rows = np.flatnonzero(ctx_lens > 0)
        slots = last_idx[rows]
        nxt_flat = np.zeros(t_b, np.int32)
        nxt_flat[slots] = nxt[rows]
        rows_t, slots_t = dev_i32(rows).long(), dev_i32(slots).long()
        with torch.no_grad():
            k_flat = torch.zeros((t_b, h, d), dtype=k.dtype, device=dev)
            v_flat = torch.zeros((t_b, h, d), dtype=v.dtype, device=dev)
            k_flat[slots_t] = k[rows_t]
            v_flat[slots_t] = v[rows_t]
        return nxt_flat, k_flat[None], v_flat[None]

    def _verify(kp, vp, tok2d, tables, ctx_lens):
        """Rectangular extension batch: row i's chunk tokens sit at
        positions ``ctx_lens[i] + col``; every chunk token gets its own
        next-token argmax."""
        s_b = tok2d.shape[1]
        posn = np.clip(ctx_lens.astype(np.int64)[:, None] +
                       np.arange(s_b)[None, :], 0, max_len - 1)  # pad cols
        nxt, k4, v4 = verify_exec(kp, vp, dev_i32(tok2d).long(),
                                  dev_i32(posn).long(), dev_i32(tables),
                                  dev_i32(ctx_lens))
        return nxt.cpu().numpy(), k4, v4

    def step(arrays: List[np.ndarray]) -> list:
        tokens, row_id, positions, valid, tables, ctx_lens, last_idx = \
            [np.asarray(a) for a in arrays]
        kp, vp = cache.pools(0)
        t_b = tokens.shape[0]
        r_b = ctx_lens.shape[0]
        # pure decode <=> every valid token belongs to a row that already
        # has context and carries exactly one token
        n_valid = int(valid.sum())
        real_rows = int((ctx_lens > 0).sum())
        if n_valid > 0 and n_valid == real_rows:
            paths["decode"].note(*arrays)
            return list(_decode(kp, vp, tokens, positions, tables, ctx_lens,
                                last_idx))
        # uniform multi-token extension (speculative verify, same-width
        # prefill): repack rectangular for the multi-query kernel; S is
        # bucketed to a power of two, as in the JAX executor
        counts = np.bincount(row_id[valid > 0], minlength=r_b)
        live = counts[counts > 0]
        if live.size and live.min() == live.max() and live[0] > 1:
            s = int(live[0])
            s_b = 1 << (s - 1).bit_length()
            rows = np.flatnonzero(counts)
            offs = np.concatenate([[0], np.cumsum(counts[rows])[:-1]])
            tok2d = np.zeros((r_b, s_b), np.int32)
            for i, off in zip(rows, offs):
                tok2d[i, :s] = tokens[off:off + s]
            paths["verify"].note(tok2d, tables, ctx_lens)
            nxt2d, k2d, v2d = _verify(kp, vp, tok2d, tables, ctx_lens)
            # flattened slot off+j <- rectangular (row, j); bookkeeping on
            # the host, one indexed copy each for K and V on the device
            src_r = np.repeat(rows, s)
            src_c = np.tile(np.arange(s), rows.size)
            dst = (offs[:, None] + np.arange(s)[None, :]).reshape(-1)
            nxt = np.zeros(t_b, np.int32)
            nxt[dst] = nxt2d[src_r, src_c]
            sr, sc, ds = (dev_i32(a).long() for a in (src_r, src_c, dst))
            with torch.no_grad():
                k_new = torch.zeros((t_b, h, d), dtype=k2d.dtype,
                                    device=dev)
                v_new = torch.zeros((t_b, h, d), dtype=v2d.dtype,
                                    device=dev)
                k_new[ds] = k2d[sr, sc]
                v_new[ds] = v2d[sr, sc]
            return [nxt, k_new[None], v_new[None]]
        paths["mixed"].note(*arrays)
        return list(_mixed(kp, vp, tokens, row_id, positions, valid, tables,
                           ctx_lens))

    step.jit_fns = (paths["mixed"], paths["decode"], paths["verify"])
    step.executors = {"mixed": mixed_exec, "decode": decode_exec,
                      "verify": verify_exec}
    return step


def executor_args(cache, rows: int, tokens: int = 1, width: int = 4,
                  device=None) -> dict:
    """Example device arguments of each executor of ``make_step_fn``
    (``step.executors``), for :func:`executor_family`: ``rows`` rows of
    ``tokens`` tokens (the verify window; mixed: ``rows * tokens`` ragged
    tokens), block tables ``width`` pages wide."""
    dev = cache.device if device is None else torch.device(device)
    kp, vp = cache.pools(0)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.long, device=dev)
    t = rows * tokens
    tables = torch.zeros((rows, width), **i32)
    lens = torch.ones((rows,), **i32)
    return {
        "mixed": (kp, vp, torch.zeros(t, **i64), torch.zeros(t, **i32),
                  torch.zeros(t, **i64), torch.ones(t, **i32), tables, lens),
        "decode": (kp, vp, torch.zeros(rows, **i64),
                   torch.zeros(rows, **i64), tables, lens),
        "verify": (kp, vp, torch.zeros((rows, tokens), **i64),
                   torch.zeros((rows, tokens), **i64), tables, lens),
    }


def executor_family(step, arg_specs, mesh=None, name="decode-executor"):
    """The mixed/decode/verify executor router as a declared
    :class:`~paddle_tpu_torch.analysis.schedule.ProgramFamily` (reference
    ``decode_model.py:217``). The server picks the executor from the batch
    composition (prefill rows present / pure decode / verify windows), a
    host decision every rank makes alike for a dispatched batch, so the
    members' schedules may differ. ``arg_specs`` maps a member to the
    device arguments its executor (``step.executors``) is traced with
    (:func:`executor_args`; fakes of them, nothing read); members absent
    from it are skipped."""
    from ..analysis.schedule import ProgramFamily
    from ..analysis.walker import trace_program
    members = {}
    for member, fn in step.executors.items():
        if member not in arg_specs:
            continue
        args = tuple(arg_specs[member])
        members[member] = (lambda f=fn, a=args: trace_program(f, *a))
    return ProgramFamily(
        name=name,
        selector="batch composition bucket (has-prefill / pure-decode / "
                 "has-verify rows), host-uniform per dispatched batch",
        rank_invariant=True, members=members, mesh=mesh)


@torch.no_grad()
def dense_generate(params, prompt_tokens, max_new: int,
                   device=None) -> List[int]:
    """Greedy-decode oracle: full dense recompute per step, no cache.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    p = _on_device(params, dev)
    h, d = p["num_heads"], p["head_dim"]
    e = h * d
    toks = [int(t) for t in prompt_tokens]
    out: List[int] = []
    scale = 1.0 / math.sqrt(d)
    for _ in range(int(max_new)):
        t = len(toks)
        x = p["embed"][torch.tensor(toks, device=dev)] + p["pos"][:t]
        q, k, v = _qkv(p, x)
        s = torch.einsum("thd,uhd->htu", q.float() * scale, k.float())
        causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        s = torch.where(causal[None], s, torch.full_like(s, -1e30))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("htu,uhd->thd", pr, v.float())
        y = x + o.reshape(t, e) @ p["wo"]
        nxt = int(torch.argmax(y[-1] @ p["head"]))
        toks.append(nxt)
        out.append(nxt)
    return out
