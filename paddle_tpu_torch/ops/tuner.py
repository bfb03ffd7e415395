"""The tuning DB: launch configurations by kernel, device kind, dtype and
shape bucket, with a sweep that measures the port's own split counts on
the card.

Port of ``paddle_tpu/ops/pallas/tuner.py``.

- **Keys** are ``kernel|device_kind|dtype|dims`` (:func:`make_key`), with
  sequence and token dims bucketed to the next power of two
  (:func:`shape_bucket`), so one entry serves every shape in its bucket.
- **The DB** is the seed shipped beside this module (``tuning_db.json``)
  under a user overlay (``PADDLE_TPU_TORCH_TUNING_DB``, else
  ``~/.cache/paddle_tpu_torch/tuning_db.json``); the overlay wins per key,
  and a missing or corrupt file reads as empty with one warning. The seed
  holds the reference's 18 device-generic (``"any"``) rows verbatim and
  the port's own rows measured on an H100 (``validated: "device"``).
- **Resolution** (:func:`resolve`) tries the exact device kind, then
  ``"any"``, then the caller's defaults, and counts each outcome in
  ``kernel_config_resolved_total{kernel,source}`` (the reference's
  ``pallas_config_resolved_total``). A device row's config is merged over
  the defaults, not over the generic row, so the port keeps its own knobs
  under its own kernel names: ``fused_ce_fwd_tiled`` (``{"splits": n}``,
  the tiled CE forward's vocab splits, dims :func:`ce_dims`) and
  ``paged_split`` (``{"splits": n}``, the paged split route's context
  splits a row, dims :func:`paged_split_dims`). The reference's
  ``flash_attention``, ``fused_ce`` and ``paged_attention`` rows are only
  resolved to answer as the reference does: the flash blocks key the
  dropout mask (``ops/flash_attention.py``), so no device row is ever
  written for them. Answers are memoised per (kernel, device, dtype, dims,
  defaults), since the paged kernel resolves on every decode step;
  :func:`clear_cache` drops the memo with the DB.
- **Tuning** (:func:`tune`) sweeps each case's candidate split counts on
  the card: every candidate runs the CUDA kernel and is held against the
  plain version (the CE forward's ``lse``/``tgt`` within
  :data:`CE_STAT_ATOL`, the paged stats within :data:`PAGED_ATOL` and
  :data:`PAGED_RTOL`, ``chip_smoke.py``'s bars) before it may be timed,
  then timed with CUDA events behind an L2 flush and a lead spin. The
  fastest replaces the formula's count when it is faster by more than
  :data:`MIN_GAIN` (a smaller win is timing noise); the row keeps
  ``validated: "device"``, its ``mean_us``, the formula's and the fastest
  config with their times, and the whole candidate table. A rerun of a
  key records the prior ``mean_us`` against the fresh one as the
  ``tuner:<kernel>`` calibration pair. The reference's CPU sweep runs its
  kernels in interpret mode; the port's kernels have none, so ``tune``
  raises without a card.

``record_fallback(kernel)`` is called when a dispatcher sends a shape that
the kernel's gate rejects to the plain path. It bumps ``FALLBACKS[kernel]``
(read by ``chip_smoke.py``) and, with telemetry on,
``kernel_fallbacks_total{kernel}``.

CLI (writes the overlay; ``--generic`` writes the shipped seed instead,
under the card's device kind)::

    python -m paddle_tpu_torch.ops.tuner --suite h100 [--db PATH]
    python -m paddle_tpu_torch.ops.tuner --suite h100 --generic
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import telemetry

__all__ = [
    "TuningDB", "default_db_path", "overlay_db_path", "get_db",
    "clear_cache", "shape_bucket", "device_kind", "make_key", "flash_dims",
    "ce_dims", "paged_split_dims", "resolve", "resolve_splits",
    "record_fallback", "FALLBACKS", "tune", "tune_case", "flash_candidates",
    "ce_candidates", "paged_candidates", "ce_fwd_split_candidates",
    "paged_split_candidates", "GENERIC_DEVICE", "CE_SPLIT_KERNEL",
    "PAGED_SPLIT_KERNEL", "CE_STAT_ATOL", "PAGED_ATOL", "PAGED_RTOL",
]

GENERIC_DEVICE = "any"
CE_SPLIT_KERNEL = "fused_ce_fwd_tiled"
PAGED_SPLIT_KERNEL = "paged_split"
MAX_SPLIT_CANDIDATES = 16
# a candidate's bar against the plain version (chip_smoke.py's): the CE
# forward's float32 lse and tgt; the paged route's float32 (acc, m, l)
CE_STAT_ATOL = 1e-4
PAGED_ATOL, PAGED_RTOL = 1e-4, 1e-4
# cycles of spinning ahead of each timed call (about 0.5 ms on an NVIDIA
# H100 80GB HBM3 at 700 W)
LEAD_CYCLES = 1_000_000
# a candidate replaces the formula's count only when it is faster by more
# than this share: two sweeps time one count up to ~3% apart on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md, section 6), so a smaller win is noise
MIN_GAIN = 0.03

_VERSION = 1

FALLBACKS: "collections.Counter[str]" = collections.Counter()
_lock = threading.Lock()


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def shape_bucket(n: int, floor: int = 128) -> int:
    """Next power of two >= n (min ``floor``)."""
    n = max(int(n), 1)
    b = floor
    while b < n:
        b <<= 1
    return b


_kind: Dict[str, str] = {}


def device_kind() -> str:
    """The card's name normalised as the reference normalises its device
    kind (``"NVIDIA H100 80GB HBM3"`` -> ``"nvidia-h100-80gb-hbm3"``);
    ``"cpu"`` without a card."""
    kind = _kind.get("kind")
    if kind is None:
        import torch
        kind = "cpu"
        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name().strip().lower().replace(
                " ", "-")
        _kind["kind"] = kind
    return kind


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def make_key(kernel: str, device: str, dtype, dims: Dict[str, int]) -> str:
    dim_s = ",".join(f"{k}{int(v)}" for k, v in sorted(dims.items()))
    return f"{kernel}|{device}|{_dtype_name(dtype)}|{dim_s}"


def flash_dims(d: int, sq: int, sk: int) -> Dict[str, int]:
    """Bucketed dims of a flash-attention call: head_dim exact, sq bucketed
    with floor 1 (decode-shaped calls keep exact keys), sk with floor 128."""
    return {"d": int(d), "sq": shape_bucket(sq, floor=1),
            "sk": shape_bucket(sk)}


def ce_dims(h: int, v: int, tokens: int) -> Dict[str, int]:
    """Bucketed dims of a fused-CE call: hidden and vocab exact (vocab is a
    model constant, not a batch axis), the token count bucketed."""
    return {"h": int(h), "v": int(v), "t": shape_bucket(tokens)}


def paged_split_dims(b: int, h: int, d: int, page_size: int, width: int,
                     tq: int) -> Dict[str, int]:
    """Dims of a paged split-route call: heads, head dim and page size
    exact, the batch rows and query tokens bucketed with floor 1, the
    table's capacity (``width * page_size`` keys) bucketed."""
    return {"b": shape_bucket(b, floor=1), "h": int(h), "d": int(d),
            "ps": int(page_size), "sk": shape_bucket(width * page_size),
            "sq": shape_bucket(tq, floor=1)}


# ---------------------------------------------------------------------------
# DB
# ---------------------------------------------------------------------------

def default_db_path() -> str:
    """The seed DB shipped beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tuning_db.json")


def overlay_db_path() -> str:
    """The user overlay: ``PADDLE_TPU_TORCH_TUNING_DB``, else
    ``~/.cache/paddle_tpu_torch/tuning_db.json``. ``tune`` writes here, so
    the seed stays as shipped."""
    env = os.environ.get("PADDLE_TPU_TORCH_TUNING_DB")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "tuning_db.json")


class TuningDB:
    """A ``{key: entry}`` map with a JSON round trip. An entry is::

        {"config": {"splits": 4}, "kernel": "fused_ce_fwd_tiled",
         "device": "nvidia-h100-80gb-hbm3", "dtype": "bfloat16",
         "dims": {"h": 768, "t": 8192, "v": 50304},
         "mean_us": 2251.3 | None, "validated": "device" | "interpret"
         | "seed", "swept": 16}

    and, for the port's own rows, ``"default"`` (the formula's config and
    ``mean_us``) and ``"candidates"`` (each candidate's ``config``,
    ``max_err`` and ``mean_us``). The file format is the reference's, so
    either package reads the other's files."""

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path: str) -> "TuningDB":
        """Read a DB file; a missing or corrupt file gives an empty DB
        (with one warning when corrupt): a broken overlay must not stop a
        launch."""
        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict) or \
                    not isinstance(raw.get("entries", {}), dict):
                raise ValueError("not a tuning DB object")
            return cls(raw.get("entries", {}), path=path)
        except (OSError, ValueError) as e:
            warnings.warn(f"tuning DB {path!r} unreadable ({e}); "
                          "treating as empty", stacklevel=2)
            return cls(path=path)

    def save(self, path: Optional[str] = None):
        """Write the DB atomically (a temporary file, then a rename)."""
        path = path or self.path
        if not path:
            raise ValueError("TuningDB.save: no path")
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _VERSION, "entries": self.entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)

    def lookup(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, entry: dict):
        self.entries[key] = entry

    def merged_over(self, base: "TuningDB") -> "TuningDB":
        """self (the overlay) wins per key over ``base``."""
        merged = dict(base.entries)
        merged.update(self.entries)
        return TuningDB(merged)

    def __len__(self):
        return len(self.entries)


_db_cache: Dict[str, Any] = {}
_memo: Dict[tuple, Tuple[Dict[str, int], str]] = {}


def get_db(refresh: bool = False) -> TuningDB:
    """The merged DB (overlay over seed), cached per overlay path (read
    from the environment that names it, so a cache hit costs two dict
    lookups: every paged launch resolves)."""
    key = (os.environ.get("PADDLE_TPU_TORCH_TUNING_DB"),
           os.environ.get("HOME"))
    if refresh or _db_cache.get("key") != key:
        base = TuningDB.load(default_db_path())
        overlay = TuningDB.load(overlay_db_path())
        _db_cache["key"] = key
        _db_cache["db"] = overlay.merged_over(base)
        _memo.clear()
    return _db_cache["db"]


def clear_cache():
    """Drop the cached DB, the resolution memo and the device kind (tests,
    and after a tuner run)."""
    _db_cache.clear()
    _memo.clear()
    _kind.clear()


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def _count(kernel: str, source: str):
    if telemetry.enabled():
        telemetry.counter(
            "kernel_config_resolved_total",
            "kernel launch-configuration resolutions, by source"
        ).inc(kernel=kernel, source=source)


def resolve(kernel: str, dtype, dims: Dict[str, int],
            defaults: Dict[str, int]) -> Tuple[Dict[str, int], str]:
    """(config, source): the exact device kind's row, else the generic
    row, merged over ``defaults`` (source ``"db"``); else ``defaults``
    (source ``"default"``). Counted in
    ``kernel_config_resolved_total{kernel,source}``."""
    dev = device_kind()
    db = get_db()
    memo_key = (kernel, dev, dtype, tuple(sorted(dims.items())),
                tuple(sorted(defaults.items())))
    hit = _memo.get(memo_key)
    if hit is None:
        hit = dict(defaults), "default"
        for d in (dev, GENERIC_DEVICE):
            entry = db.lookup(make_key(kernel, d, dtype, dims))
            if entry and isinstance(entry.get("config"), dict):
                cfg = dict(defaults)
                cfg.update({k: int(v) for k, v in entry["config"].items()})
                hit = cfg, "db"
                break
        _memo[memo_key] = hit
    _count(kernel, hit[1])
    return dict(hit[0]), hit[1]


def resolve_splits(kernel: str, dtype, dims: Dict[str, int],
                   formula: int) -> int:
    """The split count a launch of ``kernel`` takes: the DB's, else the
    ``formula``'s."""
    return resolve(kernel, dtype, dims, {"splits": int(formula)})[0]["splits"]


def record_fallback(kernel: str):
    """Count one dispatch of ``kernel``'s work to the plain path."""
    with _lock:
        FALLBACKS[kernel] += 1
    if telemetry.enabled():
        telemetry.counter(
            "kernel_fallbacks_total",
            "kernel dispatches sent to the plain path by the shape gate"
        ).inc(kernel=kernel)


# ---------------------------------------------------------------------------
# candidate grids
# ---------------------------------------------------------------------------

def flash_candidates(sq: int, sk: int) -> List[Dict[str, int]]:
    """The reference's (block_q, block_k) grid: powers of two that divide
    the bucketed sequence lengths."""
    out = []
    for bq in (128, 256, 512):
        if bq > sq or sq % bq:
            continue
        for bk in (128, 256, 512, 1024):
            if bk > sk or sk % bk:
                continue
            out.append({"block_q": bq, "block_k": bk})
    return out or [{"block_q": min(sq, 128), "block_k": min(sk, 128)}]


def ce_candidates(tokens: int, vocab: int) -> List[Dict[str, int]]:
    """The reference's (block_tokens, block_vocab) grid for fused CE."""
    out = []
    for bt in (128, 256, 512):
        if bt > tokens or tokens % bt:
            continue
        for bv in (512, 1024, 2048, 4096):
            if bv > max(vocab, 512):
                continue
            out.append({"block_tokens": bt, "block_vocab": bv})
    return out or [{"block_tokens": min(tokens, 128),
                    "block_vocab": min(shape_bucket(vocab), 512)}]


def paged_candidates(sq: Optional[int] = None) -> List[Dict[str, int]]:
    """The reference's q_pad grid for its paged kernel: 8 and 16 for
    decode, the bucketed chunk width for verify."""
    if sq is not None:
        return [{"q_pad": int(sq)}]
    return [{"q_pad": 8}, {"q_pad": 16}]


def ce_fwd_split_candidates(n: int, v: int) -> List[Dict[str, int]]:
    """The tiled CE forward's vocab splits: 1 up to the vocab tiles over
    ``FWD_MIN_SPLIT_TILES`` (every split keeps that many tiles), at most
    :data:`MAX_SPLIT_CANDIDATES`."""
    from .fused_ce import FWD_MIN_SPLIT_TILES, FWD_TILE_VOCAB
    vocab_tiles = -(-int(v) // FWD_TILE_VOCAB)
    top = max(1, min(vocab_tiles // FWD_MIN_SPLIT_TILES,
                     MAX_SPLIT_CANDIDATES))
    return [{"splits": s} for s in range(1, top + 1)]


def paged_split_candidates(width: int, page_size: int
                           ) -> List[Dict[str, int]]:
    """The paged split route's splits a row: 1 up to the cap
    ``paged_splits`` applies (a page and ``MIN_SPLIT_KEYS`` keys of a full
    table a split), at most :data:`MAX_SPLIT_CANDIDATES`."""
    from .paged_attention import MIN_SPLIT_KEYS
    cap = min(int(width), int(width) * int(page_size) // MIN_SPLIT_KEYS)
    top = max(1, min(cap, MAX_SPLIT_CANDIDATES))
    return [{"splits": s} for s in range(1, top + 1)]


# ---------------------------------------------------------------------------
# validation and timing on the card
# ---------------------------------------------------------------------------

def _time_us(fn, flush, reps: int = 25, warmup: int = 5) -> float:
    """Median device time of one call in microseconds: CUDA events, the L2
    flushed before each timed call, and a spin of :data:`LEAD_CYCLES` ahead
    of the start event so that the call's host work is queued behind it
    and the events time the device alone (``chip_smoke.time_ms(...,
    lead=True)``)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    mid = len(times) // 2
    ms = times[mid] if len(times) % 2 else 0.5 * (times[mid - 1] +
                                                  times[mid])
    return ms * 1e3


def _need_card(what: str):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"tuner.{what} needs a CUDA card: it times the port's CUDA "
            "kernels, which have no CPU mode")


def _ce_case_fns(case, dtype, flush):
    """(dims, candidates, formula config, validate, timeit) for the tiled
    CE forward at ``case`` = {n, h, v}: random bf16 hidden states, the
    weight as a tied embedding's (H, V) ``.T`` view, random labels."""
    import torch

    from . import fused_ce as fc
    n, h, v = int(case["n"]), int(case["h"]), int(case["v"])
    if fc.fwd_route(dtype, h) != "tiled":
        raise ValueError(f"tuner: ({n}, {h}, {v}) {dtype} does not take "
                         "the tiled CE forward")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    hid = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
    emb = (torch.randn(v, h, device="cuda", generator=gen) * 0.02).to(dtype)
    w = emb.T
    lbl = torch.randint(0, v, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    want = fc.fused_ce_plain_fwd(hid, w, lbl)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def validate(cfg):
        got = fc.ce_fwd(hid, w, lbl, splits=cfg["splits"])
        err = max((g - r).abs().max().item() for g, r in zip(got, want))
        return err, err <= CE_STAT_ATOL

    def timeit(cfg):
        return _time_us(lambda: fc.ce_fwd(hid, w, lbl, splits=cfg["splits"]),
                        flush)

    return (ce_dims(h, v, n), ce_fwd_split_candidates(n, v),
            {"splits": fc.fwd_splits(n, v, sms)}, validate, timeit)


def _paged_case_fns(case, dtype, flush):
    """The same for the paged split route at ``case`` = {b, h, d, ps,
    width, tq}: random pools of 2048 pages, shuffled tables, every row's
    context a full table."""
    import torch

    from . import paged_attention as pa
    b, h, d = int(case["b"]), int(case["h"]), int(case["d"])
    ps, width, tq = int(case["ps"]), int(case["width"]), int(case["tq"])
    pages = max(2048, b * width)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.randn(b, tq, h, d, device="cuda", generator=gen)
    kp = torch.randn(pages, ps, h, d, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(pages, ps, h, d, device="cuda", generator=gen).to(dtype)
    tab = torch.stack([torch.randperm(pages, device="cuda",
                                      generator=gen)[:width]
                       for _ in range(b)]).to(torch.int32)
    ln = torch.full((b,), width * ps, dtype=torch.int32, device="cuda")
    want = pa.paged_attention_plain(q, kp, vp, tab, ln)
    if pa.paged_route(dtype, d, True) != "split":
        raise ValueError("tuner: the paged case does not take the split "
                         "route")

    def validate(cfg):
        got = pa.paged_attention(q, kp, vp, tab, ln, route="split",
                                 splits=cfg["splits"])
        err = max((g - r).abs().max().item() for g, r in zip(got, want))
        return err, all(torch.allclose(g, r, atol=PAGED_ATOL,
                                       rtol=PAGED_RTOL)
                        for g, r in zip(got, want))

    def timeit(cfg):
        return _time_us(lambda: pa.paged_attention(
            q, kp, vp, tab, ln, route="split", splits=cfg["splits"]),
            flush)

    formula = pa.paged_splits(
        b, h, width, ps, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    return (paged_split_dims(b, h, d, ps, width, tq),
            paged_split_candidates(width, ps), {"splits": formula},
            validate, timeit)


_CASES = {CE_SPLIT_KERNEL: _ce_case_fns, PAGED_SPLIT_KERNEL: _paged_case_fns}


def sweep(kernel: str, dims: Dict[str, int], dtype, device: str,
          candidates: List[Dict[str, int]], default: Dict[str, int],
          validate: Callable[[dict], Tuple[float, bool]],
          timeit: Callable[[dict], float],
          log: Callable[[str], None] = lambda s: None) -> Tuple[str, dict]:
    """Validate every candidate (``validate(cfg)`` -> its max abs error
    against the plain version and whether it holds the bar), then time
    each that passed (``timeit(cfg)`` -> microseconds) -> (key, entry).
    The entry's config is the fastest candidate's when it beats the
    formula's config (``default``) by more than :data:`MIN_GAIN`, else the
    formula's. A candidate that fails validation is recorded with no time;
    the sweep raises if none passes or if the formula's config fails. An
    exception from a launch propagates."""
    key = make_key(kernel, device, dtype, dims)
    table = []

    def run(cfg):
        err, ok = validate(cfg)
        us = float(timeit(cfg)) if ok else None
        log(f"  {key} {cfg}: max_err {err:.3g} "
            + (f"ok, {us:.3f} us" if ok else "FAILED numerics"))
        return {"config": dict(cfg), "max_err": float(err), "mean_us": us}

    table = [run(cfg) for cfg in candidates]
    timed = [r for r in table if r["mean_us"] is not None]
    if not timed:
        raise RuntimeError(f"tuner: no candidate of {key} passed "
                           "validation")
    best = min(timed, key=lambda r: r["mean_us"])
    dflt = next((r for r in table if r["config"] == default), None) or \
        run(default)
    if dflt["mean_us"] is None:
        raise RuntimeError(f"tuner: the formula's config {default} of {key} "
                           "failed validation")
    chosen = best if best["mean_us"] < (1.0 - MIN_GAIN) * dflt["mean_us"] \
        else dflt
    return key, {
        "config": dict(chosen["config"]), "kernel": kernel,
        "device": device, "dtype": _dtype_name(dtype), "dims": dict(dims),
        "mean_us": round(chosen["mean_us"], 3), "validated": "device",
        "swept": len(timed),
        "default": {"config": dict(default),
                    "mean_us": round(dflt["mean_us"], 3)},
        "fastest": {"config": dict(best["config"]),
                    "mean_us": round(best["mean_us"], 3)},
        "candidates": [{"config": r["config"], "max_err": r["max_err"],
                        "mean_us": (None if r["mean_us"] is None
                                    else round(r["mean_us"], 3))}
                       for r in table]}


def tune_case(kernel: str, case: Dict[str, int], dtype,
              log: Callable[[str], None] = lambda s: None
              ) -> Tuple[str, dict]:
    """Sweep one (kernel, shape case, dtype) on the card -> (key, entry),
    keyed by this card's device kind. ``kernel`` is
    :data:`CE_SPLIT_KERNEL` (``case`` = {n, h, v}) or
    :data:`PAGED_SPLIT_KERNEL` (``case`` = {b, h, d, ps, width, tq})."""
    _need_card("tune_case")
    import torch
    if kernel not in _CASES:
        raise ValueError(f"tuner: unknown kernel {kernel!r}; one of "
                         f"{sorted(_CASES)}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    dims, cands, default, validate, timeit = _CASES[kernel](case, dtype,
                                                           flush)
    return sweep(kernel, dims, dtype, device_kind(), cands, default,
                 validate, timeit, log=log)


def tune(cases: List[Tuple[str, Dict[str, int], Any]],
         db_path: Optional[str] = None, verbose: bool = False,
         case_fn: Optional[Callable[..., Tuple[str, dict]]] = None
         ) -> TuningDB:
    """Sweep ``cases`` (a list of (kernel, case, dtype)) and write each
    row into ``db_path`` (default: the overlay), merged with what the file
    holds. A key the merged DB already times is re-measured: its prior
    ``mean_us`` against the fresh one is recorded as the
    ``tuner:<kernel>`` calibration pair. ``case_fn`` replaces
    :func:`tune_case` (tests); without it ``tune`` needs the card."""
    if case_fn is None:
        _need_card("tune")
        case_fn = tune_case
    path = db_path or overlay_db_path()
    db = TuningDB.load(path)
    log = (lambda s: print(s, flush=True)) if verbose else (lambda s: None)
    for kernel, case, dtype in cases:
        t0 = time.perf_counter()
        key, entry = case_fn(kernel, case, dtype, log=log)
        prior = get_db().lookup(key)
        prior_us = prior.get("mean_us") if prior else None
        if prior_us:
            from ..telemetry import calibration
            calibration.record(f"tuner:{kernel}", prior_us * 1e-6,
                               entry["mean_us"] * 1e-6)
        db.put(key, entry)
        log(f"{key} -> {entry['config']} ({entry['mean_us']} us; formula "
            f"{entry['default']['config']} {entry['default']['mean_us']} "
            f"us; fastest {entry['fastest']['config']} "
            f"{entry['fastest']['mean_us']} us; {entry['swept']} valid, "
            f"{time.perf_counter() - t0:.1f} s)")
    db.save(path)
    clear_cache()
    return db


# ---------------------------------------------------------------------------
# suites and CLI
# ---------------------------------------------------------------------------

def suite(name: str) -> List[Tuple[str, Dict[str, int], Any]]:
    """The sweep's cases: ``h100``, the main path's shapes (the CE forward
    at GPT-base and at gpt_1p3b's width; the paged decode and the
    bucketed 1+K verify window of the serving cell); ``smoke``, one small
    case of each."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    paged = dict(b=8, h=12, d=64, ps=16, width=64)
    if name == "h100":
        return [
            (CE_SPLIT_KERNEL, {"n": 8192, "h": 768, "v": 50304}, bf16),
            (CE_SPLIT_KERNEL, {"n": 8192, "h": 2048, "v": 50304}, bf16),
            (PAGED_SPLIT_KERNEL, dict(paged, tq=1), f32),
            (PAGED_SPLIT_KERNEL, dict(paged, tq=8), f32),
        ]
    if name == "smoke":
        return [
            (CE_SPLIT_KERNEL, {"n": 512, "h": 128, "v": 2048}, bf16),
            (PAGED_SPLIT_KERNEL, dict(b=2, h=2, d=64, ps=16, width=8, tq=1),
             f32),
        ]
    raise SystemExit(f"unknown suite {name!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="h100", choices=("h100", "smoke"),
                    help="shape cases to sweep")
    ap.add_argument("--db", default=None,
                    help="DB file to update (default: the overlay)")
    ap.add_argument("--generic", action="store_true",
                    help="update the shipped seed (tuning_db.json beside "
                         "this module) instead of the overlay")
    args = ap.parse_args(argv)
    from . import _build
    _need_card("tune")
    _build.build(["fused_ce", "paged_attention"])
    path = args.db or (default_db_path() if args.generic else None)
    db = tune(suite(args.suite), db_path=path, verbose=True)
    print(json.dumps({"tuning_db": db.path, "entries": len(db)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
