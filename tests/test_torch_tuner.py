"""The port's tuning DB (``paddle_tpu_torch/ops/tuner.py``) against the
JAX package's (``paddle_tpu/ops/pallas/tuner.py``), on the CPU.

Keys, buckets and the reference's candidate grids are equal; each package
reads the other's DB files; ``resolve`` answers as the reference's for
every key of the reference's shipped DB and for misses (both off a card:
device kind ``"cpu"``, the generic rows); a device row keeps the generic
rows of other kernels (the port's split counts live under their own
kernel names); the memo drops with ``clear_cache``; the two call sites
take the formula without a row and the row's count with one; the sweep's
winner, entry and calibration pair with injected validate and time
functions. Exact equality throughout: no arithmetic is compared.
"""
import importlib
import json
import os
import warnings

import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import fused_ce as ref_fc
from paddle_tpu.ops.pallas import tuner as ref_tuner

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.ops import fused_ce as fc
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import tuner
from paddle_tpu_torch.telemetry import calibration

# the package exports a function of the module's name
ref_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

H100 = "nvidia-h100-80gb-hbm3"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Overlays of both packages point into tmp_path (absent unless a test
    writes them); caches are dropped before and after."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TUNING_DB",
                       str(tmp_path / "port_overlay.json"))
    monkeypatch.setenv("PADDLE_TPU_TUNING_DB",
                       str(tmp_path / "ref_overlay.json"))
    monkeypatch.setenv("PADDLE_TPU_TORCH_CALIBRATION_DB",
                       str(tmp_path / "calib.json"))
    tuner.clear_cache()
    ref_tuner.clear_cache()
    yield
    tuner.clear_cache()
    ref_tuner.clear_cache()


def _defaults(kernel):
    return {"flash_attention": {"block_q": ref_fa.DEFAULT_BLOCK_Q,
                                "block_k": ref_fa.DEFAULT_BLOCK_K},
            "fused_ce": {"block_tokens": ref_fc.DEFAULT_BLOCK_TOKENS,
                         "block_vocab": ref_fc.DEFAULT_BLOCK_VOCAB},
            "paged_attention": {"q_pad": 8}}[kernel]


# -- keys and grids -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 100, 128, 129, 1000, 8192, 8193])
@pytest.mark.parametrize("floor", [1, 8, 128])
def test_shape_bucket_equals_the_reference(n, floor):
    assert tuner.shape_bucket(n, floor) == ref_tuner.shape_bucket(n, floor)


@pytest.mark.parametrize("d,sq,sk", [(64, 1, 100), (64, 5, 1024),
                                     (128, 1000, 2048), (64, 128, 128)])
def test_dims_and_keys_equal_the_reference(d, sq, sk):
    assert tuner.flash_dims(d, sq, sk) == ref_tuner.flash_dims(d, sq, sk)
    assert tuner.ce_dims(768, 50304, sq * 8) == \
        ref_tuner.ce_dims(768, 50304, sq * 8)
    for name, (tdt, jdt) in DTYPES.items():
        dims = tuner.flash_dims(d, sq, sk)
        assert tuner.make_key("flash_attention", "any", tdt, dims) == \
            ref_tuner.make_key("flash_attention", "any", jdt, dims)


@pytest.mark.parametrize("a,b", [(128, 128), (256, 1024), (1024, 2048),
                                 (512, 512), (64, 64), (8192, 50304),
                                 (100, 300)])
def test_candidate_grids_equal_the_reference(a, b):
    assert tuner.flash_candidates(a, b) == ref_tuner.flash_candidates(a, b)
    assert tuner.ce_candidates(a, b) == ref_tuner.ce_candidates(a, b)
    assert tuner.paged_candidates(None) == ref_tuner.paged_candidates(None)
    assert tuner.paged_candidates(a) == ref_tuner.paged_candidates(a)


def test_split_candidate_grids():
    assert tuner.ce_fwd_split_candidates(8192, 50304) == \
        [{"splits": s} for s in range(1, 17)]
    # 16 vocab tiles of 128 leave 4 splits of FWD_MIN_SPLIT_TILES tiles
    assert tuner.ce_fwd_split_candidates(512, 2048) == \
        [{"splits": s} for s in range(1, 5)]
    assert tuner.ce_fwd_split_candidates(512, 100) == [{"splits": 1}]
    assert tuner.paged_split_candidates(64, 16) == \
        [{"splits": s} for s in range(1, 17)]
    # the cap paged_splits applies: a page and 64 keys of a full table each
    assert tuner.paged_split_candidates(8, 16) == [{"splits": 1},
                                                   {"splits": 2}]
    for width, ps in ((64, 16), (8, 16), (3, 8), (200, 32)):
        cap = max(1, min(width, width * ps // pa.MIN_SPLIT_KEYS))
        assert pa.paged_splits(1, 1, width, ps, 10 ** 6) == cap
        assert tuner.paged_split_candidates(width, ps)[-1]["splits"] == \
            min(cap, tuner.MAX_SPLIT_CANDIDATES)


# -- the DB files ---------------------------------------------------------------

def test_port_reads_a_db_the_reference_wrote(tmp_path):
    ref_db = ref_tuner.TuningDB.load(ref_tuner.default_db_path())
    path = str(tmp_path / "ref_written.json")
    ref_db.save(path)
    got = tuner.TuningDB.load(path)
    assert got.entries == ref_db.entries and len(got) == 18
    for key in ref_db.entries:
        assert got.lookup(key) == ref_db.lookup(key)
    # and the reference reads the port's
    port_path = str(tmp_path / "port_written.json")
    got.save(port_path)
    assert ref_tuner.TuningDB.load(port_path).entries == ref_db.entries


def test_seed_holds_the_reference_rows_verbatim_and_port_device_rows():
    ref_db = ref_tuner.TuningDB.load(ref_tuner.default_db_path())
    seed = tuner.TuningDB.load(tuner.default_db_path())
    generic = {k: v for k, v in seed.entries.items() if "|any|" in k}
    assert generic == ref_db.entries
    kinds = {"flash_attention": 6, "fused_ce": 3, "paged_attention": 9}
    for kernel, n in kinds.items():
        assert sum(k.startswith(kernel + "|") for k in generic) == n
    for key, e in seed.entries.items():
        if key in generic:
            continue
        assert e["kernel"] in (tuner.CE_SPLIT_KERNEL,
                               tuner.PAGED_SPLIT_KERNEL), key
        assert e["validated"] == "device" and e["mean_us"] > 0, key
        assert set(e["config"]) == {"splits"}, key
        assert key == tuner.make_key(e["kernel"], e["device"], e["dtype"],
                                     e["dims"])


@pytest.mark.parametrize("content", ["{not json", "[1, 2]",
                                     '{"entries": [1]}'])
def test_corrupt_db_reads_empty_with_one_warning(tmp_path, content):
    path = tmp_path / "bad.json"
    path.write_text(content)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        db = tuner.TuningDB.load(str(path))
    assert len(db) == 0
    assert len(seen) == 1 and "unreadable" in str(seen[0].message)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert len(tuner.TuningDB.load(str(tmp_path / "missing.json"))) == 0
    assert not seen


def test_save_is_atomic_and_the_overlay_wins(tmp_path):
    key = tuner.make_key("fused_ce", "any", torch.bfloat16,
                         tuner.ce_dims(768, 50304, 8192))
    overlay = tuner.TuningDB(path=os.environ["PADDLE_TPU_TORCH_TUNING_DB"])
    overlay.put(key, {"config": {"block_tokens": 128, "block_vocab": 512}})
    overlay.save()
    assert not os.path.exists(overlay.path + ".tmp")
    db = tuner.get_db(refresh=True)
    assert db.lookup(key)["config"] == {"block_tokens": 128,
                                        "block_vocab": 512}
    assert len(db) == len(tuner.TuningDB.load(tuner.default_db_path()))
    cfg, src = tuner.resolve("fused_ce", torch.bfloat16,
                             tuner.ce_dims(768, 50304, 8192),
                             _defaults("fused_ce"))
    assert (cfg, src) == ({"block_tokens": 128, "block_vocab": 512}, "db")


# -- resolution -------------------------------------------------------------------

def _ref_keys():
    db = ref_tuner.TuningDB.load(ref_tuner.default_db_path())
    for key, e in sorted(db.entries.items()):
        yield key, e["kernel"], e["dtype"], e["dims"]
    # misses: shapes and dtypes the DB does not hold
    yield "miss-flash", "flash_attention", "float32", {"d": 64, "sq": 4096,
                                                      "sk": 4096}
    yield "miss-ce", "fused_ce", "bfloat16", {"h": 2048, "t": 8192,
                                             "v": 50304}
    yield "miss-paged", "paged_attention", "bfloat16", {"d": 128, "ps": 16,
                                                       "sk": 1024}


@pytest.mark.parametrize("key,kernel,dtype,dims", list(_ref_keys()),
                         ids=[k[0] for k in _ref_keys()])
def test_resolve_equals_the_reference(key, kernel, dtype, dims):
    tdt, jdt = DTYPES[dtype]
    got = tuner.resolve(kernel, tdt, dims, _defaults(kernel))
    want = ref_tuner.resolve(kernel, jdt, dims, _defaults(kernel))
    assert got == want
    assert got[1] == ("default" if key.startswith("miss") else "db")


def _write_overlay(rows):
    db = tuner.TuningDB(path=os.environ["PADDLE_TPU_TORCH_TUNING_DB"])
    for kernel, dev, dtype, dims, cfg in rows:
        db.put(tuner.make_key(kernel, dev, dtype, dims),
               {"config": cfg, "kernel": kernel, "device": dev,
                "dtype": str(dtype).rsplit(".", 1)[-1], "dims": dims,
                "mean_us": 1.0, "validated": "device"})
    db.save()
    tuner.clear_cache()


def test_a_device_row_keeps_the_generic_rows(monkeypatch):
    """The shadowing trap: a device row merges over the defaults, not over
    the generic row, so the port's split counts live under their own
    kernel names and the reference's fused_ce row still answers."""
    monkeypatch.setattr(tuner, "device_kind", lambda: H100)
    ce = tuner.ce_dims(768, 50304, 8192)
    _write_overlay([(tuner.CE_SPLIT_KERNEL, H100, torch.bfloat16, ce,
                     {"splits": 7})])
    got = tuner.resolve("fused_ce", torch.bfloat16, ce, _defaults("fused_ce"))
    want = ref_tuner.resolve("fused_ce", jnp.bfloat16, ce,
                             _defaults("fused_ce"))
    assert got == want == ({"block_tokens": 256, "block_vocab": 2048}, "db")
    assert tuner.resolve(tuner.CE_SPLIT_KERNEL, torch.bfloat16, ce,
                         {"splits": 4}) == ({"splits": 7}, "db")
    # and the flash blocks that key the dropout mask stay the reference's
    for s in (128, 1024, 2048):
        dims = tuner.flash_dims(64, s, s)
        assert tuner.resolve("flash_attention", torch.bfloat16, dims,
                             _defaults("flash_attention")) == \
            ref_tuner.resolve("flash_attention", jnp.bfloat16, dims,
                              _defaults("flash_attention"))


def test_memo_drops_on_clear_cache():
    ce = tuner.ce_dims(768, 50304, 8192)
    args = (tuner.CE_SPLIT_KERNEL, torch.bfloat16, ce, {"splits": 4})
    assert tuner.resolve(*args) == ({"splits": 4}, "default")
    db = tuner.TuningDB(path=os.environ["PADDLE_TPU_TORCH_TUNING_DB"])
    db.put(tuner.make_key(tuner.CE_SPLIT_KERNEL, "cpu", torch.bfloat16, ce),
           {"config": {"splits": 9}})
    db.save()
    # the DB and its memo are cached: the file changed under them
    assert tuner.resolve(*args) == ({"splits": 4}, "default")
    tuner.clear_cache()
    assert tuner.resolve(*args) == ({"splits": 9}, "db")
    # another formula value is another memo key
    assert tuner.resolve(tuner.CE_SPLIT_KERNEL, torch.bfloat16, ce,
                         {"splits": 3}) == ({"splits": 9}, "db")


def test_resolutions_are_counted():
    with telemetry.scope(None, profile=False) as sc:
        tuner.resolve("fused_ce", torch.bfloat16,
                      tuner.ce_dims(768, 50304, 8192), _defaults("fused_ce"))
        for _ in range(2):
            tuner.resolve(tuner.PAGED_SPLIT_KERNEL, torch.float32,
                          tuner.paged_split_dims(3, 2, 64, 16, 8, 1),
                          {"splits": 2})
        c = sc.registry.get("kernel_config_resolved_total")
        assert c.value(kernel="fused_ce", source="db") == 1
        assert c.value(kernel=tuner.PAGED_SPLIT_KERNEL,
                       source="default") == 2


@pytest.mark.parametrize("n,h,v", [(8192, 768, 50304), (8192, 2048, 50304),
                                   (300, 768, 700), (1000, 128, 4096)])
def test_ce_call_site_takes_the_formula_then_the_row(monkeypatch, n, h, v):
    for sms in (132, 114):
        assert fc.tiled_splits(torch.bfloat16, n, h, v, sms) == \
            fc.fwd_splits(n, v, sms)
    monkeypatch.setattr(tuner, "device_kind", lambda: H100)
    _write_overlay([(tuner.CE_SPLIT_KERNEL, H100, torch.bfloat16,
                     tuner.ce_dims(h, v, n), {"splits": 11})])
    assert fc.tiled_splits(torch.bfloat16, n, h, v, 132) == 11
    # another dtype or kind misses the row
    assert fc.tiled_splits(torch.float32, n, h, v, 132) == \
        fc.fwd_splits(n, v, 132)
    monkeypatch.setattr(tuner, "device_kind", lambda: "nvidia-a100")
    assert fc.tiled_splits(torch.bfloat16, n, h, v, 132) == \
        fc.fwd_splits(n, v, 132)


@pytest.mark.parametrize("b,tq,h,width", [(8, 1, 12, 64), (8, 8, 12, 64),
                                          (5, 5, 12, 64), (1, 1, 2, 8)])
def test_paged_call_site_takes_the_formula_then_the_row(monkeypatch, b, tq,
                                                        h, width):
    args = (torch.float32, b, tq, h, 64, 16, width, 132)
    assert pa.route_splits(*args) == pa.paged_splits(b, h, width, 16, 132)
    monkeypatch.setattr(tuner, "device_kind", lambda: H100)
    _write_overlay([(tuner.PAGED_SPLIT_KERNEL, H100, torch.float32,
                     tuner.paged_split_dims(b, h, 64, 16, width, tq),
                     {"splits": 3})])
    assert pa.route_splits(*args) == 3
    # bf16 pools are another key
    assert pa.route_splits(torch.bfloat16, *args[1:]) == \
        pa.paged_splits(b, h, width, 16, 132)
    # a batch in the same power-of-two bucket shares the row
    b2 = tuner.shape_bucket(b, floor=1)
    assert pa.route_splits(torch.float32, b2, *args[2:]) == 3


def test_paged_dims_bucket_rows_and_queries():
    assert tuner.paged_split_dims(5, 12, 64, 16, 64, 5) == \
        {"b": 8, "h": 12, "d": 64, "ps": 16, "sk": 1024, "sq": 8}
    assert tuner.paged_split_dims(1, 2, 32, 8, 3, 1) == \
        {"b": 1, "h": 2, "d": 32, "ps": 8, "sk": 128, "sq": 1}


# -- the sweep ----------------------------------------------------------------------

def test_tune_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tuner.tune(tuner.suite("smoke"))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tuner.tune_case(tuner.CE_SPLIT_KERNEL, {"n": 512, "h": 128,
                                                "v": 2048}, torch.bfloat16)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tuner.main(["--suite", "smoke"])


def _fake(times, errs, tol=1e-4):
    calls = []

    def validate(cfg):
        calls.append(("validate", cfg["splits"]))
        e = errs.get(cfg["splits"], 0.0)
        return e, e <= tol

    def timeit(cfg):
        calls.append(("time", cfg["splits"]))
        return times[cfg["splits"]]
    return validate, timeit, calls


def test_sweep_validates_before_timing_and_takes_the_fastest():
    times = {1: 50.0, 2: 30.0, 3: 20.0, 4: 25.0}
    validate, timeit, calls = _fake(times, {3: 5e-3})
    cands = [{"splits": s} for s in range(1, 5)]
    dims = tuner.ce_dims(128, 2048, 512)
    key, e = tuner.sweep(tuner.CE_SPLIT_KERNEL, dims, torch.bfloat16, H100,
                         cands, {"splits": 2}, validate, timeit)
    assert key == f"{tuner.CE_SPLIT_KERNEL}|{H100}|bfloat16|h128,t512,v2048"
    # 3 is fastest but fails validation: never timed, never chosen
    assert ("time", 3) not in calls
    for s in (1, 2, 4):
        assert calls.index(("validate", s)) < calls.index(("time", s))
    assert e["config"] == {"splits": 4} and e["mean_us"] == 25.0
    assert e["default"] == {"config": {"splits": 2}, "mean_us": 30.0}
    assert e["fastest"] == {"config": {"splits": 4}, "mean_us": 25.0}
    assert e["swept"] == 3 and e["validated"] == "device"
    assert e["kernel"] == tuner.CE_SPLIT_KERNEL and e["device"] == H100
    assert e["dtype"] == "bfloat16" and e["dims"] == dims
    assert [c["mean_us"] for c in e["candidates"]] == [50.0, 30.0, None,
                                                       25.0]
    assert e["candidates"][2]["max_err"] == 5e-3
    json.dumps(e)   # a DB entry is plain JSON


@pytest.mark.parametrize("fastest_us,chosen", [
    (30.0 * (1 - tuner.MIN_GAIN) - 0.01, 4),     # a clear win replaces it
    (30.0 * (1 - tuner.MIN_GAIN) + 0.01, 2),     # within noise: the formula
    (30.0, 2)])
def test_sweep_keeps_the_formula_unless_a_candidate_clearly_wins(
        fastest_us, chosen):
    validate, timeit, _ = _fake({1: 50.0, 2: 30.0, 4: fastest_us}, {})
    _, e = tuner.sweep(tuner.CE_SPLIT_KERNEL, tuner.ce_dims(128, 2048, 512),
                       torch.bfloat16, H100,
                       [{"splits": s} for s in (1, 2, 4)], {"splits": 2},
                       validate, timeit)
    assert e["config"] == {"splits": chosen}
    assert e["mean_us"] == round(fastest_us if chosen == 4 else 30.0, 3)
    assert e["fastest"]["config"] == {"splits": 4 if fastest_us < 30 else 2}


def test_sweep_raises_when_nothing_or_the_formula_fails():
    cands = [{"splits": s} for s in range(1, 3)]
    dims = tuner.ce_dims(128, 2048, 512)
    v, t, _ = _fake({1: 1.0, 2: 2.0}, {1: 1.0, 2: 1.0})
    with pytest.raises(RuntimeError, match="no candidate"):
        tuner.sweep(tuner.CE_SPLIT_KERNEL, dims, torch.bfloat16, H100,
                    cands, {"splits": 1}, v, t)
    v, t, _ = _fake({1: 1.0, 2: 2.0}, {2: 1.0})
    with pytest.raises(RuntimeError, match="formula"):
        tuner.sweep(tuner.CE_SPLIT_KERNEL, dims, torch.bfloat16, H100,
                    cands, {"splits": 2}, v, t)
    # a formula outside the candidates is validated and timed too
    v, t, calls = _fake({1: 1.0, 2: 2.0, 5: 3.0}, {})
    _, e = tuner.sweep(tuner.CE_SPLIT_KERNEL, dims, torch.bfloat16, H100,
                       cands, {"splits": 5}, v, t)
    assert e["default"] == {"config": {"splits": 5}, "mean_us": 3.0}
    assert ("time", 5) in calls and e["config"] == {"splits": 1}

    def boom(cfg):
        raise RuntimeError("launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        tuner.sweep(tuner.CE_SPLIT_KERNEL, dims, torch.bfloat16, H100,
                    cands, {"splits": 1}, boom, t)


def test_tune_writes_the_overlay_and_records_the_drift_pair(monkeypatch):
    monkeypatch.setattr(tuner, "device_kind", lambda: H100)
    calibration.reset()
    runs = iter([{1: 40.0, 2: 20.0}, {1: 40.0, 2: 30.0}])

    def case_fn(kernel, case, dtype, log=None):
        v, t, _ = _fake(next(runs), {})
        return tuner.sweep(kernel, tuner.ce_dims(**case), dtype,
                           tuner.device_kind(),
                           [{"splits": 1}, {"splits": 2}], {"splits": 1},
                           v, t)

    cases = [(tuner.CE_SPLIT_KERNEL, {"h": 128, "v": 2048, "tokens": 512},
              torch.bfloat16)]
    db = tuner.tune(cases, case_fn=case_fn)
    assert db.path == os.environ["PADDLE_TPU_TORCH_TUNING_DB"]
    key = tuner.make_key(tuner.CE_SPLIT_KERNEL, H100, torch.bfloat16,
                         tuner.ce_dims(128, 2048, 512))
    assert db.lookup(key)["mean_us"] == 20.0
    assert calibration.pair(f"tuner:{tuner.CE_SPLIT_KERNEL}") is None
    # the fresh DB answers at once (tune drops the caches)
    assert tuner.resolve(tuner.CE_SPLIT_KERNEL, torch.bfloat16,
                         tuner.ce_dims(128, 2048, 512), {"splits": 1}) == \
        ({"splits": 2}, "db")
    tuner.tune(cases, case_fn=case_fn)
    p = calibration.pair(f"tuner:{tuner.CE_SPLIT_KERNEL}")
    assert p["predicted"] == pytest.approx(20e-6) and \
        p["measured"] == pytest.approx(30e-6) and p["n"] == 1
    assert tuner.TuningDB.load(db.path).lookup(key)["mean_us"] == 30.0
    calibration.reset()


def test_suites_name_the_main_path_shapes():
    h100 = tuner.suite("h100")
    assert [(k, c) for k, c, _ in h100] == [
        (tuner.CE_SPLIT_KERNEL, {"n": 8192, "h": 768, "v": 50304}),
        (tuner.CE_SPLIT_KERNEL, {"n": 8192, "h": 2048, "v": 50304}),
        (tuner.PAGED_SPLIT_KERNEL, dict(b=8, h=12, d=64, ps=16, width=64,
                                        tq=1)),
        (tuner.PAGED_SPLIT_KERNEL, dict(b=8, h=12, d=64, ps=16, width=64,
                                        tq=8))]
    assert [d for *_, d in h100] == [torch.bfloat16, torch.bfloat16,
                                     torch.float32, torch.float32]
    assert len(tuner.suite("smoke")) == 2
    with pytest.raises(SystemExit):
        tuner.suite("nope")
