"""Decode serving in the PyTorch port (paddle_tpu_torch/inference) held
against the JAX package: the executor of both packages on the same batches,
the dense oracles, and port servers whose generations must equal the JAX
package's ``dense_generate`` token for token, through prefix sharing,
failover and speculative decoding. The golden fixture that the card checks
is regenerated in part here with the JAX package.

The port runs with ``device="cpu"`` (its kernel wrapper takes the plain
version there); the JAX executor runs its Pallas kernel in interpret mode.
Widths as tests/test_decode_serving.py (2 heads x 32), page size 8 so the
kernel gate holds. Tolerance for K/V returned by the executors: float32
``rtol=1e-5, atol=1e-6``; tokens must be equal.
"""
import os

import numpy as np
import pytest

import torch_decode_golden as golden
from paddle_tpu.inference import decode_model as jdm
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxCache
from paddle_tpu_torch.inference import decode_model as tdm
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.kv_cache import PagedKVCache as TorchCache
from paddle_tpu_torch.inference.spec_decode import (NGramDrafter,
                                                    SpeculativeDecodeServer)
from paddle_tpu_torch.resilience import faults
from torch_threads import two_threads  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)
PS = 8
PARAMS = jdm.init_decode_model(vocab=128, num_heads=2, head_dim=32, seed=7)
SYSTEM = [int(t) for t in np.random.RandomState(11).randint(0, 128, 8)]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.reset()


def prompt(i, extra=4, system=SYSTEM, vocab=128):
    rs = np.random.RandomState(100 + i)
    return system + [int(t) for t in rs.randint(0, vocab, extra)]


def oracle(p, n, params=PARAMS):
    return jdm.dense_generate(params, p, n)


def test_init_decode_model_is_the_jax_draw():
    ours = tdm.init_decode_model(vocab=128, num_heads=2, head_dim=32, seed=7)
    assert ours.keys() == PARAMS.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name], PARAMS[name])


def test_dense_generate_matches_jax():
    p = tdm.params_from_jax(PARAMS, "cpu")
    for i in (0, 1):
        assert tdm.dense_generate(p, prompt(i), 6, device="cpu") \
            == oracle(prompt(i), 6)


# -- the executor of both packages on the same batches -------------------------

def _caches(rs):
    """Two caches with identical contents: three sequences with 13, 8 and
    21 cached tokens, and one cold (empty) sequence."""
    jc = JaxCache(32, PS, 2, 32)
    tc = TorchCache(32, PS, 2, 32, device="cpu")
    seqs = []
    for n in (13, 8, 21, 0):
        toks = [int(t) for t in rs.randint(0, 128, n)]
        k = rs.randn(1, n, 2, 32).astype(np.float32)
        v = rs.randn(1, n, 2, 32).astype(np.float32)
        js, ts = jc.create([]), tc.create([])
        if n:
            jc.append(js, toks, k, v)
            tc.append(ts, toks, k, v)
        seqs.append((js, ts))
    return jc, tc, seqs


def _layout(cache, seqs, chunks, t_b, r_b, width=8):
    """DecodeServer._pad_concat's flattened varlen layout."""
    tokens = np.zeros(t_b, np.int32)
    row_id = np.zeros(t_b, np.int32)
    positions = np.zeros(t_b, np.int32)
    valid = np.zeros(t_b, np.int32)
    tables = np.zeros((r_b, width), np.int32)
    ctx_lens = np.zeros(r_b, np.int32)
    last_idx = np.zeros(r_b, np.int32)
    off = 0
    for i, (seq, chunk) in enumerate(zip(seqs, chunks)):
        n = len(chunk)
        tokens[off:off + n] = chunk
        row_id[off:off + n] = i
        positions[off:off + n] = np.arange(seq.length, seq.length + n)
        valid[off:off + n] = 1
        tables[i] = cache.block_table(seq, width)
        ctx_lens[i] = seq.length
        last_idx[i] = off + n - 1
        off += n
    return [tokens, row_id, positions, valid, tables, ctx_lens, last_idx]


@pytest.mark.parametrize("kind,rows,chunk_lens,t_b,r_b", [
    ("decode", (0, 1, 2), (1, 1, 1), 4, 4),     # pure decode + padded row
    ("verify", (0, 2), (5, 5), 16, 4),          # uniform 5-token chunks
    ("mixed", (1, 3), (1, 3), 4, 4),            # decode row + cold prefill
])
def test_step_fn_matches_jax_on_same_batch(kind, rows, chunk_lens, t_b, r_b):
    rs = np.random.RandomState(5)
    jc, tc, seqs = _caches(rs)
    chunks = [[int(t) for t in rs.randint(0, 128, n)] for n in chunk_lens]
    jarr = _layout(jc, [seqs[r][0] for r in rows], chunks, t_b, r_b)
    tarr = _layout(tc, [seqs[r][1] for r in rows], chunks, t_b, r_b)
    for a, b in zip(jarr, tarr):
        np.testing.assert_array_equal(a, b)
    jstep = jdm.make_step_fn(PARAMS, jc, interpret=True)
    tstep = tdm.make_step_fn(PARAMS, tc, device="cpu")
    jn, jk, jv = (np.asarray(o) for o in jstep(jarr))
    tn, tk, tv = tstep(tarr)
    assert isinstance(tn, np.ndarray) and tk.shape == (1, t_b, 2, 32)
    sel = jarr[3].astype(bool)
    np.testing.assert_array_equal(tn[sel], jn[sel])
    np.testing.assert_allclose(tk.numpy()[:, sel], jk[:, sel], **F32)
    np.testing.assert_allclose(tv.numpy()[:, sel], jv[:, sel], **F32)
    path = {"mixed": 0, "decode": 1, "verify": 2}[kind]
    assert [f.calls for f in tstep.jit_fns] == \
        [int(i == path) for i in range(3)]


# -- port servers against the JAX oracle ---------------------------------------

def make_stack(params=PARAMS, num_pages=64, max_pages_per_seq=8, replicas=2,
               server=serving.DecodeServer, **srv_kw):
    cache = TorchCache(num_pages, PS, 2, 32, device="cpu")
    fn = tdm.make_step_fn(params, cache, device="cpu")
    cfg_kw = dict(max_batch=32, call_timeout_s=30.0, batch_wait_s=0.002)
    cfg_kw.update(srv_kw.pop("cfg_kw", {}))
    srv = server(fn, cache, replicas=replicas,
                 config=serving.ServingConfig(**cfg_kw), prefill_chunk=8,
                 max_pages_per_seq=max_pages_per_seq, **srv_kw)
    return srv, cache, fn


def test_generations_match_jax_oracle_with_prefix_sharing():
    srv, cache, fn = make_stack()
    with srv:
        warm = srv.submit_generate(prompt(0), 5)
        assert [int(t) for t in warm.result(timeout=60)[0]] \
            == oracle(prompt(0), 5)
        hits0 = cache.prefix_hit_tokens
        shapes0 = sum(f._cache_size() for f in fn.jit_fns)
        reqs = [srv.submit_generate(prompt(i), 5) for i in range(1, 6)]
        for i, r in zip(range(1, 6), reqs):
            assert [int(t) for t in r.result(timeout=60)[0]] \
                == oracle(prompt(i), 5), f"request {i} diverged"
        # every follower reused the one full system-prompt page
        assert cache.prefix_hit_tokens - hits0 == 5 * PS
        assert srv.accounted()
        s = srv.stats()
        assert s["completed"] == 6 and s["decode_tokens"] == 30
        assert sum(f._cache_size() for f in fn.jit_fns) >= shapes0 > 0
    st = cache.stats()
    assert st["pages_used"] == st["evictable"]


def test_failover_mid_decode_matches_jax_oracle():
    srv, cache, _ = make_stack(
        cfg_kw=dict(call_timeout_s=1.0, probation_base_s=0.02,
                    probation_max_s=0.2, seed=3))
    with srv:
        srv.submit_generate(prompt(0), 3).result(timeout=60)
        with faults.inject("replica_stall") as spec:
            reqs = [srv.submit_generate(prompt(i), 4) for i in (1, 2, 3)]
            for i, r in zip((1, 2, 3), reqs):
                assert [int(t) for t in r.result(timeout=60)[0]] \
                    == oracle(prompt(i), 4), f"request {i} diverged"
        assert spec.fired == 1
        s = srv.stats()
        assert s["failovers"] >= 1 and s["failed"] == 0
        assert srv.accounted()


def test_speculative_decoding_is_exact():
    # vocab 32, seed 5: greedy continuations settle into a short cycle, so
    # the n-gram drafter locks on (the workload of tests/test_spec_decode.py)
    params = jdm.init_decode_model(vocab=32, num_heads=2, head_dim=32, seed=5)
    system = [int(t) for t in np.random.RandomState(11).randint(0, 32, 8)]
    srv, cache, fn = make_stack(params=params, server=SpeculativeDecodeServer,
                                drafter=NGramDrafter(), spec_k=4)
    with srv:
        reqs = [(p, srv.submit_generate(p, 12)) for p in
                (prompt(i, system=system, vocab=32) for i in range(4))]
        for i, (p, r) in enumerate(reqs):
            assert [int(t) for t in r.result(timeout=60)[0]] \
                == oracle(p, 12, params), f"request {i} diverged"
        assert srv.accounted()
        sd = srv.stats()["spec_decode"]
        assert sd["draft_tokens"] > 0 and sd["verify_steps"] > 0
    st = cache.stats()
    assert st["pages_used"] == st["evictable"]


def test_telemetry_traces_slo_and_flight_dump(tmp_path, monkeypatch):
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.telemetry import flight, slo, tracing
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    reg = telemetry.get_registry()
    reg.reset()
    flight.reset()
    telemetry.enable()
    tracing.enable(policy=tracing.KeepPolicy())
    mon = slo.install_shed_rule(threshold=0.3, window_s=600,
                                min_denominator=1)
    mon.min_poll_interval_s = 1e9        # polled explicitly below
    try:
        srv, cache, _ = make_stack(
            cfg_kw=dict(probation_base_s=0.02, probation_max_s=0.2))
        with srv:
            srv.submit_generate(prompt(0), 3).result(timeout=60)
            with faults.inject("serving_io") as spec:
                r = srv.submit_generate(prompt(1), 3)
                assert [int(t) for t in r.result(timeout=60)[0]] \
                    == oracle(prompt(1), 3)
            assert spec.fired == 1
        mon.poll()
        for _ in range(3):
            assert srv.submit_generate(prompt(2), 3).cause == "draining"
        assert [rule.name for rule, _ in mon.poll()] == ["shed_burn"]
        assert reg.get("serving_requests_total").value(
            outcome="completed") == 2
        assert reg.get("serving_requests_shed_total").value(
            cause="draining") == 3
        assert reg.get("serving_replica_failover_total").value() >= 1
        assert reg.get("resilience_faults_injected_total").value(
            kind="serving_io", site="serving_execute") == 1
        assert reg.get("kv_cache_prefix_hits_total").value() == PS
        assert reg.get("decode_tokens_total").value() == 6
        kept = tracing.snapshot_kept()
        assert "failover" in {t["keep_reason"] for t in kept}
        events = {e["name"] for t in kept for s in t["spans"]
                  for e in s["events"]}
        assert {"kv_prefix_hit", "kv_append"} <= events
        assert tracing.accounted()
        dumps = os.listdir(tmp_path)
        assert any(d.startswith("flight_drain_") for d in dumps)
        assert any(d.startswith("flight_slo_shed_burn_") for d in dumps)
    finally:
        telemetry.disable()
        tracing.disable()
        tracing.reset()
        slo.reset()
        flight.reset()
        reg.reset()


# -- the golden fixture the card checks ----------------------------------------

def test_golden_fixture_matches_jax_reference():
    fix = golden.load()
    assert fix["config"] == golden.CONFIG
    prompts = golden.prompts(fix)
    assert len(prompts) == golden.N_PROMPTS
    assert fix["prefix"] == golden.prefix()
    assert all(len(p) == golden.PREFIX_LEN + golden.SUFFIX_LEN
               for p in prompts)
    assert min(min(m) for m in fix["margins"]) >= fix["min_margin"]
    params = jdm.init_decode_model(**fix["config"])
    tparams = tdm.params_from_jax(params, "cpu")
    n = 8
    for i in (0, len(prompts) - 1):
        want = fix["tokens"][i][:n]
        assert jdm.dense_generate(params, prompts[i], n) == want
        assert tdm.dense_generate(tparams, prompts[i], n, device="cpu") \
            == want
