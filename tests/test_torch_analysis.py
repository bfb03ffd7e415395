"""The port's program analysis (``paddle_tpu_torch/analysis``) against the
JAX package's (``paddle_tpu/analysis``), on the CPU.

Both packages' ``ParallelTrainer`` trace the same step from the same
weights: GPT (2 layers, hidden 64, 4 heads, seq 64, vocab 128, batch 2,
AdamW, chunked CE, plain attention on both sides) and resnet18 at 32 x 32
(batch 4, Momentum). The reference stages a jaxpr
(``staged_jaxpr``), the port a ``make_fx`` graph on fake tensors
(``staged_graph``). Tolerances, each stated where it is asserted:

- matmul FLOPs (and for ResNet the convolutions' FLOPs, the reference's
  ``_conv_flops`` over every ``conv_general_dilated``) are sums of
  products of integer dims: equal to a relative 1e-9. So is the multiset
  of the matmuls' FLOPs, the reference's weighted by each equation's trip
  count (its chunked CE is a scan; the port's chunks are unrolled).
- total FLOPs price the elementwise tail by output elements; the two
  frameworks spell it differently (XLA's convert/select/broadcast against
  ATen's fused ``where``, ``addcmul`` and friends), so the totals agree
  within 5%.
- peak live bytes: the reference adds a called body's own peak (its
  inputs counted again) at the call point, and frees the inputs after
  their last use; the port keeps the inputs (the trainer's state) live
  throughout and counts a view or an in-place result as its input's
  storage. So the port's peak lies between 30% and 105% of the
  reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import analysis as ref_analysis
from paddle_tpu import nn as rnn
from paddle_tpu.analysis import cost as ref_cost
from paddle_tpu.analysis.walker import walk as ref_walk
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.text.models import GPTForPretraining as RefGPT
from paddle_tpu.vision.models import resnet18 as ref_resnet18

from paddle_tpu_torch import analysis, framework
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.analysis import cost, lint, walker
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce as fc
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.text.models import GPTForPretraining
from paddle_tpu_torch.vision.models import resnet18

GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64, tensor_parallel=False,
               attn_dropout=0.0, hidden_dropout=0.0)
TOTAL_RTOL = 5e-2
PEAK_RANGE = (0.3, 1.05)


class _RefLoss(rnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.inner = m

    def forward(self, b):
        return self.inner.fused_head_loss(b[0], b[1], chunk=64,
                                          ce_kernel="chunked")


class _PortLoss(tnn.Layer):
    def __init__(self, m):
        super().__init__()
        self.inner = m

    def forward(self, b):
        return self.inner.fused_head_loss(b[0], b[1], chunk=64,
                                          ce_kernel="chunked")


_CACHE = {}


def _gpt():
    """(reference jaxpr, port graph, port trainer, batch) of one step."""
    if "gpt" not in _CACHE:
        paddle.seed(0)
        ref = RefGPT(**GPT_CFG)
        port = GPTForPretraining(**GPT_CFG)
        port.set_state_dict_from_numpy(
            {k: np.asarray(v) for k, v in ref.state_dict().items()})
        rt = RefTrainer(_RefLoss(ref), paddle.optimizer.AdamW(
            3e-4, parameters=ref.parameters()), lambda o, _l: o,
            mesh=ref_build_mesh({"data": 1}))
        pt = ParallelTrainer(_PortLoss(port), topt.AdamW(3e-4),
                             lambda o, _l: o,
                             mesh=mesh_mod.build_mesh({"data": 1}),
                             device="cpu")
        rs = np.random.RandomState(3)
        ids, lbl = (rs.randint(0, 128, (2, 64)).astype(np.int32)
                    for _ in range(2))
        batch = ((torch.from_numpy(ids), torch.from_numpy(lbl)), 0.0)
        _CACHE["gpt"] = (rt.staged_jaxpr((ids, lbl), 0.0),
                         pt.staged_graph(*batch), pt, batch)
    return _CACHE["gpt"]


def _resnet():
    if "resnet" not in _CACHE:
        paddle.seed(0)
        ref = ref_resnet18()
        rs = np.random.RandomState(0)
        x = rs.randn(4, 3, 32, 32).astype(np.float32)
        y = rs.randint(0, 1000, (4,)).astype(np.int64)
        rt = RefTrainer(ref, paddle.optimizer.Momentum(
            1e-2, momentum=0.9, parameters=ref.parameters()),
            lambda o, t: rnn.functional.cross_entropy(o, t),
            mesh=ref_build_mesh({"data": 1}))
        framework.seed(0)
        pt = ParallelTrainer(resnet18(), topt.Momentum(1e-2, momentum=0.9),
                             lambda o, t: tnn.functional.cross_entropy(o, t),
                             mesh=mesh_mod.build_mesh({"data": 1}),
                             device="cpu")
        _CACHE["resnet"] = (rt.staged_jaxpr(x, y), pt.staged_graph(
            torch.from_numpy(x), torch.from_numpy(y)))
    return _CACHE["resnet"]


def _ref_matmul_multiset(closed):
    out = []
    for s in ref_walk(closed):
        if s.primitive == "dot_general":
            out += [ref_cost.dot_general_flops(s.eqn)] * int(s.trips)
    return sorted(out)


# ---------------------------------------------------------------------------
# walker and cost against the reference
# ---------------------------------------------------------------------------

def test_gpt_matmul_flops_equal_the_reference():
    closed, graph, _, _ = _gpt()
    ref, port = ref_cost.matmul_flops(closed), cost.matmul_flops(graph)
    assert ref > 0
    np.testing.assert_allclose(port, ref, rtol=1e-9)
    mine = sorted(cost.matmul_node_flops(s) for s in walker.walk(graph)
                  if s.op in cost._MATMUL)
    assert mine == _ref_matmul_multiset(closed)


def test_gpt_total_flops_and_peak_within_their_bands():
    closed, graph, _, _ = _gpt()
    np.testing.assert_allclose(cost.total_flops(graph),
                               ref_cost.total_flops(closed),
                               rtol=TOTAL_RTOL)
    ratio = cost.peak_live_bytes(graph) / ref_cost.peak_live_bytes(closed)
    assert PEAK_RANGE[0] <= ratio <= PEAK_RANGE[1], ratio


def test_resnet18_conv_and_matmul_flops_equal_the_reference():
    closed, graph = _resnet()
    ref_conv = sum(ref_cost._conv_flops(s.eqn) * s.trips
                   for s in ref_walk(closed)
                   if s.primitive == "conv_general_dilated")
    assert ref_conv > 0
    np.testing.assert_allclose(cost.conv_flops(graph), ref_conv, rtol=1e-9)
    np.testing.assert_allclose(cost.matmul_flops(graph),
                               ref_cost.matmul_flops(closed), rtol=1e-9)
    np.testing.assert_allclose(cost.total_flops(graph),
                               ref_cost.total_flops(closed),
                               rtol=TOTAL_RTOL)
    ratio = cost.peak_live_bytes(graph) / ref_cost.peak_live_bytes(closed)
    assert PEAK_RANGE[0] <= ratio <= PEAK_RANGE[1], ratio


def test_top_rows_and_report_render():
    _, graph, _, _ = _gpt()
    rep = analysis.analyze_graph(graph, config=analysis.AnalysisConfig(
        top_k=5))
    assert rep.num_eqns == walker.count_nodes(graph) > 500
    assert len(rep.cost.top) == 5
    assert all(r.flops >= rep.cost.top[-1].flops for r in rep.cost.top)
    assert "program analysis" in rep.to_text()
    d = rep.to_dict()
    assert d["ok"] and d["cost"]["matmul_flops"] == cost.matmul_flops(graph)
    assert rep.to_json()


# ---------------------------------------------------------------------------
# every kernel as one node
# ---------------------------------------------------------------------------

def _kernel_counts(graph):
    return {k: v for k, v in walker.count_by_op(graph).items()
            if k in walker.KERNEL_OPS}


@pytest.mark.parametrize("kernel", ["flash", "fused_ce", "paged"])
def test_each_kernel_is_one_node_on_cpu_fakes(kernel):
    g = torch.Generator().manual_seed(0)
    if kernel == "flash":
        q, k, v = (torch.randn(1, 128, 2, 64, generator=g)
                   .requires_grad_() for _ in range(3))

        def f(q, k, v):
            o = fa.flash_attention(q, k, v, causal=True)
            return torch.autograd.grad(o.float().sum(), (q, k, v))
        args = (q, k, v)
        want = {"paddle_tpu_torch.flash_attention_fwd": 1,
                "paddle_tpu_torch.flash_attention_dq": 1,
                "paddle_tpu_torch.flash_attention_dkv": 1}
    elif kernel == "fused_ce":
        h = torch.randn(64, 32, generator=g).requires_grad_()
        w = torch.randn(32, 100, generator=g).requires_grad_()
        lbl = torch.randint(0, 100, (64,), generator=g)

        def f(h, w, lbl):
            return torch.autograd.grad(fc.fused_lm_ce(h, w, lbl), (h, w))
        args = (h, w, lbl)
        want = {"paddle_tpu_torch.fused_ce_fwd": 1,
                "paddle_tpu_torch.fused_ce_dh": 1,
                "paddle_tpu_torch.fused_ce_dw": 1}
    else:
        args = (torch.randn(2, 1, 2, 32, generator=g),
                torch.randn(8, 16, 2, 32, generator=g),
                torch.randn(8, 16, 2, 32, generator=g),
                torch.zeros(2, 4, dtype=torch.int32),
                torch.tensor([5, 9], dtype=torch.int32))

        def f(*a):
            return pa.paged_attention(*a)
        want = {"paddle_tpu_torch.paged_attention": 1}
    launches = (dict(fa.LAUNCHES), dict(fc.LAUNCHES), dict(pa.LAUNCHES))
    graph = walker.trace_program(f, *args)
    assert _kernel_counts(graph) == want
    assert (dict(fa.LAUNCHES), dict(fc.LAUNCHES), dict(pa.LAUNCHES)) == \
        launches
    # the graph replays: each op's CPU body is the plain version
    out = graph(*args)
    assert all(torch.isfinite(t).all() for t in out)


def test_forward_kernels_are_one_node_on_cuda_fakes():
    """A fake CUDA tensor reaches each op's fake implementation: one node,
    no data_ptr read (the backward on CUDA fakes needs the card: the
    autograd engine asks for a CUDA device guard; chip_smoke.py phase
    ``analysis`` traces it there)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    with FakeTensorMode(allow_non_fake_inputs=True):
        q, k, v = (torch.randn(1, 256, 2, 64, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        h = torch.randn(128, 64, device="cuda", dtype=torch.bfloat16)
        w = torch.randn(64, 512, device="cuda", dtype=torch.bfloat16)
        lbl = torch.randint(0, 512, (128,), device="cuda")
        pq = torch.randn(2, 1, 2, 32, device="cuda")
        pool = torch.randn(8, 16, 2, 32, device="cuda")
        tab = torch.zeros(2, 4, dtype=torch.int32, device="cuda")
        ln = torch.ones(2, dtype=torch.int32, device="cuda")

    def f(q, k, v, h, w, lbl, pq, pool, tab, ln):
        with torch.no_grad():
            return (fa.flash_attention(q, k, v, causal=True),
                    fc.fused_lm_ce(h, w, lbl),
                    pa.paged_attention(pq, pool, pool, tab, ln))
    g = make_fx(f, tracing_mode="fake")(q, k, v, h, w, lbl, pq, pool, tab,
                                         ln)
    assert _kernel_counts(g) == {
        "paddle_tpu_torch.flash_attention_fwd": 1,
        "paddle_tpu_torch.fused_ce_fwd": 1,
        "paddle_tpu_torch.paged_attention": 1}
    devs = {str(n.meta["val"].device) for n in g.graph.nodes
            if n.op == "placeholder"}
    assert devs == {"cuda:0"}
    work = {s.op: cost.kernel_work(s) for s in walker.walk(g) if s.is_kernel}
    assert work["paddle_tpu_torch.fused_ce_fwd"] == \
        cost.ce_fwd_work(128, 64, 512, 2)


# ---------------------------------------------------------------------------
# the trainer's analysis surface
# ---------------------------------------------------------------------------

def _snapshot(tr):
    from paddle_tpu_torch.distributed._staging import state_leaves
    from paddle_tpu_torch.framework import random as rnd
    leaves, _ = state_leaves(tr.model, tr, tr._STATE_ATTRS)
    gens = [g.get_state().clone() for g in rnd._generators.values()]
    return ([t.detach().clone() for t in leaves], gens, tr._steps_run,
            sorted(rnd._generators))


def test_compile_analyze_leaves_the_trainer_bit_for_bit():
    _, _, tr, batch = _gpt()
    tr.train_step(*batch, lr=3e-4)      # non-trivial slots and step count
    before = _snapshot(tr)
    step, rep = tr.compile(*batch, analyze=True)
    tr.staged_graph(*batch, do_check=True)
    after = _snapshot(tr)
    assert before[2] == after[2] and before[3] == after[3]
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
    assert rep.ok and rep.cost.matmul_flops > 0
    assert rep.graph is not None
    loss = step()                       # the step callable still trains
    assert torch.isfinite(loss)


def test_program_family_verifies():
    from paddle_tpu_torch.analysis import schedule
    _, _, tr, batch = _gpt()
    out = schedule.verify_family(tr.program_family(*batch))
    assert out["ok"]
    # one rank: neither step issues a collective; the structure differs
    assert len(set(out["fingerprints"].values())) == 1
    g0 = tr.staged_graph(*batch)
    g1 = tr.staged_graph(*batch, do_check=True)
    assert schedule.program_fingerprint(g0, structure=True) != \
        schedule.program_fingerprint(g1, structure=True)
    assert schedule.program_fingerprint(g1, structure=True) == \
        schedule.program_fingerprint(tr.staged_graph(*batch, do_check=True),
                                     structure=True)


def test_count_fingerprint_collectives_at_one_rank():
    from paddle_tpu_torch.resilience import integrity
    _, _, tr, batch = _gpt()
    for check in (False, True):
        assert integrity.count_fingerprint_collectives(
            tr.staged_graph(*batch, do_check=check)) == 0


def test_overlap_model_and_gauge_at_one_rank():
    from paddle_tpu_torch import telemetry
    _, graph, tr, batch = _gpt()
    plan = cost.overlap_plan(graph, tr.mesh)
    out = cost.replay_overlap(plan, peak_flops=1e12)
    assert out["n_collectives"] == 0 and out["overlap_efficiency"] is None
    np.testing.assert_allclose(out["makespan"],
                               cost.total_flops(graph) / 1e12, rtol=1e-9)
    telemetry.enable()
    try:
        tr.compile(*batch)
        tr.train_step(*batch)
        snap = telemetry.get_registry().to_dict()
    finally:
        telemetry.disable()
    assert "grad_sync_overlap_efficiency" not in snap   # no collective


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def test_rule_ids_partition_the_reference():
    ref = {rid: r.severity for rid, r in ref_analysis.RULES.items()}
    mine = set(analysis.RULES) | set(analysis.NOT_APPLICABLE)
    assert mine == set(ref)
    assert not set(analysis.RULES) & set(analysis.NOT_APPLICABLE)
    for rid, r in analysis.RULES.items():
        assert r.severity == ref[rid], rid
    assert all(len(why) > 20 for why in analysis.NOT_APPLICABLE.values())


def _ref_count(fn, *args, rule, x64=False, **kw):
    import jax
    if x64:
        with jax.enable_x64(True):
            closed = jax.make_jaxpr(fn)(*args)
    else:
        closed = jax.make_jaxpr(fn)(*args)
    return len(ref_analysis.analyze(closed, rule_ids=[rule], **kw)
               .by_rule(rule))


def _port_count(fn, *args, rule, **kw):
    return len(analysis.analyze(fn, *args, rule_ids=[rule], **kw)
               .by_rule(rule))


def _planted(rule):
    """(reference count, port count) of one planted program each."""
    import jax
    import jax.numpy as jnp
    x = np.ones((16, 16), np.float32)
    t = torch.ones(16, 16)
    if rule == "fp64-leak":
        return (_ref_count(lambda a: a.astype(jnp.float64) * 2, x,
                           rule=rule, x64=True),
                _port_count(lambda a: a.double() * 2, t, rule=rule))
    if rule == "amp-fp32-leak":
        xb = jnp.ones((16, 16), jnp.bfloat16)
        return (_ref_count(lambda a, w: a.astype(jnp.float32) @ w, xb, x,
                           rule=rule),
                _port_count(lambda a, w: a.float() @ w, t.bfloat16(), t,
                            rule=rule))
    if rule == "non-donated-large-arg":
        big = np.ones((1024, 1024), np.float32)      # 4 MiB
        jf = jax.jit(lambda a: a * 2)
        return (_ref_count(lambda a: jf(a), big, rule=rule),
                _port_count(lambda a: a.copy_(a * 2),
                            torch.ones(1024, 1024), rule=rule))
    if rule == "recompile-scalar-const":
        c = jnp.asarray(3.0, jnp.float32)
        tc = torch.tensor(3.0)
        return (_ref_count(lambda a: a * c, x, rule=rule),
                _port_count(lambda a: a * tc, t, rule=rule))
    if rule == "dead-equation":
        return (_ref_count(lambda a: (jnp.sin(a), a + 1)[1], x, rule=rule),
                _port_count(lambda a: (torch.sin(a), a + 1)[1], t,
                            rule=rule))
    if rule == "int4-grad-sync-overflow":
        q = np.ones((5000,), np.int16)
        return (_ref_count(lambda a: jnp.sum(a, dtype=jnp.int16), q,
                           rule=rule),
                _port_count(lambda a: a.sum(dtype=torch.int16),
                            torch.ones(5000, dtype=torch.int16), rule=rule))
    if rule == "host-callback":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True):
            tc = torch.ones(4, device="cuda")
        return (_ref_count(lambda a: jax.pure_callback(
            lambda v: v, jax.ShapeDtypeStruct(a.shape, a.dtype), a), x,
            rule=rule),
                _port_count(lambda a: (a * 2).cpu(), tc, rule=rule))
    raise KeyError(rule)


@pytest.mark.parametrize("rule", [
    "fp64-leak", "amp-fp32-leak", "non-donated-large-arg",
    "recompile-scalar-const", "dead-equation", "int4-grad-sync-overflow",
    "host-callback"])
def test_planted_program_fires_as_in_the_reference(rule):
    ref, port = _planted(rule)
    assert ref >= 1
    assert port == ref


def test_clean_gpt_step_fires_no_error_in_either_package():
    closed, graph, tr, _ = _gpt()
    ref = ref_analysis.analyze(closed)
    assert not ref.errors, [f.render() for f in ref.errors]
    rep = analysis.analyze_graph(graph, mesh=tr.mesh)
    assert not rep.errors, [f.render() for f in rep.errors]


def test_pallas_config_untuned_fires_on_an_untuned_ce_shape():
    """float32 takes the staged route, whose row is the reference's
    ``fused_ce`` blocks: the seed DB has ``any`` rows at (h64, v512,
    t128) and none at v500."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    rule = "pallas-config-untuned"

    def count(v, device="cuda"):
        with FakeTensorMode(allow_non_fake_inputs=True):
            h = torch.randn(128, 64, device=device)
            w = torch.randn(64, v, device=device)
            lbl = torch.randint(0, v, (128,), device=device)

        def f(h, w, lbl):
            with torch.no_grad():
                return fc.fused_lm_ce(h, w, lbl)
        g = make_fx(f, tracing_mode="fake")(h, w, lbl)
        return len(analysis.analyze_graph(g, rule_ids=[rule]).by_rule(rule))
    assert count(512) == 0
    assert count(500) == 1
    assert count(500, device="cpu") == 0     # the plain version: no launch


# ---------------------------------------------------------------------------
# the lint CLI
# ---------------------------------------------------------------------------

def test_lint_smoke_strict_exits_0(capsys):
    assert lint.main(["--smoke", "--strict", "--top", "2",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "== train-step ==" in out and "decode-verify" in out


def test_lint_planted_fp64_leak_exits_1(monkeypatch, capsys):
    def leaky(smoke, device=None):
        tr, inputs, labels = lint.build_gpt(smoke, device)
        inner = tr.loss_fn
        tr.loss_fn = lambda out, lbl: inner(out, lbl).double().float()
        return tr, inputs, labels
    monkeypatch.setitem(lint.MODELS, "gpt", lint._trainer_program(leaky))
    assert lint.main(["--smoke", "--model", "gpt", "--device", "cpu"]) == 1
    assert "fp64-leak" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# BERT in the lint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", lint.BERT_SEQS)
def test_bert_step_lints_clean_with_the_named_matmul_flops(seq):
    """bench.py's bert_base_amp step at smoke widths, traced on the CPU:
    no finding, no kernel node (the flash gate takes CUDA tensors only),
    and the matmul FLOPs equal to 6NT + 6LSdT and its named differences
    (``lint.bert_matmul_terms``) to a relative 1e-9: sums of products of
    integer dims."""
    mesh_mod.set_mesh(None)
    progs = lint.lint_model("bert", True, 3, "cpu")
    rep, graph, _ = progs[f"bert-s{seq}"]
    assert rep.counts() == {"error": 0, "warning": 0, "info": 0}
    assert not set(walker.count_by_op(graph)) & set(walker.KERNEL_OPS)
    tr, ids, _ = lint.build_bert(True, "cpu", seq)
    n = sum(p.numel() for p in tr.params.values())
    assert lint.bert_params(lint.bert_config(True)) == n
    terms = lint.bert_matmul_terms(lint.bert_config(True), n, *ids.shape,
                                   flash=False)
    mm = cost.matmul_flops(graph)
    assert mm > 0 and abs(mm / sum(terms.values()) - 1) < 1e-9
