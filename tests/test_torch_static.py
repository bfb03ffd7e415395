"""The port's static mode (``paddle_tpu_torch.static``: Program, Executor,
scopes, serialization, the compat classes) against the JAX package's.

The cases of the reference's ``tests/test_static.py`` run in both
packages on the same numpy inputs and carried weights; float32 results
agree within 1e-6 (rtol and atol) unless a case says otherwise. A
Program of the port is a ``torch.fx`` graph traced on fakes: the tests
also hold its feed/fetch names, op count, analysis, per-scope cache and
the scope values entering it as inputs.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu import static as rst
from paddle_tpu_torch import static as st

TOL = dict(rtol=1e-6, atol=1e-6)
X = np.random.RandomState(0).rand(2, 4).astype("float32")
EXE = dict(place="cpu")


def _nets():
    ref.seed(0)
    rnet = ref.nn.Linear(4, 3)
    rnet.eval()
    pnet = port.nn.Linear(4, 3)
    pnet.set_state_dict_from_numpy({k: np.asarray(v)
                                    for k, v in rnet.state_dict().items()})
    pnet.eval()
    return rnet, pnet


def test_public_names_match_reference():
    names = set(rst.__all__) | {"fill_scope_from_numpy"}
    assert set(st.__all__) == names
    for n in rst.__all__:
        assert hasattr(st, n), n
    for n in ("_OverlayScope", "_scope_stack"):
        assert hasattr(st, n)


def test_program_trace_and_executor_run():
    rnet, pnet = _nets()
    rprog = rst.Program.trace(lambda x: rnet(x),
                              rst.data("x", [None, 4], "float32"),
                              fetch_names=["y"])
    prog = st.Program.trace(lambda x: pnet(x),
                            st.data("x", [None, 4], "float32"),
                            fetch_names=["y"])
    assert prog.feed_names == rprog.feed_names == ["x"]
    assert prog.fetch_names == rprog.fetch_names == ["y"]
    assert prog.num_ops() > 0 and rprog.num_ops() > 0
    assert "def forward" in str(prog)
    assert isinstance(prog.graph, torch.fx.GraphModule)
    (want,) = rst.Executor().run(rprog, feed={"x": X}, fetch_list=["y"])
    exe = st.Executor(**EXE)
    (got,) = exe.run(prog, feed={"x": X}, fetch_list=["y"])
    np.testing.assert_allclose(got, want, **TOL)
    # a new batch size traces again; the cache keeps both
    x5 = np.random.RandomState(1).rand(5, 4).astype("float32")
    (got5,) = exe.run(prog, feed={"x": x5}, fetch_list=[0])
    (want5,) = rst.Executor().run(rprog, feed={"x": x5}, fetch_list=[0])
    np.testing.assert_allclose(got5, want5, **TOL)
    assert len(prog._compiled) == 2
    out = exe.run(prog, feed={"x": X}, return_numpy=False)
    assert isinstance(out[0], torch.Tensor) and not out[0].requires_grad
    for e, p in ((rst.Executor(), rprog), (exe, prog)):
        with pytest.raises(KeyError, match="missing feed"):
            e.run(p, feed={}, fetch_list=["y"])
        with pytest.raises(KeyError, match="unknown fetch"):
            e.run(p, feed={"x": X}, fetch_list=["nope"])
    with pytest.raises(ValueError, match="empty"):
        exe.run(st.Program(), feed={"x": X})


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.Executor()


def test_program_analyze_and_repr():
    _, pnet = _nets()
    prog = st.Program.trace(lambda x: pnet(x), st.data("x", [2, 4]))
    rep = prog.analyze()
    assert rep.cost is not None and "error" in rep.summary()
    assert repr(prog).startswith("<Program: 1 feeds, 1 fetches")
    assert repr(st.Program()) == "<Program: empty>"
    assert st.Program().num_ops() == 0
    assert isinstance(st.Program().analyze(), type(rep))
    clone = prog.clone(for_test=True)
    assert clone.graph is prog.graph


def test_program_guard_and_default_program():
    for mod in (rst, st):
        prog = mod.Program()
        with mod.program_guard(prog, mod.default_startup_program()):
            assert mod.default_main_program() is prog
        assert mod.default_main_program() is not prog


def test_append_backward_matches_reference():
    w = np.random.RandomState(2).randn(3, 2).astype("float32")
    x = np.random.RandomState(3).randn(4, 3).astype("float32")
    want = rst.append_backward(
        lambda w_, x_: jnp.mean((x_ @ w_) ** 2))(jnp.asarray(w),
                                                 jnp.asarray(x))
    got = st.append_backward(
        lambda w_, x_: torch.mean((x_ @ w_) ** 2))(torch.from_numpy(w),
                                                   torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    both = st.gradients(lambda w_, x_: torch.mean((x_ @ w_) ** 2),
                        wrt=(0, 1))(torch.from_numpy(w), torch.from_numpy(x))
    wantx = rst.gradients(lambda w_, x_: jnp.mean((x_ @ w_) ** 2),
                          wrt=1)(jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(both[1].numpy(), np.asarray(wantx), **TOL)


def test_training_program_holds_its_backward():
    """A Program of the loss and its parameter gradients
    (``append_backward(..., parameter_list=layer)``, the layer bound with
    ``parameters=``): the parameters are graph inputs and the gradients
    equal the reference's ``jax.grad``."""
    rnet, pnet = _nets()
    pnet.train()
    y = np.random.RandomState(4).randn(2, 3).astype("float32")

    def rloss(params, x, t):
        from paddle_tpu.jit.functionalization import functional_call
        out, _ = functional_call(rnet, params, {}, x)
        return jnp.mean((out - t) ** 2)

    import jax
    rparams = {k: v.value for k, v in rnet.named_parameters()}
    want = jax.grad(rloss)(rparams, jnp.asarray(X), jnp.asarray(y))
    gfn = st.append_backward(lambda x, t: torch.mean((pnet(x) - t) ** 2),
                             parameter_list=pnet)

    def fn(x, t):
        loss, grads = gfn(x, t)
        return (loss, *grads)

    names = [n for n, _ in pnet.named_parameters()]
    prog = st.Program.trace(fn, st.data("x", [2, 4]), st.data("t", [2, 3]),
                            parameters=pnet,
                            fetch_names=["loss"] + [n + "@GRAD"
                                                    for n in names])
    placeholders = [n for n in prog.graph.graph.nodes
                    if n.op == "placeholder"]
    assert len(placeholders) == len(names) + 2
    outs = st.Executor(**EXE).run(prog, feed={"x": X, "t": y})
    for n, g in zip(names, outs[1:]):
        np.testing.assert_allclose(g, np.asarray(want[n]), **TOL)
    # the parameters are read at run time: an update is seen
    with torch.no_grad():
        pnet.weight.add_(1.0)
    outs2 = st.Executor(**EXE).run(prog, feed={"x": X, "t": y})
    assert not np.allclose(outs[0], outs2[0])
    # the layer must lie where the executor runs
    pnet.to("meta")
    with pytest.raises(ValueError, match="move the layer"):
        st.Executor(**EXE).run(prog, feed={"x": X, "t": y})


def test_save_load_inference_model(tmp_path):
    rnet, pnet = _nets()
    rprog = rst.Program.trace(lambda x: rnet(x), rst.data("x", [None, 4]))
    prog = st.Program.trace(lambda x: pnet(x), st.data("x", [None, 4]))
    rst.save_inference_model(str(tmp_path / "r" / "m"), None, None,
                             program=rprog)
    st.save_inference_model(str(tmp_path / "p" / "m"), None, None,
                            program=prog)
    rrun, rfeeds, rfetch = rst.load_inference_model(str(tmp_path / "r" / "m"))
    run, feeds, fetch = st.load_inference_model(str(tmp_path / "p" / "m"))
    assert (feeds, fetch) == (rfeeds, rfetch) == (["x"], ["fetch_0"])
    # the dynamic batch dim survives export
    x = np.random.RandomState(1).rand(5, 4).astype("float32")
    (got,) = run(x)
    want = rrun(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _fc_scope(mod):
    scope = mod.Scope()
    with mod.scope_guard(scope):
        prog = mod.Program.trace(
            lambda x: mod.nn.fc(x, 4, name="exec_fc", bias_attr=False),
            mod.data("x", [2, 3]))
    return scope, prog


def test_scope_values_are_graph_inputs():
    feed = {"x": np.ones((2, 3), "float32")}
    scope, prog = _fc_scope(st)
    rscope, rprog = _fc_scope(rst)
    # carry the reference's initial weight: then the outputs agree
    st.fill_scope_from_numpy({k: np.asarray(rscope.find_var(k))
                              for k in rscope.local_var_names()}, scope)
    exe = st.Executor(**EXE)
    with st.scope_guard(scope), rst.scope_guard(rscope):
        out1 = exe.run(prog, feed=feed)[0]
        np.testing.assert_allclose(
            out1, rst.Executor().run(rprog, feed=feed)[0], **TOL)
        scope.var("exec_fc.w_0", torch.zeros(3, 4))
        rscope.var("exec_fc.w_0", jnp.zeros((3, 4), jnp.float32))
        out2 = exe.run(prog, feed=feed)[0]
        np.testing.assert_allclose(out2, np.zeros((2, 4)))
        np.testing.assert_allclose(
            out2, rst.Executor().run(rprog, feed=feed)[0], **TOL)
    assert not np.allclose(out1, out2)


def test_executor_rebinds_to_current_scope():
    a, b = st.Scope(), st.Scope()
    feed = {"x": np.ones((2, 3), "float32")}
    with st.scope_guard(a):
        prog = st.Program.trace(
            lambda x: st.nn.fc(x, 4, name="sc_fc", bias_attr=False),
            st.data("x", [2, 3]))
        exe = st.Executor(**EXE)
        out_a = exe.run(prog, feed=feed)[0]
    with st.scope_guard(b):
        b.var("sc_fc.w_0", torch.zeros(3, 4))
        out_b = exe.run(prog, feed=feed)[0]
    np.testing.assert_allclose(out_b, np.zeros((2, 4)))
    assert not np.allclose(out_a, out_b)


def test_auto_names_stable_and_committed():
    for mod in (rst, st):
        scope = mod.Scope()
        with mod.scope_guard(scope):
            prog = mod.Program.trace(lambda x: mod.nn.fc(x, 4),
                                     mod.data("x", [2, 3]))
            names = set(scope.local_var_names())
            kw = EXE if mod is st else {}
            mod.Executor(**kw).run(prog,
                                   feed={"x": np.ones((2, 3), "float32")})
            assert set(scope.local_var_names()) == names
            p2 = mod.Program.trace(lambda x: mod.nn.fc(x, 8),
                                   mod.data("x", [2, 5]))
            o2 = mod.Executor(**kw).run(
                p2, feed={"x": np.ones((2, 5), "float32")})[0]
            assert o2.shape == (2, 8)
            assert len(scope.local_var_names()) == 4


def test_params_made_under_a_trace_are_concrete():
    scope = st.Scope()
    with st.scope_guard(scope):
        prog = st.Program.trace(lambda x: st.nn.fc(x, 4, name="traced_fc"),
                                st.data("x", [2, 3]))
        out = st.Executor(**EXE).run(prog,
                                     feed={"x": np.ones((2, 3), "float32")})
        assert out[0].shape == (2, 4)
        w = scope.find_var("traced_fc.w_0")
        from torch._subclasses.fake_tensor import is_fake
        assert isinstance(w, torch.Tensor) and not is_fake(w)
        assert float(w.abs().sum()) > 0
    port.rand([2])   # the generators are still usable


def test_scope_guard_and_global_scope():
    for mod, arr in ((rst, jnp.ones(3)), (st, torch.ones(3))):
        s = mod.global_scope()
        sub = mod.Scope()
        with mod.scope_guard(sub):
            assert mod.global_scope() is sub
            mod.global_scope().var("a", arr)
            assert mod.global_scope().find_var("a") is not None
        assert mod.global_scope() is s
        child = sub.new_scope()
        assert child.find_var("a") is not None and "a" in child
        assert child.local_var_names() == []
        child.drop_kids()


def test_state_save_load_and_serialization(tmp_path):
    for mod, zeros in ((rst, lambda v: jnp.zeros_like(v)),
                       (st, lambda v: torch.zeros_like(v))):
        scope = mod.Scope()
        with mod.scope_guard(scope):
            x = np.random.RandomState(0).randn(2, 4).astype("float32")
            xin = jnp.asarray(x) if mod is rst else torch.from_numpy(x)
            out = mod.nn.fc(xin, 8, name="fc_rt")
            prog = mod.default_main_program()
            path = str(tmp_path / mod.__name__ / "model")
            mod.save(prog, path)
            state = mod.load_program_state(path)
            assert "fc_rt.w_0" in state
            assert set(mod.load_program_state(path, var_list=["fc_rt.b_0"])) \
                == {"fc_rt.b_0"}
            scope.var("fc_rt.w_0", zeros(scope.find_var("fc_rt.w_0")))
            mod.load(prog, path)
            out2 = mod.nn.fc(xin, 8, name="fc_rt")
            np.testing.assert_allclose(np.asarray(out2), np.asarray(out))
            data = mod.serialize_persistables()
            scope.var("fc_rt.w_0", zeros(scope.find_var("fc_rt.w_0")))
            mod.deserialize_persistables(prog, data)
            np.testing.assert_allclose(
                np.asarray(mod.nn.fc(xin, 8, name="fc_rt")), np.asarray(out))
            mod.set_program_state(prog, {"fc_rt.b_0": np.ones(8, "float32")})
            assert float(np.asarray(scope.find_var("fc_rt.b_0")).sum()) == 8
        with open(path + ".pdparams", "rb") as f:
            blob = pickle.load(f)
        assert sorted(blob) == ["fc_rt.b_0", "fc_rt.w_0"]
        pb = mod.serialize_program()
        assert isinstance(mod.deserialize_program(pb), mod.Program)
        p = str(tmp_path / f"{mod.__name__}.bin")
        mod.save_to_file(p, b"abc")
        assert mod.load_from_file(p) == b"abc"
        assert mod.normalize_program(prog) is prog


def test_global_vars_parameters_and_compat_classes():
    for mod in (rst, st):
        scope = mod.Scope()
        with mod.scope_guard(scope):
            v = mod.create_global_var([2, 3], 1.5, "float32", name="gv")
            assert tuple(scope.find_var("gv").shape) == (2, 3)
            assert float(np.asarray(scope.find_var("gv")).sum()) == 9.0
            mod.create_parameter([4], "float32", name="pp")
            assert scope.find_var("pp") is not None
            assert repr(v).startswith("Variable")
        bs = mod.BuildStrategy()
        bs.fuse_all_reduce_ops = False
        es = mod.ExecutionStrategy()
        es.num_threads = 4
        assert mod.cuda_places() and mod.xpu_places()
        assert len(mod.cpu_places(2)) == 2 and mod.device_count() >= 1
        with mod.device_guard("cpu"):
            pass
        with mod.name_scope("block"):
            pass
        mod.WeightNormParamAttr(dim=0)
        assert mod.InputSpec([None, 3]).shape == (-1, 3)
    with st.device_guard("cpu"):
        assert port.zeros([1]).device.type == "cpu"


def test_compiled_and_parallel_executor():
    rnet, pnet = _nets()
    prog = st.Program.trace(lambda x: pnet(x), st.data("x", [2, 4]))
    rprog = rst.Program.trace(lambda x: rnet(x), rst.data("x", [2, 4]))
    want = rst.Executor().run(rst.CompiledProgram(rprog), feed={"x": X})[0]
    got = st.Executor(**EXE).run(st.CompiledProgram(prog), feed={"x": X})[0]
    np.testing.assert_allclose(got, want, **TOL)
    assert st.CompiledProgram(prog).feed_names == ["x"]
    pe = st.ParallelExecutor(use_cuda=False, main_program=prog)
    np.testing.assert_allclose(pe.run(feed={"x": X})[0], want, **TOL)
    st.Executor(**EXE).close()


def test_metrics_print_and_py_func(capsys):
    logits = np.eye(4, 5, dtype="float32")
    lbl = np.arange(4)
    assert float(st.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(lbl))) == float(
        rst.accuracy(jnp.asarray(logits), jnp.asarray(lbl))) == 1.0
    rs = np.random.RandomState(5)
    probs = rs.rand(64, 2).astype("float32")
    labels = rs.randint(0, 2, (64, 1))
    np.testing.assert_allclose(float(st.auc(probs, labels)),
                               float(rst.auc(probs, labels)), rtol=1e-6)
    out = st.Print(torch.ones(2), message="hello")
    assert "hello" in capsys.readouterr().out and out.shape == (2,)
    got = st.py_func(lambda a: np.asarray(a) * 2, torch.ones(3))
    want = rst.py_func(lambda a: np.asarray(a) * 2, jnp.ones(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want))


def test_py_func_and_print_stage_as_graph_ops(capsys):
    def net(x):
        y = st.py_func(lambda a: np.asarray(a) + 1.0, x)
        st.Print(y, message="y")
        return y * 2

    prog = st.Program.trace(net, st.data("x", [3]))
    names = [str(n.target) for n in prog.graph.graph.nodes]
    assert any("static_py_func" in n for n in names)
    assert any("dy2static_print" in n for n in names)
    capsys.readouterr()
    (out,) = st.Executor(**EXE).run(prog, feed={"x": np.ones(3, "float32")})
    np.testing.assert_allclose(out, 4.0)
    assert "y" in capsys.readouterr().out


def _step(emb, w, batch):
    y = np.asarray(batch["label"], np.float32).reshape(-1)
    feat = emb.mean(axis=1)
    logit = feat @ w
    loss = np.mean(np.maximum(logit, 0) - logit * y +
                   np.log1p(np.exp(-np.abs(logit))))
    dlogit = (1.0 / (1.0 + np.exp(-logit)) - y) / y.size
    gw = feat.T @ dlogit
    ge = np.repeat((dlogit[:, None] * w[None, :])[:, None, :],
                   emb.shape[1], axis=1) / emb.shape[1]
    return float(loss), ge.astype(np.float32), gw.astype(np.float32)


def test_train_and_infer_from_dataset_match_reference():
    from paddle_tpu.distributed import ps as ref_ps
    from paddle_tpu_torch.distributed import ps
    rs = np.random.RandomState(1)
    batches = [{"ids": rs.randint(0, 50, (16, 4)).astype(np.int64),
                "label": (rs.rand(16) > 0.5).astype(np.float32)}
               for _ in range(4)]
    res = []
    for mod, smod in ((ps, st), (ref_ps, rst)):
        table = mod.SparseTable(4, "adagrad", seed=3, init_range=0.01)
        dense = mod.DenseTable(4, "sgd", init=np.zeros(4, np.float32))
        exe = smod.Executor(**(EXE if smod is st else {}))
        stats = exe.train_from_dataset(_step, batches, table,
                                       dense_table=dense, thread=1,
                                       batch_size=16, lr=0.5)
        inf = exe.infer_from_dataset(_step, batches, table,
                                     dense_table=dense, thread=1)
        res.append((stats["losses"], inf["losses"],
                    table.export_rows(np.arange(50), False)))
    assert res[0][0] == res[1][0] and res[0][1] == res[1][1]
    np.testing.assert_array_equal(res[0][2], res[1][2])


def test_fleet_save_persistables_of_the_static_scope(tmp_path):
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu_torch.distributed import fleet as pfleet
    from paddle_tpu_torch import framework_io
    rscope, pscope = rst.Scope(), st.Scope()
    w = np.random.RandomState(0).randn(3, 4).astype("float32")
    rscope.var("w", jnp.asarray(w))
    pscope.var("w", torch.from_numpy(w))
    with rst.scope_guard(rscope):
        rfleet.fleet.save_persistables(dirname=str(tmp_path / "r"))
    with st.scope_guard(pscope):
        pfleet.fleet.save_persistables(dirname=str(tmp_path / "p"))
    got = framework_io.load(str(tmp_path / "p" / "scope.pdparams"))
    want = ref.load(str(tmp_path / "r" / "scope.pdparams"))
    assert sorted(got) == sorted(want) == ["w"]
    np.testing.assert_array_equal(np.asarray(got["w"]),
                                  np.asarray(want["w"]))
    # the port's file reads back in the reference, and the other way
    back = ref.load(str(tmp_path / "p" / "scope.pdparams"))
    np.testing.assert_array_equal(np.asarray(back["w"]), w)
    os.remove(str(tmp_path / "p" / "scope.pdparams"))
