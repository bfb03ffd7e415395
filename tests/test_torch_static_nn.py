"""``paddle_tpu_torch.static.nn`` and ``static.amp`` against the JAX
package's.

Each function of the reference's ``static/nn.py`` ``__all__`` runs in
both packages on the same numpy inputs: the reference first, in a scope
of its own, where it creates its parameters by name; the port's scope is
then filled with the reference scope's arrays
(``static.fill_scope_from_numpy``, the weight carry of the static mode),
so both compute the same function. float32 within 1e-5 relative and 1e-6
absolute (convolutions and matmuls reorder sums), integers exactly. The
cases of the reference's ``tests/test_static_nn.py`` run beside. The
functions also run traced, inside a ``Program``, against their eager
results. ``deform_conv2d`` raises by name: ``vision/ops.py`` is not
ported yet.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import static as rst
from paddle_tpu.static import amp as ramp
from paddle_tpu.static import nn as rnn
from paddle_tpu_torch import static as st
from paddle_tpu_torch.static import amp as pamp
from paddle_tpu_torch.static import nn as pnn

RS = np.random.RandomState(0)
X2 = RS.randn(4, 8).astype("float32")
X4 = RS.randn(2, 4, 6, 6).astype("float32")
X5 = RS.randn(1, 2, 4, 4, 4).astype("float32")
SEQ = np.arange(24, dtype="float32").reshape(2, 4, 3) / 10.0
LEN = np.asarray([2, 4], "int64")
IDS = np.asarray([[0, 1, 3], [2, 0, 4]], "int64")
TOL = dict(rtol=1e-5, atol=1e-6)


# the reference's eager-only (ragged, host) cases, its sampling nce and
# sequence_slice (traced, its time dim is the static bound); the others
# run under jax.jit (one XLA compile, its parameters still
# made concretely: the reference's _param evaluates at compile time)
REF_EAGER = {"nce", "sequence_concat_lengths", "sequence_expand",
             "sequence_expand_as", "sequence_pad", "sequence_pad_packed",
             "sequence_unpad", "sequence_enumerate", "switch_case",
             "switch_case_dict", "spectral_norm", "sequence_slice"}


def _call(mod, fn, args, name=None):
    if mod is rnn:
        args = [jnp.asarray(a) for a in args]
        if name in REF_EAGER:
            return fn(mod, *args)
        import jax
        return jax.jit(lambda *a: fn(mod, *a))(*args)
    return fn(mod, *[torch.from_numpy(np.ascontiguousarray(a).copy())
                     for a in args])


def _np(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    if isinstance(o, (list, tuple)):
        return [_np(x) for x in o]
    return np.asarray(o)


def _same(r, p):
    if isinstance(r, (list, tuple)):
        assert len(r) == len(p)
        for a, b in zip(r, p):
            _same(a, b)
        return
    r, p = _np(r), _np(p)
    assert r.shape == p.shape, (r.shape, p.shape)
    if r.dtype.kind == "f":
        np.testing.assert_allclose(p, r, **TOL)
    else:
        np.testing.assert_array_equal(p, r)


# name -> fn(mod, *tensors): the call, written once for both packages
CASES = {
    "fc": (lambda m, x: m.fc(x, 5, name="fc_a", activation="relu"), (X2,)),
    "fc_flatten": (lambda m, x: m.fc(x, 3, num_flatten_dims=2,
                                     name="fc_b"), (X4,)),
    "embedding": (lambda m, i: m.embedding(i, (6, 4), padding_idx=0,
                                           name="emb"), (IDS,)),
    "sparse_embedding": (lambda m, i: m.sparse_embedding(i, (6, 4),
                                                         name="semb"),
                         (IDS,)),
    "bilinear_tensor_product": (lambda m, x, y: m.bilinear_tensor_product(
        x, y, 3, act="tanh", name="btp"), (X2, X2[:, :5].copy())),
    "batch_norm": (lambda m, x: m.batch_norm(x, act="relu", name="bn"),
                   (X4,)),
    "data_norm": (lambda m, x: m.data_norm(x, name="dn"), (X2,)),
    "group_norm": (lambda m, x: m.group_norm(x, 2, name="gn"), (X4,)),
    "instance_norm": (lambda m, x: m.instance_norm(x, name="inn"), (X4,)),
    "layer_norm": (lambda m, x: m.layer_norm(x, begin_norm_axis=1,
                                             name="ln"), (X4,)),
    "spectral_norm": (lambda m, w: m.spectral_norm(w, power_iters=3),
                      (RS.randn(6, 3, 3, 3).astype("float32"),)),
    "prelu_all": (lambda m, x: m.prelu(x, mode="all", name="pa"), (X4,)),
    "prelu_channel": (lambda m, x: m.prelu(x, mode="channel", name="pc"),
                      (X4,)),
    "prelu_element": (lambda m, x: m.prelu(x, mode="element", name="pe"),
                      (X4,)),
    "conv2d": (lambda m, x: m.conv2d(x, 6, 3, padding=1, act="relu",
                                     name="c2"), (X4,)),
    "conv2d_transpose": (lambda m, x: m.conv2d_transpose(
        x, 6, filter_size=2, stride=2, name="c2t"), (X4,)),
    "conv3d": (lambda m, x: m.conv3d(x, 4, 3, padding=1, name="c3"), (X5,)),
    "conv3d_transpose": (lambda m, x: m.conv3d_transpose(
        x, 3, filter_size=2, stride=2, name="c3t"), (X5,)),
    "row_conv": (lambda m, x: m.row_conv(x, 2, name="rc"), (SEQ,)),
    "crf_decoding": (lambda m, e, t: m.crf_decoding(e, t),
                     (RS.randn(2, 5, 4).astype("float32"),
                      RS.randn(6, 4).astype("float32"))),
    "crf_decoding_length": (lambda m, e, t, n: m.crf_decoding(e, t,
                                                              length=n),
                            (RS.randn(2, 5, 4).astype("float32"),
                             RS.randn(6, 4).astype("float32"),
                             np.asarray([3, 5], "int64"))),
    # no negatives: the loss on the true class alone (the packages'
    # generators differ, so sampled negatives cannot match)
    "nce": (lambda m, x, y: m.nce(x, y, 10, num_neg_samples=0, name="nce"),
            (X2, np.asarray([1, 2, 3, 4], "int64"))),
    "multi_box_head": (lambda m, f1, f2, img: m.multi_box_head(
        [f1, f2], img, base_size=64, num_classes=3,
        aspect_ratios=[[2.0], [2.0]], name="mbh"),
        (RS.randn(1, 4, 8, 8).astype("float32"),
         RS.randn(1, 4, 4, 4).astype("float32"),
         np.zeros((1, 3, 64, 64), "float32"))),
    "sequence_conv": (lambda m, x: m.sequence_conv(x, 5, filter_size=3,
                                                   name="sc"), (SEQ,)),
    "sequence_softmax": (lambda m, x, n: m.sequence_softmax(x, length=n),
                         (SEQ, LEN)),
    "sequence_pool_sum": (lambda m, x, n: m.sequence_pool(x, "sum", n),
                          (SEQ, LEN)),
    "sequence_pool_average": (lambda m, x, n: m.sequence_pool(
        x, "average", n), (SEQ, LEN)),
    "sequence_pool_sqrt": (lambda m, x, n: m.sequence_pool(x, "sqrt", n),
                           (SEQ, LEN)),
    "sequence_pool_max": (lambda m, x, n: m.sequence_pool(x, "max", n),
                          (SEQ, LEN)),
    "sequence_first_step": (lambda m, x, n: m.sequence_first_step(x, n),
                            (SEQ, LEN)),
    "sequence_last_step": (lambda m, x, n: m.sequence_last_step(x, n),
                           (SEQ, LEN)),
    "sequence_concat": (lambda m, a, b: m.sequence_concat([a, b]),
                        (SEQ, SEQ)),
    "sequence_concat_lengths": (lambda m, a, b: m.sequence_concat(
        [a, b], [np.asarray([1, 2]), np.asarray([2, 1])]), (SEQ, SEQ)),
    "sequence_slice": (lambda m, x: m.sequence_slice(
        x, np.asarray([1, 0]), np.asarray([2, 3])), (SEQ,)),
    "sequence_expand": (lambda m, x: m.sequence_expand(
        x, None, length=np.asarray([2, 1])), (X2[:2].copy(),)),
    "sequence_expand_as": (lambda m, x, y: m.sequence_expand_as(x, y),
                           (X2[:2].copy(), SEQ)),
    "sequence_pad": (lambda m: m.sequence_pad(
        [np.ones((2, 3), "float32"), np.ones((4, 3), "float32")], 0.0),
        ()),
    "sequence_pad_packed": (lambda m, x: m.sequence_pad(
        x, -1.0, maxlen=3, length=[1, 3]), (X2,)),
    "sequence_unpad": (lambda m, x, n: m.sequence_unpad(x, n), (SEQ, LEN)),
    "sequence_reshape": (lambda m, x: m.sequence_reshape(x, 6), (SEQ,)),
    "sequence_scatter": (lambda m, x, i, u: m.sequence_scatter(x, i, u),
                         (X2, np.asarray([[0, 2], [1, 1], [3, 0],
                                          [7, 7]], "int64"),
                          RS.randn(4, 2).astype("float32"))),
    "sequence_enumerate": (lambda m, i: m.sequence_enumerate(i, 2,
                                                             pad_value=0),
                           (np.asarray([[1, 2, 3]], "int64"),)),
    "sequence_reverse": (lambda m, x, n: m.sequence_reverse(x, n),
                         (SEQ, LEN)),
    "cond": (lambda m, x: m.cond(x.sum() > 0, lambda: x * 2,
                                 lambda: x - 1), (X2,)),
    "case": (lambda m, x: m.case([(x.sum() > 1e9, lambda: x * 2),
                                  (x.sum() < 1e9, lambda: x * 3)],
                                 default=lambda: x), (X2,)),
    "case_no_default": (lambda m, x: m.case(
        [(x.sum() > 1e9, lambda: x * 2), (x.sum() > 1e9, lambda: x * 3)]),
        (X2,)),
    "switch_case": (lambda m, x: m.switch_case(
        2, [lambda: x, lambda: x * 2, lambda: x * 3]), (X2,)),
    "switch_case_dict": (lambda m, x: m.switch_case(
        1, {0: lambda: x, 1: lambda: x * 5}, default=lambda: -x), (X2,)),
    "while_loop": (lambda m, x: m.while_loop(
        lambda i, s: i < 4, lambda i, s: (i + 1, s + x * i),
        (x.sum() * 0, x * 0)), (X2,)),
    "py_func": (lambda m, x: m.py_func(lambda a: np.asarray(a) * 2 + 1, x),
                (X2,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_reference_with_carried_scope(name):
    fn, args = CASES[name]
    rscope, pscope = rst.Scope(), st.Scope()
    with rst.scope_guard(rscope):
        want = _call(rnn, fn, args, name)
    st.fill_scope_from_numpy({k: np.asarray(rscope.find_var(k))
                              for k in rscope.local_var_names()}, pscope)
    with st.scope_guard(pscope):
        got = _call(pnn, fn, args)
    assert sorted(pscope.local_var_names()) == sorted(
        rscope.local_var_names())
    _same(want, got)


def test_every_reference_function_has_a_case():
    assert pnn.__all__ == rnn.__all__
    covered = {n.split("_length")[0].split("_packed")[0] for n in CASES}
    covered |= {n for n in rnn.__all__ if any(c.startswith(n)
                                              for c in CASES)}
    assert set(rnn.__all__) - covered == {"deform_conv2d"}


def test_deform_conv2d_raises_by_name():
    with pytest.raises(NotImplementedError, match="vision/ops.py"):
        pnn.deform_conv2d(torch.ones(1, 2, 4, 4), torch.zeros(1, 18, 4, 4),
                          None, 2, 3)


TRACEABLE = ["fc", "batch_norm", "layer_norm", "conv2d", "prelu_channel",
             "sequence_pool_average", "sequence_slice", "sequence_reverse",
             "crf_decoding", "cond", "case", "while_loop", "py_func"]


@pytest.mark.parametrize("name", TRACEABLE)
def test_function_staged_in_a_program_matches_eager(name):
    fn, args = CASES[name]
    scope = st.Scope()
    tensors = [torch.from_numpy(a.copy()) for a in args]
    with st.scope_guard(scope):
        eager = _np(fn(pnn, *tensors))
        specs = [st.data(f"a{i}", list(a.shape), str(a.dtype))
                 for i, a in enumerate(args)]
        prog = st.Program.trace(lambda *ts: fn(pnn, *ts), *specs)
        outs = st.Executor("cpu").run(
            prog, feed={f"a{i}": a for i, a in enumerate(args)})
    if name == "sequence_slice":   # traced: the static time bound
        eager = np.pad(eager, ((0, 0), (0, 1), (0, 0)))
    _same(eager if isinstance(eager, list) else [eager], outs)
    if name in ("cond", "case"):
        assert any("cond" in str(n.target) for n in prog.graph.graph.nodes)
    if name == "while_loop":
        assert any("while_loop" in str(n.target)
                   for n in prog.graph.graph.nodes)


def test_ragged_ops_raise_under_a_trace():
    with pytest.raises(TypeError, match="eager-only"):
        st.Program.trace(lambda x: pnn.sequence_expand(
            x, None, length=torch.tensor([1, 1])), st.data("x", [2, 3]))


def test_reference_cases():
    """The reference's own checks of tests/test_static_nn.py."""
    scope = st.Scope()
    with st.scope_guard(scope):
        x = torch.from_numpy(X2)
        a = pnn.fc(x, 16, name="fc_reuse")
        b = pnn.fc(x, 16, name="fc_reuse")
        np.testing.assert_allclose(a.numpy(), b.numpy())
        out = _np(pnn.embedding(np.array([[0, 1], [2, 0]]), (5, 4),
                                padding_idx=0, name="emb_pad"))
        np.testing.assert_allclose(out[0, 0], np.zeros(4))
        assert np.abs(out[0, 1]).sum() > 0
        w = RS.randn(6, 3, 3, 3).astype("float32")
        sn = _np(pnn.spectral_norm(w, power_iters=3)).reshape(6, -1)
        assert abs(np.linalg.svd(sn, compute_uv=False)[0] - 1.0) < 0.2
        emis = np.full((1, 3, 3), -5.0, dtype="float32")
        emis[0, 0, 0] = emis[0, 1, 1] = emis[0, 2, 2] = 5.0
        path = _np(pnn.crf_decoding(emis, np.zeros((5, 3), "float32")))
        np.testing.assert_array_equal(path[0], [0, 1, 2])
        l1 = _np(pnn.nce(x, np.arange(1, 5), 50, name="nce_fresh"))
        l2 = _np(pnn.nce(x, np.arange(1, 5), 50, name="nce_fresh"))
        assert l1.shape == (4, 1) and np.all(l1 > 0)
        assert not np.allclose(l1, l2)     # fresh negatives each call
        s = _np(pnn.sequence_softmax(torch.from_numpy(SEQ), length=LEN))
        assert abs(s[0, :, 0].sum() - 1.0) < 1e-5 and s[0, 2:].sum() == 0
        feats = [torch.zeros(1, 4, 4, 4)]
        img = torch.zeros(1, 3, 100, 200)
        _, _, boxes, _ = pnn.multi_box_head(
            feats, img, base_size=100, num_classes=2, aspect_ratios=[[1.0]],
            min_sizes=[20.0], max_sizes=[40.0], flip=False, name="mbh_ns")
        bx = _np(boxes)
        assert abs(bx[0, 2] - bx[0, 0] - 20.0 / 200) < 1e-6
        assert abs(bx[0, 3] - bx[0, 1] - 20.0 / 100) < 1e-6
    rng = np.random.RandomState(3)
    for _ in range(5):
        emis = rng.randn(2, 6, 4).astype("float32")
        trans = rng.randn(6, 4).astype("float32")
        full = _np(pnn.crf_decoding(emis[:1, :3], trans))
        masked = _np(pnn.crf_decoding(emis, trans,
                                      length=np.array([3, 6])))
        np.testing.assert_array_equal(masked[0, :3], full[0])


# -- static.amp -----------------------------------------------------------------
def test_amp_public_names():
    assert pamp.__all__ == ramp.__all__
    for n in ramp.__all__:
        assert hasattr(pamp, n), n
    lists = pamp.AutoMixedPrecisionLists({"matmul"}, {"exp"}, {"v"})
    rl = ramp.AutoMixedPrecisionLists({"matmul"}, {"exp"}, {"v"})
    assert (lists.white_list, lists.black_list, lists.black_varnames) == \
        (rl.white_list, rl.black_list, rl.black_varnames)
    assert pamp.CustomOpLists is pamp.AutoMixedPrecisionLists
    assert pamp.bf16.decorate_bf16 is pamp.decorate
    assert pamp.bf16.AutoMixedPrecisionListsBF16 is \
        pamp.AutoMixedPrecisionLists


def test_fp16_guard_casts_matmuls_in_a_program():
    from paddle_tpu_torch import amp
    x = np.random.RandomState(1).randn(2, 4).astype("float32")
    w = np.random.RandomState(2).randn(4, 3).astype("float32")

    def net(a):
        with pamp.fp16_guard():
            assert amp.amp_state().enabled
            return st.nn.fc(a, 3, name="amp_fc", bias_attr=False)

    scope = st.Scope()
    scope.var("amp_fc.w_0", torch.from_numpy(w))
    with st.scope_guard(scope):
        prog = st.Program.trace(net, st.data("a", [2, 4]))
        (out,) = st.Executor("cpu").run(prog, feed={"a": x},
                                        return_numpy=False)
    assert not amp.amp_state().enabled
    # fc's matmul is the plain torch.matmul: it runs in float32 in both
    # packages' static.nn (the amp lists apply to the tensor API's matmul)
    import paddle_tpu_torch as port
    with pamp.fp16_guard():
        hm = port.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert hm.dtype == torch.bfloat16
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-6)


def test_cast_model_and_parameters():
    from paddle_tpu_torch import nn
    m = nn.Linear(4, 2)
    assert pamp.cast_model_to_fp16(m).weight.dtype == torch.bfloat16
    m2 = nn.Linear(4, 2)
    pamp.cast_parameters_to_fp16(model=m2)
    assert m2.weight.dtype == torch.bfloat16
    assert pamp.cast_parameters_to_fp16() is None
    with pytest.raises(TypeError, match="Layer"):
        pamp.cast_model_to_fp16(object())


def _opt_pair():
    import paddle_tpu.optimizer as roptim
    import paddle_tpu_torch.optimizer as poptim
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    return (ramp.decorate(roptim.SGD(0.1), **kw),
            pamp.decorate(poptim.SGD(0.1), **kw))


def test_decorated_optimizer_functional_path_matches_reference():
    ropt, popt = _opt_pair()
    p0 = np.random.RandomState(0).randn(3).astype("float32")
    rparams, pparams = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0)}
    rstate, pstate = ropt.init_state(rparams), popt.init_state(pparams)
    grads = [np.full(3, 8.0, "float32"), np.full(3, np.inf, "float32"),
             np.full(3, 4.0, "float32"), np.full(3, 2.0, "float32")]
    for g in grads:
        rparams, rstate = ropt.apply_gradients(rparams, {"w": jnp.asarray(g)},
                                               rstate)
        pparams, pstate = popt.apply_gradients(
            pparams, {"w": torch.from_numpy(g)}, pstate)
        np.testing.assert_allclose(pparams["w"].numpy(),
                                   np.asarray(rparams["w"]), rtol=1e-6)
        assert popt.get_loss_scaling(pstate) == \
            ropt.get_loss_scaling(rstate)
    assert float(popt.scale_loss(torch.tensor(1.0), pstate)) == \
        float(ropt.scale_loss(jnp.asarray(1.0), rstate))


def test_decorated_optimizer_eager_path():
    import paddle_tpu_torch.optimizer as poptim
    from paddle_tpu_torch import nn
    m = nn.Linear(2, 1)
    w0 = m.weight.detach().clone()
    opt = pamp.decorate(poptim.SGD(0.1, parameters=m.parameters()),
                        init_loss_scaling=4.0)
    loss = m(torch.ones(1, 2)).sum()
    opt.backward(loss).backward()
    assert torch.allclose(m.weight.grad, torch.full_like(w0, 4.0))
    opt.minimize()
    np.testing.assert_allclose(m.weight.detach().numpy(),
                               (w0 - 0.1).numpy(), rtol=1e-6)
    assert opt.amp_init() is None and opt.get_loss_scaling() == 4.0
    plain = pamp.decorate(poptim.SGD(0.1), use_dynamic_loss_scaling=False)
    assert plain.get_loss_scaling() == 1.0
    assert plain.backward(torch.tensor(2.0)) == 2.0
