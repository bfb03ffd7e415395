"""The port's tensor API (``paddle_tpu_torch.add``, ``.reshape``,
``.matmul`` ... — ``paddle_tpu_torch/tensor``) against the JAX package's
(``paddle_tpu/tensor``).

One parametrised test walks a table with a case for every public function
of the reference's ``tensor/__init__.py``: the same numpy inputs go to
both packages and the outputs must agree — float32 within 1e-6 (rtol and
atol), integers and bools exactly. A case may compare a function of the
outputs where the result is only defined up to it (the signs of singular
and eigen vectors, the order of eigenvalues) and says so. The random ops
draw from different generators (ROADMAP "Oracle caveats": no seed
parity), so they get shape, dtype and moment checks only. The in-place
ops must also write into their input, as Paddle's do.
"""
import builtins
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu.tensor as ref_tensor
import paddle_tpu_torch as port
import paddle_tpu_torch.tensor as port_tensor

RS = np.random.RandomState(0)
F = RS.randn(3, 4).astype("float32")
G = RS.randn(3, 4).astype("float32")
POS = (np.abs(RS.randn(3, 4)) + 0.5).astype("float32")
UNIT = RS.uniform(-0.9, 0.9, (3, 4)).astype("float32")
GT1 = (np.abs(RS.randn(3, 4)) + 1.5).astype("float32")
I = RS.randint(-5, 6, (3, 4)).astype("int32")
IP = RS.randint(1, 9, (3, 4)).astype("int32")
B = RS.rand(3, 4) > 0.5
B2 = RS.rand(3, 4) > 0.5
V = RS.randn(4).astype("float32")
W = RS.randn(4).astype("float32")
SQ = (RS.randn(3, 3) + 3 * np.eye(3)).astype("float32")
SYM = (SQ + SQ.T).astype("float32")
SPD = (SQ @ SQ.T + 3 * np.eye(3)).astype("float32")
LOW = np.tril(SQ).astype("float32")
M34 = RS.randn(3, 4).astype("float32")
M45 = RS.randn(4, 5).astype("float32")
BT = RS.randn(2, 3, 4).astype("float32")
BT2 = RS.randn(2, 4, 5).astype("float32")
SORTED = np.sort(RS.randn(6)).astype("float32")
C3 = RS.randn(2, 3).astype("float32")
D3 = RS.randn(2, 3).astype("float32")
IDX = np.asarray([2, 0, 1], "int64")
DUPS = np.asarray([3, 1, 3, 2, 1, 1, 5], "int64")
COUNTS = RS.randint(0, 6, (10,)).astype("int64")
NANS = np.asarray([[1.0, np.nan, 3.0], [np.inf, -2.0, np.nan]], "float32")
CPLX_PAIR = RS.randn(3, 2).astype("float32")
IMG = RS.randn(1, 2, 3, 3).astype("float32")


class Case:
    """``fn(*args, **kwargs)`` in both packages; ``post`` maps both
    outputs before they are compared; ``inplace``: the port must write
    the result into its first argument."""

    def __init__(self, name, *args, post=None, inplace=False,
                 tol=(1e-6, 1e-6), **kwargs):
        self.name, self.args, self.kwargs = name, args, kwargs
        self.post, self.inplace, self.tol = post, inplace, tol


def _abs(out):
    return [np.abs(np.asarray(o)) for o in out]


def _sorted_real(out):
    return np.sort(np.real(np.asarray(out)))


CASES = [
    # creation
    Case("to_tensor", F), Case("to_tensor", [1.5, 2.5]),
    Case("zeros", [2, 3]), Case("ones", [2, 3], dtype="int32"),
    Case("full", [2, 2], 1.5), Case("empty", [2, 3]),
    Case("zeros_like", F), Case("ones_like", I), Case("full_like", F, 7.0),
    Case("empty_like", F), Case("arange", 5), Case("arange", 1, 7, 2),
    Case("arange", 0.0, 1.0, 0.25), Case("linspace", 0.0, 1.0, 5),
    Case("eye", 3), Case("eye", 2, 4),
    Case("diag", V), Case("diag", V, offset=1), Case("diag", SQ),
    Case("diag", V, padding_value=2.0), Case("diagflat", C3),
    Case("tril", F), Case("triu", F, 1), Case("meshgrid", V, W[:3]),
    Case("assign", F), Case("clone", F), Case("numel", F), Case("shape", BT),
    Case("tolist", F), Case("complex", F, G),
    # array
    Case("create_array", initialized_list=[F]),
    Case("array_write", F, 1), Case("array_read", [F, G], 1),
    Case("array_length", [F, G]),
    # math: binary
    Case("add", F, G), Case("subtract", F, G), Case("multiply", F, G),
    Case("divide", F, POS), Case("divide", I, IP), Case("floor_divide", I, IP),
    Case("remainder", I, IP), Case("remainder", F, POS), Case("mod", I, IP),
    Case("floor_mod", F, POS), Case("pow", POS, 1.5), Case("pow", POS, G),
    Case("maximum", F, G), Case("minimum", F, G), Case("fmax", NANS, NANS[::-1]),
    Case("fmin", NANS, NANS[::-1]), Case("atan2", F, G),
    Case("logaddexp", F, G), Case("inner", V, W), Case("outer", V, W),
    # math: unary
    Case("sqrt", POS), Case("rsqrt", POS), Case("exp", F), Case("expm1", F),
    Case("log", POS), Case("log2", POS), Case("log10", POS),
    Case("log1p", POS), Case("abs", F), Case("abs", I), Case("ceil", F),
    Case("floor", F), Case("round", F * 3), Case("trunc", F * 3),
    Case("sin", F), Case("cos", F), Case("tan", UNIT), Case("asin", UNIT),
    Case("acos", UNIT), Case("atan", F), Case("sinh", F), Case("cosh", F),
    Case("tanh", F), Case("asinh", F), Case("acosh", GT1),
    Case("atanh", UNIT), Case("sigmoid", F), Case("square", F),
    Case("reciprocal", POS), Case("sign", F), Case("sign", I), Case("neg", F),
    Case("erf", F), Case("erfinv", UNIT), Case("digamma", POS),
    # XLA's and ATen's lgamma approximations differ by up to 1.6e-6
    Case("lgamma", POS, tol=(1e-6, 2e-6)), Case("conj", F), Case("angle", F), Case("real", F),
    Case("imag", F), Case("frac", F * 3), Case("rad2deg", F),
    Case("deg2rad", F), Case("isnan", NANS), Case("isinf", NANS),
    Case("isfinite", NANS), Case("clip", F, -0.5, 0.5), Case("clip", F, 0.0),
    Case("lerp", F, G, 0.3), Case("nan_to_num", NANS),
    Case("nan_to_num", NANS, nan=1.0, posinf=9.0, neginf=-9.0),
    # math: reductions
    Case("sum", F), Case("sum", F, axis=1), Case("sum", F, axis=[0, 1],
                                                 keepdim=True),
    Case("sum", I, axis=0), Case("sum", B), Case("mean", F),
    Case("mean", F, axis=0, keepdim=True), Case("mean", I),
    Case("prod", POS), Case("prod", POS, axis=1), Case("prod", IP,
                                                       axis=[0, 1]),
    Case("max", F), Case("max", F, axis=1, keepdim=True), Case("min", F),
    Case("min", I, axis=0), Case("amax", F, axis=[0, 1]),
    Case("amin", F, axis=-1), Case("logsumexp", F),
    Case("logsumexp", F, axis=1, keepdim=True), Case("all", B),
    Case("all", B, axis=1), Case("any", B), Case("any", B, axis=[0, 1],
                                                 keepdim=True),
    Case("cumsum", F), Case("cumsum", F, axis=1), Case("cumsum", I, axis=0),
    Case("cumprod", POS, dim=1), Case("count_nonzero", I),
    Case("count_nonzero", I, axis=1), Case("trace", SQ),
    Case("trace", M34, offset=1), Case("diff", F), Case("diff", F, axis=0),
    Case("kron", C3, D3),
    # math: matmul family
    Case("matmul", M34, M45), Case("matmul", M34, M34, transpose_y=True),
    Case("matmul", BT, BT2), Case("mm", M34, M45), Case("bmm", BT, BT2),
    Case("dot", V, W), Case("dot", F, G), Case("mv", M34, V),
    Case("addmm", RS.randn(3, 5).astype("float32"), M34, M45, beta=0.5,
         alpha=2.0),
    Case("multiplex", [F, G, -F], np.asarray([[0], [2], [1]], "int32")),
    # math: misc
    Case("increment", F), Case("increment", F, 2.5),
    Case("scale", F, 2.0, 1.0), Case("scale", F, 2.0, 1.0,
                                      bias_after_scale=False),
    Case("stanh", F), Case("broadcast_shape", [3, 1], [1, 4]),
    Case("gcd", IP, IP[::-1]), Case("lcm", IP, IP[::-1]),
    Case("add_n", [F, G, F]), Case("diagonal", BT, 0, 1, 2),
    # linalg
    Case("norm", F), Case("norm", F, p=1, axis=1), Case("norm", F, p=2,
                                                         axis=0),
    Case("norm", F, p=float("inf")), Case("norm", F, p=0),
    Case("norm", F, p=3, axis=1, keepdim=True), Case("dist", F, G),
    Case("dist", F, G, p=1), Case("cross", C3, D3),
    Case("cholesky", SPD), Case("cholesky", SPD, upper=True),
    Case("cholesky_solve", M34[:, :2].copy(), np.linalg.cholesky(SPD)
         .astype("float32")),
    Case("inverse", SQ), Case("inv", SQ), Case("pinv", M34),
    Case("det", SQ), Case("slogdet", SQ),
    Case("svd", M34, post=lambda o: np.asarray(o[1])),
    Case("qr", SQ, post=_abs),
    Case("eig", SYM, post=lambda o: _sorted_real(o[0])),
    Case("eigh", SYM, post=lambda o: [np.asarray(o[0]),
                                      np.abs(np.asarray(o[1]))]),
    Case("eigvals", SYM, post=_sorted_real), Case("eigvalsh", SYM),
    Case("matrix_power", SQ, 3), Case("matrix_rank", SQ),
    Case("lstsq", M34.T.copy(), V, post=lambda o: np.asarray(o[0])),
    Case("solve", SQ, M34[:, :2].copy()),
    Case("triangular_solve", LOW, M34[:, :2].copy(), upper=False),
    Case("triangular_solve", LOW.T.copy(), M34[:, :2].copy(), upper=True,
         transpose=True),
    Case("multi_dot", [M34, M45, RS.randn(5, 2).astype("float32")]),
    Case("histogram", F, bins=5), Case("histogram", F, bins=4, min=-1,
                                       max=1),
    Case("bincount", COUNTS), Case("bincount", COUNTS, minlength=8),
    Case("einsum", "ij,jk->ik", M34, M45),
    # logic
    Case("equal", I, IP), Case("not_equal", I, IP),
    Case("greater_than", F, G), Case("greater_equal", I, IP),
    Case("less_than", F, G), Case("less_equal", I, IP),
    Case("logical_and", B, B2), Case("logical_or", B, B2),
    Case("logical_xor", B, B2), Case("logical_not", B),
    Case("bitwise_and", I, IP), Case("bitwise_or", I, IP),
    Case("bitwise_xor", I, IP), Case("bitwise_not", I),
    Case("allclose", F, F + 1e-7), Case("allclose", F, G),
    Case("isclose", F, F * (1 + (B * 1e-3)).astype("float32")),
    Case("equal_all", F, F.copy()), Case("equal_all", F, G),
    Case("is_empty", F), Case("is_empty", np.zeros((0, 2), "float32")),
    Case("is_tensor", F),
    # manipulation
    Case("reshape", F, [2, 6]), Case("reshape", F, [-1]),
    Case("transpose", BT, [2, 0, 1]), Case("t", F), Case("t", V),
    Case("moveaxis", BT, 0, 2), Case("concat", [F, G]),
    Case("concat", [F, G], axis=1), Case("stack", [F, G]),
    Case("stack", [F, G], axis=2), Case("unstack", F), Case("unstack", F,
                                                            axis=1),
    Case("split", F, 2, axis=1), Case("split", F, [1, -1, 1], axis=1),
    Case("chunk", F, 3, axis=1), Case("squeeze", F[:, :1]),
    Case("squeeze", F[None], axis=0), Case("squeeze", F, axis=[0]),
    Case("unsqueeze", F, 0), Case("unsqueeze", F, [0, 3]),
    Case("flatten", BT), Case("flatten", BT, 1, 2), Case("flip", F, [0]),
    Case("flip", F, 1), Case("rot90", F), Case("rot90", F, 2),
    Case("roll", F, 2), Case("roll", F, 1, axis=1), Case("tile", V, [2, 2]),
    Case("expand", V, [3, 4]), Case("expand", F[:1], [3, -1]),
    Case("expand_as", V, F), Case("broadcast_to", V, [2, 4]),
    Case("broadcast_tensors", [V, F]), Case("cast", F, "int32"),
    Case("cast", I, "float32"), Case("slice", F, [0, 1], [1, 0], [3, 2]),
    Case("strided_slice", F, [1], [0], [4], [2]),
    Case("strided_slice", F, [1], [3], [0], [-1]),
    Case("gather", F, IDX), Case("gather", F, IDX[:2], axis=1),
    Case("gather_nd", F, np.asarray([[0, 1], [2, 3]], "int64")),
    Case("scatter", F, IDX[:2], G[:2]),
    Case("scatter", F, np.asarray([1, 1], "int64"), G[:2], overwrite=False),
    Case("scatter_nd_add", F, np.asarray([[0, 1], [0, 1], [2, 3]], "int64"),
         V[:3]),
    Case("scatter_nd", np.asarray([[1], [3]], "int64"),
         RS.randn(2, 3).astype("float32"), [5, 3]),
    Case("index_select", F, IDX), Case("index_select", F, IDX[:2], axis=1),
    Case("index_sample", F, np.asarray([[0, 1], [3, 3], [2, 0]], "int64")),
    Case("take_along_axis", F, np.argsort(F, 1)[:, :2], 1),
    Case("put_along_axis", F, np.argsort(F, 1)[:, :2], 9.0, 1),
    Case("put_along_axis", F, np.argsort(F, 1)[:, :2], 1.5, 1,
         reduce="add"),
    Case("put_along_axis", F, np.argsort(F, 1)[:, :2], 2.0, 1,
         reduce="multiply"),
    Case("masked_select", F, B), Case("unique", DUPS),
    Case("unique", DUPS, return_index=True, return_inverse=True,
         return_counts=True),
    Case("unique_consecutive", DUPS),
    Case("unique_consecutive", np.asarray([1, 1, 2, 2, 2, 3, 1], "int64"),
         return_inverse=True, return_counts=True),
    Case("unbind", F, 1), Case("where", B, F, G), Case("where", B),
    Case("nonzero", B), Case("nonzero", B, as_tuple=True),
    Case("sort", F), Case("sort", F, axis=0, descending=True),
    Case("argsort", F), Case("argsort", I, descending=True),
    Case("topk", F, 2), Case("topk", F, 2, axis=0, largest=False),
    Case("argmax", F), Case("argmax", F, axis=1), Case("argmax", F, axis=0,
                                                       keepdim=True),
    Case("argmin", F), Case("argmin", F, axis=1, dtype="int32"),
    Case("searchsorted", SORTED, V), Case("searchsorted", SORTED, V,
                                          right=True, out_int32=True),
    Case("bucketize", V, SORTED), Case("repeat_interleave", V, 2),
    Case("repeat_interleave", F, 2, axis=1), Case("crop", F, [2, 2], [1, 1]),
    Case("crop_tensor", F, [2, 3]), Case("pad", F, [1, 0, 0, 2]),
    Case("pad", IMG, [1, 1, 2, 0], value=0.5),
    Case("pad", IMG, [1, 1, 1, 1], mode="reflect"),
    Case("pad", IMG, [2, 1, 0, 1], mode="replicate"),
    Case("pad", IMG, [1, 1, 1, 1], mode="circular"),
    Case("as_complex", CPLX_PAIR), Case("view", F, [4, 3]),
    Case("tensordot", BT, M45, 1), Case("tensordot", M34, M34,
                                        [[0, 1], [0, 1]]),
    Case("rank", BT), Case("reverse", F, [0, 1]),
    Case("shard_index", np.asarray([[1], [7], [15], [3]], "int64"), 16, 4, 1),
    # inplace: each writes into its first argument
    Case("add_", F, G, inplace=True), Case("subtract_", F, G, inplace=True),
    Case("ceil_", F, inplace=True), Case("clip_", F, -0.5, 0.5, inplace=True),
    Case("exp_", F, inplace=True), Case("floor_", F, inplace=True),
    Case("reciprocal_", POS, inplace=True), Case("round_", F * 3,
                                                inplace=True),
    Case("rsqrt_", POS, inplace=True), Case("scale_", F, 2.0, 0.5,
                                            inplace=True),
    Case("scatter_", F, IDX[:2], G[:2], inplace=True),
    Case("sqrt_", POS, inplace=True), Case("tanh_", F, inplace=True),
    Case("zero_", F, inplace=True), Case("fill_", F, 3.0, inplace=True),
    Case("flatten_", BT, inplace=True), Case("reshape_", F, [6, 2],
                                             inplace=True),
    Case("squeeze_", F[None], 0, inplace=True),
    Case("unsqueeze_", F, 1, inplace=True),
    # stat
    Case("std", F), Case("std", F, axis=1, unbiased=False),
    Case("var", F), Case("var", F, axis=0, keepdim=True),
    Case("median", F), Case("median", F, axis=1),
    Case("median", F[:, :3], axis=1, keepdim=True),
    Case("nanmedian", NANS, axis=1), Case("quantile", F, 0.3),
    Case("quantile", F, np.asarray([0.25, 0.75], "float32"), axis=1),
    Case("nanquantile", NANS, 0.5, axis=1), Case("nansum", NANS),
    Case("nansum", NANS, axis=1), Case("nanmean", NANS, axis=1),
]
# complex-valued inputs
CASES += [Case("real", None, post=None), Case("imag", None),
          Case("conj", None), Case("angle", None), Case("as_real", None)]
_COMPLEX = ("real", "imag", "conj", "angle", "as_real")

RANDOM = {"rand", "randn", "standard_normal", "normal", "uniform",
          "randint", "randint_like", "randperm", "bernoulli", "poisson",
          "multinomial", "exponential_", "check_shape", "get_rng_key"}
NOT_CALLED = {"Tensor", "set_printoptions"}


def _public(mod):
    import types
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n))
                  and not isinstance(getattr(mod, n), types.ModuleType))


def test_every_reference_function_exists_and_has_a_case():
    names = set(_public(ref_tensor))
    assert names <= set(_public(port_tensor)), names - set(
        _public(port_tensor))
    covered = {c.name for c in CASES} | RANDOM | NOT_CALLED
    assert names <= covered, sorted(names - covered)
    # every name is at the top level too, the subpackages intact
    for n in names:
        assert getattr(port, n) is getattr(port_tensor, n), n
    import paddle_tpu_torch.nn
    import paddle_tpu_torch.optimizer  # noqa: F401
    assert inspect.ismodule(port.nn) and inspect.ismodule(port.optimizer)
    assert port.Tensor is torch.Tensor and port_tensor.Tensor is torch.Tensor


def _ref_arg(a):
    if isinstance(a, np.ndarray):
        return jnp.asarray(a)
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [jnp.asarray(x) for x in a]
    return a


def _port_arg(a):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a).copy())
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_port_arg(x) for x in a]
    return a


def _out_np(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    if isinstance(o, (list, tuple)):
        return [_out_np(x) for x in o]
    return np.asarray(o) if o is not None else None


def _compare(r, p, what, tol=(1e-6, 1e-6)):
    if isinstance(r, list) or isinstance(p, list):
        r, p = list(r), list(p)
        assert len(r) == len(p), what
        for a, b in zip(r, p):
            _compare(a, b, what, tol)
        return
    if r is None or p is None:
        assert r is None and p is None, what
        return
    r, p = np.asarray(r), np.asarray(p)
    assert r.shape == p.shape, (what, r.shape, p.shape)
    if r.dtype.kind in "fc":
        assert p.dtype.kind == r.dtype.kind, (what, r.dtype, p.dtype)
        np.testing.assert_allclose(p, r, rtol=tol[0], atol=tol[1],
                                   equal_nan=True, err_msg=what)
    else:
        assert p.dtype.kind in ("iu" if r.dtype.kind in "iu" else "b"), \
            (what, r.dtype, p.dtype)
        np.testing.assert_array_equal(p, r, err_msg=what)


def _ids():
    seen = {}
    out = []
    for c in CASES:
        k = seen.get(c.name, 0)
        seen[c.name] = k + 1
        out.append(f"{c.name}-{k}")
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_function_matches_reference(case):
    args, kwargs = case.args, case.kwargs
    if case.name in _COMPLEX:
        z = (F + 1j * G).astype("complex64")
        r = getattr(ref, case.name)(jnp.asarray(z))
        p = getattr(port, case.name)(torch.from_numpy(z.copy()))
    else:
        r = getattr(ref, case.name)(*[_ref_arg(a) for a in args], **kwargs)
        pargs = [_port_arg(a) for a in args]
        p = getattr(port, case.name)(*pargs, **kwargs)
        if case.inplace:
            assert p is pargs[0], "an inplace op must return its input"
            if case.name not in ("flatten_", "reshape_", "squeeze_",
                                 "unsqueeze_"):
                _compare(_out_np(r), _out_np(pargs[0]), case.name)
            else:
                assert tuple(pargs[0].shape) == tuple(np.shape(r))
    if case.name == "tolist":
        assert np.allclose(np.asarray(r), np.asarray(p), rtol=1e-6)
        return
    r, p = _out_np(r), _out_np(p)
    if case.post is not None:
        r, p = case.post(r), case.post(p)
    _compare(r, p, case.name, case.tol)


def test_set_printoptions():
    before = np.get_printoptions()
    try:
        ref.set_printoptions(precision=3)
        port.set_printoptions(precision=3)
        assert np.get_printoptions()["precision"] == 3
        assert "1.235" in str(torch.tensor([1.23456]))
    finally:
        np.set_printoptions(**before)
        torch.set_printoptions(profile="default")


RANDOM_CASES = {
    "rand": (([2000],), {}, (0.5, 1 / 12 ** 0.5)),
    "randn": (([2000],), {}, (0.0, 1.0)),
    "standard_normal": (([2000],), {}, (0.0, 1.0)),
    "normal": ((1.0, 2.0, [2000]), {}, (1.0, 2.0)),
    "uniform": (([2000],), {"min": 0.0, "max": 4.0}, (2.0, 4 / 12 ** 0.5)),
    "randint": ((0, 10, [2000]), {}, (4.5, (99 / 12) ** 0.5)),
    "randperm": ((2000,), {}, (999.5, None)),
}


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
def test_random_shapes_dtypes_and_moments(name):
    args, kwargs, (mean, std) = RANDOM_CASES[name]
    port.seed(1)
    r = np.asarray(getattr(ref, name)(*args, **kwargs))
    p = getattr(port, name)(*args, **kwargs)
    assert tuple(p.shape) == r.shape
    assert p.numpy().dtype.kind == r.dtype.kind
    pv = p.double().numpy()
    assert abs(pv.mean() - mean) < 0.15 * (std or 1) + 0.05 * builtins.abs(
        mean) + 1e-3
    if std is not None:
        assert abs(pv.std() - std) < 0.1 * std
    else:
        assert sorted(pv.tolist()) == list(range(2000))
    # the port's generator: seeded, reproducible
    port.seed(1)
    again = getattr(port, name)(*args, **kwargs)
    assert torch.equal(again, p)


def test_random_like_and_sampling():
    port.seed(0)
    x = torch.full((4000,), 0.3)
    b = port.bernoulli(x)
    assert b.dtype == x.dtype and abs(float(b.mean()) - 0.3) < 0.05
    lam = torch.full((4000,), 2.0)
    assert abs(float(port.poisson(lam).mean()) - 2.0) < 0.15
    ri = port.randint_like(torch.zeros(3000, dtype=torch.int32), 0, 5)
    assert ri.dtype == torch.int32 and int(ri.min()) == 0 and \
        int(ri.max()) == 4
    probs = torch.tensor([[0.1, 0.9], [0.8, 0.2]])
    m = port.multinomial(probs, 2)
    assert m.shape == (2, 2) and set(m[0].tolist()) == {0, 1}
    e = port.exponential_(torch.zeros(4000), 2.0)
    assert abs(float(e.mean()) - 0.5) < 0.05
    assert port.check_shape([2, 3]) == ref.check_shape([2, 3]) == [2, 3]
    with pytest.raises(ValueError):
        port.check_shape([2, 0])
    assert isinstance(port.get_rng_key(), torch.Generator)
    # the port's generators, never torch's global one
    torch.manual_seed(123)
    state = torch.get_rng_state()
    port.rand([5])
    assert torch.equal(state, torch.get_rng_state())
