"""The port's small modules against the JAX package's, on the CPU:
``framework.flags``, ``monitor``, ``device`` and the top-level device
names, ``sysconfig``, ``utils`` (``deprecated``, ``download``'s local
helpers, ``install_check``, ``try_import``, ``require_version``),
``utils.cpp_extension``, ``framework.io_crypto`` and the collectives
``split_group``, ``all_gather_concat`` and ``split``.

- The cases of ``tests/test_misc_api.py`` (flags, device, deprecated,
  run_check), ``tests/test_profiler_monitor.py:112-140`` (monitor),
  ``tests/test_fs_crypto.py:54-108`` (crypto, on both packages, and files
  written by one package read by the other in both formats) and
  ``tests/test_inference_extension.py:85-156`` (the custom op: forward,
  gradient, under ``jit.to_static``, two inputs without a gradient,
  ``setup``; the same source built for both packages).
- ``set_device`` sets the default of every entry point; without a card
  ``set_device("gpu")`` raises (the reference swallows that error). Each
  test that calls it puts the default back.
- ``split``, ``split_group`` and ``all_gather_concat`` on a gloo world of
  2 (``tests/torch_collective_worker.py``) against the reference on a
  2-device mesh, at 1e-6 (float32 dot products of 8 terms).
"""
import io
import os
import tarfile
import textwrap
import threading
import unittest.mock as mock
import warnings
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref

import paddle_tpu_torch as port
from paddle_tpu_torch import monitor, telemetry
from paddle_tpu_torch._device import default_device
from paddle_tpu_torch.framework import flags, io_crypto
from paddle_tpu_torch.utils import download

import torch_collective_worker as cworker

HAS_CARD = torch.cuda.is_available()


# -- flags ----------------------------------------------------------------------

def test_flags_set_get_roundtrip():
    port.set_flags({"FLAGS_benchmark": True})
    assert port.get_flags("FLAGS_benchmark")["FLAGS_benchmark"] is True
    port.set_flags({"benchmark": False})
    assert port.get_flags(["benchmark"])["FLAGS_benchmark"] is False
    with pytest.raises(ValueError):
        port.set_flags({"FLAGS_no_such_flag": 1})
    assert sorted(flags._REGISTRY) == sorted(
        __import__("paddle_tpu.framework.flags",
                   fromlist=["_REGISTRY"])._REGISTRY)


@pytest.mark.parametrize("leaf", ["numpy", "tensor"])
def test_check_numerics_names_the_leaf_as_the_reference(leaf):
    from paddle_tpu.framework import flags as rflags
    bad = np.array([1.0, np.nan], "f4")
    tree = {"ok": np.ones(2, "f4"), "g": [np.ones(1, "f4"), bad]}
    ptree = tree if leaf == "numpy" else \
        {"ok": torch.ones(2), "g": [torch.ones(1), torch.from_numpy(bad)]}
    msgs = []
    for mod, t, setter in ((rflags, tree, ref.set_flags),
                           (flags, ptree, port.set_flags)):
        setter({"FLAGS_check_nan_inf": True})
        try:
            mod.check_numerics({"ok": tree["ok"]}, "t:")   # no raise
            with pytest.raises(FloatingPointError) as e:
                mod.check_numerics(t, "t:")
            msgs.append(str(e.value))
        finally:
            setter({"FLAGS_check_nan_inf": False})
    assert msgs[0] == msgs[1]
    assert msgs[1].endswith("t:['g'][1]")
    flags.check_numerics(ptree, "off:")     # the flag off: no scan


def test_check_nan_inf_in_the_trainer():
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    net = nn.Linear(4, 1)
    tr = ParallelTrainer(net, optimizer.SGD(0.1),
                         lambda o, y: torch.mean((o - y) ** 2),
                         device="cpu")
    x = np.ones((2, 4), "f4")
    port.set_flags({"FLAGS_check_nan_inf": True})
    try:
        tr.train_step(x, np.zeros((2, 1), "f4"))
        with pytest.raises(FloatingPointError, match="train_step:"):
            tr.train_step(x, np.full((2, 1), np.nan, "f4"))
    finally:
        port.set_flags({"FLAGS_check_nan_inf": False})


# -- monitor ----------------------------------------------------------------------

def test_monitor_gauges():
    g = monitor.stat("STAT_test_mem")
    g.reset()
    g.increase(10)
    g.decrease(3)
    assert g.get() == 7
    assert monitor.stat("STAT_test_mem") is g
    assert monitor.get_all_stats()["STAT_test_mem"] == 7

    def bump():
        for _ in range(1000):
            g.increase()

    ts = [threading.Thread(target=bump) for _ in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert g.get() == 7 + 4000
    monitor.reset_all_stats()
    assert g.get() == 0


def test_monitor_stat_exports_via_telemetry():
    g = monitor.stat("STAT_prom_bridge")
    g.reset()
    g.set(42)
    assert telemetry.get_registry().get("STAT_prom_bridge").value() == 42.0
    assert "STAT_prom_bridge 42" in telemetry.prometheus_text()
    g.reset()


# -- device -----------------------------------------------------------------------

def test_device_namespace():
    assert port.device.device_count() >= 1
    cpu = port.device.CPUPlace()
    assert cpu.get_device_id() == 0 and cpu.torch_device.type == "cpu"
    assert port.CUDAPinnedPlace().torch_device.type == "cpu"
    assert port.CUDAPlace(0) == port.CUDAPlace(0) != port.CUDAPlace(1)
    assert isinstance(port.device.get_available_device(), list)
    assert "cpu" in port.device.get_all_device_type()
    port.device.synchronize()
    port.device.cuda.empty_cache()
    assert port.device.cuda.device_count() == torch.cuda.device_count()
    if not HAS_CARD:
        assert port.get_device() == "cpu"
        assert port.get_cudnn_version() is None
        assert port.get_cuda_rng_state() == []
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.CUDAPlace(0).torch_device


@pytest.fixture
def restore_device():
    before = default_device()
    yield
    port.device.set_default_device(before)


def test_set_device_sets_the_default(restore_device):
    from paddle_tpu_torch._device import resolve_device
    assert port.set_device("cpu") == "cpu"
    assert resolve_device(None) == torch.device("cpu")
    if not HAS_CARD:
        # the departure: no silent CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.set_device("gpu")
        assert default_device() == "cpu"
    with pytest.raises(ValueError):
        port.set_device("quantum:0")


def test_cuda_rng_state_round_trips():
    if not HAS_CARD:
        port.set_cuda_rng_state([])
        return
    state = port.get_cuda_rng_state()
    a = torch.rand(3, device="cuda",
                   generator=port.framework.get_generator("cuda"))
    port.set_cuda_rng_state(state)
    b = torch.rand(3, device="cuda",
                   generator=port.framework.get_generator("cuda"))
    assert torch.equal(a, b)


# -- sysconfig and utils ------------------------------------------------------------

def test_sysconfig():
    inc = port.sysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, "paddle_ext.h"))
    assert os.path.samefile(inc, ref.sysconfig.get_include())
    assert port.sysconfig.get_lib().endswith(
        os.path.join("paddle_tpu_torch", "_build"))


def test_deprecated_decorator_warns():
    @port.utils.deprecated(update_to="new_api", since="0.1")
    def old_api():
        return 42

    with pytest.warns(DeprecationWarning, match="use new_api instead"):
        assert old_api() == 42


def test_utils_helpers():
    assert port.utils.try_import("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="not installed"):
        port.utils.try_import("no_such_module_here")
    assert port.utils.require_version("0.0.1")
    with pytest.raises(Exception):
        port.utils.require_version("99.0")
    assert port.utils.unique_name("fc") != port.utils.unique_name("fc")


def test_download_local_helpers(tmp_path):
    from paddle_tpu.utils import download as rdownload
    assert download.is_url("https://x/y.tar") and not download.is_url("/a")
    f = tmp_path / "w.bin"
    f.write_bytes(b"weights")
    import hashlib
    md5 = hashlib.md5(b"weights").hexdigest()
    for mod in (download, rdownload):
        assert mod._md5check(str(f), md5) and mod._md5check(str(f), None)
        assert not mod._md5check(str(f), "0" * 32)
    # archives unpack beside themselves, once
    tgz = tmp_path / "pack.tar"
    with tarfile.open(tgz, "w") as tf:
        data = b"abc"
        info = tarfile.TarInfo("pack/a.txt")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    out = download._maybe_decompress(str(tgz))
    assert out == str(tmp_path / "pack")
    assert (tmp_path / "pack" / "a.txt").read_bytes() == b"abc"
    zp = tmp_path / "z.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("z/b.txt", "b")
    assert download._maybe_decompress(str(zp)) == str(tmp_path / "z")
    assert download._maybe_decompress(str(f)) == str(f)


def test_run_check_on_the_cpu(capsys):
    loss = port.utils.run_check(device="cpu")
    out = capsys.readouterr().out
    assert "installed successfully" in out and np.isfinite(loss)
    if not HAS_CARD:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.utils.run_check()


# -- io_crypto ----------------------------------------------------------------------

def test_crypto_roundtrip_and_tamper():
    from paddle_tpu_torch.framework.io_crypto import (CipherFactory,
                                                      decrypt_bytes,
                                                      encrypt_bytes)
    key = CipherFactory.generate_key()
    data = os.urandom(1000) + b"params"
    blob = encrypt_bytes(data, key)
    assert blob != data and data not in blob
    assert decrypt_bytes(blob, key) == data
    with pytest.raises(ValueError):
        decrypt_bytes(blob, CipherFactory.generate_key())
    with pytest.raises(ValueError):
        decrypt_bytes(blob[:-1] + bytes([blob[-1] ^ 1]), key)
    with pytest.raises(ValueError):
        decrypt_bytes(b"garbage", key)


@pytest.mark.parametrize("fmt", ["v3_gcm", "v2_shake"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_crypto_files_cross_packages(tmp_path, fmt, writer):
    from paddle_tpu.framework import io_crypto as rcrypto
    w, r = (io_crypto, rcrypto) if writer == "port" else (rcrypto, io_crypto)
    key = io_crypto.CipherFactory.generate_key()
    src, enc, dec = (tmp_path / n for n in ("m.bin", "m.enc", "m.out"))
    src.write_bytes(b"model-weights" * 100)
    if fmt == "v2_shake":
        with mock.patch.object(w, "_aesgcm", lambda: None):
            w.encrypt_file(str(src), str(enc), key)
        assert enc.read_bytes().startswith(b"PTPUENC2")
    else:
        assert w._aesgcm() is not None
        w.encrypt_file(str(src), str(enc), key)
        assert enc.read_bytes().startswith(b"PTPUENC3")
    r.decrypt_file(str(enc), str(dec), key)
    assert dec.read_bytes() == src.read_bytes()
    assert b"model-weights" not in enc.read_bytes()


def test_cipher_file_roundtrip(tmp_path):
    c = io_crypto.Cipher()
    path = str(tmp_path / "model.enc")
    c.encrypt_to_file(b"model-bytes", path)
    assert c.decrypt_from_file(path) == b"model-bytes"
    assert b"model-bytes" not in open(path, "rb").read()


# -- cpp_extension -------------------------------------------------------------------

EXT = textwrap.dedent("""
    #include "paddle_ext.h"
    #include <algorithm>
    #include <cmath>

    static void relu6_fwd(const float** ins, int, float* out, int64_t n) {
      for (int64_t i = 0; i < n; ++i)
        out[i] = std::min(std::max(ins[0][i], 0.0f), 6.0f);
    }
    static void relu6_bwd(const float** ins, int, const float* gout,
                          float** gins, int64_t n) {
      for (int64_t i = 0; i < n; ++i)
        gins[0][i] = (ins[0][i] > 0.0f && ins[0][i] < 6.0f)
                         ? gout[i] : 0.0f;
    }
    PD_EXT_REGISTER(relu6, &relu6_fwd, &relu6_bwd, 1);

    static void scaled_add_fwd(const float** ins, int, float* out,
                               int64_t n) {
      for (int64_t i = 0; i < n; ++i)
        out[i] = ins[0][i] + 2.0f * ins[1][i];
    }
    PD_EXT_REGISTER(scaled_add, &scaled_add_fwd, nullptr, 2);
""")


@pytest.fixture(scope="module")
def exts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ext")
    src = d / "myops.cc"
    src.write_text(EXT)
    from paddle_tpu.utils import cpp_extension as rcpp
    from paddle_tpu_torch.utils import cpp_extension as pcpp
    return (rcpp.load("myops_ref", [str(src)],
                      build_directory=str(d / "rbuild")),
            pcpp.load("myops_port", [str(src)],
                      build_directory=str(d / "pbuild")))


def test_custom_op_forward(exts):
    rext, pext = exts
    x = np.array([-2.0, 1.0, 9.0], dtype=np.float32)
    got = pext.relu6(x).numpy()
    np.testing.assert_array_equal(got, [0.0, 1.0, 6.0])
    np.testing.assert_array_equal(got, np.asarray(rext.relu6(x)))


def test_custom_op_grad(exts):
    rext, pext = exts
    x = np.array([-2.0, 1.0, 9.0], dtype=np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    pext.relu6(t).sum().backward()
    want = np.asarray(jax.grad(lambda v: rext.relu6(v).sum())(x))
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 1.0, 0.0])


def test_custom_op_under_to_static(exts):
    _, pext = exts
    x = torch.arange(8, dtype=torch.float32) - 4

    def f(v):
        return pext.relu6(v) * 2.0

    sf = port.jit.to_static(f)
    np.testing.assert_allclose(sf(x).numpy(), np.clip(x.numpy(), 0, 6) * 2)
    names = [str(n.target) for n in sf.graph(x).graph.nodes
             if n.op == "call_function"]
    assert any("paddle_tpu_torch_ext" in n for n in names), names
    xg = x.clone().requires_grad_(True)
    port.jit.to_static(lambda v: pext.relu6(v).sum())(xg).backward()
    np.testing.assert_array_equal(xg.grad.numpy(),
                                  ((x > 0) & (x < 6)).float().numpy())


def test_custom_op_two_inputs_no_grad(exts):
    _, pext = exts
    x = np.ones(4, dtype=np.float32)
    y = np.full(4, 3.0, dtype=np.float32)
    np.testing.assert_array_equal(pext.scaled_add(x, y).numpy(),
                                  np.full(4, 7.0, np.float32))
    assert "scaled_add" in pext.op_names()
    assert not pext._ops["scaled_add"].has_grad
    with pytest.raises(TypeError, match="expects 2 inputs"):
        pext.scaled_add(x)
    with pytest.raises(ValueError, match="every input"):
        pext.scaled_add(x, np.ones(3, np.float32))


def test_setup_builds_extension(tmp_path):
    src = tmp_path / "one.cc"
    src.write_text(
        '#include "paddle_ext.h"\n'
        "static void neg_fwd(const float** ins, int, float* out, int64_t n)"
        " { for (int64_t i = 0; i < n; ++i) out[i] = -ins[0][i]; }\n"
        "PD_EXT_REGISTER(neg, &neg_fwd, nullptr, 1);\n")
    from paddle_tpu_torch.utils import cpp_extension
    with mock.patch.object(port.sysconfig, "get_lib",
                           lambda: str(tmp_path / "build")):
        mod = cpp_extension.setup(
            "one_test", cpp_extension.CppExtension([str(src)],
                                                   name="one_test"))
    assert os.path.isfile(tmp_path / "build" / "libone_test.so")
    np.testing.assert_array_equal(mod.neg(np.array([1.0, -2.0], "f4")),
                                  [-1.0, 2.0])
    with pytest.raises(NotImplementedError, match="ops._build"):
        cpp_extension.CUDAExtension(["k.cu"])


# -- collectives -----------------------------------------------------------------

def test_collectives_outside_a_group_are_the_identity():
    from paddle_tpu_torch.distributed import collective
    x = torch.arange(6.0).reshape(2, 3)
    assert collective.all_gather_concat(x) is x
    g = collective.split_group(None, [1])
    assert g[0].ranks == [0]
    with pytest.raises(ValueError, match="num_partitions"):
        collective.split(x, (3, 4), "linear", axis=1, num_partitions=3)
    with pytest.raises(ValueError, match="axis 0"):
        collective.split(x, (3, 4), "embedding", axis=1)
    with pytest.raises(ValueError, match="row"):
        collective.split(x, (3, 4), "linear", axis=2)
    with pytest.raises(ValueError, match="unsupported operation"):
        collective.split(x, (3, 4), "conv")


def _split_plan(n):
    rs = np.random.RandomState(30)
    emb = rs.randn(10, 4).astype("f4")
    w = rs.randn(8, 6).astype("f4")
    x = rs.randn(3, 8).astype("f4")
    return {
        "rows": cworker.rows(31, n), "split_sizes": [1, 1],
        "split": {
            "embedding": dict(operation="embedding", axis=0, size=(10, 4),
                              weight=emb, x=rs.randint(0, 10, (3, 5))),
            "row": dict(operation="linear", axis=0, size=(8, 6), weight=w,
                        x=x, no_bias=True),
            "column": dict(operation="linear", axis=1, size=(8, 6),
                           weight=w, x=x, no_bias=True),
        }}


def _ref_collectives(plan, n):
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.distributed import collective as rc
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.nn.initializer import Assign
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    stacked = jnp.concatenate([jnp.asarray(r) for r in plan["rows"]], 0)
    concat = jax.shard_map(lambda v: rc.all_gather_concat(v), mesh=mesh,
                           in_specs=P("data"), out_specs=P(),
                           check_vma=False)(stacked)
    build_mesh({"model": n})
    out = {}
    for name, case in plan["split"].items():
        out[name] = np.asarray(rc.split(
            jnp.asarray(case["x"]), case["size"], case["operation"],
            axis=case["axis"], num_partitions=n,
            weight_attr=Assign(case["weight"]),
            bias_attr=False if case.get("no_bias") else None))
    build_mesh({"data": 1})
    return np.asarray(concat), out


@pytest.mark.multihost(timeout=300)
def test_split_and_gather_on_a_gloo_world_of_2(tmp_path_factory):
    n = 2
    plan = _split_plan(n)
    ranks = cworker.spawn_plan(plan, n, tmp_path_factory, "coll2")
    concat, splits = _ref_collectives(plan, n)
    for r in ranks:
        np.testing.assert_array_equal(r["concat"], concat)
        np.testing.assert_array_equal(r["concat_axis1"],
                                      np.concatenate(plan["rows"], 1))
        assert r["groups"] == [[0], [1]]
        for name, want in splits.items():
            np.testing.assert_allclose(r["split"][name], want, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        case = plan["split"]["column"]
        np.testing.assert_allclose(splits["column"],
                                   case["x"] @ case["weight"], rtol=1e-5,
                                   atol=1e-5)
