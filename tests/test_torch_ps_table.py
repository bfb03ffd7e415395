"""The port's parameter-server tables (``paddle_tpu_torch/distributed/ps``:
``native``, ``table``; ``distributed/entry.py``) against the JAX
package's, on the CPU.

Both packages bind the same C++ sources (``csrc/ps``), each its own build,
so the same calls give the same bits: every comparison here is exact
(``assert_array_equal``), rows and optimizer-slot columns alike. The
port's library is built by the port into ``paddle_tpu_torch/_build/``,
never at import, and never loaded from the reference's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.distributed import entry as ref_entry
from paddle_tpu.distributed.ps import table as ref_table

from paddle_tpu_torch.distributed import entry
from paddle_tpu_torch.distributed.ps import native, table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(cls, *args, **kw):
    return (getattr(ref_table, cls)(*args, **kw),
            getattr(table, cls)(*args, **kw))


def _pushes(rs, n_keys, dim, steps, vocab=500):
    for _ in range(steps):
        keys = rs.randint(0, vocab, n_keys).astype(np.int64)
        yield keys, rs.randn(n_keys, dim).astype(np.float32)


def test_the_build_is_the_ports_own_and_lazy():
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "paddle_tpu_torch"
    assert [p.name for p in (native.SRC_DIR / s for s in native.SOURCES)
            if not p.exists()] == []
    # importing the package builds and loads nothing
    code = ("import paddle_tpu_torch.distributed.ps as ps, "
            "paddle_tpu_torch.rec\n"
            "from paddle_tpu_torch.distributed.ps import native\n"
            "print(native._dll is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr
    dll = native.lib()
    assert os.path.realpath(dll._name) == os.path.realpath(str(lib))
    assert "paddle_tpu/lib" not in dll._name


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_pushes_give_equal_rows_and_slots(opt):
    """The same pulls and pushes (duplicate keys in a batch, more than the
    native table's threading cut-over of 1024 keys) into both tables:
    rows and every slot column equal bit for bit."""
    ref, port = _both("SparseTable", 8, opt, seed=5, init_range=0.05)
    rs = np.random.RandomState(0)
    for keys, g in _pushes(rs, 2000, 8, 4):
        np.testing.assert_array_equal(port.pull(keys), ref.pull(keys))
        ref.push(keys, g, 0.1)
        port.push(keys, g, 0.1)
    assert len(port) == len(ref)
    assert port.row_width == ref.row_width == 8 * {"sgd": 1, "adagrad": 2,
                                                   "adam": 3}[opt]
    keys = np.arange(500)
    np.testing.assert_array_equal(port.export_rows(keys),
                                  ref.export_rows(keys))


def test_export_import_with_slots_and_missing_rows():
    ref, port = _both("SparseTable", 4, "adagrad", seed=1)
    keys = np.arange(20)
    g = np.random.RandomState(1).rand(20, 4).astype(np.float32)
    for t in (ref, port):
        t.push(keys, g, 0.5)
    rows = port.export_rows(keys)
    np.testing.assert_array_equal(rows, ref.export_rows(keys))
    # absent keys: zeros without create_missing, the seeded init with it
    miss = np.array([1000, 1001])
    np.testing.assert_array_equal(port.export_rows(miss, False),
                                  ref.export_rows(miss, False))
    np.testing.assert_array_equal(port.export_rows(miss),
                                  ref.export_rows(miss))
    # rows written back to another table (the hot tier's flush) carry on
    # identically under the same next push
    r2, p2 = _both("SparseTable", 4, "adagrad", seed=9)
    r2.import_rows(keys, ref.export_rows(keys))
    p2.import_rows(keys, rows)
    for t in (ref, port, r2, p2):
        t.push(keys, g, 0.5)
    for t in (port, r2, p2):
        np.testing.assert_array_equal(t.export_rows(keys),
                                      ref.export_rows(keys))


def test_save_load_spill_and_shard_keys(tmp_path):
    ref, port = _both("SparseTable", 8, "adam", seed=3)
    keys = np.arange(300)
    g = np.random.RandomState(2).randn(300, 8).astype(np.float32)
    for t in (ref, port):
        t.push(keys, g, 0.01)
    port.save(str(tmp_path / "port" / "t.bin"))
    ref.save(str(tmp_path / "ref" / "t.bin"))
    with open(tmp_path / "port" / "t.bin", "rb") as a, \
            open(tmp_path / "ref" / "t.bin", "rb") as b:
        assert a.read() == b.read()
    # each package loads the other's file
    loaded = table.SparseTable(8, "adam", seed=99)
    loaded.load(str(tmp_path / "ref" / "t.bin"))
    np.testing.assert_array_equal(loaded.export_rows(keys),
                                  ref.export_rows(keys))
    with pytest.raises(IOError):
        table.SparseTable(4, "adam").load(str(tmp_path / "ref" / "t.bin"))
    # the cold tier: spilled rows come back transparently
    port.spill(str(tmp_path / "cold.bin"), max_hot_rows=50)
    assert port.hot_rows == 50 and len(port) == 300
    np.testing.assert_array_equal(port.pull(keys), ref.pull(keys))
    big = np.random.RandomState(0).randint(0, 2 ** 40, 10_000)
    for n in (1, 2, 3, 8):
        np.testing.assert_array_equal(table.shard_keys(big, n),
                                      ref_table.shard_keys(big, n))


def test_dense_table():
    init = np.arange(6, dtype=np.float32)
    for opt in ("sgd", "adagrad", "adam"):
        ref, port = _both("DenseTable", 6, opt, init=init)
        for i in range(3):
            g = np.full(6, 0.5 * (i + 1), np.float32)
            ref.push(g, 0.1)
            port.push(g, 0.1)
        np.testing.assert_array_equal(port.pull(), ref.pull())


def test_graph_table():
    ref, port = _both("GraphTable", 3, seed=4)
    rs = np.random.RandomState(3)
    src = rs.randint(0, 20, 300)
    dst = rs.randint(0, 1000, 300)
    w = rs.rand(300).astype(np.float32)
    for t in (ref, port):
        t.add_edges(src[:200], dst[:200])
        t.add_edges(src[200:], dst[200:], w[200:])
        t.set_node_feature(np.arange(5), np.arange(15, dtype=np.float32))
    assert len(port) == len(ref)
    assert [port.degree(k) for k in range(21)] == \
        [ref.degree(k) for k in range(21)]
    for weighted in (False, True):
        for seed in (0, 7):
            a = port.sample_neighbors(np.arange(22), 4, seed, weighted)
            b = ref.sample_neighbors(np.arange(22), 4, seed, weighted)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(port.node_feature([4, 0, 99]),
                                  ref.node_feature([4, 0, 99]))


def test_admission_entries_against_the_reference():
    keys = np.random.RandomState(5).randint(0, 2 ** 33, 5000)
    np.testing.assert_array_equal(
        entry.ProbabilityEntry(0.3).accumulate_and_admit(keys),
        ref_entry.ProbabilityEntry(0.3).accumulate_and_admit(keys))
    for bad in (1, 0.0, 1.5):
        with pytest.raises(ValueError):
            entry.ProbabilityEntry(bad)
    for bad in (-1, 0.5):
        with pytest.raises(ValueError):
            entry.CountFilterEntry(bad)
    assert entry.CountFilterEntry(3)._to_attr() == "count_filter_entry:3"
    # the gated tables under the same stream of pulls and pushes
    tabs = []
    for mod, tmod in ((ref_entry, ref_table), (entry, table)):
        t = tmod.SparseTable(4, "adagrad", seed=2)
        tabs.append((t, mod._AdmissionTable(t, mod.CountFilterEntry(2))))
    rs = np.random.RandomState(6)
    for _ in range(5):
        k = rs.randint(0, 40, 60)
        g = rs.randn(60, 4).astype(np.float32)
        outs = [at.pull(k) for _, at in tabs]
        np.testing.assert_array_equal(outs[1], outs[0])
        for _, at in tabs:
            at.push(k, g, 0.1)
    (rt, rat), (pt, pat) = tabs
    assert len(pt) == len(rt)
    np.testing.assert_array_equal(pt.export_rows(np.arange(40), False),
                                  rt.export_rows(np.arange(40), False))
    np.testing.assert_array_equal(pat.pull(np.arange(40), False),
                                  rat.pull(np.arange(40), False))
