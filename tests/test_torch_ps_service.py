"""The port's parameter-server service (``distributed/ps/service.py``) and
the fleet's server lifecycle against the JAX package's, on the CPU.

Servers bind port 0 (a free port, read back) or a port asked of the OS
just before; never a fixed one. Both packages run the same C++ service,
and a key's row and optimizer state are independent of every other key's,
so a table sharded over servers gives the same bits as one local table:
those comparisons are exact. The cross-process Wide&Deep runs its servers
in two child processes (``torch_ps_worker.py``, through
``fleet.init_server``/``run_server``) and trains the port's model over
``DistributedSparseTable``s, held bit for bit against the same model on
local tables and, within the rec tests' bars (``STEP_ATOL``, losses rtol
1e-5: another GEMM order), against the JAX package's model.
"""
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.ps import SparseTable as RefSparseTable

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.ps import (DistributedGraphTable,
                                             DistributedSparseTable, PsServer,
                                             SparseTable, shard_keys)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _stop(*servers):
    for s in servers:
        s.stop()


def test_round_trip_equals_the_reference_table_bit_for_bit():
    ref = RefSparseTable(8, optimizer="adagrad", seed=3)
    srv = PsServer(8, optimizer="adagrad", seed=3)
    try:
        dist = DistributedSparseTable([srv.endpoint])
        keys = np.array([5, 17, 5, 900000007], dtype=np.int64)
        np.testing.assert_array_equal(dist.pull(keys), ref.pull(keys))
        g = np.random.RandomState(0).randn(4, 8).astype("f4")
        dist.push(keys, g, lr=0.1)
        ref.push(keys, g, lr=0.1)
        np.testing.assert_array_equal(dist.pull(keys), ref.pull(keys))
        np.testing.assert_array_equal(srv.table.export_rows(keys),
                                      ref.export_rows(keys))
        dist.close()
    finally:
        _stop(srv)


@pytest.mark.parametrize("opt,n", [("adam", 64), ("adagrad", 3 * 8192 + 5)],
                         ids=["adam", "adagrad-pipelined"])
def test_sharded_routing_over_two_servers_is_invisible(opt, n):
    """Adam's bias correction counts push calls per table, so it is held
    on a request of one frame; the pipelined request (several frames to
    each server) under Adagrad."""
    single = RefSparseTable(4, optimizer=opt, seed=7)
    servers = [PsServer(4, optimizer=opt, seed=7) for _ in range(2)]
    try:
        dist = DistributedSparseTable([s.endpoint for s in servers],
                                      pipeline=True)
        rs = np.random.RandomState(1)
        keys = rs.randint(0, 10_000, n)
        np.testing.assert_array_equal(dist.pull(keys), single.pull(keys))
        for _ in range(3):
            g = rs.randn(keys.size, 4).astype("f4")
            dist.push(keys, g, lr=0.05)
            single.push(keys, g, lr=0.05)
        np.testing.assert_array_equal(dist.pull(keys), single.pull(keys))
        sizes = dist.shard_sizes()
        assert sum(sizes) == len(single) and min(sizes) > 0
        assign = shard_keys(keys, 2)
        for s in range(2):
            assert sizes[s] == np.unique(keys[assign == s]).size
        assert dist.stats["max_inflight_reqs"] == (1 if n < 8192 else 2)
        dist.close()
    finally:
        _stop(*servers)


def test_geo_async_staleness_and_flush():
    srv = PsServer(4, optimizer="sgd", init_range=0.0)
    try:
        dist = DistributedSparseTable([srv.endpoint], async_mode=True,
                                      max_pending=2)
        keys = np.arange(8, dtype=np.int64)
        np.testing.assert_array_equal(dist.pull(keys), 0.0)
        for _ in range(5):
            dist.push(keys, np.ones((8, 4), "f4"), lr=1.0)
        dist.flush()
        np.testing.assert_array_equal(dist.pull(keys), -5.0)
        dist.close()
    finally:
        _stop(srv)


def test_oversized_frames_are_rejected_and_push_errors_surface():
    srv = PsServer(16, optimizer="sgd")
    try:
        host, port = srv.endpoint.rsplit(":", 1)
        for op, n in ((4, (1 << 24) + 1), (1, (1 << 23) + 1),
                      (2, (1 << 23) + 1)):
            s = socket.create_connection((host, int(port)), timeout=10)
            s.sendall(bytes([op, 0]) + struct.pack("<q", n))
            s.settimeout(10)
            assert s.recv(1) == b""          # the server closed it
            s.close()
        dist = DistributedSparseTable([srv.endpoint])
        assert dist.pull(np.arange(4)).shape == (4, 16)
        dist.close()
    finally:
        _stop(srv)
    srv = PsServer(4, optimizer="sgd")
    dist = DistributedSparseTable([srv.endpoint], async_mode=True)
    keys = np.arange(4, dtype=np.int64)
    dist.push(keys, np.ones((4, 4), "f4"), lr=1.0)
    dist.flush()
    srv.stop()                               # the server dies under it
    with pytest.raises((ConnectionError, OSError)):
        for _ in range(50):
            dist.push(keys, np.ones((4, 4), "f4"), lr=1.0)
            dist.flush()
            time.sleep(0.02)


def test_graph_sampling_across_two_servers():
    srvs = [PsServer(4, "sgd", graph_feat_dim=2) for _ in range(2)]
    try:
        g = DistributedGraphTable([s.endpoint for s in srvs])
        n = 24
        src = np.arange(n, dtype=np.int64).repeat(2)
        dst = np.stack([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n],
                       1).reshape(-1).astype(np.int64)
        g.add_edges(src, dst)
        assert g.num_nodes() == n
        assert len(srvs[0].graph) > 0 and len(srvs[1].graph) > 0
        nbrs, counts = g.sample_neighbors(np.arange(n), 2, seed=3)
        for i in range(n):
            assert set(nbrs[i].tolist()) <= {(i + 1) % n, (i - 1) % n}
            assert counts[i] == 2
        hops = g.sample_hops(np.arange(6), [2, 2], seed=1)
        assert set(shard_keys(hops[1][0], 2).tolist()) == {0, 1}
        feats = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
        g.set_node_feature(np.arange(n), feats)
        np.testing.assert_array_equal(g.node_feature(hops[1][0]),
                                      feats[hops[1][0]])
        g.close()
    finally:
        _stop(*srvs)


def test_fleet_lifecycle_in_process(monkeypatch):
    import threading
    f = fleet.Fleet()
    srv = f.init_server(dim=8, optimizer="sgd", port=0, init_range=0.0)
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS", srv.endpoint)
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    assert f.server_num() == 1 and not f.is_server()
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    assert f.is_server()
    t = threading.Thread(target=f.run_server, daemon=True)
    t.start()
    client = f.init_worker()
    keys = np.asarray([3, 9], np.int64)
    assert client.pull(keys).shape == (2, 8)
    client.push(keys, np.ones((2, 8), np.float32), lr=1.0)
    np.testing.assert_array_equal(client.pull(keys), -1.0)
    f.stop_worker()
    assert f._ps_client is None
    f.stop_server()
    t.join(timeout=10)
    assert not t.is_alive()
    # the port from this server's entry of the endpoints
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS",
                       f"127.0.0.1:1,127.0.0.1:{free}")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "1")
    g = fleet.Fleet()
    assert g.init_server(dim=4).port == free
    g.stop_server()
    g._ps_server.stop()
    monkeypatch.delenv("PADDLE_PSERVER_ENDPOINTS")
    with pytest.raises(RuntimeError, match="ENDPOINTS"):
        fleet.Fleet().init_worker()


# -- two server processes, the port's Wide&Deep over them ---------------------

def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _start_servers(rdv, dims, n=2):
    eps = ",".join(f"127.0.0.1:{p}" for p in _free_ports(n))
    procs = []
    for sid in range(n):
        env = dict(os.environ, TRAINING_ROLE="PSERVER",
                   PADDLE_PSERVER_ENDPOINTS=eps, PADDLE_PSERVER_ID=str(sid),
                   PYTHONPATH=ROOT + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_ps_worker.py"),
             str(rdv), ",".join(map(str, dims))], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + 120
    while not all((rdv / f"ep.{i}").exists() for i in range(n)):
        for p in procs:
            if p.poll() is not None:
                pytest.fail(f"a PS server process died:\n{p.stdout.read()}")
        assert time.time() < deadline, "PS server processes did not start"
        time.sleep(0.05)
    per_dim = list(zip(*[(rdv / f"ep.{i}").read_text().split("\n")
                         for i in range(n)]))
    assert [e.rsplit(":", 1)[1] for e in per_dim[0]] == \
        [e.rsplit(":", 1)[1] for e in eps.split(",")]
    return procs, per_dim


@pytest.mark.multihost(timeout=240)
def test_cross_process_wide_deep_on_the_sharded_ps(tmp_path):
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu import rec as ref_rec
    from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
    from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
    from paddle_tpu_torch import optimizer as topt, rec
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.ps import DistributedEmbedding
    from test_torch_rec_models import (DENSE, FIELDS, LR, STEP_ATOL, _bce,
                                       _ctr_data, _ref_bce)

    procs, (eps16, eps1) = _start_servers(tmp_path, (8, 1))
    try:
        ref_build_mesh({"data": 1})
        paddle.seed(0)
        ref = ref_rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                               hidden_sizes=(16, 8), sparse=True)
        w = {k: np.asarray(v) for k, v in ref.state_dict().items()}
        rt = RefTrainer(ref, paddle.optimizer.Adam(
            LR, parameters=ref.parameters()), _ref_bce)
        runs = {}
        for mode in ("remote", "local"):
            mesh_mod.set_mesh(None)
            mesh_mod.build_mesh({"data": 1})
            m = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                             hidden_sizes=(16, 8), sparse=True)
            if mode == "remote":
                m.embedding = DistributedEmbedding(
                    8, lr=0.05, table=DistributedSparseTable(list(eps16)))
                m.linear_emb = DistributedEmbedding(
                    1, lr=0.05, table=DistributedSparseTable(list(eps1)))
            m.set_state_dict_from_numpy(w)
            tr = ParallelTrainer(m, topt.Adam(LR), _bce, device="cpu")
            runs[mode] = (m, tr, [])
        ref_losses = []
        for step in range(3):
            ids, dense, y = _ctr_data(seed=step)
            ref_losses.append(float(rt.train_step((ids, dense), y)))
            for m, tr, losses in runs.values():
                losses.append(float(tr.train_step(
                    (torch.from_numpy(ids), torch.from_numpy(dense)),
                    torch.from_numpy(y))))
        (rm, rtr, rl), (lm, ltr, ll) = runs["remote"], runs["local"]
        assert rl == ll
        np.testing.assert_allclose(rl, ref_losses, rtol=1e-5)
        keys = np.arange(sum(FIELDS))
        for name in ("embedding", "linear_emb"):
            remote, local = getattr(rm, name).table, getattr(lm, name).table
            want = getattr(ref, name).table
            sizes = remote.shard_sizes()
            assert sum(sizes) == len(local) == len(want) and min(sizes) > 0
            got = remote.pull(keys, create_missing=False)
            np.testing.assert_array_equal(
                got, local.pull(keys, create_missing=False))
            np.testing.assert_allclose(got, want.pull(keys, False), rtol=0,
                                       atol=STEP_ATOL)
        for k, p in rtr.params.items():
            assert torch.equal(p, ltr.params[k]), k
        for name in ("embedding", "linear_emb"):
            getattr(rm, name).table.close()
    finally:
        (tmp_path / "stop").touch()
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                raise
            assert p.returncode == 0, out[-3000:]
    assert all((tmp_path / f"exit.{i}").exists() for i in range(2))
