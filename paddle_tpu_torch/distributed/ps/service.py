"""The multi-host parameter server: TCP servers and key-hash routing.

Port of ``paddle_tpu/distributed/ps/service.py`` (reference
distributed/service/brpc_ps_server.cc / brpc_ps_client.cc, and the async
Communicator of service/communicator.h:197). The transport is
``csrc/ps/ps_service.cc`` (blocking sockets, a C ABI). Every logical key is
owned by exactly one server, chosen by ``table.shard_keys``, the hash mix
the native table shards by internally:

- ``PsServer``: one key shard of a sparse table, and optionally one node
  shard of a graph table, served on ``host:port`` (port 0: a free port,
  read back as ``.port``);
- ``DistributedSparseTable``: the client view over every server; each
  call fans out to the owning shards concurrently, and large requests are
  pipelined within a connection; ``async_mode`` drains pushes from a
  bounded queue on a background thread (geo-style bounded staleness), an
  error surfacing on the next push or ``flush``;
- ``DistributedGraphTable``: the node-partitioned graph over the servers,
  with multi-hop sampling that re-routes each hop to the owners.

Endpoints come from the launcher (``PADDLE_PSERVER_ENDPOINTS``, read by
``fleet.init_worker``). Host memory and numpy arrays only.
"""
from __future__ import annotations

import ctypes
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from .native import lib
from .table import SparseTable, shard_keys, _as_f32, _as_i64, _fp, _ip


class PsServer:
    """Serves one key shard of a sparse table — and optionally one NODE
    shard of a graph table (``graph_feat_dim``) — over TCP (reference:
    brpc_ps_server.cc serving common_sparse_table + common_graph_table).
    Owns the tables; keeps them accessible in-process (e.g. for
    checkpointing via ``table.save``)."""

    def __init__(self, dim: int, optimizer: str = "adagrad", port: int = 0,
                 host: str = "127.0.0.1",
                 graph_feat_dim: Optional[int] = None, **table_kwargs):
        from .table import GraphTable
        self.table = SparseTable(dim, optimizer, **table_kwargs)
        self.graph = (GraphTable(graph_feat_dim)
                      if graph_feat_dim is not None else None)
        self._lib = lib()
        self._h = self._lib.ps_server_start2(
            self.table._h, dim,
            self.graph._h if self.graph is not None else None,
            graph_feat_dim or 0, port)
        if not self._h:
            raise OSError(f"failed to start PS server on port {port}")
        self.host = host
        self.port = int(self._lib.ps_server_port(self._h))

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self):
        if getattr(self, "_h", None):
            self._lib.ps_server_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class _Conn:
    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self._lib = lib()
        self._h = self._lib.ps_client_connect(host.encode(), int(port))
        if not self._h:
            raise ConnectionError(f"cannot connect to PS at {endpoint}")
        self.dim = int(self._lib.ps_client_dim(self._h))
        # one CALL at a time per connection. The native c->mu serializes
        # whole blocking request/response pairs against each other, but
        # the pipelined halves take only send_mu/recv_mu — so a
        # pipelined call racing ANY other call on this connection would
        # interleave frames and mismatch FIFO replies (async-mode's
        # drain-thread push vs a concurrent pull, or two user threads
        # sharing a table). Every public entry point takes this lock;
        # the split halves do NOT (they run inside a locked pipeline).
        self.lock = threading.Lock()

    @property
    def feat_dim(self) -> int:
        return int(self._lib.ps_client_feat_dim(self._h))

    def graph_add_edges(self, src, dst, w=None):
        wp = _fp(w) if w is not None else None
        with self.lock:
            if not self._lib.ps_client_graph_add_edges(
                    self._h, _ip(src), _ip(dst), wp, src.size):
                raise ConnectionError("PS graph add_edges RPC failed")

    def graph_sample(self, keys, k, seed, weighted):
        out = np.empty((keys.size, k), dtype=np.int64)
        counts = np.empty((keys.size,), dtype=np.int64)
        with self.lock:
            if not self._lib.ps_client_graph_sample(
                    self._h, _ip(keys), keys.size, int(k), int(seed),
                    _ip(out), _ip(counts), 1 if weighted else 0):
                raise ConnectionError("PS graph sample RPC failed")
        return out, counts

    def graph_feature(self, keys, feat_dim):
        out = np.empty((keys.size, feat_dim), dtype=np.float32)
        with self.lock:
            if not self._lib.ps_client_graph_feature(self._h, _ip(keys),
                                                     keys.size, _fp(out)):
                raise ConnectionError("PS graph feature RPC failed")
        return out

    def graph_set_feature(self, keys, feats):
        with self.lock:
            if not self._lib.ps_client_graph_set_feature(
                    self._h, _ip(keys), keys.size, _fp(feats)):
                raise ConnectionError("PS graph set_feature RPC failed")

    def graph_num_nodes(self) -> int:
        with self.lock:
            n = int(self._lib.ps_client_graph_num_nodes(self._h))
        if n < 0:
            raise ConnectionError("PS graph num_nodes RPC failed")
        return n

    def pull(self, keys: np.ndarray, create: bool) -> np.ndarray:
        out = np.empty((keys.size, self.dim), dtype=np.float32)
        with self.lock:
            if not self._lib.ps_client_pull(self._h, _ip(keys), keys.size,
                                            _fp(out), 1 if create else 0):
                raise ConnectionError("PS pull RPC failed")
        return out

    def push(self, keys: np.ndarray, grads: np.ndarray, lr: float):
        with self.lock:
            if not self._lib.ps_client_push(self._h, _ip(keys), keys.size,
                                            _fp(grads), lr):
                raise ConnectionError("PS push RPC failed")

    # -- pipelined halves (many requests in flight per connection;
    # replies are FIFO on the ordered stream — see ps_service.cc) ------
    def pull_send(self, keys: np.ndarray, create: bool):
        if not self._lib.ps_client_pull_send(self._h, _ip(keys), keys.size,
                                             1 if create else 0):
            raise ConnectionError("PS pull_send failed")

    def pull_recv(self, out: np.ndarray, n: int):
        if not self._lib.ps_client_pull_recv(self._h, _fp(out), n):
            raise ConnectionError("PS pull_recv failed")

    def push_send(self, keys: np.ndarray, grads: np.ndarray, lr: float):
        if not self._lib.ps_client_push_send(self._h, _ip(keys), keys.size,
                                             _fp(grads), lr):
            raise ConnectionError("PS push_send failed")

    def push_recv(self):
        if not self._lib.ps_client_push_recv(self._h):
            raise ConnectionError("PS push_recv failed")

    def sample_send(self, keys: np.ndarray, k: int, seed: int,
                    weighted: bool):
        if not self._lib.ps_client_graph_sample_send(
                self._h, _ip(keys), keys.size, int(k), int(seed),
                1 if weighted else 0):
            raise ConnectionError("PS sample_send failed")

    def sample_recv(self, n: int, k: int):
        out = np.empty((n, k), dtype=np.int64)
        counts = np.empty((n,), dtype=np.int64)
        if not self._lib.ps_client_graph_sample_recv(
                self._h, n, int(k), _ip(out), _ip(counts)):
            raise ConnectionError("PS sample_recv failed")
        return out, counts

    def size(self) -> int:
        with self.lock:
            return int(self._lib.ps_client_size(self._h))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ps_client_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _ShardedClient:
    """Shared key-hash routing + concurrent per-shard fan-out (each _Conn
    has its own socket+lock — the reference brpc client's parallel
    fan-out; sequential round trips would cost n_shards x RTT).

    Within each connection large requests are PIPELINED: the key range is
    chunked and a dedicated sender thread streams request frames while
    the shard's worker drains replies concurrently (brpc_ps_client.cc's
    async stubs keep many calls in flight per channel the same way) —
    server-side hash work, network transfer, and client-side marshalling
    overlap instead of latency-stacking per shard in skewed fan-outs.
    ``stats`` records the in-flight depth."""

    # keys per in-flight request frame: small enough that several
    # requests fit in socket buffers, large enough to amortize syscalls
    PIPELINE_CHUNK = 8192

    def __init__(self, endpoints: Sequence[str],
                 pipeline: Optional[bool] = None):
        assert endpoints, "need at least one PS endpoint"
        self.conns: List[_Conn] = [_Conn(e) for e in endpoints]
        self.n_shards = len(self.conns)
        self._pool = (ThreadPoolExecutor(max_workers=self.n_shards)
                      if self.n_shards > 1 else None)
        # pipelining overlaps marshalling/network/server work across
        # THREADS, so it needs cores to run them: on a 1-core host the
        # sender thread only preempts the recv drain (measured loopback
        # 4 servers, 200k keys: 5.17M pulls/sec unpipelined vs 4.5M
        # chunked) — default on only where a second core exists
        import os as _os
        self.pipeline_enabled = ((_os.cpu_count() or 1) > 1
                                 if pipeline is None else bool(pipeline))
        self.stats = {"pipelined_calls": 0, "max_inflight_reqs": 1}

    def _route(self, keys: np.ndarray):
        assign = shard_keys(keys, self.n_shards)
        for s in range(self.n_shards):
            idx = np.nonzero(assign == s)[0]
            if idx.size:
                yield s, idx

    def _fan_out(self, jobs):
        if self._pool is None or len(jobs) <= 1:
            for j in jobs:
                j()
            return
        futs = [self._pool.submit(j) for j in jobs]
        for f in futs:
            f.result()  # re-raises ConnectionError from any shard

    def _chunks(self, idx: np.ndarray):
        if not self.pipeline_enabled:
            return [idx]
        ch = self.PIPELINE_CHUNK
        return [idx[i:i + ch] for i in range(0, idx.size, ch)]

    def _pipelined(self, conn, chunks, send_one, recv_one):
        """Stream requests from a sender thread while this thread drains
        replies (client always reading -> no send/write deadlock, the
        flow control a fixed window would need). Holds conn.lock for the
        WHOLE call: FIFO reply matching is per-connection state, so no
        other call (blocking or pipelined — e.g. async-mode's drain
        thread) may interleave frames on this connection meanwhile."""
        with conn.lock:
            return self._pipelined_locked(conn, chunks, send_one,
                                          recv_one)

    def _pipelined_locked(self, conn, chunks, send_one, recv_one):
        self.stats["pipelined_calls"] += 1
        self.stats["max_inflight_reqs"] = max(
            self.stats["max_inflight_reqs"], len(chunks))
        err: List[BaseException] = []
        sent = threading.Semaphore(0)  # recv only what was really sent
        #                                (a send-side error must not
        #                                leave the recv loop blocked on a
        #                                healthy socket forever)

        def send_all():
            try:
                for ch in chunks:
                    send_one(conn, ch)
                    sent.release()
            except BaseException as e:
                err.append(e)
                sent.release()  # unblock the waiter

        t = threading.Thread(target=send_all, name="ps-send", daemon=True)
        t.start()
        try:
            for ch in chunks:
                sent.acquire()
                if err:
                    break
                recv_one(conn, ch)
        finally:
            t.join()
        if err:
            raise err[0]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for c in self.conns:
            c.close()


class DistributedSparseTable(_ShardedClient):
    """Client view of a sparse table sharded across PS servers by key hash.

    ``pull``/``push`` route each key to its owning server (reference:
    brpc_ps_client pull_sparse/push_sparse fan-out). ``async_mode`` drains
    pushes from a bounded queue on a background thread — the reference
    Communicator's geo/async semantics (communicator.h:197): training does
    not block on the push RPC, staleness is bounded by the queue depth.
    """

    def __init__(self, endpoints: Sequence[str], async_mode: bool = False,
                 max_pending: int = 8, pipeline: Optional[bool] = None):
        super().__init__(endpoints, pipeline=pipeline)
        try:
            self.dim = self.conns[0].dim
            for e, c in zip(endpoints, self.conns):
                if c.dim != self.dim:
                    raise ValueError(
                        f"PS dim mismatch: {endpoints[0]} serves dim "
                        f"{self.dim} but {e} serves dim {c.dim}")
        except Exception:
            super().close()  # don't leak sockets/pool on a failed build
            raise
        self.async_mode = async_mode
        self._err: Optional[BaseException] = None
        if async_mode:
            self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
            self._worker = threading.Thread(target=self._drain,
                                            name="ps-async-drain",
                                            daemon=True)
            self._worker.start()

    def pull(self, keys, create_missing: bool = True) -> np.ndarray:
        keys = _as_i64(keys)
        flat = keys.reshape(-1)
        out = np.empty((flat.size, self.dim), dtype=np.float32)

        def job(s, idx):
            def go():
                chunks = self._chunks(idx)
                if len(chunks) <= 1:
                    out[idx] = self.conns[s].pull(
                        np.ascontiguousarray(flat[idx]), create_missing)
                    return

                def send_one(conn, ch):
                    conn.pull_send(np.ascontiguousarray(flat[ch]),
                                   create_missing)

                def recv_one(conn, ch):
                    buf = np.empty((ch.size, self.dim), np.float32)
                    conn.pull_recv(buf, ch.size)
                    out[ch] = buf

                self._pipelined(self.conns[s], chunks, send_one, recv_one)
            return go

        self._fan_out([job(s, idx) for s, idx in self._route(flat)])
        return out.reshape(keys.shape + (self.dim,))

    def _push_sync(self, keys: np.ndarray, grads: np.ndarray, lr: float):
        def job(s, idx):
            def go():
                chunks = self._chunks(idx)
                if len(chunks) <= 1:
                    self.conns[s].push(np.ascontiguousarray(keys[idx]),
                                       np.ascontiguousarray(grads[idx]),
                                       lr)
                    return

                def send_one(conn, ch):
                    conn.push_send(np.ascontiguousarray(keys[ch]),
                                   np.ascontiguousarray(grads[ch]), lr)

                def recv_one(conn, ch):
                    conn.push_recv()

                self._pipelined(self.conns[s], chunks, send_one, recv_one)
            return go

        self._fan_out([job(s, idx) for s, idx in self._route(keys)])

    def push(self, keys, grads, lr: float):
        keys = _as_i64(keys).reshape(-1)
        grads = _as_f32(grads).reshape(keys.size, self.dim)
        if not self.async_mode:
            self._push_sync(keys, grads, lr)
            return
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        # copies: the caller may reuse/donate its buffers
        self._q.put((keys.copy(), grads.copy(), float(lr)))

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._push_sync(*item)
            except BaseException as e:  # surfaced on next push/flush
                self._err = e
            finally:
                self._q.task_done()

    def flush(self):
        """Barrier for async pushes (reference Communicator barrier)."""
        if self.async_mode:
            self._q.join()
            if self._err is not None:
                err, self._err = self._err, None
                raise err

    def shard_sizes(self) -> List[int]:
        return [c.size() for c in self.conns]

    def close(self):
        if self.async_mode and self._worker.is_alive():
            self._q.join()
            self._q.put(None)
            self._worker.join(timeout=5)
        super().close()


class DistributedGraphTable(_ShardedClient):
    """Client view of a graph table NODE-partitioned across PS servers
    (reference: common_graph_table.cc:1-596 served by brpc — each server
    owns the adjacency + features of its hash shard of the node space).

    Edges live with their SOURCE node's owner, so neighbor sampling for
    a node is one RPC to its owner; sampled neighbor ids may belong to
    ANY server — multi-hop sampling (``sample_hops``) re-routes each
    hop's frontier to the owning servers, which is the cross-server
    walk the reference's graph service performs.
    """

    def __init__(self, endpoints: Sequence[str],
                 pipeline: Optional[bool] = None):
        super().__init__(endpoints, pipeline=pipeline)
        try:
            self.feat_dim = self.conns[0].feat_dim
            for e, c in zip(endpoints, self.conns):
                if c.feat_dim != self.feat_dim:
                    raise ValueError(f"graph feat_dim mismatch at {e}")
            if self.feat_dim <= 0:
                raise ValueError(
                    "endpoints serve no graph table (PsServer was built "
                    "without graph_feat_dim) — graph RPCs against them "
                    "would close the connection")
        except Exception:
            super().close()  # don't leak sockets/pool on a failed build
            raise

    def add_edges(self, src, dst, weights=None):
        src = _as_i64(src).reshape(-1)
        dst = _as_i64(dst).reshape(-1)
        w = _as_f32(weights).reshape(-1) if weights is not None else None

        def job(s, idx):
            def go():
                self.conns[s].graph_add_edges(
                    np.ascontiguousarray(src[idx]),
                    np.ascontiguousarray(dst[idx]),
                    np.ascontiguousarray(w[idx]) if w is not None
                    else None)
            return go

        self._fan_out([job(s, i) for s, i in self._route(src)])

    def sample_neighbors(self, keys, k: int, seed: int = 0,
                         weighted: bool = False):
        """(neighbors (N, k) padded with -1, counts (N,)): each key's
        sample comes from its owning server's adjacency shard."""
        keys = _as_i64(keys).reshape(-1)
        out = np.full((keys.size, k), -1, dtype=np.int64)
        counts = np.zeros((keys.size,), dtype=np.int64)

        def job(s, idx):
            def go():
                chunks = self._chunks(idx)
                if len(chunks) <= 1:
                    o, c = self.conns[s].graph_sample(
                        np.ascontiguousarray(keys[idx]), k, seed, weighted)
                    out[idx] = o
                    counts[idx] = c
                    return

                def send_one(conn, ch):
                    conn.sample_send(np.ascontiguousarray(keys[ch]), k,
                                     seed, weighted)

                def recv_one(conn, ch):
                    o, c = conn.sample_recv(ch.size, k)
                    out[ch] = o
                    counts[ch] = c

                self._pipelined(self.conns[s], chunks, send_one, recv_one)
            return go

        self._fan_out([job(s, i) for s, i in self._route(keys)])
        return out, counts

    def sample_hops(self, keys, fanouts: Sequence[int], seed: int = 0,
                    weighted: bool = False):
        """Multi-hop neighborhood sampling: hop h samples ``fanouts[h]``
        neighbors of the previous frontier, re-routing every hop to the
        owners of its (possibly remote) nodes. Returns a list of
        (src (F,), neighbors (F, k), counts (F,)) per hop."""
        frontier = np.unique(_as_i64(keys).reshape(-1))
        out = []
        for h, k in enumerate(fanouts):
            nbrs, counts = self.sample_neighbors(frontier, k,
                                                 seed=seed + h,
                                                 weighted=weighted)
            out.append((frontier, nbrs, counts))
            nxt = nbrs[nbrs >= 0]
            if nxt.size == 0:
                break
            frontier = np.unique(nxt)
        return out

    def node_feature(self, keys) -> np.ndarray:
        keys = _as_i64(keys).reshape(-1)
        out = np.zeros((keys.size, self.feat_dim), dtype=np.float32)

        def job(s, idx):
            def go():
                out[idx] = self.conns[s].graph_feature(
                    np.ascontiguousarray(keys[idx]), self.feat_dim)
            return go

        self._fan_out([job(s, i) for s, i in self._route(keys)])
        return out

    def set_node_feature(self, keys, feats):
        keys = _as_i64(keys).reshape(-1)
        feats = _as_f32(feats).reshape(keys.size, self.feat_dim)

        def job(s, idx):
            def go():
                self.conns[s].graph_set_feature(
                    np.ascontiguousarray(keys[idx]),
                    np.ascontiguousarray(feats[idx]))
            return go

        self._fan_out([job(s, i) for s, i in self._route(keys)])

    def num_nodes(self) -> int:
        return sum(c.graph_num_nodes() for c in self.conns)
