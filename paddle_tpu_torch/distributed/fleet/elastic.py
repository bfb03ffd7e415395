"""The elastic training manager: file-backed membership and the
HOLD/RESTART/EXIT decision.

Port of ``paddle_tpu/distributed/fleet/elastic.py`` (the reference's
``fleet/elastic.py`` ``ElasticManager``, etcd-backed). Membership lives in
a shared-filesystem directory, one ``<host>.alive`` file a member whose
mtime is its heartbeat; a member whose heartbeat is older than
``timeout`` seconds is no longer live. The manager only decides;
``resilience.elastic`` acts on the decision (restore barrier, remesh).

The environment contract, as the launcher sets it: ``PADDLE_ELASTIC_SERVER``
(the directory), ``PADDLE_ELASTIC_JOB_ID``, ``PADDLE_ELASTIC_NP`` (the
expected world size, ``"4"``, or a range, ``"2:3"``), and ``POD_IP`` or
``PADDLE_TRAINER_ID`` for this member's name. Without a server or with
``np`` 0 the manager is disabled and ``watch`` answers HOLD (COMPLETED
once the process is done).
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import List, Optional


class ElasticStatus:
    """The decisions of :meth:`ElasticManager.watch`."""
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """File-backed membership manager: ``elastic_server`` is the
    membership root directory (in place of an etcd url), ``job_id``
    namespaces the job, ``np`` the expected world size (or a ``"min:max"``
    range), ``host`` names this member and ``timeout`` bounds a
    heartbeat's age."""

    def __init__(self, elastic_server: Optional[str] = None,
                 job_id: Optional[str] = None, np: Optional[int] = None,
                 host: Optional[str] = None, timeout: float = 30.0):
        self.server = elastic_server or os.environ.get(
            "PADDLE_ELASTIC_SERVER")
        self.job_id = job_id or os.environ.get("PADDLE_ELASTIC_JOB_ID", "job")
        np_env = np if np is not None else os.environ.get(
            "PADDLE_ELASTIC_NP", "0")
        self.np_min, self.np_max = self._parse_np(str(np_env))
        self.host = host or os.environ.get(
            "POD_IP", f"rank-{os.environ.get('PADDLE_TRAINER_ID', '0')}")
        self.timeout = timeout
        self.enable = bool(self.server) and self.np_min > 0
        self._registered = False
        self._prev_handlers = {}
        if self.enable:
            os.makedirs(self._dir(), exist_ok=True)
            # Chain (don't clobber) existing handlers; signal.signal only
            # works on the main thread — skip elsewhere.
            if threading.current_thread() is threading.main_thread():
                self._prev_handlers = {
                    signal.SIGTERM: signal.signal(signal.SIGTERM,
                                                  self.signal_handler),
                    signal.SIGINT: signal.signal(signal.SIGINT,
                                                 self.signal_handler),
                }

    @staticmethod
    def _parse_np(np_str: str):
        if ":" in np_str:
            lo, hi = np_str.split(":")
            return int(lo), int(hi)
        n = int(np_str)
        return n, n

    def _dir(self) -> str:
        return os.path.join(self.server, self.job_id)

    def _member_file(self, host: Optional[str] = None) -> str:
        return os.path.join(self._dir(), (host or self.host) + ".alive")

    # -- membership ----------------------------------------------------------
    def register(self):
        """Announce this member (a heartbeat refreshes it).
        The KV write is retried (site ``elastic_kv``): on shared staging
        volumes a transient EIO here must not kill the member."""
        if not self.enable:
            return
        from ...resilience.retry import call_with_retry

        def _write():
            with open(self._member_file(), "w") as f:
                f.write(str(os.getpid()))

        call_with_retry(_write, site="elastic_kv", tries=3, base_delay=0.02)
        self._registered = True

    def heartbeat(self):
        if self._registered:
            try:
                os.utime(self._member_file())
            except FileNotFoundError:
                # KV dir was wiped (elastic relaunch / operator cleanup):
                # re-register instead of crashing the training loop.
                os.makedirs(self._dir(), exist_ok=True)
                self.register()

    def deregister(self):
        if self._registered:
            try:
                os.remove(self._member_file())
            except FileNotFoundError:
                pass
            self._registered = False

    def _reap_stale(self):
        """Remove members whose heartbeat passed the staleness bound (etcd
        leases expire by themselves; these leases are mtimes, so the
        watcher removes them). ``hosts()`` already leaves stale entries
        out; reaping keeps the directory the same for every observer."""
        if not self.enable:
            return
        now = time.time()
        try:
            names = os.listdir(self._dir())
        except OSError:
            return
        for fn in names:
            if not fn.endswith(".alive"):
                continue
            full = os.path.join(self._dir(), fn)
            try:
                if now - os.path.getmtime(full) > self.timeout:
                    os.remove(full)
            except OSError:
                pass

    def hosts(self) -> List[str]:
        """Live members (heartbeat within timeout). The directory scan is
        retried (site ``elastic_kv``) — a transient listdir failure must
        degrade to a delayed observation, not a RESTART decision."""
        if not self.enable:
            return []
        from ...resilience.retry import call_with_retry
        now = time.time()
        out = []
        for fn in call_with_retry(lambda: os.listdir(self._dir()),
                                  site="elastic_kv", tries=3,
                                  base_delay=0.02):
            if not fn.endswith(".alive"):
                continue
            full = os.path.join(self._dir(), fn)
            try:
                if now - os.path.getmtime(full) <= self.timeout:
                    out.append(fn[:-len(".alive")])
            except FileNotFoundError:
                pass
        return sorted(out)

    # -- decisions -----------------------------------------------------------
    def _match(self) -> bool:
        """Live membership within the expected np range."""
        n = len(self.hosts())
        return self.np_min <= n <= self.np_max

    def wait(self, interval: float = 1.0, max_wait: float = 60.0) -> bool:
        """Block until membership matches (or ``max_wait`` passes)."""
        if not self.enable:
            return True
        deadline = time.time() + max_wait
        while time.time() < deadline:
            self.heartbeat()
            if self._match():
                return True
            time.sleep(interval)
        return self._match()

    def watch(self, proc_alive=lambda: True) -> str:
        """One observation -> an :class:`ElasticStatus`."""
        if not self.enable:
            return ElasticStatus.COMPLETED if not proc_alive() \
                else ElasticStatus.HOLD
        self.heartbeat()
        self._reap_stale()
        if not proc_alive():
            return ElasticStatus.COMPLETED
        n = len(self.hosts())
        if n < self.np_min:
            return ElasticStatus.EXIT if n == 0 else ElasticStatus.RESTART
        if n > self.np_max:
            return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    def exit(self, completed: bool = False):
        """Deregister; COMPLETED or EXIT."""
        self.deregister()
        return ElasticStatus.COMPLETED if completed else ElasticStatus.EXIT

    def close(self):
        """Deregister and restore the chained signal handlers, so a
        manager created in tests or short-lived tools does not leave its
        handler installed (and its member file advertised) after use."""
        self.deregister()
        if self._prev_handlers and \
                threading.current_thread() is threading.main_thread():
            for sig, h in self._prev_handlers.items():
                try:
                    signal.signal(sig, signal.SIG_DFL if h is None else h)
                except (ValueError, TypeError):
                    pass
        self._prev_handlers = {}

    def signal_handler(self, sigint, frame):
        """Deregister, chain the previous handler, exit with 128 + signum."""
        self.deregister()
        prev = getattr(self, "_prev_handlers", {}).get(sigint)
        if callable(prev):
            prev(sigint, frame)
        raise SystemExit(128 + sigint)
