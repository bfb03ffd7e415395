"""Multi-process training launcher and supervisor.

Port of ``paddle_tpu/distributed/launch.py`` (the reference's
``python -m paddle.distributed.launch``)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \
        [--max_restarts K] [--log_dir DIR] script.py [script args]

starts one process per rank with the environment ``distributed/env.py``
reads: ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT`` (a free port of this host) and the
reference's ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``/
``PADDLE_RANK_IN_NODE``/``PADDLE_CURRENT_ENDPOINT``/
``PADDLE_TRAINER_ENDPOINTS``; the script calls
``distributed.init_parallel_env()`` with no arguments.

The supervisor watches the ranks and fails fast: when one exits non-zero
it terminates the others and, while restarts remain, relaunches the
whole set (each relaunch resumes from the last checkpoint through
``run_resilient``). A SIGTERM to the launcher is forwarded to every rank
(``terminate``), which drains it (exit 143), and the launcher exits.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "get_cluster_env", "main"]


def _find_free_ports(n: int, start: int = 6170) -> List[int]:
    import socket
    ports, p = [], start
    while len(ports) < n:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
                ports.append(p)
            except OSError:
                pass
        p += 1
    return ports


def get_cluster_env(rank: int, nprocs: int, ports: List[int],
                    master_port: int) -> dict:
    """The environment of one rank."""
    endpoints = ",".join(f"127.0.0.1:{p}" for p in ports)
    return {
        "RANK": str(rank),
        "WORLD_SIZE": str(nprocs),
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(nprocs),
        # the default process group's rendezvous (env:// in
        # init_parallel_env)
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(master_port),
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{ports[rank]}",
        "PADDLE_TRAINER_ENDPOINTS": endpoints,
        "PADDLE_RANK_IN_NODE": str(rank),
    }


class _Supervisor:
    def __init__(self, script: str, script_args: List[str], nprocs: int,
                 log_dir: Optional[str], max_restarts: int):
        self.script = script
        self.script_args = script_args
        self.nprocs = nprocs
        self.log_dir = log_dir
        self.max_restarts = max_restarts
        self.procs: List[subprocess.Popen] = []
        self.logs = []

    def start_local_trainers(self):
        ports = _find_free_ports(self.nprocs + 1)
        coord, ports = ports[0], ports[1:]
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        self.procs, self.logs = [], []
        for rank in range(self.nprocs):
            env = dict(os.environ)
            env.update(get_cluster_env(rank, self.nprocs, ports, coord))
            if self.log_dir:
                log = open(os.path.join(self.log_dir,
                                        f"workerlog.{rank}"), "ab")
            else:
                log = None
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-u", self.script] + self.script_args,
                env=env, stdout=log, stderr=subprocess.STDOUT if log else None))

    def terminate_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        for log in self.logs:
            if log:
                log.close()
        self.logs = []

    def watch(self, poll_interval: float = 0.5) -> int:
        """Wait for the ranks; returns the exit code. A rank that fails
        ends the set, which is relaunched while restarts remain."""
        restarts = 0
        while True:
            while True:
                codes = [p.poll() for p in self.procs]
                if all(c == 0 for c in codes):
                    self.terminate_all()
                    return 0
                failed = [(i, c) for i, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed:
                    break
                time.sleep(poll_interval)
            rank, code = failed[0]
            print(f"[launch] rank {rank} exited with {code}", file=sys.stderr)
            self.terminate_all()
            if restarts >= self.max_restarts:
                print(f"[launch] aborting after {restarts} restarts",
                      file=sys.stderr)
                return code or 1
            restarts += 1
            print(f"[launch] elastic restart {restarts}/{self.max_restarts}",
                  file=sys.stderr)
            self.start_local_trainers()


def launch(script: str, script_args: Optional[List[str]] = None,
           nproc_per_node: int = 1, log_dir: Optional[str] = None,
           max_restarts: int = 0) -> int:
    sup = _Supervisor(script, list(script_args or []), nproc_per_node,
                      log_dir, max_restarts)

    def on_sig(signum, frame):
        # forward: terminate() sends every rank SIGTERM (its drain)
        sup.terminate_all()
        sys.exit(1)

    old_term = signal.signal(signal.SIGTERM, on_sig)
    try:
        sup.start_local_trainers()
        return sup.watch()
    finally:
        # on any exit path (KeyboardInterrupt included) no rank is left
        # holding a card or a port; terminate_all is idempotent
        sup.terminate_all()
        signal.signal(signal.SIGTERM, old_term)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch one training process per rank with the "
                    "torch.distributed environment.")
    ap.add_argument("--nproc_per_node", type=int,
                    default=int(os.environ.get("PADDLE_NPROC_PER_NODE", 1)))
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="elastic: relaunch the worker set up to N times "
                         "when a rank fails (0 = fail fast)")
    ap.add_argument("training_script")
    ap.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    return launch(args.training_script, args.training_script_args,
                  nproc_per_node=args.nproc_per_node, log_dir=args.log_dir,
                  max_restarts=args.max_restarts)


if __name__ == "__main__":
    sys.exit(main())
