"""Filesystem clients for checkpoint and dataset IO.

Port of ``paddle_tpu/distributed/fleet/fs.py`` (the reference's
``fleet/utils/fs.py``): ``LocalFS`` and ``HDFSClient`` with one surface
(``ls_dir``, ``is_file``, ``is_dir``, ``is_exist``, ``upload``,
``download``, ``mkdirs``, ``delete``, ``touch``, ``mv``, ``list_dirs``).

``LocalFS`` covers POSIX paths (a mounted shared volume). ``HDFSClient``
shells out to ``$HADOOP_HOME/bin/hadoop fs`` (or ``hadoop_home``), retrying
a failed command every ``sleep_inter`` ms for up to ``time_out`` ms. On a
host without a ``hadoop`` binary it still constructs, and every operation
raises ``ExecuteError``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

__all__ = ["FS", "LocalFS", "HDFSClient"]


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    """The common surface."""

    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError


class LocalFS(FS):
    """A POSIX filesystem client."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, path) -> bool:
        return os.path.isfile(path)

    def is_dir(self, path) -> bool:
        return os.path.isdir(path)

    def is_exist(self, path) -> bool:
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if self.is_dir(path):
            shutil.rmtree(path)
        elif self.is_file(path):
            os.remove(path)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path):
            if exist_ok:
                return
            raise FSFileExistsError(path)
        with open(path, "a"):
            pass

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_exist(dst):
            if not overwrite:
                raise FSFileExistsError(dst)
            self.delete(dst)
        shutil.move(src, dst)

    def list_dirs(self, path) -> List[str]:
        return self.ls_dir(path)[0]

    def upload(self, local_path, fs_path):
        if self.is_dir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)


class HDFSClient(FS):
    """Shells out to ``hadoop fs`` commands (module docstring). Keeps the
    reference's constructor (``hadoop_home``, ``configs``, ``time_out``
    and ``sleep_inter`` in ms)."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        self._hadoop = None
        hadoop_home = hadoop_home or os.environ.get("HADOOP_HOME")
        if hadoop_home:
            cand = os.path.join(hadoop_home, "bin", "hadoop")
            if os.path.exists(cand):
                self._hadoop = cand
        self._config_args = []
        for k, v in (configs or {}).items():
            self._config_args += ["-D", f"{k}={v}"]
        # retry budget for transient namenode failures (reference client
        # semantics): total time_out ms, sleep_inter ms between attempts
        self._time_out = time_out / 1000.0
        self._sleep_inter = sleep_inter / 1000.0

    def _run(self, *cmd, retry: bool = True):
        if self._hadoop is None:
            raise ExecuteError(
                "no hadoop binary found (set hadoop_home or $HADOOP_HOME); "
                "use LocalFS over a mounted shared path")
        import time as _time
        deadline = _time.time() + (self._time_out if retry else 0.0)
        while True:
            out = subprocess.run(
                [self._hadoop, "fs", *self._config_args, *cmd],
                capture_output=True, text=True)
            if out.returncode == 0:
                return out.stdout
            if not retry or _time.time() + self._sleep_inter >= deadline:
                raise ExecuteError(out.stderr.strip() or
                                   f"hadoop fs {' '.join(cmd)} failed "
                                   f"(exit {out.returncode})")
            _time.sleep(self._sleep_inter)

    def _run_raw(self, *cmd):
        """Single attempt; returns (returncode, stderr)."""
        if self._hadoop is None:
            raise ExecuteError(
                "no hadoop binary found (set hadoop_home or $HADOOP_HOME)")
        out = subprocess.run(
            [self._hadoop, "fs", *self._config_args, *cmd],
            capture_output=True, text=True)
        return out.returncode, out.stderr.strip()

    def ls_dir(self, path):
        dirs, files = [], []
        for line in self._run("-ls", path).splitlines():
            # 7 fixed fields precede the path; maxsplit keeps names with
            # spaces intact
            parts = line.split(None, 7)
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[7])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    # stderr lines that do NOT indicate failure: hadoop prints these on
    # every invocation on common installs
    _BENIGN_STDERR = ("WARN", "INFO", "SLF4J", "log4j",
                      "Unable to load native", "DeprecationWarning",
                      "deprecated")

    def _test(self, flag, path) -> bool:
        # FsShell exits 1 BOTH for "test is false" and for most runtime
        # errors (connection refused, auth failure — printed to stderr as
        # 'test: ...'). Misreading an infra failure as "absent" would make
        # checkpoint logic silently re-train/overwrite, so on exit 1 the
        # stderr is scanned: benign warning lines are ignored, anything
        # else (the FsShell error line) raises.
        rc, err = self._run_raw("-test", flag, path)
        if rc == 0:
            return True
        real_errors = [ln for ln in err.splitlines()
                       if ln.strip() and not any(b in ln
                                                 for b in self._BENIGN_STDERR)]
        if rc == 1 and not real_errors:
            return False
        raise ExecuteError("\n".join(real_errors)
                           or f"hadoop fs -test exited {rc}")

    def is_exist(self, path) -> bool:
        return self._test("-e", path)

    def is_file(self, path) -> bool:
        return self._test("-f", path)

    def is_dir(self, path) -> bool:
        return self._test("-d", path)

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path):
            if exist_ok:
                return  # -touchz fails on non-empty existing files
            raise FSFileExistsError(path)
        self._run("-touchz", path)

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        # missing-src failures are permanent; don't burn the retry budget
        self._run("-mv", src, dst, retry=False)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)
