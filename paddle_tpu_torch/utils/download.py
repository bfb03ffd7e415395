"""Weights/dataset download cache (a copy of ``paddle_tpu/utils/
download.py``; reference python/paddle/utils/download.py —
get_weights_path_from_url:75, get_path_from_url:121 with md5 check +
tar/zip decompress).

A fetch is attempted only when the file is not already in the cache, and
a failure raises a clear error instead of hanging: where there is no
network, place the file in the cache by hand. The cache is
``~/.cache/paddle_tpu_torch/<basename>``.
"""
from __future__ import annotations

import hashlib
import os
import os.path as osp
import shutil
import tarfile
import zipfile

WEIGHTS_HOME = osp.expanduser("~/.cache/paddle_tpu_torch/hapi/weights")
DATA_HOME = osp.expanduser("~/.cache/paddle_tpu_torch/dataset")


def is_url(path: str) -> bool:
    return path.startswith(("http://", "https://"))


def _md5check(fullname: str, md5sum=None) -> bool:
    if md5sum is None:
        return True
    md5 = hashlib.md5()
    with open(fullname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            md5.update(chunk)
    return md5.hexdigest() == md5sum


def get_path_from_url(url: str, root_dir: str, md5sum=None,
                      check_exist: bool = True, decompress: bool = True) -> str:
    fname = osp.split(url)[-1]
    fullname = osp.join(root_dir, fname)
    if check_exist and osp.exists(fullname) and _md5check(fullname, md5sum):
        return _maybe_decompress(fullname) if decompress else fullname
    os.makedirs(root_dir, exist_ok=True)
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r, \
                open(fullname + ".part", "wb") as f:
            shutil.copyfileobj(r, f)
    except Exception as e:
        raise RuntimeError(
            f"download of {url} failed ({e}); without a network, place "
            f"the file at {fullname} by hand") from e
    os.replace(fullname + ".part", fullname)
    if not _md5check(fullname, md5sum):
        raise RuntimeError(f"md5 mismatch for {fullname}")
    return _maybe_decompress(fullname) if decompress else fullname


def _maybe_decompress(fullname: str) -> str:
    if tarfile.is_tarfile(fullname):
        dst = osp.splitext(fullname)[0]
        if not osp.exists(dst):
            with tarfile.open(fullname) as tf:
                tf.extractall(osp.dirname(fullname), filter="data")
        return dst
    if zipfile.is_zipfile(fullname):
        dst = osp.splitext(fullname)[0]
        if not osp.exists(dst):
            with zipfile.ZipFile(fullname) as zf:
                zf.extractall(osp.dirname(fullname))
        return dst
    return fullname


def get_weights_path_from_url(url: str, md5sum=None) -> str:
    """Reference: download.py:75."""
    return get_path_from_url(url, WEIGHTS_HOME, md5sum)
