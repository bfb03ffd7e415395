"""Build and bind the parameter server's native core (``csrc/ps/*.cc``).

The four C++ sources at the repo root (the sharded sparse table with its
host optimizers and the dense table, the MultiSlot parser, the TCP
service, the graph table) compile on first use into one shared library:

    g++ -O3 -std=c++17 -shared -fPIC -pthread \\
        -o paddle_tpu_torch/_build/libpaddle_ps-<hash>.so csrc/ps/*.cc

The name carries a hash of the four sources, so an edited source is never
served by a stale build; the compiler writes a per-process temporary
name that is renamed into place, so concurrent processes (launcher ranks,
test workers) never load a half-written library. Nothing is built at
import: :func:`lib` builds what is missing and loads it, with a plain C
ABI through ``ctypes``. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "SRC_DIR", "BUILD_DIR", "library_path", "build", "lib"]

_PKG = Path(__file__).resolve().parents[2]          # paddle_tpu_torch/
SRC_DIR = _PKG.parent / "csrc" / "ps"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sparse_table.cc", "datafeed.cc", "ps_service.cc",
           "graph_table.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_dll = None

_c = ctypes
_I64, _F32, _INT, _U64, _VP = (_c.c_int64, _c.c_float, _c.c_int,
                               _c.c_uint64, _c.c_void_p)
_PI64, _PF32, _PINT = (_c.POINTER(_c.c_int64), _c.POINTER(_c.c_float),
                       _c.POINTER(_c.c_int))

# name: (restype, argtypes), every entry point the Python tier calls
_SIGNATURES = {
    # sparse and dense tables (sparse_table.cc)
    "ps_sparse_create": (_VP, [_INT, _INT, _U64, _F32, _F32, _F32, _F32]),
    "ps_sparse_destroy": (None, [_VP]),
    "ps_sparse_size": (_I64, [_VP]),
    "ps_sparse_pull": (None, [_VP, _PI64, _I64, _PF32, _INT]),
    "ps_sparse_push": (None, [_VP, _PI64, _I64, _PF32, _F32]),
    "ps_sparse_row_width": (_INT, [_VP]),
    "ps_sparse_export_rows": (None, [_VP, _PI64, _I64, _PF32, _INT]),
    "ps_sparse_import_rows": (None, [_VP, _PI64, _I64, _PF32]),
    "ps_sparse_save": (_INT, [_VP, _c.c_char_p]),
    "ps_sparse_spill": (_INT, [_VP, _c.c_char_p, _I64]),
    "ps_sparse_hot_rows": (_I64, [_VP]),
    "ps_sparse_load": (_INT, [_VP, _c.c_char_p]),
    "ps_dense_create": (_VP, [_I64, _INT, _F32, _F32, _F32]),
    "ps_dense_destroy": (None, [_VP]),
    "ps_dense_size": (_I64, [_VP]),
    "ps_dense_set": (None, [_VP, _PF32]),
    "ps_dense_pull": (None, [_VP, _PF32]),
    "ps_dense_push": (None, [_VP, _PF32, _F32]),
    # the TCP service (ps_service.cc)
    "ps_server_start": (_VP, [_VP, _INT, _INT]),
    "ps_server_start2": (_VP, [_VP, _INT, _VP, _INT, _INT]),
    "ps_server_port": (_INT, [_VP]),
    "ps_server_stop": (None, [_VP]),
    "ps_client_connect": (_VP, [_c.c_char_p, _INT]),
    "ps_client_dim": (_INT, [_VP]),
    "ps_client_feat_dim": (_INT, [_VP]),
    "ps_client_pull": (_INT, [_VP, _PI64, _I64, _PF32, _INT]),
    "ps_client_push": (_INT, [_VP, _PI64, _I64, _PF32, _F32]),
    "ps_client_size": (_I64, [_VP]),
    "ps_client_close": (None, [_VP]),
    "ps_client_pull_send": (_INT, [_VP, _PI64, _I64, _INT]),
    "ps_client_pull_recv": (_INT, [_VP, _PF32, _I64]),
    "ps_client_push_send": (_INT, [_VP, _PI64, _I64, _PF32, _F32]),
    "ps_client_push_recv": (_INT, [_VP]),
    "ps_client_graph_add_edges": (_INT, [_VP, _PI64, _PI64, _PF32, _I64]),
    "ps_client_graph_sample": (_INT, [_VP, _PI64, _I64, _INT, _U64, _PI64,
                                      _PI64, _INT]),
    "ps_client_graph_feature": (_INT, [_VP, _PI64, _I64, _PF32]),
    "ps_client_graph_set_feature": (_INT, [_VP, _PI64, _I64, _PF32]),
    "ps_client_graph_num_nodes": (_I64, [_VP]),
    "ps_client_graph_sample_send": (_INT, [_VP, _PI64, _I64, _INT, _U64,
                                           _INT]),
    "ps_client_graph_sample_recv": (_INT, [_VP, _I64, _INT, _PI64, _PI64]),
    # the graph table (graph_table.cc)
    "ps_graph_create": (_VP, [_INT, _U64]),
    "ps_graph_destroy": (None, [_VP]),
    "ps_graph_add_edges": (None, [_VP, _PI64, _PI64, _PF32, _I64]),
    "ps_graph_set_feature": (None, [_VP, _PI64, _PF32, _I64]),
    "ps_graph_get_feature": (None, [_VP, _PI64, _PF32, _I64]),
    "ps_graph_degree": (_I64, [_VP, _I64]),
    "ps_graph_sample_neighbors": (None, [_VP, _PI64, _I64, _INT, _U64,
                                         _PI64, _PI64, _INT]),
    "ps_graph_num_nodes": (_I64, [_VP]),
    # the MultiSlot parser (datafeed.cc)
    "ps_datafeed_parse": (_VP, [_c.c_char_p, _INT, _PINT, _INT]),
    "ps_datafeed_destroy": (None, [_VP]),
    "ps_datafeed_num_lines": (_I64, [_VP]),
    "ps_datafeed_slot_total": (_I64, [_VP, _INT]),
    "ps_datafeed_slot_offsets": (None, [_VP, _INT, _PI64]),
    "ps_datafeed_slot_ids": (None, [_VP, _INT, _PI64]),
    "ps_datafeed_slot_vals": (None, [_VP, _INT, _PF32]),
}


def library_path() -> Path:
    """Where the build of the current sources lives."""
    digest = hashlib.sha1()
    for s in SOURCES:
        digest.update((SRC_DIR / s).read_bytes())
    return BUILD_DIR / f"libpaddle_ps-{digest.hexdigest()[:12]}.so"


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the parameter server's native "
                           "core is built with g++ on first use")
    return cxx


def build() -> Path:
    """Compile the four sources into :func:`library_path` (a no-op when it
    exists). Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native PS build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded native library, built first if missing."""
    global _dll
    with _lock:
        if _dll is None:
            dll = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.restype = res
                fn.argtypes = args
            _dll = dll
        return _dll
