"""How fast the host can feed chip_smoke.py's ``hapi`` (a2) step: the
per-image work of ``chip_smoke.HapiImages`` (a seeded 256 x 256 x 3 uint8
image drawn and put through ``RandomResizedCrop(224)``,
``RandomHorizontalFlip``, ``Normalize`` and ``Transpose``) in 1 to 8
forked processes at once, each on one BLAS thread, and
``io.DataLoader``'s delivery of 128-image batches at ``num_workers`` 0
and W (7 by default). No card is used; run it on the card's host to read
that host.

    python3 tests/torch_loader_bench.py [--workers 7] [--batches 64]
        [--against OTHER/io/dataloader.py]

``--against`` times another version of ``io/dataloader.py`` (loaded as a
module of this package, so its relative imports resolve here) at W
workers in turns with this one: this, other, this, other.

Prints one JSON object per line: the host (``os.cpu_count()``, the
usable cores, ``/dev/shm``'s size and free bytes), then ``{"procs": n,
"images_per_s": ...}`` for each n, then one line per loader run: its
images/s over all ``--batches`` batches, the first batch's seconds, and
the steady images/s over the batches after the first 2 W (the workers'
first two rounds, which start together).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import multiprocessing as mp
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_PROC = 100        # images each process transforms
BATCH = 128

_DS = None


def _transform(k: int) -> float:
    from paddle_tpu_torch.io import dataloader
    dataloader._set_openblas_threads(1)
    t0 = time.perf_counter()
    for i in range(k * PER_PROC, (k + 1) * PER_PROC):
        _DS[i]
    return time.perf_counter() - t0


def _load_other(path):
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch.io._other_dataloader", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # its workers pickle its classes
    spec.loader.exec_module(mod)
    return mod


def loader_run(loader_cls, ds, workers, batches, name):
    """One pass of ``batches`` batches -> its line."""
    t0 = time.perf_counter()
    arrived = []
    for x, _ in loader_cls(ds, batch_size=BATCH, num_workers=workers):
        arrived.append(time.perf_counter())
    check = len(arrived) == batches and x.shape[0] == BATCH
    k0 = min(2 * workers, batches - 2) if workers else 1
    return {"loader": name, "num_workers": workers, "batch": BATCH,
            "batches": len(arrived), "complete": check,
            "images_per_s": len(arrived) * BATCH / (arrived[-1] - t0),
            "first_batch_s": arrived[0] - t0, "steady_from_batch": k0,
            "images_per_s_steady": (len(arrived) - 1 - k0) * BATCH / (
                arrived[-1] - arrived[k0])}


def main():
    global _DS
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=7)
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from paddle_tpu_torch import io
    from paddle_tpu_torch.vision import transforms
    shm = shutil.disk_usage("/dev/shm") if os.path.isdir("/dev/shm") \
        else None
    print(json.dumps({"cpu_count": os.cpu_count(),
                      "usable_cores": len(os.sched_getaffinity(0)),
                      "dev_shm_bytes": shm and shm.total,
                      "dev_shm_free_bytes": shm and shm.free}), flush=True)
    _DS = chip_smoke.HapiImages(transforms, n=8 * PER_PROC)
    for n in (1, 2, 4, 7, 8):
        t0 = time.perf_counter()
        with mp.get_context("fork").Pool(n) as pool:
            secs = pool.map(_transform, range(n))
        print(json.dumps({"procs": n, "images_per_s": n * PER_PROC / (
            time.perf_counter() - t0), "seconds_each": secs}), flush=True)
    ds = chip_smoke.HapiImages(transforms, n=args.batches * BATCH)
    print(json.dumps(loader_run(io.DataLoader, chip_smoke.HapiImages(
        transforms, n=8 * BATCH), 0, 8, "this")), flush=True)
    runs = [("this", io.DataLoader)]
    if args.against:
        runs.append(("other", _load_other(args.against).DataLoader))
    for name, cls in runs * 2:
        print(json.dumps(loader_run(cls, ds, args.workers, args.batches,
                                    name)), flush=True)


if __name__ == "__main__":
    main()
