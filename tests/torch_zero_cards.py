"""ZeRO over a world of four cards: NCCL, one process a card.

    python3 tests/torch_zero_cards.py          # a host with four cards
    python3 tests/torch_zero_cards.py --cpu    # rehearsal: four gloo ranks
                                               # on the CPU, a narrow GPT

Each rank trains bench.py's ``fused_b8_pallas_ce`` model (full GPT-base,
bf16, dropout 0, AdamW 3e-4, the fused CE kernels; on the CPU a 2-layer,
width-64 GPT through the kernels' plain versions) on a global batch of 32
x 1024 (8 rows a rank), 2 warm-up and 3 timed steps, in five runs:

- ``dp4-s0``: ``{"data": 4}``, stage 0 (the yardstick);
- ``dxs-s1``, ``dxs-s2``, ``dxs-s3``: ``{"data": 2, "sharding": 2}`` at
  stages 1, 2 and 3; ``dxs-s3`` saves step 3 through
  ``CheckpointManager`` into one shared directory (the world's format);
- ``s4-s3``: ``{"sharding": 4}`` at stage 3.

Then a fresh ``dxs-s3`` trainer restores step 3 and takes steps 4-5, and
another restores it and goes through ``reshard_trainer`` onto ``{"sharding":
4}``. Checks (any failure exits non-zero): stage 1's parameters equal stage
0's bit for bit (both exchange through one all_reduce of the same four
ranks, and the update is elementwise); every run's losses finite, falling
and within ``LOSS_RTOL`` of stage 0's; the resumed steps equal ``dxs-s3``'s
bit for bit; after the reshard every parameter and slot equals its chunk
of step 3's logical arrays; the bytes each rank stores (parameters,
slots) equal ``sharding.zero_bytes_per_rank``'s count. Reports per run the
step ms and each rank's peak allocated memory. Prints one JSON object per
line; the last is ``{"ok": true, ...}``. Imports torch, numpy and
``paddle_tpu_torch`` only.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

RUNS = (("dp4-s0", {"data": 4}, 0),
        ("dxs-s1", {"data": 2, "sharding": 2}, 1),
        ("dxs-s2", {"data": 2, "sharding": 2}, 2),
        ("dxs-s3", {"data": 2, "sharding": 2}, 3),
        ("s4-s3", {"sharding": 4}, 3))
# bf16 training through reductions in other orders (a reduce-scatter and a
# mean over data against one all_reduce): the gradients differ at bf16
# precision, and 5 steps carry it; chip_smoke.py's bar for remat and
# gradient merge against the plain step
LOSS_RTOL = 1e-2
GLOBAL_BATCH, SEQ = 32, 1024


def _model(cpu):
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.text.models import GPTForPretraining
    framework.seed(0)
    cfg = (dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                max_position_embeddings=128) if cpu else
           dict(vocab_size=50304, hidden_size=768, num_layers=12,
                num_heads=12, max_position_embeddings=SEQ))
    return GPTForPretraining(tensor_parallel=False, attn_dropout=0.0,
                             hidden_dropout=0.0, **cfg).bfloat16()


class _Loss(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch):
        ids, lbl = batch
        return self.inner.fused_head_loss(ids, lbl, chunk=8192,
                                          ce_kernel="pallas")


def _batch(cpu, device):
    rs = np.random.RandomState(0)
    vocab, seq = (512, 128) if cpu else (50304, SEQ)
    ids, lbl = (torch.from_numpy(rs.randint(0, vocab, (GLOBAL_BATCH, seq))
                                 .astype(np.int32)).to(device)
                for _ in range(2))
    return (ids, lbl), 0.0


def _sync(cpu):
    if not cpu:
        torch.cuda.synchronize()


def rank_main(cpu, root, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import env, sharding
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         load_checkpoint)
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.resilience.elastic import reshard_trainer
    env.init_parallel_env(device="cpu" if cpu else None)
    rank = env.get_rank()
    device = torch.device("cpu") if cpu else torch.device("cuda",
                                                          env.get_local_rank())
    batch = _batch(cpu, device)
    meshes = {}

    def mesh_of(degrees):
        key = tuple(sorted(degrees.items()))
        if key not in meshes:
            meshes[key] = build_mesh(degrees)
        return meshes[key]

    def trainer(degrees, stage):
        return ParallelTrainer(_Loss(_model(cpu)), optimizer.AdamW(3e-4),
                               lambda out, _l: out, mesh=mesh_of(degrees),
                               zero_stage=stage, device=device)

    def stored(tr):
        st = tr.state
        nb = lambda tree: sum(  # noqa: E731
            v.numel() * v.element_size() for v in _leaves(tree))
        return {"params": nb(st["params"]), "slots": nb(st["opt"]["slots"])}

    out = {"rank": rank, "runs": {}}
    ck_root = os.path.join(root, "ckpt")
    for name, degrees, stage in RUNS:
        if not cpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        tr = trainer(degrees, stage)
        losses, ms = [], []
        for i in range(1, 6):
            _sync(cpu)
            t0 = time.perf_counter()
            losses.append(tr.train_step(*batch).item())
            ms.append((time.perf_counter() - t0) * 1e3)
            if name == "dxs-s3" and i == 3:
                mgr = CheckpointManager(ck_root)
                t0 = time.perf_counter()
                assert mgr.save(3, {"trainer": tr.state})
                out["save_seconds"] = time.perf_counter() - t0
        with torch.device("meta"):
            shapes = _Loss(_model(cpu))
        run = {"losses": losses, "ms": ms[2:], "stored": stored(tr),
               "computed": sharding.zero_bytes_per_rank(
                   shapes, tr._opt, stage, tr.n_shard),
               "peak_gb": (0.0 if cpu else
                           torch.cuda.max_memory_allocated(device) / 2 ** 30)}
        tr.sync_to_model()
        if rank == 0:
            run["params"] = {n: p.detach().float().cpu().numpy()
                             for n, p in tr.params.items()}
        out["runs"][name] = run
        del tr
    # resume on the same layout, bit for bit
    tr = trainer({"data": 2, "sharding": 2}, 3)
    mgr = CheckpointManager(ck_root)
    t0 = time.perf_counter()
    tr.state = mgr.restore(template={"trainer": tr.state})["trainer"]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out["restore_seconds"] = time.perf_counter() - t0
    out["resumed"] = [tr.train_step(*batch).item() for _ in range(2)]
    del tr
    # reshard onto {"sharding": 4}: every rank's pieces against step 3
    tr = trainer({"data": 2, "sharding": 2}, 3)
    tr.state = mgr.restore(template={"trainer": tr.state})["trainer"]
    t0 = time.perf_counter()
    reshard_trainer(tr, mesh_of({"sharding": 4}),
                    os.path.join(root, "reshard"))
    out["reshard_seconds"] = time.perf_counter() - t0
    logical = load_checkpoint(os.path.join(ck_root, "3"))["trainer"]
    st = tr.state
    bad = []
    for part in ("params", "opt"):
        for path, v in _flat(st[part], part).items():
            want = logical[path]
            pc = st.layout.get(path)
            if pc is not None:
                want = torch.chunk(want, pc.count, dim=pc.dim)[pc.index]
            if not torch.equal(v.detach().cpu(), want):
                bad.append(path)
    out["reshard_mismatch"] = bad
    out["reshard_losses"] = [tr.train_step(*batch).item()
                             for _ in range(2)]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _flat(tree, prefix):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
    else:
        out[prefix] = tree
    return out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    cpu = "--cpu" in sys.argv
    sys.path.insert(0, ROOT)
    if not cpu:
        if torch.cuda.device_count() < 4:
            raise SystemExit("torch_zero_cards: needs four cards "
                             f"(found {torch.cuda.device_count()})")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(json.dumps({"cards": smi}), flush=True)
        from paddle_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build(["flash_attention", "fused_ce"])   # once, for all ranks
        print(json.dumps({"build_seconds": time.perf_counter() - t0}),
              flush=True)
    from paddle_tpu_torch.distributed.spawn import spawn
    with tempfile.TemporaryDirectory(prefix="zero_cards_") as root:
        spawn(rank_main, args=(cpu, root, root), nprocs=4, timeout=1500)
        ranks = []
        for r in range(4):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    r0 = ranks[0]["runs"]
    base = r0["dp4-s0"]
    for name, _, stage in RUNS:
        run = r0[name]
        for out in ranks:
            got, want = out["runs"][name]["stored"], run["computed"]
            check(got == {k: want[k] for k in got},
                  f"{name}: rank {out['rank']} stores {got}, counted {want}")
        check(all(np.isfinite(run["losses"])) and
              run["losses"][-1] < run["losses"][0], f"{name}: {run['losses']}")
        check(np.allclose(run["losses"], base["losses"], rtol=LOSS_RTOL),
              f"{name} losses {run['losses']} vs {base['losses']}")
        for out in ranks[1:]:
            check(out["runs"][name]["losses"] == run["losses"],
                  f"{name}: ranks disagree on the loss")
        print(json.dumps({"run": name, "stage": stage,
                          "losses": run["losses"], "ms": run["ms"],
                          "peak_gb_by_rank": [o["runs"][name]["peak_gb"]
                                              for o in ranks],
                          "stored_by_rank": [o["runs"][name]["stored"]
                                             for o in ranks],
                          "computed": run["computed"]}), flush=True)
    same = all(np.array_equal(r0["dxs-s1"]["params"][k], v)
               for k, v in base["params"].items())
    check(same, "stage 1 parameters differ from stage 0's")
    for out in ranks:
        check(out["resumed"] == out["runs"]["dxs-s3"]["losses"][3:],
              f"resumed {out['resumed']} vs "
              f"{out['runs']['dxs-s3']['losses'][3:]}")
        check(out["reshard_mismatch"] == [],
              f"rank {out['rank']}: {out['reshard_mismatch'][:4]}")
    print(json.dumps({"stage1_params_bit_equal_stage0": True,
                      "resumed": ranks[0]["resumed"],
                      "save_seconds": [o["save_seconds"] for o in ranks],
                      "restore_seconds": [o["restore_seconds"]
                                          for o in ranks],
                      "reshard_seconds": [o["reshard_seconds"]
                                          for o in ranks],
                      "reshard_losses": ranks[0]["reshard_losses"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": "cpu" if cpu else
                      torch.cuda.get_device_name(0),
                      "count": 4}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
