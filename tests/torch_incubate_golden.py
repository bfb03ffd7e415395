"""Write ``paddle_tpu_torch/testdata/incubate_golden.json``: the JAX
package's ``LookAhead`` and ``ModelAverage``, each beside AdamW, training a
narrow GPT through ``ParallelTrainer`` on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_incubate_golden.py

The model is ``GPTForPretraining`` at :data:`CONFIG` in float32, dropout
0, its weights from ``recipes.bert_weights(names_shapes, SEED, STD)`` in
``state_dict`` order, one fixed batch of ids and labels
``randint(0, vocab, (BATCH, SEQ))`` from ``RandomState(DATA_SEED)``, the
loss ``cross_entropy`` of the dense logits. Two runs of :data:`STEPS`
``train_step`` calls each:

- ``lookahead``: ``LookAhead(AdamW(LR, weight_decay=WD), alpha, k)``; per
  step the loss ``train_step`` returns and the global L2 norm of the
  step's parameter update;
- ``model_average``: ``AdamW(LR, weight_decay=WD)``, and after each step
  ``ModelAverage(rate, min_average_window, max_average_window)
  .apply_gradients`` on the trainer's parameters; per step the loss, the
  global L2 norm of the window average and of the average minus the live
  parameters.

``chip_smoke.py`` (``incubate``, i2) holds the port's run on the card
against this file, ``tests/test_torch_incubate.py`` the port's run on the
CPU, each at the bars it states.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, os.pardir, "paddle_tpu_torch", "testdata",
                   "incubate_golden.json")

CONFIG = {"vocab_size": 256, "hidden_size": 64, "num_layers": 2,
          "num_heads": 4, "max_position_embeddings": 32,
          "attn_dropout": 0.0, "hidden_dropout": 0.0}
BATCH, SEQ = 4, 32
SEED, STD, DATA_SEED = 0, 0.02, 1
LR, WD = 1e-3, 0.01
STEPS = 5
LOOKAHEAD = {"alpha": 0.5, "k": 3}
MODEL_AVERAGE = {"average_window_rate": 0.5, "min_average_window": 2,
                 "max_average_window": 4}


def batch():
    rs = np.random.RandomState(DATA_SEED)
    ids = rs.randint(0, CONFIG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    lbl = rs.randint(0, CONFIG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    return ids, lbl


def norm(tree) -> float:
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(v, np.float64)))
                             for v in tree.values())))


def golden() -> dict:
    import jax.numpy as jnp

    from paddle_tpu import nn, optimizer
    from paddle_tpu.distributed.engine import ParallelTrainer
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.incubate import LookAhead, ModelAverage
    from paddle_tpu.text.models import GPTForPretraining
    from paddle_tpu_torch.testdata import recipes

    build_mesh({"data": 1})
    ids, lbl = batch()

    def trainer(opt):
        model = GPTForPretraining(tensor_parallel=False, **CONFIG)
        names_shapes = [(n, tuple(int(s) for s in v.shape))
                        for n, v in model.state_dict().items()]
        w = recipes.bert_weights(names_shapes, SEED, STD)
        model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
        return ParallelTrainer(
            model, opt, lambda logits, y: nn.functional.cross_entropy(
                logits, y))

    def params(tr):
        return {k: np.asarray(v, np.float32)
                for k, v in tr.state["params"].items()}

    out = {}
    tr = trainer(LookAhead(optimizer.AdamW(LR, weight_decay=WD),
                           **LOOKAHEAD))
    losses, updates = [], []
    for _ in range(STEPS):
        before = params(tr)
        losses.append(float(tr.train_step(ids, lbl)))
        after = params(tr)
        updates.append(norm({k: after[k] - before[k] for k in after}))
    out["lookahead"] = {"losses": losses, "update_norms": updates}

    tr = trainer(optimizer.AdamW(LR, weight_decay=WD))
    ma = ModelAverage(**MODEL_AVERAGE)
    state = None
    losses, avg_norms, diff_norms = [], [], []
    for _ in range(STEPS):
        losses.append(float(tr.train_step(ids, lbl)))
        live = {k: jnp.asarray(v) for k, v in params(tr).items()}
        if state is None:
            state = ma.init_state(live)
        _, state = ma.apply_gradients(live, None, state)
        avg = {k: np.asarray(v) for k, v in ma._average(state).items()}
        avg_norms.append(norm(avg))
        diff_norms.append(norm({k: avg[k] - np.asarray(live[k])
                                for k in avg}))
    out["model_average"] = {"losses": losses, "avg_norms": avg_norms,
                            "avg_diff_norms": diff_norms}
    return {"recipe": {"config": CONFIG, "batch": BATCH, "seq": SEQ,
                       "seed": SEED, "std": STD, "data_seed": DATA_SEED,
                       "lr": LR, "weight_decay": WD, "steps": STEPS,
                       "lookahead": LOOKAHEAD,
                       "model_average": MODEL_AVERAGE,
                       "weights": "recipes.bert_weights"},
            **out}


def main():
    sys.path.insert(0, os.path.join(HERE, os.pardir))
    data = golden()
    with open(OUT, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
