"""Write ``paddle_tpu_torch/testdata/optimizer_golden.json``: each of the JAX
package's eleven optimizer classes takes three ``apply_gradients`` steps on
seeded numpy tensors, and the file keeps the parameters after them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_optimizer_golden.py

Two parameters, ``"w"`` (64 x 48) and ``"b_norm"`` (48,), so that Lamb's
and Lars's exclusions by name take ``b_norm`` out of their decay; ``"w"``
steps at half the learning rate (``lr_scales``). The parameters come from
``RandomState(PARAM_SEED)``, the gradients of step ``i`` from
``RandomState(GRAD_SEED + i)``, each key in ``SHAPES`` order. A case's
``exclude`` names the substring Lamb's ``exclude_from_weight_decay_fn`` and
Lars's ``exclude_from_weight_decay`` match on.

``chip_smoke.py`` (``eager``) runs the port's eager ``step()`` on the card
against this file; ``tests/test_torch_optimizer.py`` checks the committed
file against a fresh run of :func:`golden`.
"""
import base64
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, os.pardir, "paddle_tpu_torch", "testdata",
                   "optimizer_golden.json")

SHAPES = {"w": (64, 48), "b_norm": (48,)}
PARAM_SEED, GRAD_SEED, STEPS = 0, 100, 3
LR_SCALES = {"w": 0.5}
CASES = [
    ("SGD", dict(learning_rate=0.05, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.05, momentum=0.9, use_nesterov=True)),
    ("DGCMomentum", dict(learning_rate=0.05, momentum=0.9,
                         rampup_begin_step=1, rampup_step=4,
                         sparsity=[0.5, 0.9])),
    ("Adagrad", dict(learning_rate=0.05, initial_accumulator_value=0.1)),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    ("Adam", dict(learning_rate=0.01)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
    ("Adamax", dict(learning_rate=0.01)),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.5, centered=True)),
    ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.1,
                  exclude="norm")),
    ("Lars", dict(learning_rate=0.1, lars_weight_decay=0.01,
                  exclude="norm")),
]


def arrays(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def make(module, name, kwargs):
    """The optimizer ``name`` of ``module`` (the reference's or the
    port's) from a case's keyword arguments."""
    kw = dict(kwargs)
    sub = kw.pop("exclude", None)
    if name == "Lamb" and sub:
        kw["exclude_from_weight_decay_fn"] = lambda key: sub in str(key)
    if name == "Lars" and sub:
        kw["exclude_from_weight_decay"] = [sub]
    if "sparsity" in kw:
        kw["sparsity"] = tuple(kw["sparsity"])
    return getattr(module, name)(**kw)


def encode(a) -> str:
    return base64.b64encode(np.ascontiguousarray(
        a, dtype="<f4").tobytes()).decode()


def decode(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<f4").reshape(shape)


def golden() -> dict:
    import jax.numpy as jnp
    from paddle_tpu import optimizer as ref_opt
    cases = []
    for name, kwargs in CASES:
        opt = make(ref_opt, name, kwargs)
        params = {k: jnp.asarray(v) for k, v in arrays(PARAM_SEED).items()}
        state = opt.init_state(params)
        for i in range(STEPS):
            grads = {k: jnp.asarray(v)
                     for k, v in arrays(GRAD_SEED + i).items()}
            params, state = opt.apply_gradients(params, grads, state,
                                                lr_scales=LR_SCALES)
        cases.append({"name": name, "kwargs": kwargs,
                      "params": {k: encode(np.asarray(params[k]))
                                 for k in SHAPES}})
    return {"recipe": {"shapes": {k: list(s) for k, s in SHAPES.items()},
                       "param_seed": PARAM_SEED, "grad_seed": GRAD_SEED,
                       "steps": STEPS, "lr_scales": LR_SCALES,
                       "encoding": "base64 of little-endian float32"},
            "cases": cases}


def main():
    sys.path.insert(0, os.path.join(HERE, os.pardir))
    data = golden()
    with open(OUT, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.normpath(OUT)}: {len(data['cases'])} optimizers")


if __name__ == "__main__":
    main()
