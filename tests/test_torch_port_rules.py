"""The PyTorch port's own rules: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor any module of the JAX package ``paddle_tpu``; the
port's entry points put their state on the card and raise without one
unless the caller asks for the CPU; ``chip_smoke.py`` fails, printing no
result, where there is no card or no package beside it.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "paddle_tpu")


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p, _ in _modules()] + [SMOKE]
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
    # the prefix rule: the port's own name is not the JAX package's
    assert not _forbidden("paddle_tpu_torch.ops")
    assert _forbidden("paddle_tpu.ops") and _forbidden("jax.numpy")


def test_every_module_imports_with_jax_blocked():
    mods = [m for _, m in _modules()]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from paddle_tpu_torch.distributed.ps import native\n"
            "assert native._dll is None, 'the PS library loaded at import'\n"
            "print('imported', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 15


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_default_to_the_card_and_raise_without_one():
    _no_card()
    from paddle_tpu_torch.inference import decode_model as dm
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(4, 8, 2, 32)
    params = dm.init_decode_model()
    with pytest.raises(RuntimeError):
        dm.params_from_jax(params)
    with pytest.raises(RuntimeError):
        dm.dense_generate(params, [1, 2], 1)
    cache = PagedKVCache(4, 8, 2, 32, device="cpu")
    with pytest.raises(RuntimeError):
        dm.make_step_fn(params, cache)
    assert cache.k.device.type == "cpu"
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelTrainer(Linear(4, 4), AdamW(1e-3), lambda out, _: out.sum())
    trainer = ParallelTrainer(Linear(4, 4), AdamW(1e-3),
                              lambda out, _: out.sum(), device="cpu")
    assert trainer.get_param("weight").device.type == "cpu"


def test_the_predictor_defaults_to_the_card_and_raises_without_one(
        tmp_path):
    _no_card()
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.nn import Linear
    prefix = str(tmp_path / "m")
    jit.save(Linear(4, 2), prefix, input_spec=[jit.InputSpec([None, 4])])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.create_predictor(inference.Config(prefix))
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    try:
        pred = inference.create_predictor(cfg)
        assert pred._layer.device.type == "cpu"
    finally:
        inference.clear_layer_cache()


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(SMOKE.read_text())
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
