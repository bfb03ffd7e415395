"""The port's content digests (``paddle_tpu_torch/resilience/integrity.py``)
against the JAX package's ``array_digest`` on the same values, on the CPU:
float32, bfloat16, integer and bool arrays, 0-d and strided ones, given to
the port as tensors and as numpy arrays; the tree's dotted keys and
``compare_digests``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.resilience import integrity as ref

from paddle_tpu_torch.resilience import integrity


def _cases():
    rs = np.random.RandomState(0)
    return {
        "float32": rs.randn(16, 8).astype(np.float32),
        "bfloat16": rs.randn(5, 3).astype(np.float32).astype(
            ml_dtypes.bfloat16),
        "int32": rs.randint(-9, 9, (7,)).astype(np.int32),
        "int64": np.arange(12, dtype=np.int64).reshape(3, 4),
        "bool": rs.rand(6) > 0.5,
        "0-d float32": np.array(3.25, np.float32),
        "0-d int64": np.int64(7),
        "empty": np.zeros((0, 4), np.float32),
    }


def _tensor(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(_cases()))
def test_digest_equals_the_reference(name):
    a = _cases()[name]
    want = ref.array_digest(a)
    if np.asarray(a).dtype != np.int64:   # jax keeps int64 as int32
        assert ref.array_digest(jnp.asarray(a)) == want
    assert integrity.array_digest(_tensor(a)) == want
    assert integrity.array_digest(a) == want


def test_strided_tensor_hashes_its_row_major_values():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    t = torch.from_numpy(a.copy()).t()           # a transposed view
    assert integrity.array_digest(t) == ref.array_digest(jnp.asarray(a.T))


def test_tree_digests_dotted_keys_and_compare():
    tree = {"params": {"w": torch.arange(6.0), "b": {"c": torch.ones(3)}},
            "step": torch.tensor(3, dtype=torch.int32)}
    d1 = integrity.tree_digests(tree)
    assert set(d1) == {"params.w", "params.b.c", "step"}
    assert d1["params.w"] == ref.array_digest(jnp.arange(6.0,
                                                         dtype=jnp.float32))
    tree["params"]["w"] = tree["params"]["w"] + 1
    d2 = integrity.tree_digests(tree)
    assert integrity.compare_digests(d1, d2) == ["params.w"]
    assert integrity.compare_digests(d1, d1) == []
    assert integrity.compare_digests({"x": "a"}, {}) == []
