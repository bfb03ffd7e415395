"""The numpy recipes that rebuild the golden files' weights and inputs.

One definition for every caller: the golden writers
(``tests/torch_resnet_golden.py``, ``tests/torch_moe_golden.py``,
``tests/torch_bert_golden.py``, which
run the JAX package on the CPU), the tests, and ``chip_smoke.py`` on the
card. Each golden file records the arguments (seeds, scales) it was made
with. Imports numpy only.
"""
from __future__ import annotations

import numpy as np

__all__ = ["resnet_weights", "resnet_data", "moe_weights", "moe_tokens",
           "bert_weights", "bert_data"]


def resnet_weights(names_shapes, seed, conv_std, linear_std) -> dict:
    """{name: float32 array} in the given (``state_dict``) order from one
    ``RandomState(seed)``: running means and ``.bias`` zeros, running
    variances and other 1-d parameters ones, convolution weights
    normal(0, conv_std), the linear ``(in, out)`` weight normal(0,
    linear_std)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        shape = tuple(shape)
        if name.endswith("._mean") or name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith("._variance") or len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            std = linear_std if len(shape) == 2 else conv_std
            out[name] = rs.normal(0.0, std, shape).astype(np.float32)
    return out


def resnet_data(seed, batch, size, classes=1000):
    """Images ``randn(batch, 3, size, size)`` float32, then labels
    ``randint(0, classes, (batch,))`` int32, from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    images = rs.randn(batch, 3, size, size).astype(np.float32)
    labels = rs.randint(0, classes, (batch,)).astype(np.int32)
    return images, labels


def moe_weights(names_shapes, seed) -> dict:
    """{name: float32 array} in the given order from one
    ``RandomState(seed)``: ``gate.weight`` normal with std
    ``1/sqrt(shape[0])``, the biases ``b1``, ``b2`` std 0.1, ``w1``,
    ``w2`` std ``1/sqrt(shape[1])`` (the fan-in)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        shape = tuple(shape)
        if name == "gate.weight":
            std = 1.0 / np.sqrt(shape[0])
        elif name in ("b1", "b2"):
            std = 0.1
        else:
            std = 1.0 / np.sqrt(shape[1])
        out[name] = (std * rs.randn(*shape)).astype(np.float32)
    return out


def moe_tokens(seed, shape):
    """``randn(*shape)`` float32 from ``RandomState(seed)``."""
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def bert_weights(names_shapes, seed, std) -> dict:
    """{name: float32 array} in the given (``state_dict``) order from one
    ``RandomState(seed)``: ``.bias`` (and ``decoder_bias``) zeros, other
    1-d parameters (the LayerNorms' weights) ones, every 2-d weight
    normal(0, std)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        shape = tuple(shape)
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
        elif len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = rs.normal(0.0, std, shape).astype(np.float32)
    return out


def bert_data(seed, batch, seq, vocab):
    """bench.py's pretraining batch from ``RandomState(seed)``: ids
    ``randint(0, vocab, (batch, seq))`` int32; MLM labels -100 except every
    8th position, ``randint(0, vocab, (batch, seq // 8))``; NSP labels
    ``randint(0, 2, (batch,))`` int32."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    mlm = np.full((batch, seq), -100, dtype=np.int32)
    mlm[:, ::8] = rs.randint(0, vocab, (batch, seq // 8))
    nsp = rs.randint(0, 2, (batch,)).astype(np.int32)
    return ids, mlm, nsp
