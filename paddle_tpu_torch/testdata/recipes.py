"""The numpy recipes that rebuild the golden files' weights and inputs.

One definition for every caller: the golden writers
(``tests/torch_resnet_golden.py``, ``tests/torch_moe_golden.py``,
``tests/torch_bert_golden.py``, ``tests/torch_mt_golden.py``, which
run the JAX package on the CPU), the tests, and ``chip_smoke.py`` on the
card. Each golden file records the arguments (seeds, scales) it was made
with. Imports numpy only: :func:`ptb_lm` and :func:`seq2seq`, the two
small models the MT golden file and the dy2static model tier train, are
built from the package handed in (``paddle_tpu`` or
``paddle_tpu_torch``), so both packages build the same tree.
"""
from __future__ import annotations

import numpy as np

__all__ = ["resnet_weights", "resnet_data", "moe_weights", "moe_tokens",
           "bert_weights", "bert_data", "mt_data", "ptb_weights", "ptb_data",
           "ptb_lm", "seq2seq"]


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


def mt_data(seed, batch, seq, vocab, min_len, pad=0, bos=0, first=2):
    """A translation batch from ``RandomState(seed)``: per row a source
    and a target length ``randint(min_len, seq + 1)``, tokens
    ``randint(first, vocab)`` (ids below ``first`` are BOS/pad and EOS),
    ``pad`` past each length -> (src, trg_in, label), each (batch, seq)
    int32; ``trg_in`` is ``bos`` then the label shifted right."""
    rs = np.random.RandomState(seed)
    src = rs.randint(first, vocab, (batch, seq)).astype(np.int32)
    lbl = rs.randint(first, vocab, (batch, seq)).astype(np.int32)
    src_len = rs.randint(min_len, seq + 1, batch)
    trg_len = rs.randint(min_len, seq + 1, batch)
    pos = np.arange(seq)[None, :]
    src[pos >= src_len[:, None]] = pad
    lbl[pos >= trg_len[:, None]] = pad
    trg_in = np.concatenate([np.full((batch, 1), bos, np.int32),
                             lbl[:, :-1]], axis=1)
    trg_in[pos >= trg_len[:, None]] = pad
    return src, trg_in, lbl


def ptb_weights(names_shapes, seed, scale) -> dict:
    """{name: float32 array}: every parameter ``uniform(-scale, scale)``
    from one ``RandomState(seed)`` in the given order (Zaremba et al.'s
    initialization)."""
    rs = np.random.RandomState(seed)
    return {name: rs.uniform(-scale, scale, tuple(shape)).astype(np.float32)
            for name, shape in names_shapes}


def ptb_data(seed, batch, steps, vocab):
    """A language-model batch from ``RandomState(seed)``: ``batch`` rows
    of ``steps + 1`` ids ``randint(0, vocab)`` -> (ids, next ids), each
    (batch, steps) int32."""
    rs = np.random.RandomState(seed)
    seq = rs.randint(0, vocab, (batch, steps + 1)).astype(np.int32)
    return seq[:, :-1].copy(), seq[:, 1:].copy()


def ptb_lm(pd, vocab, hidden, layers, dropout=0.0):
    """The word-level LSTM language model of Zaremba et al.: an embedding,
    a ``layers``-deep ``nn.LSTM`` of ``hidden`` units (``dropout``
    between layers) and a linear head, from package ``pd``."""
    nn = pd.nn

    class PtbLm(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, hidden)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, ids):
            h, _ = self.lstm(self.emb(ids))
            return self.head(h)

    return PtbLm()


def seq2seq(pd, vocab, hidden):
    """The LSTM encoder-decoder of the dy2static tier's seq2seq case
    (teacher forcing, the decoder an ``LSTMCell`` unrolled by a Python
    loop), from package ``pd``."""
    nn = pd.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(vocab, hidden)
            self.trg_emb = nn.Embedding(vocab, hidden)
            self.enc = nn.LSTM(hidden, hidden)
            self.dec_cell = nn.LSTMCell(hidden, hidden)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, src, trg):
            enc_out, (h, c) = self.enc(self.src_emb(src))
            h, c = h[0], c[0]
            logits = []
            for t in range(trg.shape[1]):     # teacher-forced decode loop
                step_in = self.trg_emb(trg[:, t])
                _, (h, c) = self.dec_cell(step_in, (h, c))
                logits.append(self.head(h))
            return pd.stack(logits, axis=1)

    return Seq2Seq()
