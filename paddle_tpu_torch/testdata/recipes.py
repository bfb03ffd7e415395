"""The numpy recipes that rebuild the golden files' weights and inputs.

One definition for every caller: the golden writers
(``tests/torch_resnet_golden.py``, ``tests/torch_moe_golden.py``,
``tests/torch_bert_golden.py``, ``tests/torch_mt_golden.py``,
``tests/torch_vision_zoo_golden.py``, which run the JAX package on the
CPU), the tests, and ``chip_smoke.py`` on the
card. Each golden file records the arguments (seeds, scales) it was made
with. Imports numpy only: :func:`ptb_lm` and :func:`seq2seq`, the two
small models the MT golden file and the dy2static model tier train, are
built from the package handed in (``paddle_tpu`` or
``paddle_tpu_torch``), so both packages build the same tree.
"""
from __future__ import annotations

import numpy as np

__all__ = ["resnet_weights", "resnet_data", "zoo_weights", "zoo_data",
           "no_dropout", "detection_inputs", "moe_weights", "moe_tokens",
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


def zoo_weights(names_shapes, seed, conv_gain=2.0, linear_gain=1.0) -> dict:
    """{name: float32 array} in the given (``state_dict``) order from one
    ``np.random.default_rng(seed)`` for the LeNet, MobileNet and VGG
    families: running means and ``.bias`` zeros, running variances and
    other 1-d parameters ones, a convolution weight ``(O, I/g, kh, kw)``
    ``standard_normal`` (float32) times ``sqrt(conv_gain / (I/g * kh *
    kw))`` (He's std for ReLU at 2), a linear weight ``(in, out)`` times
    ``sqrt(linear_gain / in)``. (The float32 draws keep VGG's 138M
    weights to a fraction of a second.)"""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in names_shapes:
        shape = tuple(shape)
        if name.endswith("._mean") or name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith("._variance") or len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            gain = conv_gain if len(shape) == 4 else linear_gain
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= np.float32(np.sqrt(gain / fan_in))
            out[name] = w
    return out


def zoo_data(seed, batch, channels, size, classes):
    """Images ``randn(batch, channels, size, size)`` float32, then labels
    ``randint(0, classes, (batch,))`` int32, from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    images = rs.randn(batch, channels, size, size).astype(np.float32)
    labels = rs.randint(0, classes, (batch,)).astype(np.int32)
    return images, labels


def no_dropout(model):
    """Set every ``Dropout`` of ``model`` (either package) to p 0; returns
    how many there were."""
    n = 0
    layers = (model.sublayers(include_self=True)
              if hasattr(model, "sublayers") else model.modules())
    for layer in layers:
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0
            n += 1
    return n


#: YOLOv3's anchors (w, h at 416x416), three a scale; the 13x13 head
#: takes the last three (mask 6, 7, 8)
YOLOV3_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                  156, 198, 373, 326]


def _boxes_xyxy(rs, n, height, width, lo, hi):
    """n boxes (x1, y1, x2, y2) inside a height x width image, sides
    uniform in [lo, hi) pixels."""
    wh = rs.uniform(lo, hi, (n, 2))
    x1 = rs.uniform(0, width - wh[:, 0])
    y1 = rs.uniform(0, height - wh[:, 1])
    return np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1).astype(
        np.float32)


def detection_inputs(op, seed=0):
    """The inputs of ``chip_smoke.py``'s detection sub-phase (v6) for
    ``op``, at the shapes of the public models' published settings, as a
    dict of numpy arrays and plain arguments; one ``RandomState(seed)``
    an op.

    - ``roi_align``: an FPN P2 level of an 800x1088 image (2 x 256 x 200
      x 272, spatial scale 1/4), 512 boxes an image, 7x7, 2 samples;
    - ``deform_conv2d``: DCNv2 in ResNet-50's C4 stage: 2 x 256 x 50 x 68,
      3x3 with padding 1, 256 filters, offsets of a few pixels, the
      modulation mask in [0, 1);
    - ``yolo_box`` and ``yolo_loss``: the YOLOv3 head at 416x416, the
      13x13 scale: 8 x 255 x 13 x 13 (3 anchors of 80 classes), 50 boxes
      an image of which the first 20 are objects (the rest padding);
    - ``nms``: 1,000 boxes in an 800x1088 image, clustered round 50
      centres, IoU 0.7;
    - ``generate_proposals``: an RPN over a 50x68 map (stride 16 of
      800x1088), 15 anchors a cell (5 sizes x 3 ratios), the reference's
      defaults (pre_nms_top_n 6000, post_nms_top_n 1000);
    - ``multiclass_nms``: SSD300's 8,732 priors and 21 classes (softmax
      scores), score 0.01, nms_top_k 400, keep_top_k 200, IoU 0.45.
    """
    rs = np.random.RandomState(seed)
    if op == "roi_align":
        boxes = np.concatenate([_boxes_xyxy(rs, 512, 800, 1088, 16, 400)
                                for _ in range(2)])
        return dict(x=rs.randn(2, 256, 200, 272).astype(np.float32),
                    boxes=boxes, boxes_num=np.array([512, 512], np.int32),
                    output_size=7, spatial_scale=0.25, sampling_ratio=2)
    if op == "deform_conv2d":
        return dict(
            x=rs.randn(2, 256, 50, 68).astype(np.float32),
            offset=(2.0 * rs.randn(2, 18, 50, 68)).astype(np.float32),
            mask=rs.rand(2, 9, 50, 68).astype(np.float32),
            weight=rs.normal(0.0, np.sqrt(2.0 / 2304),
                             (256, 256, 3, 3)).astype(np.float32),
            bias=(0.1 * rs.randn(256)).astype(np.float32), padding=1)
    if op in ("yolo_box", "yolo_loss"):
        x = rs.randn(8, 255, 13, 13).astype(np.float32)
        gt = np.zeros((8, 50, 4), np.float32)
        gt[:, :20, :2] = rs.uniform(0.05, 0.95, (8, 20, 2))
        gt[:, :20, 2:] = rs.uniform(0.02, 0.8, (8, 20, 2))
        return dict(x=x, img_size=np.full((8, 2), 416, np.int32),
                    gt_box=gt,
                    gt_label=rs.randint(0, 80, (8, 50)).astype(np.int32),
                    anchors=YOLOV3_ANCHORS, anchor_mask=[6, 7, 8],
                    class_num=80, conf_thresh=0.01, ignore_thresh=0.7,
                    downsample_ratio=32)
    if op == "nms":
        centres = rs.uniform(60, 740, (50, 2))[rs.randint(0, 50, 1000)]
        wh = rs.uniform(30, 120, (1000, 2))
        xy = centres + rs.randn(1000, 2) * 12
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1)
        return dict(boxes=boxes.astype(np.float32),
                    scores=rs.rand(1000).astype(np.float32),
                    iou_threshold=0.7)
    if op == "generate_proposals":
        a, h, w = 15, 50, 68
        sizes, ratios = [32.0, 64.0, 128.0, 256.0, 512.0], [0.5, 1.0, 2.0]
        cx = (np.arange(w) + 0.5) * 16.0
        cy = (np.arange(h) + 0.5) * 16.0
        cx, cy = np.meshgrid(cx, cy)
        half = np.array([[s * np.sqrt(1 / r) / 2, s * np.sqrt(r) / 2]
                         for r in ratios for s in sizes])
        anchors = np.stack([cx[..., None] - half[:, 0],
                            cy[..., None] - half[:, 1],
                            cx[..., None] + half[:, 0],
                            cy[..., None] + half[:, 1]], -1)
        return dict(
            scores=rs.rand(1, a, h, w).astype(np.float32),
            bbox_deltas=(0.2 * rs.randn(1, 4 * a, h, w)).astype(np.float32),
            img_size=np.array([[800, 1088]], np.float32),
            anchors=anchors.astype(np.float32),
            variances=np.ones((h, w, a, 4), np.float32),
            pre_nms_top_n=6000, post_nms_top_n=1000)
    if op == "multiclass_nms":
        boxes = _boxes_xyxy(rs, 8732, 1.0, 1.0, 0.02, 0.5)[None]
        logits = 2.0 * rs.randn(1, 21, 8732)
        scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return dict(bboxes=boxes, scores=scores.astype(np.float32),
                    score_threshold=0.01, nms_top_k=400, keep_top_k=200,
                    nms_threshold=0.45)
    raise ValueError(f"no detection inputs for {op!r}")


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
