"""``fused_linear_cross_entropy`` (port of
``paddle_tpu/nn/functional/loss.py``'s).

LM-head projection plus softmax cross entropy without materializing the
(tokens, vocab) logits. ``kernel``:

- ``"chunked"``: ``ops/chunked_ce.py``, ``chunk`` classes per step;
- ``"auto"``: the chunked path, counted by
  ``record_fallback("fused_ce")``, as the reference answers off a TPU;
- ``"pallas"``: the fused CE kernels, which are not ported yet (slice 3 of
  the port); it raises ``NotImplementedError``.
"""
from __future__ import annotations

from ...ops.chunked_ce import chunked_lm_ce
from ...ops.tuner import record_fallback

__all__ = ["fused_linear_cross_entropy"]


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               chunk=8192, kernel="auto", interpret=None,
                               name=None):
    """Mean float32 loss over labels != ``ignore_index``, gradients to
    hidden and weight. hidden: (..., H); weight: (H, V); labels: (...)."""
    del interpret   # the reference's Pallas interpret switch
    if kernel == "auto":
        record_fallback("fused_ce")
        kernel = "chunked"
    if kernel == "chunked":
        return chunked_lm_ce(hidden, weight, labels, chunk=chunk,
                             ignore_index=ignore_index)
    if kernel == "pallas":
        raise NotImplementedError(
            "fused_linear_cross_entropy(kernel='pallas'): the fused CE "
            "kernels are not ported yet (ROADMAP.md, slice 3 of the port); "
            "use kernel='chunked'")
    raise ValueError(
        f"kernel must be 'auto', 'pallas' or 'chunked', got {kernel!r}")
