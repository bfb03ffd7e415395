"""paddle_tpu_torch.onnx: ONNX export (port of ``paddle_tpu/onnx``).

``export`` always writes the port's ``jit.save`` artifact first, the
``<prefix>.pt2`` program and its ``<prefix>.pdiparams`` weights (the
counterpart of the reference's StableHLO artifact). Then it writes a real
ONNX file, without the ``onnx`` package (``_pb.py``): the layer walker
(``_writer.py``) for ``Sequential``-style models, else the trace
converter (``_trace_writer.py``) over the layer's traced ATen graph.
Where neither can express the model it warns and returns the prefix.
"""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path: str, input_spec=None, opset_version: int = 9,
           **configs):
    """Export ``layer`` for interchange (reference paddle.onnx.export).

    Always writes the ``jit.save`` program + weights at the prefix
    (``path`` without ``.onnx``). Returns the ``.onnx`` file's path when
    ONNX conversion succeeds, else (with a warning) the prefix. An opset
    under 13 is promoted to 13, with a warning, when a writer emits ONNX.
    """
    import warnings

    from .. import jit
    prefix = path[:-5] if path.endswith(".onnx") else path
    jit.save(layer, prefix, input_spec=input_spec)

    def _promote_opset():
        # warned only when a writer actually emits ONNX
        if requested_opset < 13:
            warnings.warn(
                f"opset_version={requested_opset} promoted to 13: the "
                "wire-format writer emits opset-13 ops (Gemm/Conv/"
                "BatchNormalization attribute forms)")

    requested_opset = opset_version
    opset_version = max(13, opset_version)
    onnx_path = prefix + ".onnx"
    try:
        # the layer walker first: Sequential models get idiomatic
        # Gemm/Conv graphs with a dynamic batch dim
        from ._writer import export_layer_to_onnx
        export_layer_to_onnx(layer, onnx_path, input_spec=input_spec,
                             opset_version=opset_version)
        _promote_opset()
        return onnx_path
    except NotImplementedError:
        pass  # fall through to the trace converter
    except Exception as e:  # a converter defect never breaks export: the
        warnings.warn(       # jit.save artifact is already written
            f"ONNX conversion failed ({type(e).__name__}: {e}); trying "
            "the trace-based converter.")
    try:
        # the trace converter: covers residual CNNs (ResNet) and
        # transformer blocks the layer walker refuses
        from ._trace_writer import export_traced_layer
        if input_spec is None:
            raise NotImplementedError("onnx export requires input_spec")
        export_traced_layer(layer, onnx_path, input_spec,
                            opset_version=opset_version)
        _promote_opset()
        return onnx_path
    except NotImplementedError as e:
        warnings.warn(
            f"ONNX conversion not available for this model ({e}); the "
            f"jit.save artifact at {prefix!r} is the exported format.")
    except Exception as e:
        warnings.warn(
            f"ONNX conversion failed ({type(e).__name__}: {e}); the "
            f"jit.save artifact at {prefix!r} is the exported format.")
    return prefix
