"""Library ops with their autograd registered (``torch.library``).

``make_fx`` (behind ``jit.to_static`` and the program analysis) inlines
an ``autograd.Function``'s forward, so a staged graph would lose its
backward; a library op with ``register_autograd`` stays one node of the
graph and keeps it. An op takes no Python object: a process group goes
in as ``distributed.mesh.group_handle``'s integer.
"""
from __future__ import annotations

import torch

_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")


def library_op(schema, impl, fake, backward, setup_context):
    """Define ``paddle_tpu_torch::<name>`` by ``schema``, ``impl`` on every
    device, its fake (shapes for tracing) and its autograd; returns
    ``torch.ops.paddle_tpu_torch.<name>``."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    torch.library.register_fake(f"paddle_tpu_torch::{name}", fake, lib=_LIB)
    torch.library.register_autograd(f"paddle_tpu_torch::{name}", backward,
                                    setup_context=setup_context, lib=_LIB)
    return getattr(torch.ops.paddle_tpu_torch, name)
