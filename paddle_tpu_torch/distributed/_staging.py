"""Tracing a trainer's own step on fakes of its state.

``ParallelTrainer.staged_graph`` and ``LocalSGDTrainer.step_graph`` trace
the step a user runs (``train_step``), not a copy of it: for the length of
the trace every module's parameters and buffers and the trainer's state
attributes point at the tracer's fakes of them, and everything is put back
after, the generators' states included, so the real trainer is bit for
bit as it was. :func:`state_leaves` flattens the state in one order and
:func:`bound` swaps it.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Sequence

import torch

__all__ = ["tree_leaves", "tree_rebuild", "state_leaves", "bound"]


def tree_leaves(tree) -> list:
    """The tensors of a tensor, a nested dict or None, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_rebuild(tree, it):
    """``tree`` with each tensor replaced by the next of ``it``."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_rebuild(v, it)) for k, v in tree.items())
    return next(it) if isinstance(tree, torch.Tensor) else tree


def _model_slots(model):
    slots, uniq = [], OrderedDict()
    for kind in ("_parameters", "_buffers"):
        for m in model.modules():
            for n, t in getattr(m, kind).items():
                if t is not None:
                    slots.append((m, kind, n, t))
                    uniq.setdefault(id(t), t)
    return slots, list(uniq.values())


def state_leaves(model, owner, attrs: Sequence[str]):
    """``(leaves, n_model)``: the model's tensors by identity (a tied
    weight once; parameters, then buffers), then the tensors of each of
    ``owner``'s ``attrs`` (a tensor, a nested dict or None) in order."""
    _, leaves = _model_slots(model)
    n_model = len(leaves)
    for a in attrs:
        leaves = leaves + tree_leaves(getattr(owner, a))
    return leaves, n_model


@contextlib.contextmanager
def bound(model, owner, attrs: Sequence[str], fakes, keep: Sequence[str] = ()
          ):
    """While the block runs, every module tensor and each of ``owner``'s
    ``attrs`` (and ``owner.params``, a name -> parameter dict) hold the
    matching entry of ``fakes`` (:func:`state_leaves`' order); after it,
    they, the ``keep`` attributes and every generator of
    ``framework.random`` are as they were."""
    from ..framework import random as _random
    slots, model_leaves = _model_slots(model)
    by_id = {id(t): f for t, f in zip(model_leaves, fakes)}
    saved_mods = [(m, kind, dict(getattr(m, kind)))
                  for m in model.modules()
                  for kind in ("_parameters", "_buffers")]
    saved = {a: getattr(owner, a) for a in
             tuple(attrs) + tuple(keep) + ("params",) if hasattr(owner, a)}
    gens = [(g, g.get_state()) for g in
            list(_random._generators.values()) +
            list(_random._rng_tracker._gens.values())]
    known = (set(_random._generators), set(_random._rng_tracker._gens))
    try:
        for m, kind, n, t in slots:
            getattr(m, kind)[n] = by_id[id(t)]
        if hasattr(owner, "params"):
            owner.params = OrderedDict((k, by_id[id(p)])
                                       for k, p in owner.params.items())
        it = iter(fakes[len(model_leaves):])
        for a in attrs:
            setattr(owner, a, tree_rebuild(saved[a], it))
        yield
    finally:
        for m, kind, d in saved_mods:
            getattr(m, kind).clear()
            getattr(m, kind).update(d)
        for a, v in saved.items():
            setattr(owner, a, v)
        for g, st in gens:
            g.set_state(st)
        for k in set(_random._generators) - known[0]:
            del _random._generators[k]
        for k in set(_random._rng_tracker._gens) - known[1]:
            del _random._rng_tracker._gens[k]
