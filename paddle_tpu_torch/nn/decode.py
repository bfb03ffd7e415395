"""Sequence decoding: the ``Decoder`` protocol, ``BeamSearchDecoder`` and
``dynamic_decode`` (port of ``paddle_tpu/nn/decode.py``).

Beams fold into the batch as ``(batch * beam)`` rows. Each step takes the
flat top-k over ``beam * vocab`` (ties to the lower index, as
``lax.top_k`` breaks them: a stable descending sort), lets a finished
beam extend only with ``end_token`` at no cost, and regroups the cell
states by parent beam. ``dynamic_decode`` is the reference's eager loop:
it stops when every beam has finished or at ``max_step_num``, then
``gather_tree`` backtraces the ids.
"""
from __future__ import annotations

from collections import namedtuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .functional.extension import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


def _top_k(x, k):
    """``lax.top_k``'s order: largest first, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Decoder:
    """The protocol ``dynamic_decode`` drives: ``initialize``, ``step``
    and ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a step cell: ``cell(inputs, states) -> (out,
    new_states)``; ``output_fn`` maps ``out`` to vocabulary logits and
    ``embedding_fn`` token ids to the next step's inputs."""

    OutputWrapper = namedtuple("OutputWrapper",
                               ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = namedtuple("StateWrapper",
                              ("cell_states", "log_probs", "finished",
                               "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)

    def _expand(self, x):
        x = torch.as_tensor(x)
        return x[:, None].repeat_interleave(self.beam_size, dim=1)

    def _merge(self, x):   # (batch, beam, ...) -> (batch * beam, ...)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def _split(self, x):   # (batch * beam, ...) -> (batch, beam, ...)
        return x.reshape((-1, self.beam_size) + tuple(x.shape[1:]))

    def initialize(self, initial_cell_states):
        cell_states = tree_map(lambda s: self._merge(self._expand(s)),
                               initial_cell_states)
        sample = tree_leaves(cell_states)[0]
        batch = sample.shape[0] // self.beam_size
        dev = sample.device
        # only beam 0 is live at the first step
        log_probs = torch.tensor([0.0] + [-1e9] * (self.beam_size - 1),
                                 device=dev).repeat(batch, 1)
        init_ids = torch.full((batch, self.beam_size), self.start_token,
                              dtype=torch.int32, device=dev)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int32,
                              device=dev)
        states = self.StateWrapper(cell_states, log_probs, finished, lengths)
        inputs = self.embedding_fn(init_ids) if self.embedding_fn \
            else init_ids
        return inputs, states, finished

    def step(self, time, inputs, states, **kwargs):
        merged = tree_map(self._merge, inputs)
        cell_out, next_cell_states = self.cell(merged, states.cell_states,
                                               **kwargs)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        logits = self._split(logits)                   # (batch, beam, V)
        vocab = logits.shape[-1]
        step_log_probs = torch.log_softmax(logits, dim=-1)
        # a finished beam extends only with end_token, at no cost
        noend = torch.full((vocab,), -1e9, dtype=step_log_probs.dtype,
                           device=logits.device)
        noend[self.end_token] = 0.0
        step_log_probs = torch.where(states.finished[..., None], noend,
                                     step_log_probs)
        log_probs = states.log_probs[..., None] + step_log_probs
        top, idx = _top_k(log_probs.reshape(log_probs.shape[0], -1),
                          self.beam_size)
        parent = idx // vocab
        token_ids = (idx % vocab).to(torch.int32)

        def regroup(s):
            shape = tuple(parent.shape) + (1,) * (s.dim() - 1)
            picked = self._split(s).gather(
                1, parent.reshape(shape).expand(
                    tuple(parent.shape) + tuple(s.shape[1:])))
            return picked.reshape((-1,) + tuple(s.shape[1:]))

        next_cell_states = tree_map(regroup, next_cell_states)
        prev_finished = states.finished.gather(1, parent)
        finished = prev_finished | (token_ids == self.end_token)
        lengths = states.lengths.gather(1, parent)
        lengths = torch.where(prev_finished, lengths, lengths + 1)
        next_states = self.StateWrapper(next_cell_states, top, finished,
                                        lengths)
        outputs = self.OutputWrapper(top, token_ids, parent.to(torch.int32))
        next_inputs = self.embedding_fn(token_ids) if self.embedding_fn \
            else token_ids
        return outputs, next_states, next_inputs, finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """outputs' fields (time, batch, beam); the ids backtraced."""
        ids = gather_tree(outputs.predicted_ids, outputs.parent_ids)
        return self.OutputWrapper(outputs.scores, ids,
                                  outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, is_test=False,
                   return_length=False, **kwargs):
    """Step ``decoder`` until every sequence has finished or
    ``max_step_num`` steps (256 by default) -> (outputs, final states[,
    lengths]); outputs batch-major unless ``output_time_major``."""
    inputs, states, finished = decoder.initialize(inits)
    outs = []
    max_steps = max_step_num if max_step_num is not None else 256
    for time in range(max_steps):
        step_out, states, inputs, finished = decoder.step(time, inputs,
                                                          states, **kwargs)
        outs.append(step_out)
        if bool(finished.all()):
            break
    stacked = tree_map(lambda *xs: torch.stack(xs), *outs)
    lengths = getattr(states, "lengths", None)
    final_outputs, final_states = decoder.finalize(stacked, states, lengths)
    if not output_time_major:
        final_outputs = tree_map(lambda x: x.movedim(0, 1), final_outputs)
    if return_length:
        return final_outputs, final_states, lengths
    return final_outputs, final_states
