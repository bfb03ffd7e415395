"""The port's ``BeamSearchDecoder`` and ``dynamic_decode``
(``nn/decode.py``) against the JAX package's.

- The reference test's deterministic chain (``tests/test_nn_extras.py``:
  token t prefers t + 1, token 3 prefers END): the best beam is 1, 2, 3,
  END and every beam finishes.
- A real cell: an ``LSTMCell`` with an embedding and a linear output
  (weights carried from the reference), batch 3, beam 4, vocab 11, ten
  steps at most: scores within rtol 1e-5 (log-softmax sums over the
  steps), predicted and parent ids, the backtraced ids, the finished
  flags and lengths equal; so is the stop step.
"""
import numpy as np
import torch

import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port

VOCAB, END = 5, 4


class _Chain:
    def __init__(self, pd, table, to):
        self.pd, self.table, self.to = pd, to(table), to

    def __call__(self, ids, states):
        return self.table[ids.reshape(-1)], states


def _chain_table():
    table = np.full((VOCAB, VOCAB), -10.0, dtype=np.float32)
    for t in range(VOCAB):
        table[t, (t + 1) % VOCAB] = 10.0
    return table


def test_deterministic_chain():
    dec = port.nn.BeamSearchDecoder(
        _Chain(port, _chain_table(), torch.from_numpy), start_token=0,
        end_token=END, beam_size=2)
    out, states = port.nn.dynamic_decode(dec, torch.zeros(2, 1),
                                         max_step_num=10)
    np.testing.assert_array_equal(out.predicted_ids[0, :4, 0].numpy(),
                                  [1, 2, 3, 4])
    assert bool(states.finished.all())


class _LstmStep:
    def __init__(self, cell):
        self.cell = cell

    def __call__(self, inputs, states):
        return self.cell(inputs, states)


def _decoders():
    ref.seed(0)
    parts = {}
    for pd in (ref, port):
        parts[pd] = (pd.nn.Embedding(11, 6), pd.nn.LSTMCell(6, 8),
                     pd.nn.Linear(8, 11))
    for r, p in zip(parts[ref], parts[port]):
        p.set_state_dict_from_numpy({k: np.asarray(v)
                                     for k, v in r.state_dict().items()})
    decs = {}
    for pd, (emb, cell, head) in parts.items():
        decs[pd] = pd.nn.BeamSearchDecoder(
            _LstmStep(cell), start_token=0, end_token=1, beam_size=4,
            embedding_fn=emb, output_fn=head)
    return decs


def test_lstm_beam_search_matches_the_reference():
    decs = _decoders()
    rs = np.random.RandomState(2)
    h = rs.randn(3, 8).astype(np.float32)
    c = rs.randn(3, 8).astype(np.float32)
    r_out, r_st, r_len = ref.nn.dynamic_decode(
        decs[ref], (jnp.asarray(h), jnp.asarray(c)), max_step_num=10,
        return_length=True)
    with torch.no_grad():
        p_out, p_st, p_len = port.nn.dynamic_decode(
            decs[port], (torch.from_numpy(h), torch.from_numpy(c)),
            max_step_num=10, return_length=True)
    assert p_out.scores.shape == r_out.scores.shape
    np.testing.assert_allclose(p_out.scores.numpy(),
                               np.asarray(r_out.scores), rtol=1e-5,
                               atol=1e-5)
    for f in ("predicted_ids", "parent_ids"):
        np.testing.assert_array_equal(getattr(p_out, f).numpy(),
                                      np.asarray(getattr(r_out, f)))
    np.testing.assert_array_equal(p_st.finished.numpy(),
                                  np.asarray(r_st.finished))
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(r_len))
    time_major, _ = port.nn.dynamic_decode(
        decs[port], (torch.from_numpy(h), torch.from_numpy(c)),
        max_step_num=10, output_time_major=True)
    np.testing.assert_array_equal(time_major.predicted_ids.movedim(0, 1)
                                  .numpy(), p_out.predicted_ids.numpy())
