"""The port's recurrent layers (``nn/layers/rnn.py``) against the JAX
package's: the three cells, ``RNN``/``BiRNN`` and the ``SimpleRNN``,
``LSTM`` and ``GRU`` stacks over their directions, depths and layouts,
weights carried 1:1 by name (the gates and layouts are the reference's),
the same numpy inputs from a seed. float32: outputs and final states
within rtol 1e-5, atol 1e-6 (35 steps at most of tanh/sigmoid gates, the
matmuls' sums in another order); gradients through ``jax.grad`` of the
reference within rtol 1e-4, atol 1e-6. Dropout between layers draws
from the port's generator: held by structure (train differs from eval,
eval equals the undropped stack)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.jit.functionalization import functional_call, state_of

RS = np.random.RandomState(4)
B, T, I, H = 3, 6, 5, 4


def _pair(name, *args, **kw):
    ref.seed(0)
    rl = getattr(ref.nn, name)(*args, **kw)
    pl = getattr(port.nn, name)(*args, **kw)
    pl.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rl.state_dict().items()})
    return rl, pl


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("cell,kw", [("SimpleRNNCell", {}),
                                     ("SimpleRNNCell",
                                      {"activation": "relu"}),
                                     ("LSTMCell", {}), ("GRUCell", {})])
def test_cells_match_the_reference(cell, kw):
    rl, pl = _pair(cell, I, H, **kw)
    x = RS.randn(B, I).astype(np.float32)
    states = rl.get_initial_states(jnp.asarray(x), init_value=0.3)
    r_out, r_st = rl(jnp.asarray(x), states)
    p_out, p_st = pl(torch.from_numpy(x), pl.get_initial_states(
        torch.from_numpy(x), init_value=0.3))
    _close(p_out, r_out)
    _close(p_st, r_st)
    _close(pl(torch.from_numpy(x)), rl(jnp.asarray(x)))   # zero states


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect", "backward"])
@pytest.mark.parametrize("time_major", [False, True])
def test_stacks_match_the_reference(mode, direction, time_major):
    rl, pl = _pair(mode, I, H, num_layers=2, direction=direction,
                   time_major=time_major)
    shape = (T, B, I) if time_major else (B, T, I)
    x = RS.randn(*shape).astype(np.float32)
    _close(pl(torch.from_numpy(x)), rl(jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_initial_states_are_used(mode):
    rl, pl = _pair(mode, I, H, num_layers=2, direction="bidirect")
    x = RS.randn(B, T, I).astype(np.float32)
    h = RS.randn(4, B, H).astype(np.float32)
    c = RS.randn(4, B, H).astype(np.float32)
    r_init = (jnp.asarray(h), jnp.asarray(c)) if mode == "LSTM" else \
        jnp.asarray(h)
    p_init = (torch.from_numpy(h), torch.from_numpy(c)) if mode == "LSTM" \
        else torch.from_numpy(h)
    _close(pl(torch.from_numpy(x), p_init), rl(jnp.asarray(x), r_init))


def test_lstm_gradients_match_the_reference():
    rl, pl = _pair("LSTM", I, H, num_layers=2)
    x = RS.randn(B, T, I).astype(np.float32)
    w = RS.randn(B, T, H).astype(np.float32)
    params, buffers = state_of(rl)

    def loss(p, xx):
        out, _ = functional_call(rl, p, buffers, xx)[0]
        return jnp.sum(out * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = pl(xt)
    (out * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, gx, rtol=1e-4)
    for name, p in pl.named_parameters():
        _close(p.grad, gp[name], rtol=1e-4)


def test_dropout_between_layers():
    _, pl = _pair("LSTM", I, H, num_layers=2, dropout=0.5)
    _, plain = _pair("LSTM", I, H, num_layers=2)
    x = torch.from_numpy(RS.randn(B, T, I).astype(np.float32))
    pl.eval()
    plain.eval()
    assert torch.equal(pl(x)[0], plain(x)[0])
    pl.train()
    port.seed(1)
    assert not torch.equal(pl(x)[0], plain(x)[0])


def test_rnn_and_birnn_wrappers():
    ref.seed(0)
    rc, rc2 = ref.nn.GRUCell(I, H), ref.nn.GRUCell(I, H)
    pc, pc2 = port.nn.GRUCell(I, H), port.nn.GRUCell(I, H)
    for r, p in ((rc, pc), (rc2, pc2)):
        p.set_state_dict_from_numpy({k: np.asarray(v)
                                     for k, v in r.state_dict().items()})
    x = RS.randn(B, T, I).astype(np.float32)
    _close(port.nn.RNN(pc, is_reverse=True)(torch.from_numpy(x)),
           ref.nn.RNN(rc, is_reverse=True)(jnp.asarray(x)))
    _close(port.nn.BiRNN(pc, pc2)(torch.from_numpy(x)),
           ref.nn.BiRNN(rc, rc2)(jnp.asarray(x)))
