"""The port's ``summary`` and ``flops`` (``hapi.model_summary``) against
the JAX package's, on the CPU.

- ``summary``'s printed table and returned dict equal the reference's, on
  the MLP ``Linear(16,32)-ReLU-Linear(32,4)`` and on LeNet.
- ``flops`` equals the reference's XLA count on the MLP (1,348), on LeNet
  at 1x1x28x28 (696,078) and on a convolution + batch norm + ReLU +
  average pool; on layer norm + softmax it reads lower, and the test
  states by how much and why.
"""
import paddle_tpu as ref

import paddle_tpu_torch as port
from test_torch_hapi import _lenets, _mlps
from torch_threads import two_threads  # noqa: F401


def test_summary_and_flops_match_the_reference(capsys):
    rl, pl = _lenets()
    rmlp, pmlp = _mlps()
    for rnet, pnet, shape, want in ((rmlp, pmlp, (1, 16), 1348),
                                    (rl, pl, (1, 1, 28, 28), 696078)):
        want_dict = ref.summary(rnet, shape)
        want_table = capsys.readouterr().out
        assert port.summary(pnet, shape) == want_dict
        assert capsys.readouterr().out == want_table
        assert port.flops(pnet, shape) == ref.flops(rnet, shape) == want
    model = port.Model(pl, device="cpu")
    assert model.summary((1, 1, 28, 28)) == {"total_params": 61610,
                                             "trainable_params": 61610}


def test_flops_where_the_count_is_exact_and_where_it_is_not():
    """A convolution, batch norm (eval), ReLU and average pool: the trace
    decomposes batch norm into XLA's elementwise ops, so the counts are
    equal. Layer norm and softmax stay whole ops in the trace (the variance
    one reduction, softmax no countable op), where XLA expands them into
    reductions, subtractions, squares and divides: 1,247 here against the
    reference's 1,569 (ROADMAP.md, Oracle caveats)."""
    def conv_bn(pkg):
        n = pkg.nn.Sequential(pkg.nn.Conv2D(3, 8, 3, padding=1),
                              pkg.nn.BatchNorm2D(8), pkg.nn.ReLU(),
                              pkg.nn.AvgPool2D(2))
        n.eval()
        return n

    def ln_softmax(pkg):
        return pkg.nn.Sequential(pkg.nn.Linear(16, 32), pkg.nn.LayerNorm(32),
                                 pkg.nn.Softmax())
    assert port.flops(conv_bn(port), (1, 3, 8, 8)) == \
        ref.flops(conv_bn(ref), (1, 3, 8, 8)) == 26824
    got = port.flops(ln_softmax(port), (1, 16))
    want = ref.flops(ln_softmax(ref), (1, 16))
    assert (got, want) == (1247, 1569)
