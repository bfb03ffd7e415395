"""``fleet.utils.recompute`` under each remat policy, on the CPU.

A narrow GPT (2 blocks, hidden 64, 4 heads, sequence 32) runs embeddings,
then each block through ``recompute(block, h, policy=p)``, the final norm
and the chunked CE head: for each of the six policy names of the JAX
package's ``checkpoint_policy`` (and a policy function), the loss and
every gradient equal the run without recompute bit for bit, with dropout
on (the replayed generator draws the recompute's masks again) and off.
Without the replay (``preserve_rng_state=False``) the recompute draws new
masks and the gradients differ, so the check can fail.

What each policy keeps shows in the ops the backward runs: the recompute
of ``"full"`` and ``"nothing_saveable"`` runs the block's matmuls again,
``"dots_saveable"`` none of them, ``"dots_with_no_batch_dims_saveable"``
only the attention's batched ones (``bmm``), ``"everything_saveable"`` no
op of the forward at all.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.distributed.fleet import utils as ref_utils

from paddle_tpu_torch import framework
from paddle_tpu_torch.distributed.fleet import utils as fleet_utils
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.text.models import GPTForPretraining
from torch_threads import two_threads  # noqa: F401

POLICIES = [None, "full", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "nothing_saveable", "everything_saveable"]
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=32)


def _model(dropout):
    framework.seed(0)
    torch.manual_seed(0)
    return GPTForPretraining(tensor_parallel=False, attn_dropout=dropout,
                             hidden_dropout=dropout, **CFG)


def _batch():
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, 128, (2, 32)))
    lbl = torch.from_numpy(rs.randint(0, 128, (2, 32)))
    return ids, lbl


def _loss(model, ids, lbl, policy="none", replay=True):
    """The loss; ``policy="none"`` calls each block without recompute."""
    h = model.gpt.embeddings(ids)
    for block in model.gpt.h:
        if policy == "none":
            h = block(h)
        else:
            h = fleet_utils.recompute(block, h, policy=policy,
                                      preserve_rng_state=replay)
    h = model.gpt.ln_f(h)
    return F.fused_linear_cross_entropy(h, model.lm_head.weight.T, lbl,
                                        chunk=64, kernel="chunked")


def _run(model, policy, seed=5, replay=True, count=None):
    ids, lbl = _batch()
    framework.seed(seed)
    loss = _loss(model, ids, lbl, policy, replay)
    params = list(model.parameters())
    if count is None:
        return loss, torch.autograd.grad(loss, params)
    with count:
        grads = torch.autograd.grad(loss, params)
    return loss, grads


class _Count(TorchDispatchMode):
    """Counts the ATen ops that run, by name."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_policy_names_are_the_reference_names():
    assert set(ref_utils._POLICIES) == set(fleet_utils._POLICIES)
    for name in POLICIES[2:]:
        assert callable(fleet_utils.checkpoint_policy(name))
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        fleet_utils.checkpoint_policy("dots")


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("policy", POLICIES + ["function"])
def test_values_and_gradients_equal_no_recompute(policy, dropout):
    model = _model(dropout)
    want_loss, want = _run(model, "none")
    if policy == "function":
        policy = fleet_utils.checkpoint_policy("dots_saveable")
    loss, got = _run(model, policy)
    assert torch.equal(loss, want_loss)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_without_the_replay_the_masks_differ(policy):
    model = _model(0.1)
    _, want = _run(model, "none")
    _, got = _run(model, policy, replay=False)
    assert not all(torch.equal(a, b) for a, b in zip(got, want))


def test_what_each_policy_keeps():
    model = _model(0.0)
    counts = {}
    for policy in ["none"] + POLICIES[1:]:
        count = _Count()
        _run(model, policy, count=count)
        counts[policy] = count.ops
    base = counts["none"]
    # detach: the bookkeeping of saved tensors, not an op of the forward
    extra = {p: {op: n - base.get(op, 0) for op, n in c.items()
                 if n != base.get(op, 0) and op != "detach"}
             for p, c in counts.items()}
    # full: the forward's matmuls run again: bmm, the two attention
    # products; mm, three of each block's four linears (the recompute
    # stops once it holds every tensor the backward needs, and the last
    # linear's output is none of them)
    assert extra["full"].get("mm", 0) == 3 * CFG["num_layers"]
    assert extra["full"].get("bmm", 0) == 2 * CFG["num_layers"]
    assert extra["nothing_saveable"] == extra["full"]
    assert "mm" not in extra["dots_saveable"] and \
        "bmm" not in extra["dots_saveable"]
    assert "mm" not in extra["dots_with_no_batch_dims_saveable"]
    assert extra["dots_with_no_batch_dims_saveable"].get("bmm", 0) == \
        2 * CFG["num_layers"]
    assert extra["everything_saveable"] == {}
