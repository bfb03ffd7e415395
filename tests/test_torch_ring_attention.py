"""Ring attention over ``sep`` (context parallelism) of the port, over gloo
ranks on the CPU, against the JAX package's ``ring_flash_attention`` under
``shard_map`` and its trainer on a mesh of the same shape.

The port ``spawn``s a world of 2 and one of 4 (``torch_hybrid_worker.py``,
each once); the reference runs in this process on as many of the 8
virtual devices, from the same numpy inputs (each reference run once per
module).

- the ring at ``sep`` 2 and 4, causal and not, float32 (B 2, S 64, H 2,
  D 16): the output and the gradients of q, k and v against the
  reference's ring (its partials are float32 einsums, AD through the
  scan) and against whole-sequence attention (the flash kernels' plain
  versions over all 64 rows); the one-device block steps
  (``ring_attention_local``, the form ``chip_smoke.py`` runs on one card)
  give the distributed ring's bits;
- GPT (the tensor-parallel tests' widths) at ``{"data": 2, "sep": 2}`` and,
  tensor parallel, at ``{"sep": 2, "model": 2}`` against the reference's
  trainer (``tests/test_distributed.py:577-623``);
- the raise for a mask or for attention dropout under ``sep``.

Tolerances: on the CPU each block is the kernels' plain version, float32
throughout, and the merge is the reference's; port and reference differ
only in the order of float32 sums (the scores' dot products, the
softmax's row sums, the merge's order is the same), so outputs and
gradients agree within 1e-5 absolute on values of order 1 (a few hundred
float32 ulps of the largest term, for sums of 64 terms and at most four
merges). Against whole-sequence attention the same bar holds: the merge
is exact up to the rounding of ``exp(lse_j - LSE)``. The GPT runs take
``test_torch_tensor_parallel.py``'s bars (losses rtol 1e-5, parameters
lr / 50, the key bias's q and v parts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.ops.ring_attention import \
    ring_flash_attention as ref_ring

import test_torch_tensor_parallel as tpt
import torch_hybrid_worker as worker
from paddle_tpu_torch.distributed.mesh import Mesh, set_mesh
from paddle_tpu_torch.ops.flash_attention import (flash_attention_plain_bwd,
                                                  flash_attention_plain_fwd)
from paddle_tpu_torch.ops.ring_attention import ring_attention_local
from paddle_tpu_torch.text.models import GPTAttention
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=300)

RING_ATOL = 1e-5
SHAPE = (2, 64, 2, 16)


def _ring_inputs(seed):
    rs = np.random.RandomState(seed)
    return {x: rs.randn(*SHAPE).astype(np.float32)
            for x in ("q", "k", "v", "do")}


def _ring(n, causal, seed):
    return dict(degrees={"sep": n}, causal=causal, **_ring_inputs(seed))


def _gpt(degrees, tp):
    return tpt._gpt(degrees=degrees, tp=tp)


CASES = {
    2: {"ring": {"sep2": _ring(2, False, 1), "sep2-causal": _ring(2, True, 2)},
        "train": {}},
    4: {"ring": {"sep4": _ring(4, False, 3), "sep4-causal": _ring(4, True, 4)},
        "train": {"dp2-sep2": _gpt({"data": 2, "sep": 2}, False),
                  "sep2-tp2": _gpt({"sep": 2, "model": 2}, True)}},
}


_RUNS = {}


def _world(n, tmp_path_factory):
    if n not in _RUNS:
        plan = dict(CASES[n], gpt_cfg=dict(tpt.GPT_CFG),
                    weights=tpt._weights(), batches=tpt._batches())
        _RUNS[n] = worker.spawn_plan(plan, n, tmp_path_factory, f"ring{n}")
    return _RUNS[n]


_REF = {}


def _ref_ring(name, case):
    """The reference's ring under shard_map: (out, (dq, dk, dv))."""
    if name not in _REF:
        n = case["degrees"]["sep"]
        mesh = ref_build_mesh({"sep": n})
        spec = P(None, "sep")
        f = jax.shard_map(
            lambda q, k, v: ref_ring(q, k, v, causal=case["causal"]),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)
        q, k, v, do = (jnp.asarray(case[x]) for x in ("q", "k", "v", "do"))
        out, vjp = jax.vjp(f, q, k, v)
        _REF[name] = (np.asarray(out), [np.asarray(g) for g in vjp(do)])
    return _REF[name]


def _whole(case):
    """Whole-sequence attention (the kernels' plain versions)."""
    q, k, v, do = (torch.from_numpy(case[x]) for x in ("q", "k", "v", "do"))
    out, lse = flash_attention_plain_fwd(q, k, v, causal=case["causal"])
    grads = flash_attention_plain_bwd(q, k, v, out, lse, do,
                                      causal=case["causal"])
    return out.numpy(), [g.numpy() for g in grads]


def _cat(ranks, name, field, i=None):
    parts = [r["ring"][name][field] if i is None else r["ring"][name][field][i]
             for r in ranks]
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("n,name", [(n, c) for n in CASES
                                    for c in CASES[n]["ring"]])
def test_ring_matches_the_reference_and_whole_sequence_attention(
        n, name, tmp_path_factory):
    ranks = _world(n, tmp_path_factory)
    case = CASES[n]["ring"][name]
    ref_out, ref_grads = _ref_ring(name, case)
    w_out, w_grads = _whole(case)
    out = _cat(ranks, name, "out")
    for want in (ref_out, w_out):
        np.testing.assert_allclose(out, want, rtol=0, atol=RING_ATOL)
    for i in range(3):
        g = _cat(ranks, name, "grads", i)
        for want in (ref_grads[i], w_grads[i]):
            np.testing.assert_allclose(g, want, rtol=0, atol=RING_ATOL,
                                       err_msg=f"{name} grad {i}")


@pytest.mark.parametrize("n,name", [(n, c) for n in CASES
                                    for c in CASES[n]["ring"]])
def test_one_device_block_steps_give_the_rings_bits(n, name,
                                                    tmp_path_factory):
    for r in _world(n, tmp_path_factory):
        got = r["ring"][name]
        np.testing.assert_array_equal(got["out"], got["local_out"])
        for a, b in zip(got["grads"], got["local_grads"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES[4]["train"]))
def test_gpt_under_sep_matches_the_reference(name, tmp_path_factory):
    ranks = _world(4, tmp_path_factory)
    case = CASES[4]["train"][name]
    losses, params = tpt._ref_run(f"ring-{name}", case)
    for r in ranks:
        got = r["train"][name]
        assert got["skipped"] == 0
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, want in params.items():
        got = worker.assemble(ranks, name, k)
        np.testing.assert_allclose(tpt._qv(k, got), tpt._qv(k, want),
                                   rtol=0, atol=tpt.GPT_ATOL,
                                   err_msg=f"{name} {k}")


def test_sep_raises_for_a_mask_or_attention_dropout():
    attn = GPTAttention(32, 2, attn_dropout=0.1, resid_dropout=0.0,
                        tensor_parallel=False)
    x = torch.randn(2, 8, 32)
    set_mesh(Mesh({"sep": 2}))
    try:
        with pytest.raises(NotImplementedError, match="attn_mask=None"):
            attn.eval()(x, attn_mask=torch.ones(8, 8, dtype=torch.bool))
        with pytest.raises(NotImplementedError, match="attn_dropout"):
            attn.train()(x)
    finally:
        set_mesh(None)


@pytest.mark.parametrize("causal", [False, True])
def test_local_ring_equals_whole_sequence_attention(causal):
    case = dict(_ring_inputs(7), causal=causal)
    q, k, v, do = (torch.from_numpy(case[x]) for x in ("q", "k", "v", "do"))
    out, lse, grads = ring_attention_local(q, k, v, 4, causal=causal, do=do)
    w_out, w_grads = _whole(case)
    _, w_lse = flash_attention_plain_fwd(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), w_out, atol=RING_ATOL)
    np.testing.assert_allclose(lse.numpy(), w_lse.numpy(), atol=RING_ATOL)
    for g, w in zip(grads, w_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=RING_ATOL)
