"""The port's sharded lookup (``ops/sharded_embedding.alltoall_lookup``)
against the JAX package's, on gloo worlds of 2 and 4
(``torch_ep_worker.py``), each rank holding ``64 / n`` rows of a 64 x 5
table and looking up its own 16 ids (-1 padding among them; a fifth of
every rank's ids on one row, so that the caps 1 and 3 overflow their
buckets and the all-gather fallback runs, and 16 does not).

- forward: bit for bit the reference's ``alltoall_lookup`` under
  ``shard_map`` over as many CPU devices, and the dense gather;
- gradients of ``sum(out * coef)`` (``coef`` a ramp over the ids, so a
  wrong owner or position shows) with respect to the table, put together
  from the ranks' slices, against the dense gather's ``jax.grad`` within
  the reference test's bar (rtol 1e-5: the scatter-adds sum a row's
  cotangents in other orders, ``tests/test_heter_embedding.py:303-340``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from paddle_tpu.ops.sharded_embedding import alltoall_lookup as ref_lookup

import torch_ep_worker as worker

pytestmark = pytest.mark.multihost(timeout=300)


def _dense(rows, ids):
    return np.where((ids >= 0)[:, None],
                    rows[np.clip(ids, 0, rows.shape[0] - 1)], 0.0)


def _ref_forward(rows, ids, n, cap):
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("data",))
    f = jax.shard_map(
        lambda r, i: ref_lookup(r, i, "data", cap, rows.shape[0] // n),
        mesh=mesh, in_specs=(P("data", None), P("data")),
        out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(rows), jnp.asarray(ids)))


def _dense_grad(rows, ids, coef):
    def loss(r):
        o = jnp.where((jnp.asarray(ids) >= 0)[:, None],
                      r[jnp.clip(jnp.asarray(ids), 0, r.shape[0] - 1)], 0.0)
        return jnp.sum(o * coef)
    return np.asarray(jax.grad(loss)(jnp.asarray(rows)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cap", worker.LOOKUP_CAPS)
def test_lookup_forward_bit_for_bit(n, cap, tmp_path_factory):
    rows, ids, _ = worker.lookup_data(n)
    ranks = worker.world(n, tmp_path_factory, kinds=("lookup",))
    got = np.concatenate([r["lookup"][cap]["out"] for r in ranks])
    np.testing.assert_array_equal(got, _ref_forward(rows, ids, n, cap))
    np.testing.assert_array_equal(got, _dense(rows, ids))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cap", worker.LOOKUP_CAPS)
def test_lookup_gradients_match_the_dense_gather(n, cap, tmp_path_factory):
    rows, ids, coef = worker.lookup_data(n)
    ranks = worker.world(n, tmp_path_factory, kinds=("lookup",))
    got = np.concatenate([r["lookup"][cap]["grad"] for r in ranks])
    np.testing.assert_allclose(got, _dense_grad(rows, ids, coef), rtol=1e-5)


def test_small_caps_overflow_and_the_large_one_does_not():
    """The planted skew: the caps 1 and 3 overflow on every world (the
    fallback runs), 16 holds every id of a rank."""
    for n in (2, 4):
        _, ids, _ = worker.lookup_data(n)
        rps = worker.LOOKUP_ROWS // n
        for r in range(n):
            mine = ids[r * worker.LOOKUP_IDS:(r + 1) * worker.LOOKUP_IDS]
            owners = np.bincount(mine[mine >= 0] // rps, minlength=n)
            assert owners.max() > 3 and owners.max() <= 16
