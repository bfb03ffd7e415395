"""The port's compressed gradient exchange against the JAX package's, in one
process on the CPU.

- The quantizers, ``pack_int4``/``unpack_int4``, ``bucket_sizes``,
  ``normalize_axis_policies``, ``wire_bytes_per_rank`` and
  ``tree_wire_bytes`` give the same bits (or the same Python values) as the
  reference on the same numpy inputs: odd lengths, all-zero blocks, values
  that land on .5 steps (both round half to even), and both default blocks.
  The reference is jitted throughout, as its trainer runs it: XLA compiles
  ``amax / 127`` into ``amax * (1/127)``, and the port does the same.
- ``compressed_tree_mean`` and ``compressed_psum_scatter`` on a gloo world
  of one rank against the reference inside ``shard_map`` on a one-device
  mesh, the reference jitted as the trainer runs it: every policy
  quantizes there too, and means and scattered sums are bit-identical (the
  same float32 operations in the same order; no collective moves data at
  one rank). Residuals are ``x - q * scale``, which XLA contracts into one
  fused multiply-add under jit where the port rounds ``q * scale`` first:
  they agree within half an ulp of ``q * scale``.

Larger worlds (2 and 4 gloo ranks) are in ``test_torch_data_parallel.py``.
"""
import socket

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed import compressed as ref
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh

from paddle_tpu_torch.distributed import compressed as port
from paddle_tpu_torch.distributed import mesh as port_mesh


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same_bits(got, want, what=""):
    got, want = np.ascontiguousarray(_np(got)), np.ascontiguousarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def _signal(n, seed, zero_blocks=(), block=64, halves=False):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n) * np.exp(rs.randn(n))).astype(np.float32)
    for b in zero_blocks:
        x[b * block:(b + 1) * block] = 0.0
    if halves:
        # a block whose abs-max is 127 (scale exactly 1): entries k + 0.5
        # must round half to even on both sides
        x[:block] = (np.arange(block) % 20 - 10 + 0.5).astype(np.float32)
        x[0] = 127.0
    return x


QUANT_CASES = [(kind, block, 64 * 256, seed)
               for kind in ("int8", "int4")
               for block, seed in ((None, 0), (32, 1), (256, 2))]


@pytest.mark.parametrize("kind,block,n,seed", QUANT_CASES)
def test_quantizers_are_bit_identical(kind, block, n, seed):
    blk = ref.resolve_block(kind, block)
    assert port.resolve_block(kind, block) == blk
    x = _signal(n, seed, zero_blocks=(1, 3), block=blk, halves=True)
    rq, rd = ((ref.quantize_int8_blocks, ref.dequantize_int8_blocks)
              if kind == "int8" else
              (ref.quantize_int4_blocks, ref.dequantize_int4_blocks))
    pq, pd = ((port.quantize_int8_blocks, port.dequantize_int8_blocks)
              if kind == "int8" else
              (port.quantize_int4_blocks, port.dequantize_int4_blocks))
    # jitted, as the trainer runs them (XLA turns x / 127 into x * (1/127))
    rq, rd = jax.jit(rq, static_argnums=1), jax.jit(rd, static_argnums=2)
    q_r, s_r = rq(jnp.asarray(x), blk)
    q_p, s_p = pq(_t(x), blk)
    _same_bits(q_p, q_r, "q")
    _same_bits(s_p, s_r, "scale")
    assert np.all(_np(s_p)[[1, 3]] == 1.0)     # all-zero blocks: scale 1
    _same_bits(pd(q_p, s_p, blk), rd(q_r, s_r, blk), "dequantized")
    # the shared-scale path: a given scale is used as it is
    shared = np.abs(_np(s_p)) * np.float32(1.5)
    q_r2, _ = rq(jnp.asarray(x), blk, jnp.asarray(shared))
    q_p2, _ = pq(_t(x), blk, scale=_t(shared))
    _same_bits(q_p2, q_r2, "q with a shared scale")


def test_pack_int4_round_trip_is_bit_identical():
    vals = np.tile(np.arange(-7, 8, dtype=np.int8), 9)[:128]
    rs = np.random.RandomState(2)
    vals = np.concatenate([vals, rs.randint(-7, 8, 258).astype(np.int8)])
    p_r = ref.pack_int4(jnp.asarray(vals))
    p_p = port.pack_int4(_t(vals))
    _same_bits(p_p, p_r, "packed")
    _same_bits(port.unpack_int4(p_p), ref.unpack_int4(p_r), "unpacked")
    np.testing.assert_array_equal(_np(port.unpack_int4(p_p)), vals)
    assert port.int4_accum_dtype(2) == torch.int16
    assert port.int4_accum_dtype(port.INT16_SAFE_RANKS + 1) == torch.int32
    assert ref.int4_accum_dtype(2) == jnp.int16
    assert port.INT16_SAFE_RANKS == ref.INT16_SAFE_RANKS


@pytest.mark.parametrize("total,bucket,align", [
    (10 * 128, 3 * 128, 128), (1024, 1 << 20, 512), (4096, 100, 64),
    (256, 256, 256), (7 * 512, 1000, 512)])
def test_bucket_sizes_match(total, bucket, align):
    assert port.bucket_sizes(total, bucket, align) == \
        ref.bucket_sizes(total, bucket, align)


@pytest.mark.parametrize("axis,policy", [
    ("data", "int8"), (("data", "sharding"), "int4"),
    (("data", "sharding"), {"data": "int8"}),
    (("sharding", "data"), {"data": "bf16", "sharding": "int4"}),
    (("data", "sharding"), "fp32")])
def test_normalize_axis_policies_match(axis, policy):
    assert port.normalize_axis_policies(axis, policy) == \
        ref.normalize_axis_policies(axis, policy)


def test_bad_policies_raise_on_both_sides():
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.normalize_axis_policies("data", "fp8")
        with pytest.raises(ValueError):
            mod.normalize_axis_policies("data", {"data": "int2"})


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8", "int4"])
def test_wire_bytes_match(policy):
    for numel in (1 << 20, 124_475_904, 4096):
        for n in (1, 2, 4, 8):
            for block in (None, 64):
                assert port.wire_bytes_per_rank(numel, n, policy, block) == \
                    ref.wire_bytes_per_rank(numel, n, policy, block)
    rs = np.random.RandomState(0)
    tree = {"w": rs.randn(33, 7).astype(np.float32),
            "b": rs.randn(5).astype(ml_dtypes.bfloat16),
            "c": np.arange(3, dtype=np.int32)}
    for n in (1, 2, 4):
        assert port.tree_wire_bytes({k: _t(v) for k, v in tree.items()}, n,
                                    policy) == \
            ref.tree_wire_bytes({k: jnp.asarray(v) for k, v in tree.items()},
                                n, policy)
    fp32 = port.wire_bytes_per_rank(1 << 20, 4, "fp32")
    assert fp32 / port.wire_bytes_per_rank(1 << 20, 4, "int8") >= 3.5
    assert fp32 / port.wire_bytes_per_rank(1 << 20, 4, "int4") >= 7.0


# ---------------------------------------------------------------------------
# the exchange on a gloo world of one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo_world_of_one():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_no}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        port_mesh.set_mesh(None)


def _tree(seed):
    """Odd-length leaves in two float dtypes, an all-zero leaf and an
    integer counter; dict keys out of sorted order (both sides sort)."""
    rs = np.random.RandomState(seed)
    return {"w2": (rs.randn(31, 9) * 3).astype(np.float32),
            "a": rs.randn(77).astype(np.float32),
            "zero": np.zeros(130, np.float32),
            "h": rs.randn(3, 41).astype(ml_dtypes.bfloat16),
            "n": {"c": np.arange(4, dtype=np.int32),
                  "v": rs.randn(300).astype(np.float32)}}


def _res(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (rs.randn(*v.shape) * 0.01).astype(np.float32), tree)


def _ref_tree_mean(tree, axis, res, **kw):
    mesh = ref_build_mesh({"data": 1})
    fn = jax.jit(jax.shard_map(
        lambda t, r: ref.compressed_tree_mean(t, axis, residuals=r, **kw),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False))
    return fn(jax.tree_util.tree_map(jnp.asarray, tree),
              None if res is None else
              jax.tree_util.tree_map(jnp.asarray, res))


def _to_port(tree):
    return jax.tree_util.tree_map(_t, tree)


TREE_CASES = [(policy, res, block, bucket_bytes, axis)
              for policy in ("fp32", "bf16", "int8", "int4")
              for res in (False, True)
              for block, bucket_bytes in ((None, 4 << 20), (32, 1024))
              for axis in ("data",)]
TREE_CASES += [({"data": "int8"}, True, None, 2048, ("data", "sharding")),
               ({"sharding": "int4"}, True, 64, 4 << 20,
                ("data", "sharding")),
               ("int4", True, 64, 512, ("data", "sharding"))]


@pytest.mark.parametrize("policy,use_res,block,bucket_bytes,axis",
                         TREE_CASES)
def test_tree_mean_on_a_world_of_one_is_bit_identical(
        gloo_world_of_one, policy, use_res, block, bucket_bytes, axis):
    tree = _tree(5)
    res = _res(tree, 6) if use_res else None
    kw = dict(policy=policy, block=block, bucket_bytes=bucket_bytes)
    want, want_res = _ref_tree_mean(tree, axis, res, **kw)
    mesh = port_mesh.build_mesh({"data": 1}, group=dist.group.WORLD)
    got, got_res = port.compressed_tree_mean(
        _to_port(tree), axis, residuals=None if res is None else
        _to_port(res), mesh=mesh, **kw)
    quantized = "int" in str(policy)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            port.tree_flatten(got)[0]):
        if w.dtype == jnp.int32:      # the integer leaf: a plain mean
            np.testing.assert_array_equal(_np(g), np.asarray(w))
            continue
        _same_bits(g, w, jax.tree_util.keystr(path))
    if quantized:
        # one rank still quantizes: the mean is not the input
        assert not np.array_equal(_np(got["a"]), tree["a"])
    if res is None:
        assert got_res is None and want_res is None
        return
    x_eff = jax.tree_util.tree_map(
        lambda v, r: np.asarray(v).astype(np.float32) + r, tree, res)
    for (path, w), g, x in zip(
            jax.tree_util.tree_flatten_with_path(want_res)[0],
            port.tree_flatten(got_res)[0], jax.tree_util.tree_leaves(x_eff)):
        what = "residual " + jax.tree_util.keystr(path)
        if not quantized:             # passed through untouched
            _same_bits(g, w, what)
            continue
        # the residual is x - q*scale. Under jit XLA contracts that into
        # one fused multiply-add (one rounding) where the port rounds q*scale
        # first: they may differ by half an ulp of q*scale, |q*scale| <=
        # |x| + |residual|
        w = np.asarray(w)
        bound = 2.0 ** -24 * (np.abs(x) + np.abs(w))
        assert np.all(np.abs(_np(g) - w) <= bound), what
    if quantized:
        assert port.residual_norm(got_res) > 0
        np.testing.assert_allclose(port.residual_norm(got_res),
                                   ref.residual_norm(want_res), rtol=1e-6)


def test_tree_mean_with_an_unbound_axis_is_the_identity():
    port_mesh.set_mesh(None)
    tree = {"w": torch.ones(4)}
    out, res = port.compressed_tree_mean(tree, "data", policy="int8")
    assert out is tree and res is None
    with pytest.raises(ValueError):
        port.compressed_tree_mean(tree, "data", policy="fp8")
    with pytest.raises(ValueError):
        port.compressed_tree_mean(
            tree, "data", policy="int4", block=33,
            mesh=port_mesh.Mesh({"data": 1}))


def test_init_residuals_and_norm():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    res = port.init_residuals(tree)
    assert res["a"].dtype == torch.float32 and res["a"].shape == (3,)
    assert port.residual_norm(res) == 0.0
    res["b"][0] += 2.0
    assert port.residual_norm(res) == pytest.approx(np.sqrt(8.0))


SCATTER_CASES = [(policy, dim, use_res, block)
                 for policy in ("fp32", "bf16", "int8", "int4")
                 for dim in (0, 1)
                 for use_res in (False, True)
                 for block in (None,)]
SCATTER_CASES += [("int4", 1, True, 32), ("int8", 0, True, 64)]


@pytest.mark.parametrize("policy,dim,use_res,block", SCATTER_CASES)
def test_psum_scatter_on_a_world_of_one_is_bit_identical(
        gloo_world_of_one, policy, dim, use_res, block):
    rs = np.random.RandomState(11)
    x = (rs.randn(6, 45) * 2).astype(np.float32)
    r = (rs.randn(6, 45) * 0.01).astype(np.float32) if use_res else None
    mesh = ref_build_mesh({"data": 1})

    def body(xx, rr):
        return ref.compressed_psum_scatter(
            xx, "data", scatter_dim=dim, policy=policy, block=block,
            residual=rr)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                               out_specs=P(), check_vma=False))
    want = fn(jnp.asarray(x), None if r is None else jnp.asarray(r))
    got = port.compressed_psum_scatter(
        _t(x), "data", scatter_dim=dim, policy=policy, block=block,
        residual=None if r is None else _t(r),
        mesh=port_mesh.build_mesh({"data": 1}, group=dist.group.WORLD))
    if use_res:
        _same_bits(got[0], want[0], "sum")
        if policy in ("fp32", "bf16"):
            _same_bits(got[1], want[1], "residual")
        else:   # x - q*scale: the fused multiply-add bound, as above
            w = np.asarray(want[1])
            bound = 2.0 ** -24 * (np.abs(x + r) + np.abs(w))
            assert np.all(np.abs(_np(got[1]) - w) <= bound)
    else:
        _same_bits(got, want, "sum")
