"""The port's hand-written CUDA kernels on the card, held against their
plain PyTorch versions. Every test here needs a CUDA device and skips
without one.

This file imports neither JAX nor ``paddle_tpu`` (the machine with the
card has no JAX), so it runs there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: atol = rtol = 1e-4 (float32 math in both versions, sums taken
in different orders; bfloat16 pools are upcast exactly by both). The flash
kernels' bfloat16 cases: 2e-2 (one bfloat16 rounding of each output; on
the tensor-core forward also of p before P·V), on both forward routes. The
fused-CE kernels: lse and tgt atol 1e-4; dh and dw ``max|err| <= tol *
max|plain|`` with tol 1e-4 in float32, 1e-2 in bfloat16.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.inference import decode_model as dm
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.kv_cache import PagedKVCache
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _case(dev, d, tq, dtype, b=6, h=3, ps=16, pool=64, width=8, seed=0):
    rs = np.random.RandomState(seed)
    lens = np.asarray([0, 1, 15, 16, 17, 999][:b], np.int32)
    tables = np.stack([rs.permutation(pool)[:width] for _ in range(b)])
    for i, n in enumerate(lens):
        used = -(-min(int(n), width * ps) // ps)
        tables[i, used:] = -1 if i % 2 else pool + 7
    f = lambda *s: torch.as_tensor(  # noqa: E731
        rs.randn(*s).astype(np.float32), device=dev)
    return (f(b, tq, h, d), f(pool, ps, h, d).to(dtype),
            f(pool, ps, h, d).to(dtype),
            torch.as_tensor(tables.astype(np.int32), device=dev),
            torch.as_tensor(lens, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tq", [1, 2, 4, 5, 8, 16, 32])
def test_kernel_matches_plain(cuda_device, tq, d, dtype):
    args = _case(cuda_device, d, tq, dtype, seed=d + tq)
    key = "decode" if tq == 1 else "verify"
    n0 = pa.LAUNCHES[key]
    got = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[key] == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    # the empty row: l == 0 and acc == 0, never NaN
    assert got[2][0].abs().max().item() == 0.0
    assert got[0][0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, kp, vp, tables, lens = _case(cuda_device, 64, 1, torch.float32)
    with pytest.raises(ValueError):            # head_dim the gate rejects
        pa.paged_attention(q[..., :48], kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), tables, lens)
    with pytest.raises(ValueError):            # non-contiguous pool
        pa.paged_attention(q, kp.transpose(0, 1).contiguous().transpose(0, 1),
                           vp, tables, lens)
    with pytest.raises(ValueError):            # mixed pool types
        pa.paged_attention(q, kp, vp.to(torch.bfloat16), tables, lens)
    with pytest.raises(ValueError):            # pool on another device
        pa.paged_attention(q, kp.cpu(), vp, tables, lens)


def _routes(r0):
    return {k: pa.ROUTES[k] - r0[k] for k in pa.ROUTES
            if pa.ROUTES[k] != r0[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [1, 2, 5, 32])
@pytest.mark.parametrize("splits", [1, 2, 3, 8, 11])
def test_split_route_matches_plain_at_every_split_count(cuda_device, splits,
                                                        tq, dtype):
    # 8 = the table's width, 11 more than it: the extra splits are empty
    args = _case(cuda_device, 64, tq, dtype, seed=100 + splits + tq)
    r0 = dict(pa.ROUTES)
    got = pa.paged_attention(*args, splits=splits)
    want = pa.paged_attention_plain(*args)
    model = pa.paged_attention_split_plain(*args, splits)
    torch.cuda.synchronize()
    assert _routes(r0) == {("decode" if tq == 1 else "verify") + "_split": 1}
    for g, w, mo in zip(got, want, model):
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, mo, **TOL)
    # the empty row: every split empty, m = NEG_INF, l = 0, acc = 0
    assert (got[1][0] == pa.NEG_INF).all().item()
    assert got[2][0].abs().max().item() == 0.0
    assert got[0][0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("tq", [1, 8, 32])
def test_split_route_matches_plain_at_other_head_dims(cuda_device, tq, d,
                                                      dtype):
    args = _case(cuda_device, d, tq, dtype, seed=200 + d + tq)
    for splits in (1, 3):
        got = pa.paged_attention(*args, splits=splits)
        want = pa.paged_attention_plain(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)


def _main_shape(dev, tq, dtype, b=8, h=12, d=64, ps=16, pool=2048, width=64,
                ctx=1024, seed=0):
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.as_tensor(  # noqa: E731
        rs.randn(*s).astype(np.float32), device=dev)
    tables = np.stack([rs.permutation(pool)[:width] for _ in range(b)])
    return (f(b, tq, h, d), f(pool, ps, h, d).to(dtype),
            f(pool, ps, h, d).to(dtype),
            torch.as_tensor(tables.astype(np.int32), device=dev),
            torch.full((b,), ctx, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5, 32])
def test_split_route_is_bit_reproducible(cuda_device, tq):
    args = _main_shape(cuda_device, tq, torch.float32)
    first = [t.clone() for t in pa.paged_attention(*args)]
    for _ in range(3):
        again = pa.paged_attention(*args)
        for f, a in zip(first, again):
            assert torch.equal(f, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [1, 5, 32])
def test_split_route_never_reads_outside_the_used_pages(cuda_device, tq,
                                                        dtype):
    # every pool slot that no row's context reaches holds NaN: unused
    # pages, and the tail of each row's last page
    q, kp, vp, tables, lens = _case(cuda_device, 64, tq, dtype, seed=7 + tq)
    ps = kp.shape[1]
    used = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda_device)
    for row, n in zip(tables.tolist(), lens.tolist()):
        n = min(n, len(row) * ps)
        for pos in range(n):
            used[row[pos // ps], pos % ps] = True
    nan_k = torch.where(used[..., None, None], kp, float("nan")).to(dtype)
    nan_v = torch.where(used[..., None, None], vp, float("nan")).to(dtype)
    want = pa.paged_attention_plain(q, kp, vp, tables, lens)
    for splits in (1, 3, 11):
        got = pa.paged_attention(q, nan_k, nan_v, tables, lens,
                                 route="split", splits=splits)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all().item(), splits
            torch.testing.assert_close(g, w, **TOL)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5])
def test_misaligned_pool_takes_the_simple_route(cuda_device, tq):
    q, kp, vp, tables, lens = _case(cuda_device, 64, tq, torch.float32,
                                    seed=3)
    key = "decode" if tq == 1 else "verify"
    for args in ((q, _misaligned(kp), vp), (q, kp, _misaligned(vp)),
                 (_misaligned(q), kp, vp)):
        r0 = dict(pa.ROUTES)
        got = pa.paged_attention(*args, tables, lens)
        assert _routes(r0) == {f"{key}_simple": 1}
        for g, w in zip(got, pa.paged_attention_plain(q, kp, vp, tables,
                                                      lens)):
            torch.testing.assert_close(g, w, **TOL)
        with pytest.raises(ValueError):        # the split route refuses it
            pa.paged_attention(*args, tables, lens, route="split")
    assert pa.paged_route(torch.float32, 64, False) == "simple"


@pytest.mark.cuda
def test_split_wrapper_rejects_what_neither_route_takes(cuda_device):
    q, kp, vp, tables, lens = _case(cuda_device, 64, 1, torch.float32)
    with pytest.raises(ValueError):            # float16 pools
        pa.paged_attention(q, kp.half(), vp.half(), tables, lens)
    with pytest.raises(ValueError):            # no such route
        pa.paged_attention(q, kp, vp, tables, lens, route="gather")
    with pytest.raises(ValueError):            # no split
        pa.paged_attention(q, kp, vp, tables, lens, splits=0)
    with pytest.raises(ValueError):            # splits on the simple route
        pa.paged_attention(q, kp, vp, tables, lens, route="simple",
                           splits=2)
    with pytest.raises(ValueError):            # Tq past the kernels' 32
        pa.paged_attention(torch.zeros(6, 33, 3, 64, device=cuda_device),
                           kp, vp, tables, lens)


@pytest.mark.cuda
def test_decode_server_on_card_matches_oracle(cuda_device):
    params = dm.params_from_jax(
        dm.init_decode_model(vocab=128, num_heads=2, head_dim=32, seed=7))
    system = [int(t) for t in np.random.RandomState(11).randint(0, 128, 8)]
    prompts = [system + [int(t) for t in np.random.RandomState(100 + i)
                         .randint(0, 128, 4)] for i in range(4)]
    cache = PagedKVCache(64, 8, 2, 32)
    step = dm.make_step_fn(params, cache)
    srv = serving.DecodeServer(
        step, cache, replicas=2,
        config=serving.ServingConfig(max_batch=32, call_timeout_s=30.0),
        prefill_chunk=8, max_pages_per_seq=8)
    n0 = dict(pa.LAUNCHES)
    with srv:
        reqs = [srv.submit_generate(p, 6) for p in prompts]
        for p, r in zip(prompts, reqs):
            assert [int(t) for t in r.result(timeout=120)[0]] \
                == dm.dense_generate(params, p, 6)
        assert srv.accounted()
    assert pa.LAUNCHES["decode"] > n0["decode"]


# -- flash attention: forward, dq and dk/dv kernels ---------------------------

FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the tensor-core forward beside FLASH_TOL, as chip_smoke.py holds it:
# ||out - plain|| / ||plain|| over the whole output and max |lse - plain|
MMA_FWD_BOUND = {"out_rel": 8e-3, "lse_abs": 5e-6}
# the tensor-core dq and dk/dv, as chip_smoke.py holds them: ||g - plain||
# / ||plain|| of each gradient (set from tests/test_torch_flash_bwd_rounding.py)
MMA_BWD_BOUND = {"dq_rel": 1e-2, "dk_rel": 1e-2, "dv_rel": 1e-2}


def _mma_fwd_within_bound(out, lse, ref_out, ref_lse):
    o, r = out.float(), ref_out.float()
    rel = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    assert rel <= MMA_FWD_BOUND["out_rel"], rel
    assert (lse - ref_lse).abs().max().item() <= MMA_FWD_BOUND["lse_abs"]


def _mma_bwd_within_bound(grads, ref):
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        g, r = g.float(), r.float()
        rel = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        assert rel <= MMA_BWD_BOUND[f"{name}_rel"], (name, rel)


def _route_counts(r0):
    """The launches on each flash route since ``r0`` (a copy of ROUTES),
    the routes with none left out."""
    return {k: n - r0[k] for k, n in fa.ROUTES.items() if n != r0[k]}


def _flash_inputs(dev, s, d, dtype, b=2, h=4, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.as_tensor(rs.randn(b, s, h, d).astype(np.float32),
                            device=dev).to(dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (s, d, causal, lens, torch.float32, 0.0)
    for s in (128, 200, 1024) for d in (64, 128) for causal in (True, False)
    for lens in (None, "s37")] + [
    (200, 64, True, [0, 37], torch.float32, 0.0),
    (200, 128, True, "s37", torch.bfloat16, 0.0),
    (1024, 64, False, "s37", torch.bfloat16, 0.0),
    (256, 64, True, None, torch.float32, 0.1),
    (1024, 64, True, None, torch.bfloat16, 0.1)])
def test_flash_kernels_match_plain(cuda_device, case):
    s, d, causal, lens, dtype, rate = case
    q, k, v, do = _flash_inputs(cuda_device, s, d, dtype, seed=s + d)
    if lens == "s37":
        lens = [s, 37]
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda_device)
    blocks = fa.keying_blocks(dtype, d, s, s)
    n0, r0 = dict(fa.LAUNCHES), dict(fa.ROUTES)
    qg, kg, vg = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(qg, kg, vg, causal=causal, kv_lens=ln,
                             dropout_rate=rate, dropout_seed=7)
    out.backward(do)
    _, lse = fa.flash_attention_fwd(q, k, v, ln, 7, None, causal, rate,
                                    blocks)
    ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, ln, 7, None,
                                                    causal, rate, blocks)
    ref = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse, do, ln, 7,
                                       None, causal, rate, blocks)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": n0["flash_fwd"] + 2,
                           "flash_dq": n0["flash_dq"] + 1,
                           "flash_dkv": n0["flash_dkv"] + 1}
    route = "mma" if dtype == torch.bfloat16 else "scalar"
    assert _route_counts(r0) == {f"flash_fwd_{route}": 2,
                                 f"flash_dq_{route}": 1,
                                 f"flash_dkv_{route}": 1}
    for g, r in zip((out, lse, qg.grad, kg.grad, vg.grad),
                    (ref_out, ref_lse, *ref)):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(), **FLASH_TOL[dtype])
    if lens is not None and 0 in lens:
        row = lens.index(0)       # no visible key: out 0, lse 0, no K/V grad
        assert out[row].abs().max().item() == 0.0
        assert lse[row].abs().max().item() == 0.0
        assert kg.grad[row].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_kernels_match_plain_on_the_qkv_split(cuda_device):
    """The main path's call: GPT-base (B=8, H=12, S=1024, D=64), bf16,
    causal, no kv_lens, no dropout; q, k and v are the strided views that
    GPTAttention's per-head QKV split makes, read by the kernels in place."""
    b, s, h, d = 8, 1024, 12, 64
    rs = np.random.RandomState(1)
    qkv = torch.as_tensor(rs.randn(b, s, h, 3 * d).astype(np.float32),
                          device=cuda_device).to(torch.bfloat16)
    do = torch.as_tensor(rs.randn(b, s, h, d).astype(np.float32),
                         device=cuda_device).to(torch.bfloat16)
    q, k, v = torch.split(qkv, d, dim=-1)
    assert not q.is_contiguous() and q.stride(2) == 3 * d
    qkv_g = qkv.clone().requires_grad_()
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_attention(*torch.split(qkv_g, d, dim=-1), causal=True)
    (grad,) = torch.autograd.grad(out, (qkv_g,), do)
    blocks = fa.keying_blocks(q.dtype, d, s, s)
    _, lse = fa.flash_attention_fwd(q, k, v, None, 0, None, True, 0.0, blocks)
    ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, None, 0, None,
                                                    True, 0.0, blocks)
    ref = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse, do, None, 0,
                                       None, True, 0.0, blocks)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": n0["flash_fwd"] + 2,
                           "flash_dq": n0["flash_dq"] + 1,
                           "flash_dkv": n0["flash_dkv"] + 1}
    for g, r in zip((out, lse, *torch.split(grad, d, dim=-1)),
                    (ref_out, ref_lse, *ref)):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(),
                                   **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (s, d, causal, lens, 0.0)
    for s in (128, 200, 1024) for d in (64, 128) for causal in (True, False)
    for lens in (None, "s37", [0, 37])] + [
    (1024, 64, True, None, 0.1), (1024, 128, False, "s37", 0.1)])
def test_flash_mma_forward_matches_plain(cuda_device, case):
    """The tensor-core forward (bfloat16, D = 64 and 128) against the plain
    forward, and the scalar kernel on the same inputs, over the cases of
    test_flash_kernels_match_plain in bfloat16; ROUTES shows each route."""
    s, d, causal, lens, rate = case
    q, k, v, _ = _flash_inputs(cuda_device, s, d, torch.bfloat16,
                               seed=s + d + 1)
    if lens == "s37":
        lens = [s, 37]
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda_device)
    blocks = fa.keying_blocks(torch.bfloat16, d, s, s)
    r0 = dict(fa.ROUTES)
    args = (q, k, v, ln, 7, None, causal, rate, blocks)
    out, lse = fa.flash_attention_fwd(*args)
    s_out, s_lse = fa.flash_attention_fwd(*args, route="scalar")
    ref_out, ref_lse = fa.flash_attention_plain_fwd(*args)
    torch.cuda.synchronize()
    assert _route_counts(r0) == {"flash_fwd_mma": 1, "flash_fwd_scalar": 1}
    for g, r in ((out, ref_out), (lse, ref_lse), (s_out, ref_out),
                 (s_lse, ref_lse)):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(),
                                   **FLASH_TOL[torch.bfloat16])
    _mma_fwd_within_bound(out, lse, ref_out, ref_lse)
    if lens is not None and 0 in lens:
        row = lens.index(0)       # no visible key: out 0, lse 0
        assert out[row].abs().max().item() == 0.0
        assert lse[row].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_mma_forward_on_the_qkv_split_is_bit_reproducible(cuda_device):
    """The main path's call (GPT-base, bf16, causal, the QKV split's strided
    views) takes the tensor-core route, agrees with the plain forward, and
    two launches give the same bits."""
    b, s, h, d = 8, 1024, 12, 64
    rs = np.random.RandomState(2)
    qkv = torch.as_tensor(rs.randn(b, s, h, 3 * d).astype(np.float32),
                          device=cuda_device).to(torch.bfloat16)
    q, k, v = torch.split(qkv, d, dim=-1)
    blocks = fa.keying_blocks(q.dtype, d, s, s)
    r0 = dict(fa.ROUTES)
    args = (q, k, v, None, 0, None, True, 0.0, blocks)
    out, lse = fa.flash_attention_fwd(*args)
    out2, lse2 = fa.flash_attention_fwd(*args)
    ref_out, ref_lse = fa.flash_attention_plain_fwd(*args)
    torch.cuda.synchronize()
    assert fa.ROUTES["flash_fwd_mma"] == r0["flash_fwd_mma"] + 2
    assert fa.ROUTES["flash_fwd_scalar"] == r0["flash_fwd_scalar"]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.bfloat16])
    _mma_fwd_within_bound(out, lse, ref_out, ref_lse)


@pytest.mark.cuda
def test_flash_forward_routes_on_the_card(cuda_device):
    """float32, D = 256 and rows off 16-byte boundaries take the scalar
    kernel; asking for the mma route there raises, with no launch."""
    r0 = dict(fa.ROUTES)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k, v, _ = _flash_inputs(cuda_device, 128, d, dtype)
        fa.flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match="route"):
            fa.flash_attention_fwd(q, k, v, route="mma")
    wide = torch.zeros(2, 128, 4, 72, dtype=torch.bfloat16,
                       device=cuda_device)
    q = wide[..., :64]                       # h stride 72: aligned
    odd = torch.zeros(2, 128, 4, 68, dtype=torch.bfloat16,
                      device=cuda_device)[..., :64]    # h stride 68
    fa.flash_attention_fwd(q, q, q)
    fa.flash_attention_fwd(odd, odd, odd)
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention_fwd(odd, odd, odd, route="mma")
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention_fwd(q, q, q, route="wgmma")
    torch.cuda.synchronize()
    assert _route_counts(r0) == {"flash_fwd_mma": 1, "flash_fwd_scalar": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (s, d, causal, lens, 0.0)
    for s in (128, 200, 1024) for d in (64, 128) for causal in (True, False)
    for lens in (None, "s37", [0, 37])] + [
    (1024, 64, True, None, 0.1), (1024, 128, False, "s37", 0.1),
    (200, 64, True, [0, 37], 0.1)])
def test_flash_mma_backward_matches_plain(cuda_device, case):
    """The tensor-core dq and dk/dv (bfloat16, D = 64 and 128) on the mma
    forward's out and lse, against the plain backward on the plain
    forward's, and the scalar kernels on the same inputs beside them."""
    s, d, causal, lens, rate = case
    q, k, v, do = _flash_inputs(cuda_device, s, d, torch.bfloat16,
                                seed=s + d + 2)
    if lens == "s37":
        lens = [s, 37]
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda_device)
    blocks = fa.keying_blocks(torch.bfloat16, d, s, s)
    rest = (ln, 7, None, causal, rate, blocks)
    r0 = dict(fa.ROUTES)
    out, lse = fa.flash_attention_fwd(q, k, v, *rest)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, *rest)
    scalar = fa.flash_attention_bwd(q, k, v, out, lse, do, *rest,
                                    route="scalar")
    ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, *rest)
    ref = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse, do, *rest)
    torch.cuda.synchronize()
    assert _route_counts(r0) == {"flash_fwd_mma": 1, "flash_dq_mma": 1,
                                 "flash_dkv_mma": 1, "flash_dq_scalar": 1,
                                 "flash_dkv_scalar": 1}
    for g, r in zip((*grads, *scalar), (*ref, *ref)):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(),
                                   **FLASH_TOL[torch.bfloat16])
    _mma_bwd_within_bound(grads, ref)
    if lens is not None and 0 in lens:
        row = lens.index(0)       # no visible key: no gradient at all
        for g in grads:
            assert g[row].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_mma_backward_on_the_qkv_split_is_bit_reproducible(cuda_device):
    """The main path's call (GPT-base, bf16, causal, the QKV split's strided
    views) runs dq and dk/dv on the tensor-core route, agrees with the plain
    backward, and two launches give the same bits."""
    b, s, h, d = 8, 1024, 12, 64
    rs = np.random.RandomState(3)
    qkv = torch.as_tensor(rs.randn(b, s, h, 3 * d).astype(np.float32),
                          device=cuda_device).to(torch.bfloat16)
    do = torch.as_tensor(rs.randn(b, s, h, d).astype(np.float32),
                         device=cuda_device).to(torch.bfloat16)
    q, k, v = torch.split(qkv, d, dim=-1)
    rest = (None, 0, None, True, 0.0, fa.keying_blocks(q.dtype, d, s, s))
    out, lse = fa.flash_attention_fwd(q, k, v, *rest)
    r0 = dict(fa.ROUTES)
    once = fa.flash_attention_bwd(q, k, v, out, lse, do, *rest)
    twice = fa.flash_attention_bwd(q, k, v, out, lse, do, *rest)
    ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, *rest)
    ref = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse, do, *rest)
    torch.cuda.synchronize()
    assert _route_counts(r0) == {"flash_dq_mma": 2, "flash_dkv_mma": 2}
    assert all(torch.equal(a, b) for a, b in zip(once, twice))
    for g, r in zip(once, ref):
        torch.testing.assert_close(g.float(), r.float(),
                                   **FLASH_TOL[torch.bfloat16])
    _mma_bwd_within_bound(once, ref)


def _call_bwd_entry(entry, q, k, v, do, lse, delta, outs, bf16):
    """A backward C entry called as _launch_bwd calls it; its return code."""
    b, s, h, d = q.shape
    lib = fa.load_kernel()
    return getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        fa._strides(q, k, v, do), lse.data_ptr(), delta.data_ptr(),
        *[o.data_ptr() for o in outs], None, None, b, h, s, s, d, bf16,
        d ** -0.5, 1, 0, 0, 1.0, 1, 1,
        torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
def test_flash_backward_routes_on_the_card(cuda_device):
    """float32, D = 256 and a do off 16-byte boundaries take the scalar
    dq and dk/dv; asking for the mma route there raises, with no launch;
    the mma C entries refuse them too (cudaErrorInvalidValue, no launch)."""
    r0 = dict(fa.ROUTES)
    lse = torch.zeros(2, 4, 128, device=cuda_device)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k, v, do = _flash_inputs(cuda_device, 128, d, dtype)
        fa.flash_attention_bwd(q, k, v, q, lse, do, causal=True)
        with pytest.raises(ValueError, match="route"):
            fa.flash_attention_bwd(q, k, v, q, lse, do, route="mma")
    q, k, v, _ = _flash_inputs(cuda_device, 128, 64, torch.bfloat16)
    odd_do = torch.zeros(2, 128, 4, 68, dtype=torch.bfloat16,
                         device=cuda_device)[..., :64]      # h stride 68
    fa.flash_attention_bwd(q, k, v, q, lse, odd_do, causal=True)
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention_bwd(q, k, v, q, lse, odd_do, route="mma")
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention_bwd(q, k, v, q, lse, q, route="wgmma")
    torch.cuda.synchronize()
    assert _route_counts(r0) == {"flash_dq_scalar": 3, "flash_dkv_scalar": 3}
    dq, dk, dv = (torch.full_like(q, 7.0) for _ in range(3))
    f32 = [x.float() for x in (q, k, v, q)]
    for entry, outs in (("flash_attention_dq_mma", (dq,)),
                        ("flash_attention_dkv_mma", (dk, dv))):
        assert _call_bwd_entry(entry, q, k, v, odd_do, lse, lse, outs, 1) == 1
        assert _call_bwd_entry(entry, *f32, lse, lse,
                               [o.float() for o in outs], 0) == 1
    torch.cuda.synchronize()
    assert all((o == 7.0).all() for o in (dq, dk, dv))


@pytest.mark.cuda
def test_float16_attention_and_head_loss_fall_back_and_count(cuda_device):
    """float16 has no kernel: scaled_dot_product_attention takes the plain
    attention and fused_linear_cross_entropy(kernel="auto") the chunked
    CE, each counting one fallback instead of raising."""
    from paddle_tpu_torch.nn.functional.attention import _xla_attention
    from paddle_tpu_torch.ops import tuner
    q, k, v, _ = _flash_inputs(cuda_device, 512, 64, torch.float16)
    n0, l0 = tuner.FALLBACKS["flash_attention"], dict(fa.LAUNCHES)
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert tuner.FALLBACKS["flash_attention"] == n0 + 1
    assert fa.LAUNCHES == l0
    assert torch.equal(out, _xla_attention(q, k, v, causal=True))
    hid, w, lbl, _ = _ce_inputs(cuda_device, 64, 32, 300, torch.float16)
    c0, cl0 = tuner.FALLBACKS["fused_ce"], dict(fused_ce.LAUNCHES)
    loss = F.fused_linear_cross_entropy(hid, w, lbl, kernel="auto")
    assert tuner.FALLBACKS["fused_ce"] == c0 + 1
    assert fused_ce.LAUNCHES == cl0
    want = F.fused_linear_cross_entropy(hid, w, lbl, kernel="chunked")
    assert torch.equal(loss, want)
    wb = w.to(torch.bfloat16)                 # mixed dtypes: chunked too
    F.fused_linear_cross_entropy(hid.to(torch.float32), wb, lbl,
                                 kernel="auto")
    assert tuner.FALLBACKS["fused_ce"] == c0 + 2


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    q, k, v, do = _flash_inputs(cuda_device, 128, 64, torch.float32)
    with pytest.raises(ValueError):            # a CPU tensor among CUDA ones
        fa.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, q, torch.zeros(2, 4, 128,
                                                       device=cuda_device),
                               do.cpu())
    q96, k96, v96, _ = _flash_inputs(cuda_device, 128, 96, torch.float32)
    with pytest.raises(ValueError):            # head_dim the kernels lack
        fa.flash_attention(q96, k96, v96)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, dropout_rate=-0.5)
    with pytest.raises(ValueError):            # mixed dtypes
        fa.flash_attention_fwd(q, k.to(torch.bfloat16), v)
    assert fa.flash_supported(q, k) and not fa.flash_supported(q96, k96)


@pytest.mark.cuda
def test_sdpa_dropout_runs_the_kernel_with_a_device_seed(cuda_device):
    """The GPT attention path on the card: the gate sends S >= 512 to the
    kernels, whose dropout seed is drawn on the card's generator; re-seeding
    reproduces it, and the plain version with that seed agrees."""
    q, k, v, _ = _flash_inputs(cuda_device, 512, 64, torch.float32)
    n0 = dict(fa.LAUNCHES)
    framework.seed(3)
    out = scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                       is_causal=True)
    framework.seed(3)
    seed = framework.draw_seed(cuda_device)
    again = scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                         is_causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == n0["flash_fwd"] + 2
    assert not torch.equal(out, again)      # the generator moved on
    blocks = fa.keying_blocks(q.dtype, 64, 512, 512)
    ref, _ = fa.flash_attention_plain_fwd(q, k, v, None, int(seed), None,
                                          True, 0.1, blocks)
    torch.testing.assert_close(out, ref, **FLASH_TOL[torch.float32])
    undropped = scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                             is_causal=True, training=False)
    assert not torch.equal(out, undropped)


# -- fused LM-head cross entropy: forward, dh and dw kernels ------------------

# max|kernel - plain| <= tol * max|plain| for dh and dw; lse and tgt atol
CE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _ce_inputs(dev, n, h, v, dtype, ignore=0.3, transposed=False, seed=0):
    rs = np.random.RandomState(seed)
    hid = torch.as_tensor(rs.randn(n, h).astype(np.float32),
                          device=dev).to(dtype)
    w = torch.as_tensor((rs.randn(v, h) * 0.05).astype(np.float32),
                        device=dev).to(dtype)
    w = w.T if transposed else w.T.contiguous()
    lbl = rs.randint(0, v, n)
    lbl[rs.rand(n) < ignore] = -100
    lbl = torch.as_tensor(lbl, device=dev)
    valid = (lbl != -100).float()
    return hid, w, lbl, valid / valid.sum().clamp(min=1.0)


def _ce_check(hid, w, lbl, scale, dtype):
    n0 = dict(fused_ce.LAUNCHES)
    r0 = dict(fused_ce.ROUTES)
    lse, tgt = fused_ce.ce_fwd(hid, w, lbl)
    rl, rt = fused_ce.fused_ce_plain_fwd(hid, w, lbl)
    dh = fused_ce.ce_dh(hid, w, lbl, rl, scale)
    dw = fused_ce.ce_dw(hid, w, lbl, rl, scale)
    rdh = fused_ce.fused_ce_plain_dh(hid, w, lbl, rl, scale)
    rdw = fused_ce.fused_ce_plain_dw(hid, w, lbl, rl, scale)
    torch.cuda.synchronize()
    assert fused_ce.LAUNCHES == {k: n0[k] + 1 for k in n0}
    fwd = fused_ce.fwd_route(dtype, hid.shape[1])
    route = fused_ce.bwd_route(dtype, hid.shape[1])
    assert fused_ce.ROUTES == {
        k: r0[k] + (k in (f"ce_fwd_{fwd}", f"ce_dh_{route}",
                          f"ce_dw_{route}")) for k in r0}
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tgt, rt, rtol=1e-5, atol=1e-4)
    assert dh.dtype == hid.dtype and dw.dtype == w.dtype
    assert dw.shape == w.shape
    tol = CE_TOL[dtype]
    for got, want in ((dh, rdh), (dw, rdw)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), err
    ignored = lbl == -100
    assert dh[ignored].abs().max().item() == 0.0 if ignored.any() else True
    return dh, dw


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 64, 512), (200, 32, 500),
                                   (1000, 768, 50304), (300, 2048, 5000),
                                   (1000, 768, 5003), (257, 1024, 50304),
                                   (31, 768, 77)])
def test_fused_ce_kernels_match_plain(cuda_device, shape, dtype, transposed):
    """bfloat16 at H = 768 and 1024 takes the tiled route (N not a multiple
    of its 32 rows, V not a multiple of 32 in the last three); the rest
    the staged route."""
    args = _ce_inputs(cuda_device, *shape, dtype, transposed=transposed,
                      seed=sum(shape))
    _ce_check(*args, dtype)


@pytest.mark.cuda
def test_fused_ce_tiled_route_is_bit_reproducible(cuda_device):
    hid, w, lbl, scale = _ce_inputs(cuda_device, 1000, 768, 5003,
                                    torch.bfloat16, transposed=True)
    lse, _ = fused_ce.ce_fwd(hid, w, lbl)
    first = (fused_ce.ce_dh(hid, w, lbl, lse, scale),
             fused_ce.ce_dw(hid, w, lbl, lse, scale))
    second = (fused_ce.ce_dh(hid, w, lbl, lse, scale),
              fused_ce.ce_dw(hid, w, lbl, lse, scale))
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_fused_ce_tiled_route_rejects_misaligned_rows(cuda_device):
    hid, w, lbl, scale = _ce_inputs(cuda_device, 64, 768, 300,
                                    torch.bfloat16, transposed=True)
    flat = torch.empty(64 * 768 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    odd = flat[1:].view(64, 768)                  # 2 bytes past a boundary
    odd.copy_(hid)
    assert odd.is_contiguous()
    n0 = dict(fused_ce.ROUTES)
    with pytest.raises(ValueError, match="16-byte"):
        fused_ce.ce_dh(odd, w, lbl, scale, scale)
    assert fused_ce.ROUTES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_of_range", [
    ((128, 64, 512), False), ((129, 768, 5003), False),
    ((300, 768, 700), False), ((1000, 768, 5003), True),
    ((257, 1024, 50304), False), ((300, 2048, 5000), True),
    ((8192, 768, 50304), False)])
def test_fused_ce_tiled_forward_matches_plain(cuda_device, shape,
                                              out_of_range):
    """bf16 at H a multiple of 64: lse and tgt of the split-vocabulary
    kernel within atol 1e-4 of the plain version (and of the float32 model
    of its split-and-merge); labels V + 3 and -5 give tgt 0."""
    n, h, v = shape
    hid, w, lbl, _ = _ce_inputs(cuda_device, n, h, v, torch.bfloat16,
                                transposed=True, seed=sum(shape))
    if out_of_range:
        lbl[1::11] = v + 3
        lbl[2::13] = -5
    r0 = dict(fused_ce.ROUTES)
    lse, tgt = fused_ce.ce_fwd(hid, w, lbl)
    assert fused_ce.ROUTES["ce_fwd_tiled"] == r0["ce_fwd_tiled"] + 1
    rl, rt = fused_ce.fused_ce_plain_fwd(hid, w, lbl)
    # the count the wrapper took: the tuning DB's row, else the formula
    splits = fused_ce.tiled_splits(
        torch.bfloat16, n, h, v, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count)
    ml, mt = fused_ce.fused_ce_plain_fwd_split(hid, w, lbl, splits)
    for got, want in ((lse, rl), (tgt, rt), (lse, ml), (tgt, mt)):
        assert (got - want).abs().max().item() <= 1e-4
    bad = (lbl == v + 3) | (lbl == -5)
    assert bad.any() == out_of_range and (tgt[bad] == 0).all()


@pytest.mark.cuda
def test_fused_ce_tiled_forward_is_bit_reproducible(cuda_device):
    hid, w, lbl, _ = _ce_inputs(cuda_device, 1000, 768, 50304,
                                torch.bfloat16, transposed=True)
    first = fused_ce.ce_fwd(hid, w, lbl)
    second = fused_ce.ce_fwd(hid, w, lbl)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_fused_ce_tiled_forward_refuses_what_it_does_not_take(cuda_device):
    """The C entry refuses splits outside [1, vocab tiles], float32 and H
    not a multiple of 64; the wrapper refuses misaligned rows."""
    hid, w, lbl, _ = _ce_inputs(cuda_device, 64, 768, 300, torch.bfloat16,
                                transposed=True)
    lib = fused_ce.load_kernel()
    lse, tgt = torch.empty(64, device=cuda_device), torch.empty(
        64, device=cuda_device)
    work = torch.empty(3 * 4 * 64, device=cuda_device)
    lbl32 = lbl.to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream

    def call(h=768, bf16=1, splits=1):
        return lib.fused_ce_fwd_tiled(
            hid.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
            lbl32.data_ptr(), lse.data_ptr(), tgt.data_ptr(),
            work.data_ptr(), 64, h, 300, bf16, splits, stream)

    assert call() == 0
    assert call(splits=0) != 0 and call(splits=4) != 0   # 3 vocab tiles
    assert call(bf16=0) != 0 and call(h=736) != 0
    flat = torch.empty(64 * 768 + 1, dtype=torch.bfloat16, device=cuda_device)
    odd = flat[1:].view(64, 768)
    odd.copy_(hid)
    n0 = dict(fused_ce.ROUTES)
    with pytest.raises(ValueError, match="16-byte"):
        fused_ce.ce_fwd(odd, w, lbl)
    assert fused_ce.ROUTES == n0


@pytest.mark.cuda
def test_fused_ce_staged_limits_match_the_library(cuda_device):
    lib = fused_ce.load_kernel()
    assert lib.fused_ce_max_hidden(1) == \
        fused_ce.STAGED_MAX_HIDDEN[torch.bfloat16]
    assert lib.fused_ce_max_hidden(0) == \
        fused_ce.STAGED_MAX_HIDDEN[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h", [(torch.float32, 32),
                                     (torch.bfloat16, 768),
                                     (torch.bfloat16, 1024)])
@pytest.mark.parametrize("ignore", [0.0, 1.0])
def test_fused_ce_kernels_with_no_and_all_rows_ignored(cuda_device, ignore,
                                                       dtype, h):
    args = _ce_inputs(cuda_device, 200, h, 500, dtype, ignore=ignore,
                      transposed=h > 32)
    dh, dw = _ce_check(*args, dtype)
    if ignore == 1.0:
        assert not dh.any() and not dw.any()
        hid, w, lbl, _ = args
        hg = hid.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        loss = fused_ce.fused_lm_ce(hg, ww, lbl)
        loss.backward()
        assert loss.item() == 0.0
        assert not hg.grad.any() and not ww.grad.any()


@pytest.mark.cuda
def test_fused_ce_kernels_on_the_main_path_call(cuda_device):
    """GPT-base's head: N = 8192, H = 768, V = 50304, bf16, w the tied
    embedding's .T view, through the autograd Function."""
    hid, w, lbl, scale = _ce_inputs(cuda_device, 8192, 768, 50304,
                                    torch.bfloat16, ignore=0.0,
                                    transposed=True)
    _ce_check(hid, w, lbl, scale, torch.bfloat16)
    emb = w.T.clone().requires_grad_()
    h = hid.clone().requires_grad_()
    r0 = dict(fused_ce.ROUTES)
    loss = fused_ce.fused_lm_ce(h, emb.T, lbl)
    loss.backward()
    assert {k: fused_ce.ROUTES[k] - r0[k] for k in r0} == {
        "ce_fwd_tiled": 1, "ce_fwd_staged": 0, "ce_dh_tiled": 1,
        "ce_dh_staged": 0, "ce_dw_tiled": 1, "ce_dw_staged": 0}
    ref = torch.nn.functional.cross_entropy(hid.float() @ w.float(), lbl)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)
    assert emb.grad.is_contiguous() and emb.grad.shape == (50304, 768)


@pytest.mark.cuda
def test_fused_ce_failed_load_raises(cuda_device, monkeypatch):
    hid, w, lbl, _ = _ce_inputs(cuda_device, 64, 32, 300, torch.float32)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(fused_ce, "_lib", None)
    monkeypatch.setattr(fused_ce._build, "load", broken)
    n0 = dict(fused_ce.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_ce.fused_lm_ce(hid, w, lbl)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        F.fused_linear_cross_entropy(hid, w, lbl, kernel="auto")
    assert fused_ce.LAUNCHES == n0


@pytest.mark.cuda
def test_fused_ce_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    hid, w, lbl, scale = _ce_inputs(cuda_device, 64, 32, 300, torch.float32)
    with pytest.raises(ValueError):               # mixed dtypes
        fused_ce.ce_fwd(hid, w.to(torch.bfloat16), lbl)
    with pytest.raises(ValueError):               # w on the CPU
        fused_ce.ce_fwd(hid, w.cpu(), lbl)
    with pytest.raises(ValueError):               # H the kernels lack room for
        big = torch.zeros(4, 4096, device=cuda_device)
        fused_ce.ce_fwd(big, torch.zeros(4096, 8, device=cuda_device),
                        lbl[:4])
    assert fused_ce.fused_ce_supported(hid, w)
