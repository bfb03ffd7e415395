"""The ring's gradient accumulators, modelled on the CPU at the card's
sequence, head width and chunking, and the bars ``chip_smoke.py`` holds
the ring to in ``hybrid`` (h3).

The ring's backward sums each block's dq, dk and dv, each its kernel's
output rounded to bfloat16 once, in float32 accumulators
(``ops/ring_attention.py``). ``chip_smoke`` checks that design two ways:

- ``ring_block_sums``: the ring's gradients equal, bit for bit, the
  float32 sums in the ring's order of its blocks' outputs computed one by
  one;
- ``ring_grad_bar``: against the whole-sequence backward on the ring's own
  out and lse, the relative L2 error is within ``RING_ROUNDING`` (the RMS
  bound of one bf16 rounding) times ``sqrt(sum_j ||g_j||**2 / ||g||**2 +
  2)``: the block outputs' roundings and the two results', independent.

Here the blocks are the kernels' plain versions (the CPU twin: float32
inside, the output rounded to bf16), on bf16 inputs made from a numpy
seed: B 1, S 4096, H 1, D 64, four chunks of 1024 (the card's S, D and
chunks; 1 of its 48 batch-heads), causal and not. The float32 ring meets
both checks. The same ring with its accumulators kept in bfloat16 (each
partial sum rounded) fails the first on every gradient. It stays under
the second: at four chunks the partial sums' roundings add up to a third
to the error (``PYTHONPATH=. python tests/test_torch_ring_rounding.py``
prints the readings), less than the bar's headroom over real data, whose
ulps are on average smaller than the bound's 2**-7 of the value. That is
why the exact check exists.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ring_attention as ra

SHAPE = (1, 4096, 1, 64)
N = chip_smoke.RING_CHUNKS
NAMES = ("dq", "dk", "dv")


def _inputs():
    rs = np.random.RandomState(0)
    return tuple(torch.from_numpy(rs.randn(*SHAPE).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(4))


def _bf16_accumulator_ring(q, k, v, do, out, lse, causal):
    """The ring's backward with its dq, dk and dv accumulators in
    bfloat16: ``ring_attention_local``'s block steps in its order."""
    sm_scale = ra._scale(q.shape[-1], None)
    qs, ks, vs, dos, outs = (t.chunk(N, dim=1) for t in (q, k, v, do, out))
    lses = [t.contiguous() for t in lse.chunk(N, dim=2)]
    acc = [[torch.zeros(t.shape, dtype=torch.bfloat16) for t in ts]
           for ts in (qs, ks, vs)]
    for j in range(N):
        for i in range(N):
            src = (i - j) % N
            ra._bwd_step(qs[i], ks[src], vs[src], dos[i], lses[i],
                         ra._delta(outs[i], dos[i]), i, src, causal,
                         sm_scale, acc[0][i], acc[1][src], acc[2][src])
    return tuple(torch.cat(a, dim=1) for a in acc)


def _rel(a, w):
    return float((a.float() - w.float()).norm() / w.float().norm())


@functools.lru_cache(maxsize=None)
def readings(causal):
    """Per gradient: the float32 ring's and the bf16-accumulator ring's
    errors against the block sums and the whole-sequence backward, and
    the bar."""
    q, k, v, do = _inputs()
    out, lse, grads = ra.ring_attention_local(q, k, v, N, causal, do=do)
    whole = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    sums, block_sq = chip_smoke.ring_block_sums(ra, q, k, v, do, out, lse,
                                                N, causal)
    bf16 = _bf16_accumulator_ring(q, k, v, do, out, lse, causal)
    return {x: {"f32_equal_sums": torch.equal(g, s),
                "bf16_vs_sums": _rel(b, s),
                "f32_vs_whole": _rel(g, w), "bf16_vs_whole": _rel(b, w),
                "bar": chip_smoke.ring_grad_bar(sq, w)}
            for x, g, b, s, w, sq in zip(NAMES, grads, bf16, sums, whole,
                                         block_sq)}


@pytest.mark.parametrize("causal", [False, True])
def test_float32_accumulators_give_the_block_sums_within_the_bar(causal):
    for x, r in readings(causal).items():
        assert r["f32_equal_sums"], x
        assert r["f32_vs_whole"] <= r["bar"], (x, r)
        # the readings are the roundings' own, not zero
        assert r["f32_vs_whole"] > 1e-3, (x, r)


@pytest.mark.parametrize("causal", [False, True])
def test_a_bf16_accumulator_fails_the_block_sums(causal):
    for x, r in readings(causal).items():
        assert r["bf16_vs_sums"] > 5e-4, (x, r)
        assert r["bf16_vs_whole"] > r["f32_vs_whole"], (x, r)


if __name__ == "__main__":
    torch.set_num_threads(4)
    for c in (True, False):
        for name, r in readings(c).items():
            print("causal" if c else "full", name,
                  {k: (round(v, 7) if isinstance(v, float) else v)
                   for k, v in r.items()})
