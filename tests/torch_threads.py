"""Two torch threads for a port test file.

A file takes them with::

    from torch_threads import two_threads  # noqa: F401

which makes the module-scoped autouse fixture below its own: torch's
intra-op pool holds two threads while that file's tests run and gets its
old size back after them. The tests run under several pytest workers on
one host; beside the others, a torch pool as wide as the machine only
waits on its own threads (a bf16 GPT step that takes 0.05-0.09 s alone
took many times that under six workers with every core's thread).

Importing this module also sets the inter-op pool to two threads, which
torch allows once a process and only before any inter-op work; where that
has passed, the pool keeps its size. Spawned gloo workers are new
processes and pin their own threads.
"""
import pytest
import torch

THREADS = 2

try:
    torch.set_num_interop_threads(THREADS)
except RuntimeError:    # already set, or the inter-op pool has started
    pass


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)
