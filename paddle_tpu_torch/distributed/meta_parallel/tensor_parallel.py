"""``TensorParallel`` (port of
``paddle_tpu/distributed/meta_parallel/tensor_parallel.py``; reference
``fleet/meta_parallel/tensor_parallel.py:25``).

Nothing is rewritten at wrap time: the Megatron layers
(``parallel_layers/mp_layers.py``) already hold their slices and issue
their collectives over the mesh's ``model`` group. The wrapper seeds the
``model_parallel_rng`` stream of the RNG tracker with ``100 + mp_rank``
(distinct dropout masks for split activations, the reference's
``random.py:24``), keeps the wrapped layer's parameter names and state,
and averages gradients over ``data`` in :meth:`sync_gradients` (the
trainer exchanges its own and does not call it)."""
from __future__ import annotations

from ...framework.random import get_rng_state_tracker
from ...nn.layer import Layer
from .hybrid_optimizer import data_mean

__all__ = ["TensorParallel"]


class TensorParallel(Layer):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        tracker = get_rng_state_tracker()
        if "model_parallel_rng" not in tracker.states_:
            tracker.add("model_parallel_rng",
                        100 + hcg.get_model_parallel_rank())

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            inner = self.__dict__.get("_modules", {}).get("_layers")
            if inner is None:
                raise
            return getattr(inner, name)

    def sync_gradients(self, grads: dict) -> dict:
        """The mean of each gradient over the mesh's ``data`` group."""
        return data_mean(grads)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def set_state_dict_from_numpy(self, state, mesh=None):
        return self._layers.set_state_dict_from_numpy(state, mesh)
