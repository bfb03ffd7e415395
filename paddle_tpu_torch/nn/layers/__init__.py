"""paddle_tpu_torch.nn.layers — ``common``, ``container`` and ``norm``."""
