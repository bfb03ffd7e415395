"""paddle_tpu_torch.nn.layers — ``activation``, ``common``, ``container``,
``conv``, ``loss``, ``norm``, ``pooling``, ``rnn``, ``transformer`` and
``vision``."""
