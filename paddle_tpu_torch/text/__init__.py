"""paddle_tpu_torch.text — text models (``models``)."""
