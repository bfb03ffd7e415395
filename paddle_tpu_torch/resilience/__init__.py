"""paddle_tpu_torch.resilience — fault injection (``faults``) and the
byte-budgeted retry with backoff (``retry``)."""
