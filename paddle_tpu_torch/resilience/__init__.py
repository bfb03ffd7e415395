"""paddle_tpu_torch.resilience — fault injection (``faults``), the
byte-budgeted retry with backoff (``retry``), the in-step finite check
(``guard``) and the content digests of the checkpoint's deep tier
(``integrity``)."""
