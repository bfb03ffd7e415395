"""paddle_tpu_torch.ops — hand-written Hopper kernels and their wrappers.

``paged_attention`` holds the paged decode/verify kernel
(``csrc/paged_attention.cu``); ``flash_attention`` the flash-attention
forward, dq and dk/dv kernels (``csrc/flash_attention.cu``);
``chunked_ce`` the chunked LM-head cross entropy (plain PyTorch);
``_build`` compiles kernels with nvcc at first use; ``tuner`` keeps the
shape buckets, the flash rows of the tuning DB and the fallback counter.
"""
