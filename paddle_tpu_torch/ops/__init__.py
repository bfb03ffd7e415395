"""paddle_tpu_torch.ops — hand-written Hopper kernels and their wrappers.

``paged_attention`` holds the paged decode/verify kernel
(``csrc/paged_attention.cu``); ``flash_attention`` the flash-attention
forward, dq and dk/dv kernels (``csrc/flash_attention.cu``);
``fused_ce`` the fused LM-head cross-entropy forward, dh and dw kernels
(``csrc/fused_ce.cu``); ``chunked_ce`` the chunked LM-head cross entropy
(plain PyTorch); ``_build`` compiles kernels with nvcc at first use;
``tuner`` keeps the tuning DB (the reference's rows and the port's split
counts measured on the card), its sweep and the fallback counter.
"""
