"""Print the per-rank bytes of ZeRO stages 0-3 at sharding 2, 4 and 8 for
GPT-base and gpt_1p3b (bf16 parameters; AdamW, float32 slots for GPT-base
and bfloat16 for gpt_1p3b, as bench.py trains them), computed from the
real leaves' shapes by ``zero_bytes_per_rank``:

    python -m paddle_tpu_torch.distributed.sharding

The models are built on the meta device: nothing is allocated."""
import torch

from ...optimizer import AdamW
from ...text.models import GPTForPretraining
from . import zero_bytes_per_rank

CONFIGS = {
    "GPT-base": (dict(hidden_size=768, num_layers=12, num_heads=12),
                 "float32"),
    "gpt_1p3b": (dict(hidden_size=2048, num_layers=24, num_heads=16),
                 "bfloat16"),
}


def main():
    print("| model | sharding | stage | params GiB | grads GiB | AdamW slots "
          "GiB | total GiB |")
    print("|---|---|---|---|---|---|---|")
    for name, (cfg, slot_dtype) in CONFIGS.items():
        with torch.device("meta"):
            model = GPTForPretraining(tensor_parallel=False, vocab_size=50304,
                                      max_position_embeddings=1024, **cfg)
        model = model.bfloat16()
        opt = AdamW(3e-4, slot_dtype=slot_dtype)
        for n in (2, 4, 8):
            for stage in (0, 1, 2, 3):
                b = zero_bytes_per_rank(model, opt, stage, n)
                gib = {k: v / 2 ** 30 for k, v in b.items()}
                print(f"| {name} | {n} | {stage} | {gib['params']:.3f} | "
                      f"{gib['grads']:.3f} | {gib['slots']:.3f} | "
                      f"{sum(gib.values()):.3f} |")


if __name__ == "__main__":
    main()
