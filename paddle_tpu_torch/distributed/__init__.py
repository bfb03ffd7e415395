"""paddle_tpu_torch.distributed — ``engine.ParallelTrainer`` (one device)."""
