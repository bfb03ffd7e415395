"""paddle_tpu_torch.resilience — the fault-resilient training runtime.

- ``faults``: deterministic fault injection (every recovery path has a
  reproducible trigger);
- ``retry``: jittered exponential backoff with a byte budget at the I/O
  seams;
- ``guard``: the fused all-finite check of the in-step NaN guard;
- ``runner``: ``run_resilient``: auto-resume, the SIGTERM/SIGINT drain,
  the in-process restart after a crash mid-commit, the elastic restart,
  divergence rollback and the hang watchdog;
- ``elastic``: the coordinated restore barrier, remesh and residual
  remap, ``ElasticRuntime``; ``hostsim`` runs N subprocess hosts over the
  file-backed membership on one machine;
- ``integrity``: replica fingerprints, the quarantine vote, content
  digests of the checkpoint's deep tier, step replay and the hang
  watchdog.
"""
from . import faults  # noqa: F401
from .elastic import (CoordinatorTimeout, ElasticRuntime,  # noqa: F401
                      FileCoordinator, coordinated_restore,
                      data_parallel_remesh_fn, remap_comm_err,
                      reshard_trainer)
from .faults import HostLost, SimulatedCrash, inject  # noqa: F401
from .guard import all_finite, all_finite_value  # noqa: F401
from .integrity import (HangWatchdog, compare_digests,  # noqa: F401
                        count_fingerprint_collectives, inject_param_flip,
                        quarantine_outliers, replay_step, tree_digests)
from .retry import RetryBytesExhausted, call_with_retry, retry  # noqa: F401
from .runner import RunResult, run_resilient  # noqa: F401

__all__ = ["faults", "SimulatedCrash", "HostLost", "inject", "all_finite",
           "all_finite_value", "retry", "call_with_retry",
           "RetryBytesExhausted", "RunResult", "run_resilient",
           "CoordinatorTimeout", "FileCoordinator", "coordinated_restore",
           "remap_comm_err", "reshard_trainer", "ElasticRuntime",
           "data_parallel_remesh_fn", "HangWatchdog", "tree_digests",
           "compare_digests", "count_fingerprint_collectives",
           "inject_param_flip", "quarantine_outliers", "replay_step"]
