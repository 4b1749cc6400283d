"""Multi-host layer: a torch.distributed (gloo) group + the run's one collective."""

from denseflow_tpu_torch.parallel.distributed import allreduce_counters, init_distributed

__all__ = ["allreduce_counters", "init_distributed"]
