"""Parallel execution plans of the port (one device so far)."""
from repro_torch.parallel.plan import ParallelPlan, init_state, \
    make_train_step

__all__ = ["ParallelPlan", "init_state", "make_train_step"]
