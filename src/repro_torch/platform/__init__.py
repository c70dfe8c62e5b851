"""HAI-Platform (port of ``repro/platform``; paper §VI-C, §VII): the
failure model, the time-sharing scheduler and SLO router, the node
validator and the fault-tolerant runner."""
from repro_torch.platform.failures import (FailureEvent, FailureInjector,
                                           FailureModel,
                                           SimulatedHardwareFailure)
from repro_torch.platform.runner import FTRunner, GangExit, RunReport
from repro_torch.platform.scheduler import (Cluster, Scheduler, ServingSLO,
                                            SLORouter, Task, slo_score)
from repro_torch.platform.validator import Validator

__all__ = ["FailureEvent", "FailureInjector", "FailureModel",
           "SimulatedHardwareFailure", "FTRunner", "GangExit", "RunReport",
           "Cluster", "Scheduler", "ServingSLO", "SLORouter", "Task",
           "Validator", "slo_score"]
