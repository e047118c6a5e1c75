"""Serving, meshes, the input pipeline and fault tolerance.

The continuous-batching engine (:mod:`.serving`), the ``(data, model)``
mesh and its sharding rules (:mod:`.mesh`), background device prefetch
(:mod:`.input_pipeline`), and failure detection and elastic recovery
(:mod:`.fault`). Placement runs on a mesh of one device. What needs several
devices (tensor or data parallelism across cards, and the scaling harness
``collective_stats``, ``measure_scaling``, ``run_multiprocess_scaling``) is
not ported yet: those names raise (ROADMAP.md, queue 1 item 6).
"""
from ..utils.registry import not_ported
from .fault import (ElasticSupervisor, FaultInjector, HealthMonitor, Heartbeat, InjectedFault,
                    RestartEvent, StragglerDetected, TrainingDiverged, device_healthcheck)
from .input_pipeline import (PrefetchIterator, host_slice, prefetch_to_mesh,
                             shard_batch_to_mesh)
from .mesh import Mesh, make_mesh, shard_batch, shard_variables, spec_for_variables
from .serving import InferenceEngine

collective_stats = not_ported("collective_stats (the collectives of a multi-device run)", 6)
measure_scaling = not_ported("measure_scaling (1 -> N device scaling)", 6)
run_multiprocess_scaling = not_ported("run_multiprocess_scaling (multi-process scaling)", 6)

__all__ = [
    "make_mesh", "shard_variables", "spec_for_variables",
    "collective_stats", "measure_scaling", "run_multiprocess_scaling",
    "ElasticSupervisor", "FaultInjector", "HealthMonitor", "Heartbeat", "InjectedFault",
    "RestartEvent", "StragglerDetected", "TrainingDiverged", "device_healthcheck",
    "InferenceEngine", "Mesh", "PrefetchIterator", "host_slice", "prefetch_to_mesh",
    "shard_batch", "shard_batch_to_mesh",
]
