"""Serving, meshes, tensor and data parallelism, the input pipeline and
fault tolerance.

The continuous-batching engine (:mod:`.serving`), the ``(data, model)``
mesh of ranks and its sharding rules (:mod:`.mesh`), the tensor-parallel
packed forward (:mod:`.tensor_parallel`), the scaling harness and its
collective counts (:mod:`.scaling`), background device prefetch
(:mod:`.input_pipeline`), and failure detection and elastic recovery
(:mod:`.fault`). A mesh of more than one device is one process a rank over
``torch.distributed`` on gloo (:func:`init_distributed`).
"""
from .fault import (ElasticSupervisor, FaultInjector, HealthMonitor, Heartbeat, InjectedFault,
                    RestartEvent, StragglerDetected, TrainingDiverged, device_healthcheck)
from .input_pipeline import (PrefetchIterator, host_slice, prefetch_to_mesh,
                             shard_batch_to_mesh)
from .mesh import (Mesh, ShardedVariables, free_port, init_distributed, make_mesh, shard_batch,
                   shard_variables, spec_for_variables)
from .scaling import (CollectiveCounter, collective_stats, measure_scaling,
                      run_multiprocess_scaling)
from .serving import InferenceEngine

__all__ = [
    "make_mesh", "shard_variables", "spec_for_variables",
    "collective_stats", "measure_scaling", "run_multiprocess_scaling",
    "ElasticSupervisor", "FaultInjector", "HealthMonitor", "Heartbeat", "InjectedFault",
    "RestartEvent", "StragglerDetected", "TrainingDiverged", "device_healthcheck",
    "CollectiveCounter", "InferenceEngine", "Mesh", "PrefetchIterator", "ShardedVariables",
    "free_port", "host_slice", "init_distributed", "prefetch_to_mesh", "shard_batch",
    "shard_batch_to_mesh",
]
