"""Serving, meshes, tensor and data parallelism, the input pipeline and
fault tolerance.

The continuous-batching engine (:mod:`.serving`), the ``(data, model)``
mesh of ranks and its sharding rules (:mod:`.mesh`), tensor parallelism in
packed inference and in training (:mod:`.tensor_parallel`), the scaling
harness and its collective counts (:mod:`.scaling`), background device prefetch
(:mod:`.input_pipeline`), and failure detection and elastic recovery
(:mod:`.fault`). A mesh of more than one device is one process a rank over
``torch.distributed`` on gloo (:func:`init_distributed`).
"""
from .fault import (ElasticSupervisor, FaultInjector, HealthMonitor, Heartbeat, InjectedFault,
                    RestartEvent, StragglerDetected, TrainingDiverged, device_healthcheck)
from .input_pipeline import (PrefetchIterator, host_slice, prefetch_to_mesh,
                             shard_batch_to_mesh)
from .mesh import (Mesh, ShardedVariables, free_port, gather_variables, init_distributed,
                   make_mesh, shard_batch, shard_variables, spec_for_variables)
from .scaling import (CollectiveCounter, collective_stats, measure_scaling,
                      run_multiprocess_scaling)
from .serving import InferenceEngine
from .tensor_parallel import (all_reduce, gather_channels, identity_sum_grad,
                              rank_variables)

__all__ = [
    "make_mesh", "shard_variables", "spec_for_variables", "gather_variables", "rank_variables",
    "all_reduce", "gather_channels", "identity_sum_grad",
    "collective_stats", "measure_scaling", "run_multiprocess_scaling",
    "ElasticSupervisor", "FaultInjector", "HealthMonitor", "Heartbeat", "InjectedFault",
    "RestartEvent", "StragglerDetected", "TrainingDiverged", "device_healthcheck",
    "CollectiveCounter", "InferenceEngine", "Mesh", "PrefetchIterator", "ShardedVariables",
    "free_port", "host_slice", "init_distributed", "prefetch_to_mesh", "shard_batch",
    "shard_batch_to_mesh",
]
