"""Failure detection and elastic recovery (:mod:`.fault`). The JAX
package's meshes, sharding, input pipeline, serving and scaling are not
ported yet (ROADMAP.md, queue 1 item 6)."""
from .fault import (ElasticSupervisor, FaultInjector, HealthMonitor, Heartbeat, InjectedFault,
                    RestartEvent, StragglerDetected, TrainingDiverged, device_healthcheck)

__all__ = [
    "ElasticSupervisor", "FaultInjector", "HealthMonitor", "Heartbeat", "InjectedFault",
    "RestartEvent", "StragglerDetected", "TrainingDiverged", "device_healthcheck",
]
