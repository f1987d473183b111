"""The serving side of the port: the continuous-batching server and, in
front of it, the fleet — the router, the replica handles (in-process or a
worker process of its own) and the autoscalers."""
from .autoscale import (AutoscalePolicy, ElasticAutoscaler,
                        FleetAutoscaler, ScaleDecision, verify_replay)
from .fleet import RID_STRIDE, FleetRouter, ReplicaInfo
from .serving import GenerationServer
from .transport import (InProcessReplica, RemoteReplicaError,
                        ReplicaHandle, ReplicaTransportError,
                        SubprocessReplica)

__all__ = ["AutoscalePolicy", "ElasticAutoscaler", "FleetAutoscaler",
           "FleetRouter", "GenerationServer", "InProcessReplica",
           "RID_STRIDE", "RemoteReplicaError", "ReplicaHandle",
           "ReplicaInfo", "ReplicaTransportError", "ScaleDecision",
           "SubprocessReplica", "verify_replay"]
