"""Serving path of the port: KV caches, sampling, the prefix cache, the
tokenizer and constraints, overload control, the engine, the in-process
orchestration over it (the replica router with failover, the replica
supervisor, the HTTP front end), and the cross-host fleet (the RPC
transport, host agents, remote replicas and the fleet router with
disaggregated prefill -> decode KV streaming)."""
from .constrained import (ConstraintCursor, TokenConstraint,
                          compile_constraint, compile_regex, schema_to_regex)
from .engine import (GenerationRequest, InferenceEngine, QueueFull,
                     ReplicaEvacuated, WatchdogTripped)
from .kv_cache import KVCache, PagedKVCache, cache_insert
from .lifecycle import ReplicaFailed, ReplicaSupervisor
from .overload import OverloadController
from .pod import (ArrivalRateForecaster, FleetRegistry, FleetRouter,
                  FleetScheduler, HostAgent, RemoteReplica,
                  RemoteReplicaError, connect_fleet)
from .prefix_cache import RadixPrefixCache
from .router import EngineRouter
from .rpc import RpcClient, RpcError, RpcRemoteError, RpcServer
from .sampling import sample_tokens_streams, spec_accept
from .tokenizer import ByteTokenizer, StreamDetokenizer

__all__ = ["ArrivalRateForecaster", "ByteTokenizer", "ConstraintCursor",
           "EngineRouter", "FleetRegistry", "FleetRouter", "FleetScheduler",
           "GenerationRequest", "HostAgent", "InferenceEngine", "KVCache",
           "OverloadController", "PagedKVCache", "QueueFull",
           "RadixPrefixCache", "RemoteReplica", "RemoteReplicaError",
           "ReplicaEvacuated", "ReplicaFailed", "ReplicaSupervisor",
           "RpcClient", "RpcError", "RpcRemoteError", "RpcServer",
           "ServingFrontend", "StreamDetokenizer", "Tenant",
           "TokenConstraint", "WatchdogTripped", "cache_insert",
           "compile_constraint", "compile_regex", "connect_fleet",
           "sample_tokens_streams", "schema_to_regex", "spec_accept"]


def __getattr__(name):
    # the front end loads on first use, so that
    # ``python -m paddle_tpu_torch.serving.frontend`` runs its module once
    if name in ("ServingFrontend", "Tenant"):
        from . import frontend
        return getattr(frontend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
