"""Serving path of the port: KV caches, sampling, the prefix cache, the
tokenizer and constraints, overload control, the engine, and the
in-process orchestration over it: the replica router with failover, the
replica supervisor, and the HTTP front end."""
from .constrained import (ConstraintCursor, TokenConstraint,
                          compile_constraint, compile_regex, schema_to_regex)
from .engine import (GenerationRequest, InferenceEngine, QueueFull,
                     ReplicaEvacuated, WatchdogTripped)
from .kv_cache import KVCache, PagedKVCache, cache_insert
from .lifecycle import ReplicaFailed, ReplicaSupervisor
from .overload import OverloadController
from .prefix_cache import RadixPrefixCache
from .router import EngineRouter
from .sampling import sample_tokens_streams, spec_accept
from .tokenizer import ByteTokenizer, StreamDetokenizer

__all__ = ["ByteTokenizer", "ConstraintCursor", "EngineRouter",
           "GenerationRequest", "InferenceEngine", "KVCache",
           "OverloadController", "PagedKVCache", "QueueFull",
           "RadixPrefixCache", "ReplicaEvacuated", "ReplicaFailed",
           "ReplicaSupervisor", "ServingFrontend", "StreamDetokenizer",
           "Tenant", "TokenConstraint", "WatchdogTripped", "cache_insert", "compile_constraint",
           "compile_regex", "sample_tokens_streams", "schema_to_regex",
           "spec_accept"]


def __getattr__(name):
    # the front end loads on first use, so that
    # ``python -m paddle_tpu_torch.serving.frontend`` runs its module once
    if name in ("ServingFrontend", "Tenant"):
        from . import frontend
        return getattr(frontend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
