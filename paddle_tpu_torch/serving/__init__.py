"""Serving path of the port: KV caches, sampling, the prefix cache, the
tokenizer and constraints, overload control, and the engine."""
from .constrained import (ConstraintCursor, TokenConstraint,
                          compile_constraint, compile_regex, schema_to_regex)
from .engine import (GenerationRequest, InferenceEngine, QueueFull,
                     ReplicaEvacuated, WatchdogTripped)
from .kv_cache import KVCache, PagedKVCache, cache_insert
from .overload import OverloadController
from .prefix_cache import RadixPrefixCache
from .sampling import sample_tokens_streams, spec_accept
from .tokenizer import ByteTokenizer, StreamDetokenizer

__all__ = ["ByteTokenizer", "ConstraintCursor", "GenerationRequest",
           "InferenceEngine", "KVCache", "OverloadController",
           "PagedKVCache", "QueueFull", "RadixPrefixCache",
           "ReplicaEvacuated", "StreamDetokenizer", "TokenConstraint",
           "WatchdogTripped", "cache_insert", "compile_constraint",
           "compile_regex", "sample_tokens_streams", "schema_to_regex",
           "spec_accept"]
