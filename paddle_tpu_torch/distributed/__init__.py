"""Distributed support of the port (a subset of ``paddle_tpu.distributed``):
the shared-directory key-value store that the serving fleet's registry
keeps its host records in. The elastic trainer, the collectives and the
launcher are not ported yet."""
from .elastic import FileKVStore

__all__ = ["FileKVStore"]
