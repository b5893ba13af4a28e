"""Interval sharding of the index on one device and data parallelism across
processes: the torch counterpart of the JAX package's ``parallel`` layer
(mesh, multi-process batches, sharded index and pipeline, ring merges)."""

from . import mesh, multihost, sharded_index, sharded_pipeline  # noqa: F401
