"""Interval sharding of the index on one device: the torch counterpart of
the JAX package's ``parallel`` layer (mesh, sharded index and pipeline,
ring merges)."""
