"""Host utilities of the port: copies of the JAX package's ``utils``
modules, which the tests pin to the originals (``log`` profiles with
``torch.profiler`` instead of ``jax.profiler``)."""

from . import bitvector, config, dna, fasta, larray, log, packing, sam, simulate  # noqa: F401
