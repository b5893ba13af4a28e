"""Host copies of the JAX package's index builders and file formats."""
