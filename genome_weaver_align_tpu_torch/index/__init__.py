"""Host copies of the JAX package's index builders and file formats, the
device suffix-array builder and the wavelet rank backend."""

from . import build, device_build, files, kmer, multi, native, sais, wavelet  # noqa: F401
