"""genome_weaver_align_tpu_torch — the PyTorch/CUDA port of the aligner.

The JAX package ``genome_weaver_align_tpu`` beside it is the reference: each
module here keeps its counterpart's name, and the tests run both on the same
inputs.  The port imports ``torch`` and never JAX.  It shares the JAX
package's numpy-only ``utils`` and the ``native/`` C++ sources, and keeps
the on-disk formats (``.npz`` index, ``.seedN.npz`` seed table).

Layout:

- ``index``  — host copies of the index builders and file formats.
- ``ops``    — window gather, banded DP (plain torch + the hand-written
               CUDA kernel in ``csrc/banded_dp.cu``), host affine traceback.
- ``models`` — the seed-table suffix filter and the ``SuffixFilterAligner``
               pipeline.
- ``cli``    — ``index``, ``simulate`` and ``align``.
"""

__version__ = "0.1.0"
