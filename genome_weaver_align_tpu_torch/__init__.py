"""genome_weaver_align_tpu_torch — the PyTorch/CUDA port of the aligner.

The JAX package ``genome_weaver_align_tpu`` beside it is the reference: each
module here keeps its counterpart's name, and the tests run both on the same
inputs.  The port imports ``torch`` and never JAX.  It shares the JAX
package's numpy-only ``utils`` and the ``native/`` C++ sources, and keeps
the on-disk formats (``.npz`` index, ``.seedN.npz`` seed table).

Layout:

- ``index``  — host copies of the index builders and file formats.
- ``ops``    — FM rank/occ/locate (``rank``), window gather, banded DP and
               Myers edit distance (plain torch + the hand-written CUDA
               kernels in ``csrc/banded_dp.cu`` and ``csrc/myers.cu``),
               host affine traceback.
- ``models`` — the suffix filter (FM pigeonhole and seed-table paths), the
               ``SuffixFilterAligner`` pipeline and the ``PairedAligner``.
- ``cli``    — ``index``, ``simulate`` and ``align`` (single-end and paired).
"""

__version__ = "0.1.0"
