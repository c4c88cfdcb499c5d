"""MaskSearch on PyTorch + CUDA — the port of :mod:`repro` to one NVIDIA H100.

The layout mirrors ``src/repro/`` (``kernels/``, ``core/``, ``obs/``,
``data/``, ``lockcheck.py``) so each module's counterpart sits under the
same relative path.  The package imports ``torch`` and numpy only; every
hot-path kernel is CUDA C++ for ``sm_90a`` under ``kernels/csrc/``, built
with ``nvcc`` at first use and bound through ``ctypes``.

Entry points take a ``device`` argument that defaults to ``"cuda"``; on a
CPU tensor each kernel wrapper runs its plain PyTorch version instead
(``kernels/ref.py``), which is how the CPU tests exercise the same code.
"""
