"""miso_tpu_torch: the PyTorch/CUDA port of miso_tpu for one NVIDIA H100.

Same module layout and names as ``miso_tpu`` where a reader needs to find
a module's counterpart.  Plain tensor code is PyTorch; every Pallas TPU
kernel on a ported path is a CUDA C++ kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``).  Entry points take a
``device`` argument that defaults to ``"cuda"``; tests pass ``"cpu"``,
where each kernel wrapper runs its plain PyTorch version.

This package imports neither ``jax`` nor ``miso_tpu``.
"""

__version__ = "0.1.0"
