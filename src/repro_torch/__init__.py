"""NestQuant on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Subpackages mirror ``repro`` one to one (``core/packing.py`` answers to
``repro/core/packing.py`` and so on).  This package imports ``torch`` and
numpy, never ``jax`` and never ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
