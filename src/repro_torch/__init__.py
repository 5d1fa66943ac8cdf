"""PyTorch/CUDA port of the vector-join system (``repro`` is the JAX reference).

Module paths mirror ``repro``: ``core`` (types, index build, OOD flags,
traversal, exact join), ``kernels`` (hand-written CUDA kernels and their
plain PyTorch versions), ``engine`` (wave runners and ``JoinEngine``),
``configs``, ``launch``, ``data`` and ``obs``. The package imports torch
and numpy only.
"""
