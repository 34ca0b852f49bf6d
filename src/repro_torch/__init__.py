"""PyTorch/CUDA port of the serving path of the JAX package ``repro``.

The layout mirrors ``src/repro/``: ``configs``, ``models``, ``kernels``,
``policy``, ``monitoring``, ``serving``, ``launch``.  The port imports
``torch`` and never ``jax`` or anything of ``repro``; it keeps its own
copies of the JAX-free modules it needs.
"""
