"""PyTorch/CUDA port of the coreset system (``repro``), one slice at a time.

The JAX package ``src/repro`` is the reference: every module here maps onto
its namesake there (``repro_torch.core.scoring`` ↔ ``repro.core.scoring``)
and is held against it by ``tests/test_torch_*.py``. This package imports
``torch``, ``numpy`` and ``scipy`` only — never ``jax`` or ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
