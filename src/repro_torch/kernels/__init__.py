"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel.

Each subpackage keeps the JAX package's three-part contract
(``docs/KERNELS.md``): the kernel body (here CUDA C++ in ``repro_torch/csrc``),
``ref.py`` — the plain PyTorch version, which is the CPU path and the
yardstick the kernel is held against — and ``ops.py``, the wrapper that pads,
checks and dispatches: a CUDA tensor launches the kernel (or the wrapper
raises), a CPU tensor runs ``ref.py``. Each wrapper counts its launches in a
module-level ``LAUNCHES`` integer.
"""
