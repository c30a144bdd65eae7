"""PyTorch/CUDA port of the PopPy serving stack for NVIDIA Hopper.

Mirrors the module names of ``repro`` (the JAX reference package) so each
counterpart is easy to find.  Nothing here imports ``jax`` or ``repro``:
what the port needs from the reference it keeps as its own copy.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; the
CPU runs only when the caller asks for it (the tests do).  Kernel wrappers
dispatch on the device of the tensors they are given: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the hand-written kernel
or raises.
"""

from .device import resolve_device  # noqa: F401
