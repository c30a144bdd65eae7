"""Hand-written Hopper kernels, one subpackage per TPU kernel ported.

Each subpackage holds ``ops.py`` (the wrapper: checks, launch, launch
counter), ``ref.py`` (the plain PyTorch version the wrapper takes for CPU
tensors) and ``csrc/`` (the CUDA source, built by :mod:`._build`).
"""
