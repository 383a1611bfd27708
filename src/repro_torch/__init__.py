"""ZEUS on PyTorch and CUDA: a port of the JAX package `repro`.

The layout mirrors `repro` file for file (`repro_torch/core/zeus.py`
answers to `repro/core/zeus.py`). The port imports torch, numpy and the
standard library only, never JAX or `repro`; its tests hold it against the
JAX package through numpy (`repro_torch.interop`).
"""
