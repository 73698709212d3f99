"""PyTorch + CUDA port of the deferred frame, for one NVIDIA H100 (sm_90a).

The JAX package ``tinyrenderer_tpu`` stays the reference; this package
mirrors its module names (``ops/raster.py``, ``ops/resolve.py``, ...,
``render/frame.py``, ``render/engine.py``) so each port module sits next
to its counterpart. It imports ``torch`` and never ``jax``, and nothing of
the JAX package: it keeps its own copies of the reference's JAX-free
modules under the same relative paths (``config``, ``editor.params``,
``scene``, ``assets``, ``utils.math3d``, ``utils.verify``).

Idiom: plain functions on tensors, dataclasses of tensors in place of the
JAX NamedTuple pytrees, and an explicit ``device`` everywhere (an
``Engine`` is built for one device and never guesses it). Nothing on this
path is learned or random, so there is no ``nn.Module``,
``torch.Generator`` or ``autograd.Function``.

Every TPU kernel of the reference (K1-K7: the visibility rasters, select
+ eval, fused shading, the fused raster + resolve and the windowed texel
blend) is a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` into
``build/kernels/`` on its first CUDA launch (``kernels.py``). Each wrapper
runs its plain PyTorch version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
