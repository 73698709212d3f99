"""PyTorch + CUDA port of the deferred frame, for one NVIDIA H100 (sm_90a).

The JAX package ``tinyrenderer_tpu`` stays the reference; this package
mirrors its module names (``ops/raster.py``, ``ops/resolve.py``, ...,
``render/frame.py``, ``render/engine.py``) so each port module sits next
to its counterpart. It imports ``torch`` and never ``jax``: the shared
JAX-free modules of the reference (``config``, ``scene``, ``assets``,
``utils.math3d``, ``utils.verify``) are imported, never copied, and the
reference's ``render``, ``ops`` and ``parallel`` packages are never
imported.

Idiom: plain functions on tensors, dataclasses of tensors in place of the
JAX NamedTuple pytrees, and an explicit ``device`` everywhere (an
``Engine`` is built for one device and never guesses it). Nothing on this
path is learned or random, so there is no ``nn.Module``,
``torch.Generator`` or ``autograd.Function``.

The three TPU kernels of the slice (visibility raster, select + eval,
fused shading) are CUDA C++ kernels under ``csrc/``, built with ``nvcc``
into ``build/kernels/`` on their first CUDA launch (``kernels.py``). Each
wrapper runs its plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""
