"""lfit_python_tpu_torch — the PyTorch / CUDA port of ``lfit_python_tpu``.

The same eclipsing-CV light-curve model, hierarchical posterior and
stretch-move ensemble sampler, written on PyTorch tensors for one NVIDIA
Hopper card.  The package mirrors the JAX package's layout (``models/``,
``roche/``, ``ops/``, ``sampling/``, ``examples.py``) so each module's
counterpart sits at the same path; the JAX package stays the reference
the port is tested against.

Batch dimensions are written out: where the JAX package nests ``vmap``s
over walkers and eclipses, the port's functions take ``(W, ...)`` and
``(W, E, ...)`` tensors.  Every tensor is built with an explicit dtype and
device.  The package never imports ``jax``.
"""

__version__ = "0.1.0"
