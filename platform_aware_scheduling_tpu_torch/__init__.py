"""PyTorch/CUDA port of ``platform_aware_scheduling_tpu``.

The layout mirrors the JAX package (``ops/``, ``models/``, ``tas/``,
``kube/``, ``utils/``) so each counterpart is found by path.  Tensors are
native ``torch.int64`` where the JAX package splits int64 into 32-bit
limbs.  Entry points take a ``device`` argument that defaults to
``"cuda"`` and raise when no GPU is present (``utils/device.py``); the
CPU runs the plain PyTorch versions only when asked for explicitly.

The port imports neither ``jax`` nor the JAX package.
"""
