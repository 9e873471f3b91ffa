"""bilevel_gait_gen_tpu_torch: the bilevel-MPC gait generator in PyTorch.

A port of :mod:`bilevel_gait_gen_tpu` (JAX, written for a TPU) to PyTorch on
an NVIDIA Hopper GPU.  The layout mirrors the JAX package (``ops/``,
``models/``, ``mpc/``, ``utils/``) and keeps its function names, so each
counterpart is found by path.  Differences of idiom:

* batch first: every tensor carries the leading scenario dimension that
  ``jax.vmap`` added in the JAX package; the gait update's alpha lanes
  flatten to ``B * ls_alphas`` problems;
* ``lax.scan`` loops are Python loops;
* the two TPU kernels on the main path (``gtwg`` and ``ipm_iter``) are CUDA
  kernels written by hand (``csrc/``), built with ``nvcc`` at first use and
  bound with ``ctypes`` (``ops/kernels.py``); on CPU tensors their plain
  PyTorch versions run instead.

Importing this package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
