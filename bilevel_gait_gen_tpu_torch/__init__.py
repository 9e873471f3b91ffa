"""bilevel_gait_gen_tpu_torch: the bilevel-MPC gait generator in PyTorch.

A port of :mod:`bilevel_gait_gen_tpu` (JAX, written for a TPU) to PyTorch on
an NVIDIA Hopper GPU.  The layout mirrors the JAX package (``ops/``,
``models/``, ``mpc/``, ``utils/``) and keeps its function names, so each
counterpart is found by path.  Differences of idiom:

* batch first: every tensor carries the leading scenario dimension that
  ``jax.vmap`` added in the JAX package; the gait update's alpha lanes
  flatten to ``B * ls_alphas`` problems;
* ``lax.scan`` loops are Python loops;
* the three TPU kernels (``gtwg``, ``ipm_iter`` and ``gj_inverse``) are CUDA
  kernels written by hand (``csrc/``), built with ``nvcc`` at first use and
  bound with ``ctypes`` (``ops/kernels.py``); on CPU tensors their plain
  PyTorch versions run instead;
* entry points that create tensors (``problem.make_problem``,
  ``models.a1.make_a1``, ``mpc.gait.make_trot`` / ``make_standing``,
  ``convert.from_*``) put them on the GPU unless the caller passes
  ``device`` (:func:`default_device`); the CPU tests pass ``device="cpu"``.

Importing this package imports ``torch`` and never ``jax``, and nothing of
the JAX package.
"""
import torch

__version__ = "0.2.0"


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none: the CUDA
    device.  Raises when there is none; nothing carries on on the CPU
    unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: bilevel_gait_gen_tpu_torch runs on the GPU by "
            "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means
    :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
