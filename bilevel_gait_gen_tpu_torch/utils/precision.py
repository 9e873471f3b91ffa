"""Float32 precision policy for the port.

The interior-point method breaks at reduced matmul precision: the condensed
Hessian has a natural scale of ~1e8, and rounding it to ~3 decimal digits
makes the equilibrated matrix indefinite (the JAX package's
``utils/precision.py`` records the same failure for the TPU's bf16 passes).
On Hopper the analogous trap is TF32, which keeps 10 mantissa bits.  PyTorch
leaves float32 matmuls at full precision by default but lets cuDNN use TF32,
so both switches are set explicitly here.
"""
from __future__ import annotations

import torch


def set_fp32_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN and check the matmul precision.

    Called on entry of ``solver.solve_step``, ``bilevel.gait_opt_update`` and
    ``chip_smoke.py``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {precision!r}; the interior-point "
            "solver needs 'highest' (torch.set_float32_matmul_precision)")
