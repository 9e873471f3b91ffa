"""The yardstick of the kernels' roofline shares: the card's published
peaks and each kernel's operations and bytes from its shapes.  Frozen
copies of ``bilevel_gait_gen_tpu_torch/ops/kernel_checks.py``'s
``bound_ms``, ``gtwg_work``, ``sweep_work`` and ``bmv_work``, so that a
change of the program cannot move them; the benchmark's tests hold them
equal to the port's today."""
from __future__ import annotations

import math

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and device-memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gtwg_work(B: int, m: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of M = H + G^T W G + reg I at [B, m, n]: the
    triangle of the symmetric product, B m n (n + 1); H, G, lam and s read
    once, M written once."""
    return 1.0 * B * m * n * (n + 1), 4.0 * B * (2 * n * n + m * n + 2 * m)


def sweep_work(B: int, m: int, n: int, p: int,
               ns_steps: int) -> tuple[float, float, float]:
    """(operations of a sweep with its Newton-Schulz refresh, operations of
    the iteration alone, bytes) at [B, n, m, p]: the triangle of M, 2
    products per Newton-Schulz step, then the iteration's matrix-vector work
    (two directions with one refinement each: ~22 n^2 + 12 m n + 2 p n^2
    per problem).  A sweep reads H, G, A, Mi and the vectors once and writes
    Mi and the vectors; the exact sweep handed its M has the iteration's
    operations only and reads M too."""
    iter_flops = B * (22.0 * n * n + 12.0 * m * n + 2.0 * p * n * n)
    ns_flops = 2.0 * B * n ** 3
    nbytes = 4.0 * B * (3 * n * n + m * n + p * n + 4 * (n + p + 2 * m)
                        + 3 * m)
    return (gtwg_work(B, m, n)[0] + ns_steps * 2 * ns_flops + iter_flops,
            iter_flops, nbytes)


def bmv_work(x_shape, y_shape, item: int) -> tuple[float, float]:
    """(operations, bytes) of one ``kernels.bmv`` (X Y^T over the shared
    last axis, batch axes broadcast): 2 K a result entry; X and Y read once
    (a broadcast operand once, not once per scenario) and the result
    written once.  ``item``: bytes an element."""
    bx, by = tuple(x_shape[:-2]), tuple(y_shape[:-2])
    batch = _broadcast(bx, by)
    n_out = float(math.prod(batch)) * x_shape[-2] * y_shape[-2]
    return (2.0 * n_out * x_shape[-1],
            item * (math.prod(x_shape) + math.prod(y_shape) + n_out))


def _broadcast(a: tuple, b: tuple) -> tuple:
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + a, (1,) * (n - len(b)) + b
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ValueError(f"batch shapes {a} and {b} do not broadcast")
        out.append(max(x, y))
    return tuple(out)
