"""Tensors from Python numbers without a copy from the host per call.

A tensor made from Python numbers (``torch.tensor``, ``torch.as_tensor``)
on the GPU is a copy from host memory: host time on every call, and an
operation that a CUDA graph capture refuses.  The per-call path takes its
constants from :func:`const` instead: the first call for a (value, dtype,
device) builds the tensor and every later call returns the same one, so
callers never write to it.  :func:`filled` turns an argument that may be a
tensor or a number into a tensor with a fill on the device.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    if device is None:
        raise ValueError("the reference needs its device named")
    return torch.device(device)


_BUILT: dict = {}


def _frozen(value):
    if isinstance(value, (list, tuple)):
        return tuple(_frozen(v) for v in value)
    return value


def filled(value, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` (a tensor or a number) as a tensor of ``shape`` on
    ``device``: a tensor is cast and expanded, a number filled in on the
    device rather than copied from the host."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device).expand(shape)
    return torch.full(shape, float(value), dtype=dtype, device=device)


def const(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, built at the
    first call and shared after it.  ``value`` is a number or a nested
    list or tuple of numbers (a configuration field as it is); ``device``
    is named by the caller.
    """
    key = (_frozen(value), dtype, resolve_device(device))
    t = _BUILT.get(key)
    if t is None:
        t = _BUILT[key] = torch.tensor(key[0], dtype=dtype, device=key[2])
    return t
