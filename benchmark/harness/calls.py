"""The hand-written kernels' calls of one eager run, recorded at the
port's wrapper boundary (``ops/kernels.py``: ``gtwg`` and ``ipm_iter`` as
``ops/pdip.py`` calls them, ``bmv`` as ``utils/jnp_compat.py`` calls it),
each kind of call replayed alone as a CUDA graph and set against the least
time its operations and bytes allow (``harness/work.py``).

A kind of call is a kernel with its shapes (and for ``ipm_iter`` its
refresh and whether it was handed M); the run's calls of one kind are
counted, and the first is kept to be timed.  A roofline share over a run
is then sum(count x bound) / sum(count x time): a later PR that changes
what implements a wrapper reads the same count and the same bounds.
"""
from __future__ import annotations

import torch

from benchmark.harness import trace, work

IPM_STATE = (7, 8, 9, 10, 12)   # x, y, lam, s, it: written by a sweep
IPM_BEST = 13                    # the best iterate, written too


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        return tuple(_clone(b) for b in a)
    return a


def _fresh(args):
    """A recorded ``ipm_iter`` call with clones of what the sweep writes."""
    out = list(args)
    for i in IPM_STATE:
        out[i] = args[i].clone()
    out[IPM_BEST] = tuple(b.clone() for b in args[IPM_BEST])
    return out


def _shape_key(t: torch.Tensor) -> tuple:
    return tuple(t.shape), tuple(t.stride()), str(t.dtype)


def record(fn, kinds=("gtwg", "ipm_iter", "bmv")) -> dict:
    """Run ``fn`` eagerly with recording stand-ins for the kernels module
    in ``ops/pdip.py`` and ``utils/jnp_compat.py``.  Returns
    {key: [count, args, kwargs]}, key = (kernel, shapes...)."""
    from bilevel_gait_gen_tpu_torch.ops import kernels, pdip
    from bilevel_gait_gen_tpu_torch.utils import jnp_compat
    calls: dict = {}

    def keep(key, args, kw, clone):
        rec = calls.get(key)
        if rec is None:
            calls[key] = [1, [_clone(a) for a in args] if clone else
                          list(args), dict(kw)]
        else:
            rec[0] += 1

    class Recorder:
        def __getattr__(self, name):
            return getattr(kernels, name)

        def gtwg(self, H, G, *args, **kw):
            if "gtwg" in kinds:
                keep(("gtwg", tuple(G.shape)), (H, G) + args,
                     {k: _clone(v) for k, v in kw.items()}, True)
            return kernels.gtwg(H, G, *args, **kw)

        def ipm_iter(self, *args, **kw):
            if "ipm_iter" in kinds:
                keep(("ipm_iter", tuple(args[4].shape), tuple(args[2].shape),
                      bool(args[15]), kw.get("M") is not None), args,
                     {k: _clone(v) for k, v in kw.items()}, True)
            return kernels.ipm_iter(*args, **kw)

        def bmv(self, X, Y):
            if "bmv" in kinds:
                keep(("bmv", _shape_key(X), _shape_key(Y)), (X, Y), {}, False)
            return kernels.bmv(X, Y)

    rec = Recorder()
    pdip.kernels = rec
    jnp_compat.kernels = rec
    try:
        with torch.no_grad():
            fn()
    finally:
        pdip.kernels = kernels
        jnp_compat.kernels = kernels
    return calls


def bound_of(key, args, kw) -> float:
    """The least ms a call of this kind can take on the card."""
    if key[0] == "gtwg":
        B, m, n = key[1]
        return work.bound_ms(*work.gtwg_work(B, m, n))[0]
    if key[0] == "ipm_iter":
        B, m, n = key[1]
        p = key[2][-2]
        do_ns, handed = key[3], key[4]
        flops, iter_flops, nbytes = work.sweep_work(
            B, m, n, p, kw["ns_steps"] if do_ns else 0)
        return work.bound_ms(iter_flops if handed else flops, nbytes)[0]
    X, Y = args
    return work.bound_ms(*work.bmv_work(tuple(X.shape), tuple(Y.shape),
                                        X.element_size()))[0]


def time_of(key, args, kw) -> float:
    """Device ms of one call of this kind, replayed alone as a graph."""
    from bilevel_gait_gen_tpu_torch.ops import kernels
    if key[0] == "gtwg":
        return trace.graphed_ms(lambda: kernels.gtwg(*args, **kw))
    if key[0] == "ipm_iter":
        return trace.graphed_ms(lambda: kernels.ipm_iter(*_fresh(args), **kw))
    return trace.graphed_ms(lambda: kernels.bmv(*args))


def roofline(calls: dict, kernel_names) -> dict | None:
    """sum(count x bound) and sum(count x time) over the recorded calls of
    the named kernels, and the rows; None where there were none."""
    rows = []
    for key, (count, args, kw) in calls.items():
        if key[0] not in kernel_names:
            continue
        rows.append({"key": repr(key), "count": count,
                     "bound_ms": bound_of(key, args, kw),
                     "ms": time_of(key, args, kw)})
    if not rows:
        return None
    return {"bound_ms": sum(r["count"] * r["bound_ms"] for r in rows),
            "ms": sum(r["count"] * r["ms"] for r in rows), "rows": rows}
