"""What the port's JAX-comparison tests share: the JAX package's functions
jitted for the CPU without LLVM's optimization passes, and run per
scenario."""
import jax
import jax.numpy as jnp

# XLA's CPU backend at optimization level 0: a reference that runs once or
# twice compiles faster by more than it runs slower, with a cold compile
# cache, and every test holds the port to it at the tolerance it had
COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


def jit(fn, **kw):
    """``jax.jit(fn, **kw)`` with :data:`COMPILER_OPTIONS`."""
    return jax.jit(fn, compiler_options=COMPILER_OPTIONS, **kw)


def jit_per_scenario(fn, in_axes=0, jit_fn=jit):
    """``jax.jit(jax.vmap(fn, in_axes))``'s result, computed as
    :func:`jit` of fn on each scenario (index i of the leading axis of every
    argument whose ``in_axes`` entry is 0; an entry of None passes the
    argument whole) with the results stacked on a new leading axis.  The
    same function of the same inputs, traced once for one scenario and
    without the batching interpreter: the vmapped closed loop of
    tests/test_torch_engine_gait.py took about three times as long to
    trace as the loop of one scenario, and a sixth longer to compile; each
    scenario's result agrees with the vmapped one to ~1e-10 of its
    magnitude.  ``jit_fn``: ``jax.jit`` where the reference runs many
    times, so that its runs, not its compile, take the time."""
    one = jit_fn(fn)

    def run(*args):
        axes = in_axes if isinstance(in_axes, tuple) else (in_axes,) * len(
            args)
        n = next(jax.tree.leaves(a)[0].shape[0]
                 for a, ax in zip(args, axes) if ax == 0)
        outs = [one(*(jax.tree.map(lambda x: x[i], a) if ax == 0 else a
                      for a, ax in zip(args, axes))) for i in range(n)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)

    return run
