"""Structured profiling: jax.profiler traces + solver phase breakdowns.

The reference's profiling is ad-hoc (`archive/Testing.jl:85-87` @profile
snippets, BenchmarkTools; SURVEY §5). Here: a context manager producing
TensorBoard-loadable XLA traces, plus a solve-breakdown helper that times
each pipeline phase with device-blocking precision.
"""

from __future__ import annotations

import contextlib
import os

import jax

from hank_tpu.utils.timing import timeit


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture an XLA profiler trace (view with TensorBoard / xprof).

    with profiling.trace("/tmp/hank_trace"):
        solver(x0)
    """
    if log_dir is None:
        from hank_tpu.utils.checkpoint import cache_root

        log_dir = os.path.join(cache_root(), "traces")
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def solve_breakdown(model, ss_initial, ss_ending, Jbar, exog_paths,
                    *, direction_dtype=None, iters: int = 3) -> dict:
    """Per-phase wall-clock breakdown of one solve's building blocks.

    Times (median of `iters`, compile-warmed): residual eval F, one JVP
    sweep, one preconditioner solve, one backward scan, one forward scan.
    """
    import jax.numpy as jnp

    from hank_tpu.blocks.backward import backward_iteration
    from hank_tpu.blocks.forward import forward_iteration
    from hank_tpu.ops.linalg import make_reusable_solver
    from hank_tpu.solvers.newton import make_full_residual_fn

    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss_ending.vars[k] for k in endog]), Tm1)
    y = jnp.full_like(x0, 1e-3)

    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    if direction_dtype is not None:
        from hank_tpu.ops.precision import cast_model, cast_paths, cast_ss

        F_dir = make_full_residual_fn(
            cast_model(model, direction_dtype),
            cast_ss(ss_initial, direction_dtype),
            cast_ss(ss_ending, direction_dtype),
            cast_paths(exog_paths, direction_dtype))
        x_d, y_d = x0.astype(direction_dtype), y.astype(direction_dtype)
    else:
        F_dir, x_d, y_d = F, x0, y

    solve_jbar = make_reusable_solver(Jbar)
    back = jax.jit(lambda x: backward_iteration(
        x, exog_paths, model, ss_ending.vars, ss_ending.value))
    pol = back(x0)
    fwd = jax.jit(lambda p: forward_iteration(p, model, ss_initial.D))
    F_jit = jax.jit(F)
    jvp_fn = jax.jit(lambda x, v: jax.jvp(F_dir, (x,), (v,))[1])
    b = F_jit(x0)

    return {
        "residual_F_seconds": timeit(F_jit, x0, iters=iters),
        "jvp_sweep_seconds": timeit(jvp_fn, x_d, y_d, iters=iters),
        "precond_solve_seconds": timeit(solve_jbar, b, iters=iters),
        "backward_scan_seconds": timeit(back, x0, iters=iters),
        "forward_scan_seconds": timeit(fwd, pol, iters=iters),
    }
