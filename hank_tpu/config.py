"""Global configuration for hank_tpu.

Mirrors the reference's three config tiers (YAML computational params, solver
kwargs, load-time flags — reference `ModelParser.jl:312-317`,
`NewtonRaphson.jl:72-75`, `ForwardDiff.jl/src/prelude.jl:1-7`) with a single
module of process-level defaults. Per-model values live on `CompSpec`; per-call
values are solver kwargs.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass
class Config:
    # Default compute dtype for the solver pipeline. float64 is required for
    # the 1e-8 pointwise-parity target; dense factorizations go through
    # `ops.linalg.refined_solve` (f32 LU + f64 iterative refinement).
    dtype: jnp.dtype = jnp.float64

    # Defaults matching the reference (`ModelParser.jl:312`):
    default_T: int = 150
    default_eps: float = 1e-6
    default_dx: float = 1e-8

    # VFI inner loop cap (`SteadyState.jl:134`).
    vfi_max_iter: int = 10_000

    # VFI sup-norm tolerance. Much tighter than the model's path tolerance:
    # with contraction modulus β ≈ 0.98 the distance to the fixed point is
    # ~50x the per-iteration change, and the backward scan along the path
    # amplifies any terminal-value error — 1e-8 pointwise path accuracy
    # requires the steady-state value to be converged to ~1e-12.
    vfi_eps: float = 1e-12

    # Outer Newton caps (`SteadyState.jl:192-193`, `NewtonRaphson.jl:38`).
    ss_newton_max_iter: int = 100
    path_newton_max_iter: int = 100

    # Dense invariant-distribution solve is used up to this many household
    # states; larger state spaces use the matrix-free power-iteration path.
    invariant_dense_max_states: int = 4096

    # Matrix-free invariant-distribution sup-norm tolerance. Tighter than
    # vfi_eps: a distribution converged to δ leaves the forward push-forward
    # with an O(δ·a_max) per-period drift in asset aggregates (the residual
    # of the aggregate-clearing equations then GROWS linearly along the
    # path — measured 2e-9/period at δ = 1e-12 on the two-asset model, which
    # breaches a 1e-8 path-consistency target by T ≈ 10).
    invariant_eps: float = 1e-14

    # Iterative-refinement sweeps for f64 solves built on f32 LU.
    refine_iters: int = 8

    # Emit NaN/Inf diagnostics around Newton steps (maps the reference's
    # safe_eval Inf-fill, `SteadyState.jl:199`).
    debug_nans: bool = False


config = Config()

# Division-guard epsilon for IN-GRAPH code. NOT 1e-300: an f64 emulated
# with f32 pairs has an exponent range that ends at ~1.18e-38, where a
# 1e-300 literal silently underflows to 0.0 ON DEVICE and turns
# `x / max(x, 1e-300)` guards into 0/0 = NaN when x == 0. 1e-36 is inside
# that range and still far below every meaningful f64 magnitude in the
# solvers (norms/dots bottom out around 1e-28). Host-side python floats
# (`max(x, 1e-300)`) are unaffected and may keep the smaller literal.
TINY = 1e-36


def default_dtype() -> jnp.dtype:
    return config.dtype


# ── Exact-lowerings mode ────────────────────────────────────────────────────
# A backend whose f64 GEMM rounds coarser than its elementwise/gather f64
# ops (an emulated f64 at ~1.2e-10 relative against ~1e-15) compounds a
# hat-basis GEMM contraction per Bellman step over a T=300 backward
# recursion into ~6e-7 absolute policy deviations. Full-precision residual
# programs are therefore built under `exact_lowerings()`: the interpolation gates
# (ops/egm._interp_mode, models/hank_two_asset._use_hat_interp) then select
# the exactly-rounded gather forms. The f32 DIRECTION sweeps keep the fast
# hat GEMMs — direction noise perturbs only the step, never the answer.
# The flag is read at TRACE time (the `with` executes inside the traced
# residual body), so each jitted program latches its own mode.
_EXACT_LOWERINGS = False


def exact_lowerings_active() -> bool:
    """True while tracing under `exact_lowerings()`."""
    return _EXACT_LOWERINGS


class exact_lowerings:
    """Context manager: prefer exactly-rounded lowerings while tracing.

    Contract (single-thread, whole-trace scope): the flag is a plain
    module global read at TRACE time and is invisible to jit cache keys,
    so it must only be toggled around WHOLE-PROGRAM traces from one
    thread — every residual fn in this package re-enters the context
    inside its own traced body (`make_full_residual_fn`), which satisfies
    this. Do NOT toggle it around a call to an already-jitted function
    (the cached program keeps the mode it was traced under) and do not
    trace concurrently from multiple threads while toggling.
    """

    def __init__(self, on: bool = True):
        self.on = bool(on)

    def __enter__(self):
        global _EXACT_LOWERINGS
        self.prev = _EXACT_LOWERINGS
        _EXACT_LOWERINGS = self.on
        return self

    def __exit__(self, *exc):
        global _EXACT_LOWERINGS
        _EXACT_LOWERINGS = self.prev
        return False
