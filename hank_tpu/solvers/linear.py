"""First-order (linearized) sequence-space impulse responses.

The sequence-space linear solution is ONE preconditioned Newton step from
the steady-state path:

    x_lin = x_ss − J̄⁻¹ · F(x_ss; Z)

For a transitory shock (initial SS = ending SS) F(x_ss; Z_ss) = 0 exactly,
so −J̄⁻¹F(x_ss; Z) = −J̄⁻¹ (∂F/∂Z)·dZ + O(‖dZ‖²) — the textbook
sequence-space-Jacobian IRF (Auclert-Bardóczy-Rognlie-Straub 2021; Boehl
2024 frames the nonlinear solver as iterating exactly this step,
`/root/reference/NewtonRaphson.jl:27-46` with J̄ from
`SteadyStateJacobian.jl:41-65`). For a permanent shock the same step also
carries the initial-distribution transient (D0 ≠ D_ss) to first order.

Cost: one residual evaluation + one precomputed-J̄⁻¹ matvec — versus a
full Newton solve for the nonlinear path. The gap between the two paths is
the shock's economically meaningful nonlinearity, and `x_lin` is the
standard warm start for the nonlinear solvers on large shocks.

The reference has no linear-solution API (its linear object, J̄, is used
only as the Newton preconditioner); this module closes the gap users of
the sequence-space-Jacobian toolchain expect.
"""

from __future__ import annotations

from typing import Mapping

import jax.numpy as jnp

from hank_tpu.ops.linalg import make_reusable_solver
from hank_tpu.solvers.newton import make_full_residual_fn


def linear_impulse_response(
    Jbar: jnp.ndarray,
    exog_paths: Mapping[str, jnp.ndarray],
    model,
    ss_initial,
    ss_ending,
    *,
    compute_residual: bool = True,
):
    """Linearized perfect-foresight transition path (one Newton step).

    Args mirror `newton_raphson_hank` (J̄ from
    `get_steady_state_jacobian`; exogenous paths as (T-1,) arrays).

    Returns (x_lin, info): x_lin is the flat (n_endog·(T-1),) linear path;
    info carries "dx" (the deviation from the steady-state path),
    "f0_norm" = ‖F(x_ss; Z)‖ (the first-order forcing), and — when
    compute_residual — "residual_norm" = ‖F(x_lin; Z)‖, whose size
    relative to f0_norm measures how nonlinear the shock is (it is O(dZ²),
    so it vanishes quadratically as the shock shrinks).
    """
    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    x_ss = jnp.tile(jnp.asarray([ss_ending.vars[k] for k in endog],
                                dtype=Jbar.dtype), Tm1)
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    f0 = F(x_ss)
    dx = -make_reusable_solver(Jbar)(f0)
    x_lin = x_ss + dx
    info = {"dx": dx, "f0_norm": jnp.linalg.norm(f0)}
    if compute_residual:
        info["residual_norm"] = jnp.linalg.norm(F(x_lin))
    return x_lin, info


def irf_table(x: jnp.ndarray, model, ss) -> dict[str, jnp.ndarray]:
    """Reshape a flat path into named per-variable IRFs (deviations from
    the given steady state): {name: (T-1,) array of x_t − x_ss}."""
    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    mat = x.reshape(Tm1, len(endog))
    return {k: mat[:, i] - ss.vars[k] for i, k in enumerate(endog)}
