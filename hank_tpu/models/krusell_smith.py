"""Krusell-Smith (1998) model functions.

Capability parity with the reference's model file (`KrusellSmith.jl`):
`exogenousZ` (productivity path generator) and `ValueFunction` (one EGM step,
Carroll 2006). Written as pure jnp functions — jit/scan/vmap/AD-compatible.
"""

from __future__ import annotations

import jax.numpy as jnp

from hank_tpu.ops.egm import interp_columns


def exogenousZ(T: int, *, rho: float = 0.8, z_start: float = 1.0,
               z_end: float = 2.0, shock: float = 0.0,
               key=None, sigma: float = 0.0) -> jnp.ndarray:
    """T-period productivity path from `z_start` toward `z_end`.

    Deterministic default: Z_t = z_end + (z_start + shock − z_end) · ρᵗ,
    a geometric transition consistent with the model's initial/ending steady
    states. Optionally adds seeded AR(1) innovations (σ > 0 with an explicit
    PRNG key) — the reference's `exogenousZ` (`KrusellSmith.jl:14-20`) draws
    unseeded `randn()`, which we deliberately replace with explicit,
    reproducible shocks (SURVEY §7 "make shocks explicit, seeded").
    """
    t = jnp.arange(1, T + 1, dtype=jnp.float64)
    Z = z_end + (z_start + shock - z_end) * rho ** t
    if sigma > 0.0:
        if key is None:
            raise ValueError("stochastic exogenousZ requires an explicit PRNG key")
        import jax
        eps = jax.random.normal(key, (T,), dtype=jnp.float64)
        innov = sigma * jnp.sqrt(1.0 - rho**2) * eps
        Z = Z + jnp.cumsum(innov * rho ** (T - t)) * rho ** t  # AR(1) accumulation
    return Z


def ValueFunction(value_next, xvals, model):
    """One EGM step for the KS household problem (`KrusellSmith.jl:43-83`).

    Maps the next-period marginal value ∂V_{t+1}/∂a' (n_a, n_e) to the
    current-period marginal value and savings policy:

      1. Euler: c = (β · E_{e'|e}[∂V'/∂a'])^(−1/γ)          — matmul with Πᵀ
      2. Implied wealth on the endogenous grid: a = (c + a' − w·e)/(1+r)
      3. Interpolate savings policy onto the exogenous wealth grid
         (vectorized searchsorted + gather; flat extrapolation)
      4. Borrowing constraint: a' ≥ borrow_cons
      5. Marginal value: ∂V/∂a = (1+r) · c^(−γ)
    """
    wealth = model.heterogeneity["wealth"]
    prod = model.heterogeneity["productivity"]
    grid = wealth.grid                       # (n_a,)
    Pi = prod.transition                     # (n_e, n_e) row-stochastic
    n_a, n_e = wealth.n, prod.n

    beta = model.params["β"]
    gamma = model.params["γ"]
    borrow_cons = model.params["borrow_cons"]
    r = xvals["r"]
    w = xvals["w"]

    policy_a = jnp.broadcast_to(grid[:, None], (n_a, n_e))
    labor = jnp.broadcast_to(prod.grid[None, :], (n_a, n_e))

    # 1. Expected marginal value -> consumption on the endogenous grid.
    # The expectation is clipped to a tiny positive floor so that a Newton
    # overshoot into infeasible aggregates (e.g. r < -1 making marginal
    # values negative) yields large-but-finite residuals the line search can
    # back away from, instead of NaNs that poison every later iterate.
    expected = jnp.maximum(value_next @ Pi.T, 1e-12)
    cmat = (beta * expected) ** (-1.0 / gamma)

    # 2. Implied current wealth for each (a', e) pair
    implied = (cmat - w * labor + policy_a) / (1.0 + r)

    # 3. Interpolate savings policy a'(a, e) onto the exogenous wealth grid
    gridded = interp_columns(grid, implied, policy_a)

    # 4. Borrowing constraint
    gridded = jnp.maximum(gridded, borrow_cons)

    # 5. Consumption and marginal value on the exogenous grid (floor as above)
    c_grid = jnp.maximum((1.0 + r) * policy_a + w * labor - gridded, 1e-12)
    value_current = (1.0 + r) * c_grid ** (-gamma)

    return {"Value": value_current, "KD": gridded}
