"""One-asset HANK model functions (monetary-policy shock).

Household block: standard incomplete-markets EGM over bonds. Income is
endowment share e·(Y − τ) with lump-sum taxes τ = r·B̄ funding bond interest,
so goods clearing (C = Y) holds by Walras whenever the bond market clears.
"""

from __future__ import annotations

import jax.numpy as jnp

from hank_tpu.ops.egm import interp_columns


def endowmentY(T: int, **kwargs) -> jnp.ndarray:
    """Constant unit endowment path."""
    return jnp.ones((T,), dtype=jnp.float64)


def monetaryShock(T: int, *, size: float = -0.002, rho: float = 0.6, **kwargs) -> jnp.ndarray:
    """AR(1)-decaying nominal-rate shock: eps_m_t = size · ρᵗ (expansionary
    for size < 0). Deterministic and explicitly parameterized."""
    t = jnp.arange(1, T + 1, dtype=jnp.float64)
    return size * rho ** t


def ValueFunction(value_next, xvals, model):
    """One EGM step for the bond-holding household.

      1. Euler: c = (β · E[∂V'/∂b' | e])^(−1/γ)
      2. Implied bonds today: b = (c + b' − inc(e)) / (1+r)
      3. Interpolate the savings policy onto the bond grid; clamp at the
         borrowing constraint
      4. Consumption from the budget; marginal value (1+r)·c^(−γ)

    Returns {"Value", "B" (bond policy), "C" (consumption policy)}.
    """
    bonds = model.heterogeneity["bonds"]
    income = model.heterogeneity["income"]
    grid = bonds.grid
    Pi = income.transition
    n_b, n_e = bonds.n, income.n

    beta = model.params["β"]
    gamma = model.params["γ"]
    borrow_cons = model.params["borrow_cons"]
    Bbar = model.params["Bbar"]
    r = xvals["r"]
    Y = xvals["Y"]

    tau = r * Bbar                       # lump-sum tax funds bond interest
    inc = (Y - tau) * income.grid        # (n_e,) endowment share by state

    policy_b = jnp.broadcast_to(grid[:, None], (n_b, n_e))
    inc_mat = jnp.broadcast_to(inc[None, :], (n_b, n_e))

    expected = jnp.maximum(value_next @ Pi.T, 1e-12)
    cmat = (beta * expected) ** (-1.0 / gamma)

    implied = (cmat - inc_mat + policy_b) / (1.0 + r)
    gridded = interp_columns(grid, implied, policy_b)
    gridded = jnp.maximum(gridded, borrow_cons)

    c_grid = jnp.maximum((1.0 + r) * policy_b + inc_mat - gridded, 1e-12)
    value_current = (1.0 + r) * c_grid ** (-gamma)

    return {"Value": value_current, "B": gridded, "C": c_grid}
