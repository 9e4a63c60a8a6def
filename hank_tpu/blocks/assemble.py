"""Sequence-space assembly: time shifts, padded xMat, residual dispatch.

Capability parity with the reference's L6 aggregate block
(`GeneralStructures.jl:266-455`, `Aggregation.jl:20-22`).

Design notes: `assemble_full_xmat` is a pure concatenation (no in-place
scatter), so it is natively differentiable — the reference's hand-written
rrule (`GeneralStructures.jl:392-427`) is unnecessary. Row ordering is the
variable ordering (endogenous block, heterogeneous block, exogenous block,
matching `ModelParser.jl:357`), so the three sources stack contiguously.
"""

from __future__ import annotations

from typing import Mapping

import jax.numpy as jnp


def shift_lag(x: jnp.ndarray, i: int) -> jnp.ndarray:
    """Shift a time series back by `i` periods, filling with x[0].

    Target of compiled `VAR(-i)` notation (`GeneralStructures.jl:441-444`).
    """
    return jnp.concatenate([jnp.broadcast_to(x[0], (i,)), x[:-i]]) if i else x


def shift_lead(x: jnp.ndarray, i: int) -> jnp.ndarray:
    """Shift a time series forward by `i` periods, filling with x[-1].

    Target of compiled `VAR(+i)` notation (`GeneralStructures.jl:453-455`).
    """
    return jnp.concatenate([x[i:], jnp.broadcast_to(x[-1], (i,))]) if i else x


def ss_column(model, ss_vars: Mapping[str, jnp.ndarray]) -> jnp.ndarray:
    """Stack steady-state variable values into one (n_v,) column."""
    return jnp.stack([jnp.asarray(ss_vars[k]) for k in model.var_names()])


def assemble_full_xmat(
    x_endog: jnp.ndarray,
    agg_seqs: Mapping[str, jnp.ndarray],
    exog_paths: Mapping[str, jnp.ndarray],
    model,
    ss_start_vars: Mapping[str, jnp.ndarray],
    ss_end_vars: Mapping[str, jnp.ndarray],
) -> jnp.ndarray:
    """Build the padded (n_v, T_pad) matrix for the compiled residuals fn.

    Column layout (`GeneralStructures.jl:299-306`):
      [0:max_lag)           initial-SS boundary columns
      [max_lag:max_lag+T-1) transition path
      [max_lag+T-1:T_pad)   ending-SS boundary columns

    Args:
      x_endog: flat (n_endog*(T-1),) endogenous sequence; reshaped to
        (n_endog, T-1) with column t = period-t values (the reference's
        column-major reshape, `GeneralStructures.jl:362`).
      agg_seqs: heterogeneous-variable aggregate paths, each (T-1,).
      exog_paths: exogenous paths, each (T-1,).
    """
    cs = model.compspec
    Tm1 = cs.T - 1

    x_mat_endog = x_endog.reshape(Tm1, cs.n_endog).T  # column t = period t
    het_block = jnp.stack([agg_seqs[k] for k in model.vars_of_type("heterogeneous")]) \
        if model.vars_of_type("heterogeneous") else jnp.zeros((0, Tm1), x_endog.dtype)
    exog_block = jnp.stack([jnp.asarray(exog_paths[k]) for k in model.vars_of_type("exogenous")]) \
        if model.vars_of_type("exogenous") else jnp.zeros((0, Tm1), x_endog.dtype)

    middle = jnp.concatenate([x_mat_endog, het_block, exog_block], axis=0)

    left = jnp.tile(ss_column(model, ss_start_vars)[:, None], (1, cs.max_lag)) \
        if cs.max_lag else jnp.zeros((cs.n_v, 0), middle.dtype)
    right = jnp.tile(ss_column(model, ss_end_vars)[:, None], (1, cs.max_lead)) \
        if cs.max_lead else jnp.zeros((cs.n_v, 0), middle.dtype)

    return jnp.concatenate(
        [left.astype(middle.dtype), middle, right.astype(middle.dtype)], axis=1)


def residuals(x_mat: jnp.ndarray, model) -> jnp.ndarray:
    """Evaluate the compiled residuals (`Aggregation.jl:20-22`)."""
    return model.residuals_fn(x_mat, model.params)
