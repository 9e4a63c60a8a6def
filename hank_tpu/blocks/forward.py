"""Distribution forward block: push-forward scan + aggregation.

Capability parity with the reference's `ForwardIteration` and its custom
rrules (`ForwardIteration.jl:253-420`). The Julia `for t = 1 ... T-1` loop of
sparse matrix-vector products becomes a `jax.lax.scan` of
`ops.transition.forward_step` (scatter-add + matmul). The scan is natively
reverse-differentiable, so the reference's 80-line hand-written reverse-time
pullback (`ForwardIteration.jl:339-420`) is replaced by `jax.vjp` of this
function — with identical O(n_m)-per-step structure, since the cotangent of a
scatter-add is a gather and the cotangent of the Π matmul is a matmul with Πᵀ.
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp


def forward_iteration(
    policy_seqs: Mapping[str, jnp.ndarray],
    model,
    D_initial: jnp.ndarray,
) -> dict[str, jnp.ndarray]:
    """Evolve the household distribution and aggregate each het variable.

    Args:
      policy_seqs: dict mapping each heterogeneous variable name to a
        (T-1, *state_shape) policy path (from `backward_iteration`).
      D_initial: (*state_shape,) distribution at t = 0 (initial SS).

    Returns: dict mapping each heterogeneous variable name to its (T-1,)
    aggregate path: agg[v][t] = Σ_states policy[v][t] · D_{t+1}, with the
    distribution updated *before* aggregating (`ForwardIteration.jl:297-308`).
    """
    het_keys = model.vars_of_type("heterogeneous")
    endog_dims = model.endog_dims()
    exog_dims = model.exog_dims()
    grids = [d.grid for d in endog_dims]
    transitions = [d.transition for d in exog_dims]
    policy_vars = [d.policy_var for d in endog_dims]
    k = len(endog_dims)

    from hank_tpu.ops.transition import exog_apply, lottery_apply_multi

    # Rematerialized step: the dense one-hot lottery builds an (n_a, F, n_a)
    # contraction mask per period; without remat, reverse-mode through the
    # scan would store it for all T-1 periods (O(T·n_a²·F) memory).
    @jax.checkpoint
    def step(D, policies_t):
        endog_policies = [policies_t[v] for v in policy_vars]
        D_half = lottery_apply_multi(endog_policies, D, grids)
        D_new = exog_apply(D_half, transitions, k)
        aggs_t = {v: jnp.sum(policies_t[v] * D_new) for v in het_keys}
        return D_new, aggs_t

    xs = {v: policy_seqs[v] for v in het_keys}
    _, aggs = jax.lax.scan(step, D_initial.astype(next(iter(xs.values())).dtype), xs)
    return aggs


def distribution_path(
    policy_seqs: Mapping[str, jnp.ndarray],
    model,
    D_initial: jnp.ndarray,
) -> jnp.ndarray:
    """Full (T, *state_shape) distribution path (diagnostics / plotting).

    D[0] = D_initial; D[t] is the distribution after transition step t.
    """
    endog_dims = model.endog_dims()
    grids = [d.grid for d in endog_dims]
    transitions = [d.transition for d in model.exog_dims()]
    policy_vars = [d.policy_var for d in endog_dims]
    k = len(endog_dims)

    from hank_tpu.ops.transition import exog_apply, lottery_apply_multi

    def step(D, policies_t):
        endog_policies = [policies_t[v] for v in policy_vars]
        D_new = exog_apply(lottery_apply_multi(endog_policies, D, grids),
                           transitions, k)
        return D_new, D_new

    xs = {v: policy_seqs[v] for v in policy_vars}
    _, Ds = jax.lax.scan(step, D_initial, xs)
    return jnp.concatenate([D_initial[None], Ds], axis=0)
