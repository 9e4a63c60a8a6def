"""Steady-state solver: inner VFI fixed point + outer Newton with backtracking.

Capability parity with the reference's `SteadyState.jl`:

- `SteadyState` struct (`SteadyState.jl:21-27`)
- free/pinned variable-role logic of `SSAssembler` (`SteadyState.jl:55-93`)
- inner VFI loop of `get_xVals` (`SteadyState.jl:111-154`)
- outer Newton with backtracking line search of `find_ss` (`SteadyState.jl:184-233`)
- `get_SteadyStates` (`SteadyState.jl:245-259`)
- `single_run` diagnostic forward pass (`SteadyState.jl:272-286`)

Accelerator-first redesign: the reference differentiates *through* the 10,000-iteration
VFI loop with dual numbers (`SteadyState.jl:132-141` inside
`ForwardDiff.jacobian`). Here the VFI fixed point is a `lax.while_loop` with a
`jax.custom_jvp` implicit-differentiation rule: the tangent solves the linear
fixed point dv = ∂_v f · dv + ∂_x f · dx at the converged value — the same
mathematics the contraction gives, at a fraction of the cost, and compatible
with `jax.jacfwd` for the outer Newton.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from hank_tpu.config import TINY, config
from hank_tpu.blocks.assemble import residuals as eval_residuals
from hank_tpu.ops.linalg import dense_solve, invariant_dist_colstoch
from hank_tpu.ops.transition import dense_full_transition


@dataclasses.dataclass(frozen=True)
class SteadyState:
    """Steady-state solution (`SteadyState.jl:21-27`).

    vars: aggregate variable values keyed by `model.var_names()`.
    policies: one (*state_shape,) policy array per heterogeneous variable.
    D: stationary distribution, (*state_shape,).
    value: converged marginal value (terminal condition for the backward
      recursion, `BackwardIteration.jl:84-85`).
    """

    vars: Mapping[str, jnp.ndarray]
    policies: Mapping[str, jnp.ndarray]
    D: jnp.ndarray
    value: jnp.ndarray


def _free_keys(model, ss_spec) -> tuple[str, ...]:
    """Newton search variables: endogenous vars not pinned (`SteadyState.jl:72-75`)."""
    pinned = set(ss_spec.fixed.keys())
    return tuple(k for k in model.vars_of_type("endogenous") if k not in pinned)


def make_vfi_solver(model) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the implicit-diff VFI fixed-point solver for `model`.

    Returns `vfi(xvals_vec) -> value*` where xvals_vec is the (n_v,) aggregate
    vector. Primal: while_loop on the Bellman step until the sup-norm change
    is below ε (cap `config.vfi_max_iter`, `SteadyState.jl:134-141`). Tangent:
    Neumann iteration on the linearised fixed point at `value*`.
    """
    names = model.var_names()
    state_shape = model.state_shape()
    # Models carrying several marginal values (e.g. the two-asset household's
    # (V_b, V_a) pair) declare `ValueFunction.n_values`; the value array then
    # gets a leading axis of that size.
    n_values = getattr(model.value_fn, "n_values", 1)
    value_shape = state_shape if n_values == 1 else (n_values, *state_shape)
    eps = min(model.compspec.eps, config.vfi_eps)
    max_iter = config.vfi_max_iter

    def bellman(value, xvec):
        xvals = {name: xvec[i] for i, name in enumerate(names)}
        return model.value_fn(value, xvals, model)["Value"]

    def _accelerated_fixed_point(step, v0):
        """Iterate v ← step(v) to tolerance with periodic Aitken extrapolation.

        The VFI tail is geometric with modulus ≈ β (0.98 for KS ⇒ ~1400 plain
        iterations to 1e-12). Estimating the modulus λ from successive
        sup-norm changes and extrapolating v + Δ·λ/(1−λ) every 20 iterations
        cuts this ~3-5x. The same acceleration applies to the (affine)
        tangent fixed point.
        """
        def cond(carry):
            _, _, diff, it = carry
            return (diff > eps) & (it < max_iter)

        def body(carry):
            v, diff_prev, _, it = carry
            v_new = step(v)
            diff = jnp.max(jnp.abs(v_new - v))
            lam = jnp.clip(diff / jnp.maximum(diff_prev, TINY), 0.0, 0.995)
            do_ex = (it % 20 == 19) & (it > 40)

            # SAFEGUARDED Aitken (same scheme as ops/linalg._accel_fixed_point):
            # a max-norm ratio cannot tell an oscillating mode from a
            # geometric tail, and the λ/(1−λ) extrapolation then overshoots —
            # compounding overshoots run the value to inf/NaN. Accept the
            # extrapolation only if one verification apply shows its
            # one-step residual beats the plain iterate's.
            def try_extrapolate(_):
                v_ex = v_new + (v_new - v) * (lam / (1 - lam))
                d_ex = jnp.max(jnp.abs(step(v_ex) - v_ex))
                ok = jnp.isfinite(d_ex) & (d_ex < diff)
                return jnp.where(ok, v_ex, v_new)

            v_next = jax.lax.cond(do_ex, try_extrapolate,
                                  lambda _: v_new, None)
            return v_next, diff, diff, it + 1

        v_star, _, _, _ = jax.lax.while_loop(
            cond, body, (v0, jnp.inf, jnp.inf, 0))
        return v_star

    @jax.custom_jvp
    def vfi(xvec):
        # Constant initial marginal value: makes the first EGM implied-wealth
        # grid strictly increasing (`SteadyState.jl:129-132`).
        v0 = jnp.ones(value_shape, dtype=xvec.dtype)
        return _accelerated_fixed_point(lambda v: bellman(v, xvec), v0)

    @vfi.defjvp
    def vfi_jvp(primals, tangents):
        (xvec,), (dx,) = primals, tangents
        v_star = vfi(xvec)

        # Implicit differentiation at the fixed point: dv solves the affine
        # contraction dv = ∂_v bellman · dv + ∂_x bellman · dx (the JAX-native
        # replacement for dual-number propagation through all VFI iterations,
        # `SteadyState.jl:132-141`).
        def tan_step(dv):
            _, dv_new = jax.jvp(bellman, (v_star, xvec), (dv, dx))
            return dv_new

        dv_star = _accelerated_fixed_point(tan_step, jnp.zeros_like(v_star))
        return v_star, dv_star

    return vfi


def make_ss_pipeline(model, ss_spec):
    """Build the SS evaluation pipeline for one steady state.

    Returns (F, full_state) where
      F(p) -> residual vector (n_eq,) — the Newton objective, and
      full_state(p) -> (xvals_vec, value*, policies, D) — the full solution
        at iterate p (`SteadyState.jl:111-154` get_xVals + final extraction).
    """
    names = model.var_names()
    n_v = model.compspec.n_v
    free = _free_keys(model, ss_spec)
    free_idx = np.array([names.index(k) for k in free], dtype=np.int64)
    pin_idx = np.array([names.index(k) for k in ss_spec.fixed.keys()], dtype=np.int64)
    pin_vals = np.array(list(ss_spec.fixed.values()), dtype=np.float64)
    het_keys = model.vars_of_type("heterogeneous")
    het_idx = np.array([names.index(k) for k in het_keys], dtype=np.int64)

    endog_dims = model.endog_dims()
    transitions = [d.transition for d in model.exog_dims()]
    state_shape = model.state_shape()
    grids = [d.grid for d in endog_dims]
    policy_vars = [d.policy_var for d in endog_dims]

    # Invariant-distribution strategy: direct dense solve for small
    # single-endogenous-dimension state spaces; matrix-free power iteration
    # with implicit differentiation otherwise (multi-dim / large grids).
    use_dense = (len(endog_dims) == 1
                 and model.n_total() <= config.invariant_dense_max_states)
    if not use_dense:
        from hank_tpu.ops.linalg import make_invariant_solver
        from hank_tpu.ops.transition import exog_apply, lottery_apply_multi

        def _apply(endog_policies, D):
            return exog_apply(lottery_apply_multi(endog_policies, D, grids),
                              transitions, len(endog_dims))

        invariant_solve = make_invariant_solver(
            _apply, eps=min(model.compspec.eps, config.invariant_eps))

    vfi = make_vfi_solver(model)

    def household(p):
        """p (n_free,) -> (xvals_vec, value*, policies dict, D)."""
        xvec = jnp.zeros((n_v,), dtype=p.dtype)
        xvec = xvec.at[free_idx].set(p)
        xvec = xvec.at[pin_idx].set(jnp.asarray(pin_vals, dtype=p.dtype))

        v_star = vfi(xvec)
        xvals = {name: xvec[i] for i, name in enumerate(names)}
        result = model.value_fn(v_star, xvals, model)
        policies = {k: result[k] for k in het_keys}

        if use_dense:
            lam = dense_full_transition(policies[policy_vars[0]],
                                        grids[0], transitions)
            D = invariant_dist_colstoch(lam).reshape(state_shape)
        else:
            D0 = jnp.full(state_shape, 1.0 / model.n_total(), dtype=p.dtype)
            D = invariant_solve([policies[v] for v in policy_vars], D0)

        aggs = jnp.stack([jnp.sum(policies[k] * D) for k in het_keys]) \
            if het_keys else jnp.zeros((0,), p.dtype)
        xvec = xvec.at[het_idx].set(aggs)
        return xvec, result["Value"], policies, D

    def F(p):
        xvec, _, _, _ = household(p)
        cs = model.compspec
        T_pad = 1 + cs.max_lag + cs.max_lead
        x_mat = jnp.tile(xvec[:, None], (1, T_pad))
        return eval_residuals(x_mat, model)

    return F, household, free


def find_ss(model, ss_spec, label: str = "", verbose: bool = False) -> SteadyState:
    """Newton-Raphson steady-state solve with backtracking line search.

    Mirrors `find_ss` (`SteadyState.jl:184-233`): full dense Jacobian via
    forward-mode AD (here `jax.jacfwd` through the implicit-diff VFI), direct
    solve, η-halving backtracking with a 1e-8 floor, 100-iteration cap with a
    non-convergence warning.
    """
    F, household, free = make_ss_pipeline(model, ss_spec)
    F_jit = jax.jit(F)
    J_jit = jax.jit(jax.jacfwd(F))

    # Optional per-variable box; iterates are projected into it (keeps the
    # search out of spurious basins — see SteadyStateSpec.bounds).
    lo = jnp.asarray([ss_spec.bounds.get(k, (-jnp.inf, jnp.inf))[0] for k in free],
                     dtype=config.dtype)
    hi = jnp.asarray([ss_spec.bounds.get(k, (-jnp.inf, jnp.inf))[1] for k in free],
                     dtype=config.dtype)

    def project(q):
        return jnp.clip(q, lo, hi)

    p = project(jnp.asarray([ss_spec.guesses.get(k, 1.0) for k in free],
                            dtype=config.dtype))
    # Tighter than the reference's ε = 1e-6 (`SteadyState.jl:193`): the path
    # solver's 1e-9 convergence target needs an SS consistent at that level.
    eps = min(model.compspec.eps, 1e-9)
    z = F_jit(p)

    def safe_norm(v):
        n = float(jnp.linalg.norm(v))
        return n if np.isfinite(n) else np.inf

    it = 0
    max_iter = config.ss_newton_max_iter
    while safe_norm(z) > eps and it < max_iter:
        if verbose:
            print(f"  [{label}] iteration {it}: residual norm = {safe_norm(z):.3e}")
        J = J_jit(p)
        step = dense_solve(J, z)
        eta = 1.0
        z_norm = safe_norm(z)
        p_new = project(p - eta * step)
        z_new = F_jit(p_new)
        # Strict decrease required: accepting equal-norm steps cycles forever
        # when a bound is binding or the direction is tangent to the residual
        # level set.
        improved = safe_norm(z_new) < z_norm
        while not improved:
            eta /= 2.0
            if eta <= 1e-8:
                break
            p_new = project(p - eta * step)
            z_new = F_jit(p_new)
            improved = safe_norm(z_new) < z_norm
        if not improved:
            # Line search exhausted without a finite improvement: keep the
            # best iterate instead of stepping into NaN territory (the
            # reference accepts the failed step, `SteadyState.jl:202-209`,
            # which poisons every later iteration).
            import warnings
            warnings.warn(
                f"find_ss [{label}]: line search stalled at iteration {it} "
                f"(residual norm {z_norm:.3e}); keeping current iterate")
            break
        p, z = p_new, z_new
        it += 1

    if it == max_iter:
        import warnings
        warnings.warn(
            f"find_ss [{label}]: did not converge in {max_iter} iterations "
            f"(residual norm {safe_norm(z):.3e})")

    xvec, value, policies, D = jax.jit(household)(p)
    names = model.var_names()
    vars_nt = {name: xvec[i] for i, name in enumerate(names)}
    return SteadyState(vars=vars_nt, policies=policies, D=D, value=value)


def get_steady_states(model, verbose: bool = False) -> tuple[SteadyState, SteadyState]:
    """Solve initial and ending steady states (`SteadyState.jl:245-259`).

    Skips the second solve when the specs are identical (transitory shock).
    """
    ss_initial = find_ss(model, model.ss_initial, "initial", verbose)
    if model.ss_initial is model.ss_ending or model.ss_initial == model.ss_ending:
        return ss_initial, ss_initial
    ss_ending = find_ss(model, model.ss_ending, "ending", verbose)
    return ss_initial, ss_ending


def single_run(ss_initial: SteadyState, ss_ending: SteadyState, model,
               exog_paths: Mapping[str, jnp.ndarray]) -> jnp.ndarray:
    """One full forward pass F(x) from the SS guess (`SteadyState.jl:272-286`)."""
    from hank_tpu.solvers.newton import make_full_residual_fn

    Tm1 = model.compspec.T - 1
    endog_keys = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss_initial.vars[k] for k in endog_keys]), Tm1)
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    return F(x0)
