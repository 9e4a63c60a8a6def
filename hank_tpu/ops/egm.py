"""Endogenous Grid Method primitives.

The reference's model value function interpolates the savings policy from the
endogenous grid back onto the exogenous wealth grid with Gridded(Linear) +
Flat extrapolation (`KrusellSmith.jl:65-72`). Here that is a vectorized
searchsorted+gather interpolation (`jnp.interp`), vmapped over the exogenous
state columns — fully differentiable w.r.t. query points, knots, and values,
and robust to arbitrary (even locally non-monotone) knots under jit, which the
reference flags as a startup hazard (`SteadyState.jl:129-132`).
"""

from __future__ import annotations

import os

import jax.numpy as jnp


def _interp_mode(n_k: int) -> str:
    """Default lowering for `interp_columns`: the "gather" form.

    The dense n_q·n_k "hat" form (gather-free hat-basis contraction) is
    reachable through `mode="hat"` and the `HANK_TPU_INTERP` ∈ {hat,
    gather} override for A/B probes.
    """
    from hank_tpu.config import exact_lowerings_active

    if exact_lowerings_active():
        # Full-precision residual program: always the gathers (see
        # config.exact_lowerings).
        return "gather"
    env = os.environ.get("HANK_TPU_INTERP")
    if env:
        if env not in ("hat", "gather"):
            raise ValueError(f"HANK_TPU_INTERP must be hat|gather, got {env!r}")
        return env
    return "gather"


def _interp_columns_hat(x: jnp.ndarray, knots: jnp.ndarray,
                        vals: jnp.ndarray) -> jnp.ndarray:
    """Gather-free `interp_columns`: per-column hat-basis contraction.

    interp(x)[q, e] = Σ_k hat_k(clip(x[q,e]); knots[:,e]) · vals[k, e] —
    the same identity the forward lottery (`ops/transition
    .hat_basis_weights`) and the two-asset fixed-grid interps use, here with
    DYNAMIC per-column knots (the EGM endogenous grid changes every scan
    step). Pure broadcast/min/relu arithmetic + one reduction: no
    searchsorted, no gathers, so it fuses into a single elementwise pass
    and scales with vmapped batch axes.

    Requires STRICTLY monotone-increasing knots per column for exact
    equivalence with the gather form — guaranteed at every current call
    site (EGM implied-wealth knots along the transition path are strictly
    increasing: consumption rises with next-period assets). An interior
    TIED pair of knots degrades safely: the degenerate flanks below give
    the RIGHT duplicate full weight over its interval (weights still sum
    to 1; the gather form picks the left duplicate's value — they differ
    only in which duplicate's value is used, a genuine value ambiguity).
    Knots tied AT THE ENDS remain unsupported (queries clip onto the tied
    end knot, where both flanks are degenerate); the "gather" form stays
    the default where arbitrary knots can appear (CPU VFI experiments).
    """
    # (e, q, k) layout: k on lanes, q on sublanes — the reduction axis last.
    xT = x.T[:, :, None]                              # (n_e, n_q, 1)
    g = knots.T[:, None, :]                           # (n_e, 1, n_k)
    g_lo = jnp.concatenate([2 * g[..., :1] - g[..., 1:2], g[..., :-1]], -1)
    g_hi = jnp.concatenate([g[..., 1:], 2 * g[..., -1:] - g[..., -2:-1]], -1)
    p = jnp.clip(xT, g[..., :1], g[..., -1:])
    d_up = g - g_lo
    d_dn = g_hi - g
    # Degenerate (zero-width) flanks become step functions with an
    # exclusive/inclusive pairing — at a tied interior pair the LEFT
    # duplicate's falling flank is strictly exclusive (0 at p == g) and the
    # RIGHT duplicate's rising flank inclusive (full weight at p == g), so
    # exactly one of them carries the interval and weights sum to 1.
    up = jnp.where(d_up > 0, (p - g_lo) / jnp.where(d_up > 0, d_up, 1.0),
                   jnp.where(p >= g, 2.0, 0.0))
    down = jnp.where(d_dn > 0, (g_hi - p) / jnp.where(d_dn > 0, d_dn, 1.0),
                     jnp.where(p < g, 2.0, 0.0))
    H = jnp.clip(jnp.minimum(up, down), 0.0, 1.0)     # (n_e, n_q, n_k)
    return jnp.einsum("eqk,ek->eq", H, vals.T).T


def interp_columns(x: jnp.ndarray, knots: jnp.ndarray, vals: jnp.ndarray,
                   mode: str | None = None) -> jnp.ndarray:
    """Column-wise interpolation over exogenous states.

    Args:
      x: (n_q,) or (n_q, n_exog) query points.
      knots: (n_k, n_exog) per-column knot vectors (endogenous grid).
      vals: (n_k,) or (n_k, n_exog) values at the knots.

    Returns (n_q, n_exog): for each column e, interp(x[:, e], knots[:, e],
    vals[:, e]) with flat extrapolation.

    Two lowerings (`mode`, default per backend — `_interp_mode`):
    - "gather": comparison-sum bracket location + two gathers + clipped lerp;
      robust to arbitrary (even locally non-monotone) knots.
    - "hat": gather-free hat-basis contraction (`_interp_columns_hat`);
      requires monotone knots, scales with vmapped batch axes.
    Both give flat extrapolation (zero gradient outside the knot range),
    matching the reference's Flat() extrapolation and clamped-boundary
    zero-derivative convention.
    """
    n_k, n_exog = knots.shape
    if x.ndim == 1:
        x = jnp.broadcast_to(x[:, None], (x.shape[0], n_exog))
    if vals.ndim == 1:
        vals = jnp.broadcast_to(vals[:, None], (vals.shape[0], n_exog))
    if mode is None:
        mode = _interp_mode(n_k)
    if mode == "hat":
        return _interp_columns_hat(x, knots, vals)

    # idx[q, e] = #{k : knots[k, e] < x[q, e]}, clipped to a valid bracket.
    idx = jnp.sum(knots[None, :, :] < x[:, None, :], axis=1)
    idx = jnp.clip(idx, 1, n_k - 1)
    lo = jnp.take_along_axis(knots, idx - 1, axis=0)
    hi = jnp.take_along_axis(knots, idx, axis=0)
    v_lo = jnp.take_along_axis(vals, idx - 1, axis=0)
    v_hi = jnp.take_along_axis(vals, idx, axis=0)
    denom = hi - lo
    safe = jnp.where(denom > 0, denom, 1.0)      # guard duplicate knots
    t = jnp.clip((x - lo) / safe, 0.0, 1.0)
    return v_lo + t * (v_hi - v_lo)


def egm_consumption(value_next: jnp.ndarray, Pi: jnp.ndarray,
                    beta: float, gamma: float) -> jnp.ndarray:
    """Euler-equation inversion: c = (β · E[∂V'/∂a' | e])^(-1/γ).

    `value_next` is (n_a, n_e); the expectation over next-period productivity
    is the matmul `value_next @ Pi.T` (`KrusellSmith.jl:59`).
    """
    expected = value_next @ Pi.T
    return (beta * expected) ** (-1.0 / gamma)
