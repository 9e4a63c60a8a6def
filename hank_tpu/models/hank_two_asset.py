"""Two-asset HANK model functions (fiscal shock) — Calvo-access portfolio.

Household state: (liquid b, illiquid a, productivity e, access flag). Each
period a household draws access to its illiquid account with i.i.d.
probability λ (Calvo-style adjustment opportunity, à la Bayer-Luetticke):

- WITHOUT access: the account accrues up to the grid cap,
  a' = min((1+ra)·a, a_max), with the excess accrual PAID OUT into the
  liquid budget: c + b' = (1+r)b + payout + (1−τ)w·e, u'(c) = W_b(b', a').
  The cap is valued CONSERVATIVELY: at the cap da'/da = 0 and the
  no-access envelope sets the marginal illiquid value to ZERO (households
  do not price the cap payout; the access branch, λ-mixed upstream,
  carries the cap's liquidation value). This truncation scheme keeps BOTH
  adding-up identities: the payout makes aggregate accounting exact
  (Walras to machine precision), and the zero envelope keeps the cap
  unattractive so illiquid demand stays finite. Two rejected variants,
  both implemented and measured: pricing the cap payout in the envelope
  ((1+ra)·u'(c) there, or a dividend-paying a' = a design) turns capped
  illiquid units into perpetuities that dominate bonds at any visible
  premium — demand saturates the grid and the market-clearing Jacobian
  loses all gradient; valuing the cap with flat-extrapolated W_a and
  silently confiscating the excess accrual parks mass at the top and
  breaks aggregate accounting (measured 2.7% Walras gap). The boundary
  belief error affects only the capped sliver of mass and vanishes as
  a_max → ∞ (the grid top sits ≈ 25-40× the equilibrium capital stock).
- WITH access: the household liquidates into cash-on-hand
  coh = (1+r)b + (1+ra)a + (1−τ)w·e, picks total savings s and an OPTIMAL
  PORTFOLIO SPLIT s = b' + a' with interior first-order condition
  W_b(b', a') = W_a(b', a') (monotone bisection + an implicit
  differentiable Newton step), then an EGM over s:
  u'(c) = max(W_b, W_a)(split).

So both policies genuinely depend on the full household state — the
two-endogenous-dimension configuration the reference hard-errors on
(`ForwardIteration.jl:267-269`, `TODO.md:68-69`) — and the access friction
sustains an equilibrium liquidity premium ra > r with finite, smooth
illiquid demand (the (1+ra)-compounding in V_a is terminated by adjustment
events valued at u'(c), so the marginal-value recursion is stable; a
quadratic-adjustment-cost variant was tried and is structurally knife-edged
in ra − r). The general-equilibrium closure (production, capital = illiquid
claims) lives in hank_two_asset.yaml.

Envelopes (the carried "Value" packs (V_b, V_a), `n_values = 2`):
  no access: V_b = (1+r)·u'(c),
             V_a = (1+ra)·W_a(b', a') below the cap (accrual carries on),
                   0                  at the cap (da'/da = 0: the margin
                                      is truncated until access)
  access:    V_b = (1+r)·u'(c),  V_a = (1+ra)·u'(c)

The access draw is modeled as an i.i.d. exogenous Markov dimension
(`access_process` below), so the distribution block's generic multi-dim
lottery + exogenous mixing handle it with no special cases.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hank_tpu.ops.egm import interp_columns
from hank_tpu.ops.precision import one_minus

# Portfolio regularization (round 4, `portfolio_reg` = χ): the raw split
# FOC g(a') = W_b − W_a is monotone but its slope g′ → 0 for wealth-rich
# households (CRRA curvature vanishes as c grows), so the root a*(x) has
# unbounded sensitivity 1/g′ to ANY fixed-precision evaluation noise in
# the W surfaces — a residual floor (‖F(x*)‖ ≈ 6e-6 on a backend with
# ~1e-13 value noise at the exact root of another, identical under exact
# 1e-15 lowerings of every interpolation AND the income expectation).
# No evaluation-side fix reaches 1e-8 because
# the accumulated ~1e-13 noise of the T-long W recursion — not the split
# arithmetic — is what 1/g′ amplifies. The χ-regularizer reformulates
# the selection: households pay a strictly-convex diversification penalty
#     P(a', s) = χ · W̄(s,e) · (a' − s/2)² / max(s, s₁)
# (W̄ = the mid-line continuation level (W_b+W_a)/2 at b'=a'=s/2, putting
# the penalty in local marginal-utility units so its size is uniformly
# O(χ) relative to each household's own stakes). The FOC gains the linear
# term P_a = 2χ·W̄·(a'−s/2)/max(s,s₁), so the regularized slope is
# bounded below by 2χ·W̄/s: noise amplification is capped at
# δa* ≤ ε·s/(2χ·W̄) — for χ = 1e-3 and relative W noise ε/W̄ ~ 1e-13,
# δa*/s ≲ 5e-11, far below the 1e-8 certification target. Where the raw
# FOC is steep (g′ ≫ χW̄/s: poor/constrained households) the penalty is
# negligible; where it is flat the household was near-indifferent and the
# penalty selects the diversified split among near-optimal ones — a
# smooth, economically-interpretable selection (utility loss is O(χ²·W̄·s)
# at steep cells, ≤ χ·W̄·s/4 at flat ones). χ = 0 recovers the knife-edge
# unregularized split exactly (the penalty term is dropped, not just
# zeroed). The penalty is LINEAR in a' along each budget line, so the
# analytic piecewise-quadratic root structure below is preserved verbatim.
#
# Portfolio-split FOC solve inside one Bellman step: g(a') =
# G(s-a', a') with G = W_b - W_a precomputed on the lattice (ONE bilinear
# per g evaluation, and the exact directional slope comes with it) is
# increasing in a' (both continuation values are concave), so the root
# along each line b' = s - a' is unique. Round 4: the root is found
# DIRECTLY, not iteratively. Restricted to the diagonal line b' = s - a',
# the piecewise-BILINEAR surface G is piecewise-QUADRATIC in a', with
# kinks exactly where the line crosses a grid plane: a' = agrid[j] or
# a' = s - bgrid[i] (flat-extrapolation boundaries included — beyond a
# grid top the restriction is piecewise linear, a special case). So:
# evaluate g at ALL n_a + n_b + 2 candidate breakpoints in ONE wide
# batched pass, bracket the sign change between two consecutive
# breakpoints by monotone max/min reductions (no sort needed), and solve
# the quadratic on that segment ANALYTICALLY from three exact values
# (endpoints + midpoint determine a quadratic). Sequential depth: 2
# batched bilinear passes (wide + midpoint) instead of a
# 1 + 12-bisection + 3-polish ladder — the split is the dominant serial
# depth of the two-asset sweep (each tiny pass is launch-latency bound)
# — and the root is exact to f.p. rounding instead of
# bisection-tolerance, which tightens the residual's evaluation-noise
# floor. The implicit-function step (below) yields the AD derivative.


def fiscalShock(T: int, *, size: float = 0.01, rho: float = 0.8, **kwargs) -> jnp.ndarray:
    """Transitory government-spending path G_t = size · ρᵗ (tax-financed).

    Default size 0.01 ≈ 0.5% of steady-state output. Fixed bond supply makes
    short-run bond demand inelastic, so balanced-budget G shocks move r a
    lot on impact (≈ +300bp at the default size) — much larger shocks push
    a visible mass of households across policy-clip kinks within one period
    and the kinked residual stalls any Newton method at ~1e-4.
    """
    t = jnp.arange(1, T + 1, dtype=jnp.float64)
    return size * rho ** t


def access_process(n: int = 2, lam: float = 0.1):
    """I.i.d. Calvo access dimension: state 0 = locked, 1 = can rebalance.

    Returns (grid, Π) with identical rows (the draw is independent of the
    current state) — the grid-function contract for exogenous dimensions.
    """
    import numpy as np

    grid = np.array([0.0, 1.0])
    Pi = np.array([[1.0 - lam, lam], [1.0 - lam, lam]])
    return grid, Pi


def _expect_income(Vm, Pi):
    """Income expectation W[b, a, e] = Σ_f Vm[b, a, f] · Pi[e, f].

    Under `config.exact_lowerings` (the full-precision residual /
    certification programs) the contraction UNROLLS to elementwise
    scalar·map FMAs, which round at ~1e-15 whatever precision the
    backend's f64 contraction keeps: its per-step rounding would compound
    over the T-long W recursion and the portfolio-split FOC amplifies it
    by 1/g′. The fast path keeps the einsum (n_e = 5: 25 scalar·map
    products is cheap either way, but f32 sweeps prefer one fused GEMM).
    """
    from hank_tpu.config import exact_lowerings_active

    if exact_lowerings_active():
        n_e = Pi.shape[0]
        cols = []
        for e in range(n_e):
            acc = Pi[e, 0] * Vm[..., 0]
            for f in range(1, n_e):
                acc = acc + Pi[e, f] * Vm[..., f]
            cols.append(acc)
        return jnp.stack(cols, axis=-1)
    return jnp.einsum("baf,ef->bae", Vm, Pi)


def _crra_inv_marg(W, gamma):
    """W**(-1/γ) — exact algebraic form at γ = 2 (rsqrt + one Newton polish,
    < 1 ulp) instead of generic pow. An f32 pow lowered as exp2(y·log2 x)
    carries ~2e-6 relative error, enough to floor the two-asset f32
    direction sweeps near ‖F‖ ≈ 8e-7 (a near-exact pow reaches 3e-9)."""
    if float(gamma) == 2.0:
        y = jax.lax.rsqrt(W)
        return y * (1.5 - 0.5 * W * y * y)
    return W ** (-1.0 / gamma)


def _crra_marg(c, gamma):
    """c**(-γ) — exact at γ = 2 (multiply + divide)."""
    if float(gamma) == 2.0:
        return 1.0 / (c * c)
    return c ** (-gamma)


def _interp_val_slope(W: jnp.ndarray, grid: jnp.ndarray, q: jnp.ndarray, axis: int):
    """Piecewise-linear value and slope of W along `axis` at queries q
    (q broadcastable to W's shape with `axis` replaced by q's own axis).
    Flat extrapolation: zero slope outside the grid."""
    n = grid.shape[0]
    gshape = [1] * (q.ndim + 1)
    gshape[-1] = n
    idx = jnp.clip(jnp.sum(grid.reshape(gshape) < q[..., None], axis=-1),
                   1, n - 1)
    lo = grid[idx - 1]
    hi = grid[idx]
    Wlo = jnp.take_along_axis(W, idx - 1, axis=axis)
    Whi = jnp.take_along_axis(W, idx, axis=axis)
    t = jnp.clip((q - lo) / (hi - lo), 0.0, 1.0)
    val = Wlo + t * (Whi - Wlo)
    interior = (q > grid[0]) & (q < grid[-1])
    slope = jnp.where(interior, (Whi - Wlo) / (hi - lo), 0.0)
    return val, slope


def _hat_weights_and_deriv(q: jnp.ndarray, grid: jnp.ndarray):
    """Hat-basis weights H[..., n] and dH/dq for piecewise-linear interp.

    interp(W, q) = Σ_i hat_i(clip(q)) · W[i] — the same identity the forward
    lottery uses (`ops/transition.hat_basis_weights`), applied to
    interpolation: pure broadcast/min/relu arithmetic, NO searchsorted and NO
    gathers, so the contraction against W lowers to a matmul instead of
    advanced-indexing gathers. Flat
    extrapolation: values clamp to the end knots; dH is zero outside the OPEN
    grid interval and on exact knots (measure-zero; matches the `interior`
    convention of `_bilinear`/`_interp_val_slope` up to knot-point ties).
    """
    step_lo = grid[1] - grid[0]
    step_hi = grid[-1] - grid[-2]
    g_lo = jnp.concatenate([grid[:1] - step_lo, grid[:-1]])    # g_{i-1}
    g_hi = jnp.concatenate([grid[1:], grid[-1:] + step_hi])    # g_{i+1}
    p = jnp.clip(q, grid[0], grid[-1])[..., None]
    up = (p - g_lo) / (grid - g_lo)
    down = (g_hi - p) / (g_hi - grid)
    H = jnp.maximum(jnp.minimum(up, down), 0.0)
    interior = ((q > grid[0]) & (q < grid[-1]))[..., None]
    rising = interior & (g_lo < p) & (p < grid)                # left flank
    falling = interior & (grid < p) & (p < g_hi)               # right flank
    dH = (jnp.where(rising, 1.0, 0.0) / (grid - g_lo)
          - jnp.where(falling, 1.0, 0.0) / (g_hi - grid))
    return H, dH


def _bilinear_hat(W: jnp.ndarray, bgrid: jnp.ndarray, agrid: jnp.ndarray,
                  qb: jnp.ndarray, qa: jnp.ndarray):
    """Gather-free `_bilinear`: tensor-product hat-basis contraction.

    val(q) = Σ_ij hat_i(qb)·hat_j(qa)·W[i,j,e] — two small GEMMs per output
    instead of 4 gathers per query. Slopes come from
    the derivative hats; unused outputs are DCE'd by XLA at the call sites
    that discard them.
    """
    Hb, dHb = _hat_weights_and_deriv(qb, bgrid)    # (..., n_e, n_b)
    Ha, dHa = _hat_weights_and_deriv(qa, agrid)    # (..., n_e, n_a)
    T1 = jnp.einsum("...eb,bae->...ea", Hb, W)
    val = jnp.einsum("...ea,...ea->...e", T1, Ha)
    da = jnp.einsum("...ea,...ea->...e", T1, dHa)
    Td = jnp.einsum("...eb,bae->...ea", dHb, W)
    db = jnp.einsum("...ea,...ea->...e", Td, Ha)
    return val, db, da


def _interp_val_slope_hat(W: jnp.ndarray, grid: jnp.ndarray, q: jnp.ndarray,
                          axis: int):
    """Gather-free `_interp_val_slope`: 1-D hat-basis contraction along `axis`."""
    Wm = jnp.moveaxis(W, axis, 0)                  # (n_k, *rest)
    qm = jnp.moveaxis(q, axis, 0)                  # (n_q, *rest)
    H, dH = _hat_weights_and_deriv(qm, grid)       # (n_q, *rest, n_k)
    val = jnp.einsum("q...k,k...->q...", H, Wm)
    slope = jnp.einsum("q...k,k...->q...", dH, Wm)
    return jnp.moveaxis(val, 0, axis), jnp.moveaxis(slope, 0, axis)


def _bilinear2_hat(Ws, bgrid, agrid, qb, qa):
    """`_bilinear_hat` for SEVERAL stacked surfaces Ws (n_b, n_a, n_e, S) at
    the SAME (qb, qa) queries — one hat-weight build + 5 einsums shared
    across surfaces instead of S×(2 builds + 4 einsums) (the sweep's hot
    loop evaluates W_b and W_a at the identical split point). Returns
    (val, d/dqb, d/dqa), each (..., n_e, S); unused slope outputs are DCE'd
    by XLA at call sites that discard them."""
    Hb, dHb = _hat_weights_and_deriv(qb, bgrid)    # (..., n_e, n_b)
    Ha, dHa = _hat_weights_and_deriv(qa, agrid)    # (..., n_e, n_a)
    T1 = jnp.einsum("...eb,baes->...eas", Hb, Ws)
    val = jnp.einsum("...ea,...eas->...es", Ha, T1)
    da = jnp.einsum("...ea,...eas->...es", dHa, T1)
    Td = jnp.einsum("...eb,baes->...eas", dHb, Ws)
    db = jnp.einsum("...ea,...eas->...es", Ha, Td)
    return val, db, da


def _bilinear2_gather(Ws, bgrid, agrid, qb, qa):
    """Gather-backend counterpart of `_bilinear2_hat`: per-surface
    `_bilinear` calls (semantics identical to the unstacked form — the
    exact-lowerings certification path must not change shape/op structure)."""
    outs = [_bilinear(Ws[..., s], bgrid, agrid, qb, qa)
            for s in range(Ws.shape[-1])]
    return tuple(jnp.stack([o[j] for o in outs], axis=-1) for j in range(3))


def _interp_fixed_axis1_hat(Ws, grid, q):
    """Stacked surfaces Ws (n_b, n_k, n_e, S) interpolated along axis 1 at
    queries q (n_q,) SHARED by every (b, e, s) — the no-access capped-accrual
    evaluation point a' = min((1+ra)a, a_max) depends only on a. One tiny
    (n_q, n_k) weight matrix + one einsum instead of the broadcast
    (n_b, n_q, n_e, n_k) weights `_interp_val_slope_hat` would build.
    Returns (n_b, n_q, n_e, S)."""
    H, _ = _hat_weights_and_deriv(q, grid)         # (n_q, n_k)
    return jnp.einsum("bkes,qk->bqes", Ws, H)


def _interp_fixed_axis1_gather(Ws, grid, q):
    """Gather-backend counterpart of `_interp_fixed_axis1_hat` (unchanged
    per-surface `_interp_val_slope` structure for the exact path)."""
    n_b, _, n_e, S = Ws.shape
    q_full = jnp.broadcast_to(q[None, :, None], (n_b, q.shape[0], n_e))
    return jnp.stack(
        [_interp_val_slope(Ws[..., s], grid, q_full, axis=1)[0]
         for s in range(S)], axis=-1)


def _use_hat_interp() -> bool:
    """Hat-basis (gather-free) bilinear interpolation, or the gathers.

    The 4-gathers form of `_bilinear` is the default (~n_b·n_a/4 times
    fewer flops than the hat contraction); `HANK_TPU_BILINEAR` ∈ {hat,
    gather} overrides for A/B probes.
    """
    import os

    from hank_tpu.config import exact_lowerings_active

    if exact_lowerings_active():
        # Full-precision residual program: always the gathers (see
        # config.exact_lowerings).
        return False
    env = os.environ.get("HANK_TPU_BILINEAR")
    if env:
        if env not in ("hat", "gather"):
            raise ValueError(f"HANK_TPU_BILINEAR must be hat|gather, got {env!r}")
        return env == "hat"
    return False


def _bilinear(W: jnp.ndarray, bgrid: jnp.ndarray, agrid: jnp.ndarray,
              qb: jnp.ndarray, qa: jnp.ndarray):
    """Bilinear value + axis slopes of W(b, a, e) at (qb, qa) per e.

    qb, qa: (..., n_e) queries. Returns (val, d/dqb, d/dqa), slopes zero
    outside the grids (flat extrapolation).
    """
    n_b, n_a = bgrid.shape[0], agrid.shape[0]
    ib = jnp.clip(jnp.sum(bgrid.reshape((1,) * qb.ndim + (n_b,)) < qb[..., None],
                          axis=-1), 1, n_b - 1)
    ia = jnp.clip(jnp.sum(agrid.reshape((1,) * qa.ndim + (n_a,)) < qa[..., None],
                          axis=-1), 1, n_a - 1)
    b_lo, b_hi = bgrid[ib - 1], bgrid[ib]
    a_lo, a_hi = agrid[ia - 1], agrid[ia]
    tb = jnp.clip((qb - b_lo) / (b_hi - b_lo), 0.0, 1.0)
    ta = jnp.clip((qa - a_lo) / (a_hi - a_lo), 0.0, 1.0)

    e_idx = jnp.broadcast_to(
        jnp.arange(W.shape[-1]).reshape((1,) * (qb.ndim - 1) + (-1,)), ib.shape)
    W00 = W[ib - 1, ia - 1, e_idx]
    W01 = W[ib - 1, ia, e_idx]
    W10 = W[ib, ia - 1, e_idx]
    W11 = W[ib, ia, e_idx]
    val = ((1 - tb) * (1 - ta) * W00 + (1 - tb) * ta * W01
           + tb * (1 - ta) * W10 + tb * ta * W11)
    in_b = (qb > bgrid[0]) & (qb < bgrid[-1])
    in_a = (qa > agrid[0]) & (qa < agrid[-1])
    db = jnp.where(in_b, ((1 - ta) * (W10 - W00) + ta * (W11 - W01))
                   / (b_hi - b_lo), 0.0)
    da = jnp.where(in_a, ((1 - tb) * (W01 - W00) + tb * (W11 - W10))
                   / (a_hi - a_lo), 0.0)
    return val, db, da


def ValueFunction(value_next, xvals, model):
    """One Bellman step of the Calvo-access two-asset household.

    value_next: (2, n_b, n_a, n_e, 2) packed (∂V/∂b, ∂V/∂a) over the state
    (b, a, e, access). Returns {"Value": same packing, "B", "A", "C"}.
    """
    liquid = model.heterogeneity["liquid"]
    illiq = model.heterogeneity["illiquid"]
    income = model.heterogeneity["income"]
    access = model.heterogeneity["access"]
    bgrid, agrid = liquid.grid, illiq.grid
    Pi = income.transition
    lam = access.transition[0, 1]                 # i.i.d. access probability
    n_b, n_a, n_e = liquid.n, illiq.n, income.n

    if _use_hat_interp():
        bilinear, interp_vs = _bilinear_hat, _interp_val_slope_hat
        bilinear2, interp_fix1 = _bilinear2_hat, _interp_fixed_axis1_hat
    else:
        bilinear, interp_vs = _bilinear, _interp_val_slope
        bilinear2, interp_fix1 = _bilinear2_gather, _interp_fixed_axis1_gather

    p = model.params
    beta, gamma = p["β"], p["γ"]
    r = xvals["r"]
    ra = xvals["ra"]
    tau = xvals["tau"]
    w = xvals["w"]
    # one_minus: see ops/precision.one_minus.
    y_e = jnp.maximum(one_minus(tau) * w, 1e-9) * income.grid  # (n_e,)

    # 1. Post-decision continuations on the (b', a', e) lattice: expectation
    #    over the i.i.d. access draw, then over e' (einsum).
    Vb_next, Va_next = value_next[0], value_next[1]            # (b, a, e, adj)
    Vb_mix = (1.0 - lam) * Vb_next[..., 0] + lam * Vb_next[..., 1]
    Va_mix = (1.0 - lam) * Va_next[..., 0] + lam * Va_next[..., 1]
    Wb = jnp.maximum(beta * _expect_income(Vb_mix, Pi), 1e-12)
    Wa = jnp.maximum(beta * _expect_income(Va_mix, Pi), 1e-12)

    # ── NO-ACCESS problem: capped accrual a' = min((1+ra)a, a_max), excess
    # accrual paid out as liquid income; standard liquid EGM ───────────────
    a_raw = (1.0 + ra) * agrid                                  # (n_a,)
    a_next = jnp.minimum(a_raw, agrid[-1])
    payout = a_raw - a_next                                     # ≥ 0, top only
    capped = a_raw >= agrid[-1]                                 # (n_a,)
    inc_n = payout[None, :, None] + y_e[None, None, :]          # (1, n_a, n_e)
    # Both continuation surfaces at the shared capped-accrual point a_next
    # (a function of a only): one stacked fixed-query interp — Wb_n feeds
    # the liquid EGM here, Wa_n the no-access envelope below.
    WW = jnp.stack([Wb, Wa], axis=-1)                           # (b, a, e, 2)
    W_n = interp_fix1(WW, agrid, a_next)                        # (b, q, e, 2)
    Wb_n, Wa_n = W_n[..., 0], W_n[..., 1]
    c_end_n = _crra_inv_marg(Wb_n, gamma)
    implied_b = (c_end_n + bgrid[:, None, None] - inc_n) / (1.0 + r)
    flat = lambda z: z.reshape(n_b, n_a * n_e)                  # noqa: E731
    pol_b_n = interp_columns(
        bgrid, flat(implied_b),
        jnp.broadcast_to(bgrid[:, None, None], implied_b.shape).reshape(n_b, -1))
    # Policies are clipped into the grid boxes: the state space is truncated
    # at the grid tops, the lottery sends off-grid mass to the last node, and
    # aggregates must be consistent with that truncated distribution.
    pol_b_n = jnp.clip(pol_b_n.reshape(n_b, n_a, n_e),
                       p["borrow_cons"], bgrid[-1])
    pol_a_n = jnp.broadcast_to(a_next[None, :, None], (n_b, n_a, n_e))
    c_n = jnp.maximum((1.0 + r) * bgrid[:, None, None] + inc_n - pol_b_n,
                      1e-12)

    # ── ACCESS problem: optimal split + EGM over total savings ────────────
    # Savings grid spanning total wealth (same double-exp shape as bgrid).
    s_grid = bgrid * ((bgrid[-1] + agrid[-1]) / bgrid[-1])      # (n_s,)
    n_s = n_b
    s2 = jnp.broadcast_to(s_grid[:, None], (n_s, n_e))

    # FOC gap via the DIFFERENCE SURFACE G = W_b − W_a (round 4): one
    # bilinear per evaluation instead of two (the split is the sweep's hot
    # loop), and the slope g' = dG/da' along the line b' = s − a' is the
    # EXACT directional derivative −G_b + G_a (the round-3 form dropped the
    # bilinear cross terms W_b,a and W_a,b — its Newton polish was only
    # linearly convergent and the IFT step needed an extra jvp of g).
    G = Wb - Wa

    # Strictly-convex diversification penalty (module header): adds the
    # LINEAR term pen_slope·(a' − s/2) to the FOC gap, bounding its slope
    # below by pen_slope = 2χ·W̄/max(s, s₁) so the root's noise
    # amplification is capped at s/(2χ) in relative-W units. W̄ is the
    # mid-line continuation level — one extra pair of bilinears per
    # Bellman step, constant along each budget line (the penalty must be
    # linear in a' to preserve the exact quadratic-root solve below).
    chi = float(p.get("portfolio_reg", 0.0))
    if chi > 0.0:
        mid = 0.5 * s2
        # Only the SUM W_b + W_a enters the penalty scale: one bilinear of
        # the summed surface instead of two.
        wsum_mid, _, _ = bilinear(Wb + Wa, bgrid, agrid, mid, mid)
        pen_slope = chi * wsum_mid / jnp.maximum(s2, s_grid[1])  # (n_s, n_e)
    else:
        pen_slope = None

    def g_fun(a_s):
        """FOC gap g = G(s - a', a') (+ penalty) along the line, and its
        exact slope.

        g is increasing in a' (both continuation values are concave and
        the penalty is convex), so gp = G_a - G_b (+ pen_slope) > 0 away
        from flat-extrapolation regions.
        """
        b_s = s2 - a_s
        gv, g_db, g_da = bilinear(G, bgrid, agrid, b_s, a_s)
        gp = g_da - g_db
        if pen_slope is not None:
            gv = gv + pen_slope * (a_s - 0.5 * s2)
            gp = gp + pen_slope
        return gv, gp

    # Wide breakpoint pass: g at every cell-boundary crossing of the line
    # b' = s - a' (a-knots, b-knots, both endpoints), clipped into [0, s],
    # in ONE batched interp pass (slopes are dead code here — XLA DCEs
    # them). Between consecutive breakpoints g is an exact quadratic.
    a_knots = jnp.broadcast_to(agrid[:, None, None], (n_a, n_s, n_e))
    b_knots = s2[None] - jnp.broadcast_to(bgrid[:, None, None],
                                          (n_b, n_s, n_e))
    cand = jnp.concatenate([jnp.zeros((1, n_s, n_e), s2.dtype),
                            a_knots, b_knots, s2[None]], axis=0)
    cand = jnp.clip(cand, 0.0, s2[None])                   # (K, n_s, n_e)
    g_cand, _ = g_fun(cand)
    g_lo, g_hi = g_cand[0], g_cand[-1]                     # corner tests below

    # Monotone bracket without a sort: g increasing in a' means the largest
    # NEGATIVE candidate is the left neighbor of the root and the smallest
    # NON-NEGATIVE candidate the right one — and their g values are the
    # max-over-negatives / min-over-nonnegatives respectively, so argmax
    # gathers are unnecessary. Empty sides (root at a corner) are patched
    # with finite placeholders; the corner selection below overwrites them.
    neg = g_cand < 0
    big = jnp.asarray(jnp.finfo(s2.dtype).max, s2.dtype)
    lo = jnp.max(jnp.where(neg, cand, -big), axis=0)
    hi = jnp.min(jnp.where(neg, big, cand), axis=0)
    g0 = jnp.max(jnp.where(neg, g_cand, -big), axis=0)
    g1 = jnp.min(jnp.where(neg, big, g_cand), axis=0)
    has_neg = jnp.any(neg, axis=0)
    has_pos = jnp.any(~neg, axis=0)
    lo = jnp.where(has_neg, lo, 0.0)
    g0 = jnp.where(has_neg, g0, -1.0)
    hi = jnp.where(has_pos, hi, s2)
    g1 = jnp.where(has_pos, g1, 1.0)

    # Quadratic on [lo, hi] from three exact values (endpoints + midpoint);
    # u = (a' - lo)/h. The stable-citardauq pair covers the a2 → 0 (linear
    # segment, e.g. flat extrapolation) limit without a branch.
    h = hi - lo
    gm, _ = g_fun(0.5 * (lo + hi))
    a0 = g0
    a1c = -3.0 * g0 + 4.0 * gm - g1
    a2c = 2.0 * g0 - 4.0 * gm + 2.0 * g1
    disc = jnp.maximum(a1c * a1c - 4.0 * a2c * a0, 0.0)
    sgn = jnp.where(a1c >= 0, 1.0, -1.0)
    q = -0.5 * (a1c + sgn * jnp.sqrt(disc))
    u_a = a0 / jnp.where(jnp.abs(q) > 0, q, 1.0)           # citardauq root
    u_b = q / jnp.where(jnp.abs(a2c) > 0, a2c, 1.0)        # classic root
    in01 = (u_a >= 0.0) & (u_a <= 1.0) & (jnp.abs(q) > 0)
    u = jnp.clip(jnp.where(in01, u_a, u_b), 0.0, 1.0)
    a_iter = jnp.where(h > 0, lo + u * h, lo)

    # Differentiate the root IMPLICITLY, not through the iterations: the
    # bisection selects carry no useful tangent and would leave an AD
    # Jacobian inconsistent with F (measured rel. error ≈ 0.9 in round 2,
    # no Newton descent). One Newton step at the stop_gradient'ed root,
    # with the exact directional slope g_a held constant, reproduces
    # a* = a − g/g_a with g ≈ 0: the primal is unchanged and AD yields the
    # implicit-function derivative −g_θ/g_a. The G-surface g_fun returns
    # the exact slope analytically (cross terms included) — no jvp needed.
    a_iter = jax.lax.stop_gradient(a_iter)
    g_at, g_a = g_fun(a_iter)
    g_a = jnp.maximum(jax.lax.stop_gradient(g_a), 1e-10)
    a_star = jnp.clip(a_iter - g_at / g_a, 0.0, s2)
    # Corners: marginal unit strictly better in one asset over [0, s].
    a_star = jnp.where(g_lo >= 0, 0.0, jnp.where(g_hi <= 0, s2, a_star))
    b_star = s2 - a_star
    # Both surfaces at the identical split point: shared weight build.
    w_ba, w_db, w_da = bilinear2(WW, bgrid, agrid, b_star, a_star)
    wb_s, wa_s = w_ba[..., 0], w_ba[..., 1]
    wb_db, wa_db = w_db[..., 0], w_db[..., 1]
    wb_da, wa_da = w_da[..., 0], w_da[..., 1]
    # Marginal value of savings. At an interior split both surfaces agree
    # and the true envelope derivative w.r.t. any parameter θ is the
    # slope-weighted combination (−wa'·dW_b + wb'·dW_a)/g' (wb', wa' the
    # directional slopes along the budget line, g' = wb' − wa'). Evaluating
    # W_s as that SAME combination of the two surface values,
    #     M̂ = (wb'·wa − wa'·wb) / g',
    # has two properties max(wb, wa) lacks (round-4 reformulation):
    #   1. first-order INSENSITIVITY to split error δ = a_computed − a*:
    #      wb ≈ M + δ·wb', wa ≈ M + δ·wa' cancel exactly in M̂, so the
    #      1/g' noise amplification of the root-find (per-op rounding →
    #      ~3e4× policy deviations) never re-enters the value
    #      recursion — the backward pass stays a β-contraction for
    #      evaluation noise;
    #   2. the AD derivative of M̂ IS the envelope derivative (max picks
    #      one branch and mis-weights dW_b vs dW_a at first order).
    # At corners (or where flat extrapolation degrades the slopes) the
    # marginal unit goes to the better asset: fall back to max.
    wbp = wb_da - wb_db                                        # ≥ 0 interior
    wap = wa_da - wa_db                                        # ≤ 0 interior
    gp_s = wbp - wap
    combo_ok = ((a_star > 0.0) & (a_star < s2)
                & (wbp >= 0.0) & (wap <= 0.0) & (gp_s > 1e-10))
    M_combo = (wbp * wa_s - wap * wb_s) / jnp.where(combo_ok, gp_s, 1.0)
    W_s = jnp.where(combo_ok, M_combo,
                    jnp.maximum(wb_s, wa_s))                   # (n_s, n_e)

    c_end_s = _crra_inv_marg(W_s, gamma)
    w_knots = c_end_s + s2                                      # (n_s, n_e), increasing

    # On-grid cash-on-hand and savings policy via the endogenous w-grid.
    w_grid = ((1.0 + r) * bgrid[:, None, None]
              + (1.0 + ra) * agrid[None, :, None] + y_e[None, None, :])
    wq = w_grid.reshape(n_b * n_a, n_e)
    pol_s = jnp.clip(interp_columns(wq, w_knots, s2), 0.0, None)  # (n_b·n_a, n_e)
    pol_a_a = interp_columns(pol_s, s2, a_star)                 # split at s*
    pol_a_a = jnp.clip(pol_a_a, 0.0, jnp.minimum(pol_s, agrid[-1]))
    pol_b_a = jnp.clip(pol_s - pol_a_a, p["borrow_cons"], bgrid[-1])
    # Consumption from the FINAL clipped policies: when a grid-top clip
    # binds, the overflow is consumed — the budget identity
    # c + b' + a' = coh then holds exactly at every state, so aggregate
    # accounting (Walras) is exact up to the no-access cap payout scheme.
    c_a = jnp.maximum(wq - pol_b_a - pol_a_a, 1e-12)

    pol_b_a = pol_b_a.reshape(n_b, n_a, n_e)
    pol_a_a = pol_a_a.reshape(n_b, n_a, n_e)
    c_a = c_a.reshape(n_b, n_a, n_e)

    # ── Envelopes + assembly over the access axis ──────────────────────────
    up_n = _crra_marg(c_n, gamma)
    up_a = _crra_marg(c_a, gamma)
    # No access: the marginal illiquid unit accrues to (1+ra) units of a'
    # below the cap (continuation value W_a at (b', a')); at the cap
    # da'/da = 0 and the no-access margin is worthless (the access branch,
    # mixed in with weight λ upstream, carries the cap's remaining value).
    # Wa_n (Wa at the capped accrual point) comes from the stacked
    # fixed-query interp in the no-access block above.
    Wa_n_at_b, _ = interp_vs(Wa_n, bgrid, pol_b_n, axis=0)
    Va_margin_n = jnp.where(capped[None, :, None], 0.0, Wa_n_at_b)

    Vb_n_new = (1.0 + r) * up_n
    Va_n_new = (1.0 + ra) * Va_margin_n
    Vb_a_new = (1.0 + r) * up_a
    Va_a_new = (1.0 + ra) * up_a

    stack_adj = lambda n, a: jnp.stack([n, a], axis=-1)         # noqa: E731
    value = jnp.stack([stack_adj(Vb_n_new, Vb_a_new),
                       stack_adj(Va_n_new, Va_a_new)])
    return {
        "Value": value,
        "B": stack_adj(pol_b_n, pol_b_a),
        "A": stack_adj(pol_a_n, pol_a_a),
        "C": stack_adj(c_n, c_a),
    }


ValueFunction.n_values = 2
