"""Two-asset HANK (fiscal shock): the real two-endogenous-dimension model.

BASELINE config 3. Household state (liquid, illiquid, productivity, access):
a Calvo-access portfolio choice (see models/hank_two_asset.py) makes both
asset policies depend on the full state. Closure: illiquid claims finance
productive capital (KS = A, ra/w from MPK/MPL), the liquid bond market pins
r, and a balanced-budget labor tax funds debt service plus the G shock.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.models import load_model
from tests.conftest import solve_ss_cached


def build_small_two_asset(T=12, n_b=24, n_a=12, n_e=4, lam=0.10):
    from hank_tpu.model.grids import make_double_exponential_grid, rouwenhorst
    from hank_tpu.model.structures import HeterogeneityDimension
    from hank_tpu.models.hank_two_asset import access_process

    model = load_model("hank_two_asset", T=T)
    liq = HeterogeneityDimension(
        "liquid", "endogenous", n_b,
        jnp.asarray(make_double_exponential_grid(0.0, 120.0, n_b)), None, "B")
    ill = HeterogeneityDimension(
        "illiquid", "endogenous", n_a,
        jnp.asarray(make_double_exponential_grid(0.0, 200.0, n_a)), None, "A")
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    inc = HeterogeneityDimension(
        "income", "exogenous", n_e, jnp.asarray(z), jnp.asarray(Pi), None)
    g, P = access_process(2, lam)
    acc = HeterogeneityDimension(
        "access", "exogenous", 2, jnp.asarray(g), jnp.asarray(P), None)
    return dataclasses.replace(
        model, heterogeneity={"liquid": liq, "illiquid": ill,
                              "income": inc, "access": acc})


@pytest.fixture(scope="module")
def ta_model():
    return build_small_two_asset()


@pytest.fixture(scope="module")
def ta_ss(ta_model):
    return solve_ss_cached(ta_model)


def test_two_asset_ss_clears_markets_and_production(ta_model, ta_ss):
    p = ta_model.params
    alpha, delta = p["α"], p["δ"]
    r, ra, w, tau, KS = (float(ta_ss.vars[k])
                         for k in ("r", "ra", "w", "tau", "KS"))
    assert abs(float(ta_ss.vars["B"]) - p["Bg"]) < 1e-8     # liquid clearing
    assert abs(float(ta_ss.vars["A"]) - KS) < 1e-8          # claims = capital
    assert abs(ra + delta - alpha * KS ** (alpha - 1)) < 1e-9   # MPK
    assert abs(w - (1 - alpha) * KS ** alpha) < 1e-9            # MPL
    assert abs(tau * w - r * p["Bg"]) < 1e-9                # budget balance
    assert ra > r                                           # liquidity premium
    # Goods market (Walras): C = Y − δK with Y = K^α, L = 1.
    assert abs(float(ta_ss.vars["C"]) - (KS ** alpha - delta * KS)) < 1e-6
    assert abs(float(ta_ss.D.sum()) - 1.0) < 1e-10
    assert ta_ss.D.shape == (24, 12, 4, 2)


def test_two_asset_portfolio_choice_is_real(ta_model, ta_ss):
    """Both asset policies depend on the FULL state: ∂a'/∂b ≠ 0 for
    adjusters, and the adjusters' split satisfies the interior FOC
    W_b(b', a') ≈ W_a(b', a') where it is interior."""
    polA = np.asarray(ta_ss.policies["A"])
    polB = np.asarray(ta_ss.policies["B"])
    ra = float(ta_ss.vars["ra"])
    agrid = np.asarray(ta_model.heterogeneity["illiquid"].grid)

    # Access state (adj=1): the illiquid policy varies with liquid wealth b.
    adjA = polA[..., 1]
    assert np.max(np.abs(adjA[0] - adjA[-1])) > 1e-3
    # No-access state (adj=0): capped accrual a' = min((1+ra)a, a_max),
    # independent of b (excess accrual pays out into the liquid budget).
    nadjA = polA[..., 0]
    assert np.allclose(nadjA[0], nadjA[-1], atol=1e-12)
    assert np.allclose(nadjA[0],
                       np.minimum((1 + ra) * agrid, agrid[-1])[:, None],
                       atol=1e-10)
    # Liquid policy depends on the illiquid state for adjusters (pooling).
    assert np.max(np.abs(polB[:, 0, :, 1] - polB[:, -1, :, 1])) > 1e-3


def test_two_asset_split_foc(ta_model, ta_ss):
    """Interior adjusters equate continuation marginal values across assets."""
    model, ss = ta_model, ta_ss
    Pi = model.heterogeneity["income"].transition
    lam = model.heterogeneity["access"].transition[0, 1]
    beta = model.params["β"]
    Vb, Va = ss.value[0], ss.value[1]
    Vb_mix = (1 - lam) * Vb[..., 0] + lam * Vb[..., 1]
    Va_mix = (1 - lam) * Va[..., 0] + lam * Va[..., 1]
    Wb = beta * jnp.einsum("baf,ef->bae", Vb_mix, Pi)
    Wa = beta * jnp.einsum("baf,ef->bae", Va_mix, Pi)

    from hank_tpu.models.hank_two_asset import _bilinear
    bgrid = model.heterogeneity["liquid"].grid
    agrid = model.heterogeneity["illiquid"].grid
    polB = ss.policies["B"][..., 1]          # adjusters
    polA = ss.policies["A"][..., 1]
    n_b, n_a, n_e = polB.shape
    wb, _, _ = _bilinear(Wb, bgrid, agrid, polB.reshape(-1, n_e),
                         polA.reshape(-1, n_e))
    wa, _, _ = _bilinear(Wa, bgrid, agrid, polB.reshape(-1, n_e),
                         polA.reshape(-1, n_e))
    interior = (np.asarray(polA.reshape(-1, n_e)) > 1e-6) & \
               (np.asarray(polB.reshape(-1, n_e)) > 1e-6)
    rel = np.abs(np.asarray(wb - wa)) / np.asarray(wb)
    # FOC holds to interpolation accuracy on interior splits.
    assert np.median(rel[interior]) < 5e-3
    assert np.mean(rel[interior] < 0.05) > 0.95


def test_two_asset_pipeline_consistency(ta_model, ta_ss):
    from hank_tpu.solvers.steady_state import single_run

    Tm1 = ta_model.compspec.T - 1
    res = single_run(ta_ss, ta_ss, ta_model, {"G": jnp.zeros(Tm1)})
    assert float(jnp.max(jnp.abs(res))) < 1e-8


def test_two_asset_derivative_consistency(ta_model, ta_ss):
    """AD JVP of the full equilibrium map agrees with central finite
    differences — guards the implicit differentiation of the portfolio-split
    root (a bisection/polish whose iterations are NOT differentiated; a
    stop_gradient + one exact-slope Newton step carries the IFT derivative)."""
    import jax

    from hank_tpu.models.hank_two_asset import fiscalShock
    from hank_tpu.solvers.newton import make_full_residual_fn

    model, ss = ta_model, ta_ss
    Tm1 = model.compspec.T - 1
    F = make_full_residual_fn(model, ss, ss, {"G": fiscalShock(Tm1)})
    names = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss.vars[k] for k in names]), Tm1)
    v = jax.random.normal(jax.random.PRNGKey(0), x0.shape, x0.dtype)
    v = v / jnp.linalg.norm(v)
    jv = jax.jvp(F, (x0,), (v,))[1]
    h = 1e-6
    fd = (F(x0 + h * v) - F(x0 - h * v)) / (2 * h)
    rel = float(jnp.linalg.norm(jv - fd) / jnp.linalg.norm(jv))
    # FD carries O(1e-5) truncation noise across the model's policy-clip
    # kinks; the defect this guards against measured rel ≈ 0.9.
    assert rel < 1e-4


def test_two_asset_jacobian_matches_dense(ta_model, ta_ss):
    from hank_tpu.solvers.ss_jacobian import (
        dense_path_jacobian,
        get_steady_state_jacobian,
    )

    J = np.asarray(get_steady_state_jacobian(ta_ss, ta_model))
    Jd = np.asarray(dense_path_jacobian(ta_ss, ta_ss, ta_model))
    assert np.abs(J - Jd).max() < 1e-8


def test_two_asset_fiscal_shock(ta_model, ta_ss):
    from hank_tpu.models.hank_two_asset import fiscalShock
    from hank_tpu.solvers.newton import newton_raphson_hank
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

    model, ss = ta_model, ta_ss
    Tm1 = model.compspec.T - 1
    exog = {"G": fiscalShock(Tm1)}
    names = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss.vars[k] for k in names]), Tm1)
    J = get_steady_state_jacobian(ss, model)
    x, info = newton_raphson_hank(x0, J, exog, model, ss, ss,
                                  method="newton_krylov", eps=1e-9)
    assert float(info["residual_norm"]) < 1e-9
    path = np.asarray(x).reshape(Tm1, len(names))
    tau_path = path[:, names.index("tau")]
    # Tax-financed spending raises the labor tax on impact.
    assert tau_path[0] > float(ss.vars["tau"]) + 1e-4
    # The path decays back toward the steady state (short-run bond demand
    # is inelastic, so r_t tracks the decaying G_t with a large multiplier —
    # at T=12 the terminal deviation is small but not yet zero).
    ss_row = np.asarray([float(ss.vars[k]) for k in names])
    dev = np.abs(path - ss_row).max(axis=1)
    assert dev[-1] < 0.1 * dev[0]


def test_expect_income_unrolled_matches_einsum():
    """The exact-lowerings elementwise expectation == the einsum (CPU f64
    makes both exact; the unrolled form rounds ~1e-15 on any backend)."""
    import numpy as np
    from hank_tpu.config import exact_lowerings
    from hank_tpu.models.hank_two_asset import _expect_income

    rng = np.random.default_rng(11)
    Vm = jnp.asarray(rng.normal(size=(8, 6, 5)))
    Pi = jnp.asarray(rng.dirichlet(np.ones(5), size=5))
    fast = _expect_income(Vm, Pi)
    with exact_lowerings(True):
        exact = _expect_income(Vm, Pi)
    assert float(jnp.max(jnp.abs(fast - exact))) < 1e-14


def test_load_model_param_override():
    """`load_model(params=...)` patches model parameters and rejects typos."""
    m0 = load_model("hank_two_asset", T=8)
    assert m0.params["portfolio_reg"] == pytest.approx(1e-3)
    m1 = load_model("hank_two_asset", T=8, params={"portfolio_reg": 0.0})
    assert m1.params["portfolio_reg"] == 0.0
    with pytest.raises(KeyError):
        load_model("hank_two_asset", params={"portfolio_regg": 0.0})


def test_portfolio_reg_pins_indifferent_splits(ta_model, ta_ss):
    """The χ-regularizer makes the split well-conditioned at exact
    indifference — the knife-edge case behind a noise-amplified residual
    floor (models/hank_two_asset.py module header).

    With Vb ≡ Va the raw FOC gap is identically ~0 along every budget line
    (every split is optimal) and the unregularized root is pure
    noise/tie-break selection. The penalty must (a) select the diversified
    split a* = s/2, and (b) bound the split's response to a 1e-9 relative
    perturbation of the surfaces by ε·s/(2χ·W̄)-scale — the certification
    mechanism for the two-asset residual.
    """
    import dataclasses as dc

    V = ta_ss.value
    # Symmetric continuation: same concave surface for both assets.
    Vsym = jnp.stack([V[0], V[0]])
    xv = {k: jnp.asarray(float(ta_ss.vars[k])) for k in ("r", "ra", "tau", "w")}
    from hank_tpu.models.hank_two_asset import ValueFunction

    chi = ta_model.params["portfolio_reg"]
    assert chi > 0.0
    out0 = ValueFunction(Vsym, xv, ta_model)
    polA = out0["A"][..., 1]                   # access branch
    polB = out0["B"][..., 1]
    tot = polA + jnp.maximum(polB, 0.0)
    bgrid = ta_model.heterogeneity["liquid"].grid
    agrid = ta_model.heterogeneity["illiquid"].grid
    # interior = unclipped both ways: the richest cells hit the bgrid-top
    # clip on B (b* = s/2 > b_max), which re-splits the savings by the box
    # constraint rather than the FOC.
    interior = ((polA > 1e-3) & (polB > 1e-3) & (tot > 1e-2)
                & (polB < 0.95 * bgrid[-1]) & (polA < 0.95 * agrid[-1]))
    # (a) diversified selection: a' ≈ s'/2 wherever the split is interior.
    dev = jnp.abs(polA - 0.5 * tot) / jnp.maximum(tot, 1e-2)
    assert float(jnp.max(jnp.where(interior, dev, 0.0))) < 5e-2

    # (b) noise amplification is bounded: 1e-9 relative surface noise moves
    # the access-branch policies by ≲ eps·s/(2χ) ≈ 1e-9·300/2e-3 ≈ 1.5e-4.
    key = jax.random.PRNGKey(3)
    noise = 1e-9 * Vsym * jax.random.normal(key, Vsym.shape)
    out1 = ValueFunction(Vsym + noise, xv, ta_model)
    dA = float(jnp.max(jnp.abs(out1["A"][..., 1] - polA)))
    assert dA < 5e-4

    # The χ = 0 knife-edge: same perturbation, unregularized split. The
    # response is orders of magnitude larger (pure tie-break selection) —
    # this is the residual-floor mechanism, kept as a regression witness
    # that the test actually exercises the ill-conditioned regime.
    m0 = dc.replace(ta_model, params={**ta_model.params, "portfolio_reg": 0.0})
    o0 = ValueFunction(Vsym, xv, m0)
    o1 = ValueFunction(Vsym + noise, xv, m0)
    dA0 = float(jnp.max(jnp.abs(o1["A"][..., 1] - o0["A"][..., 1])))
    assert dA0 > 10 * dA


def test_portfolio_reg_chi_to_zero_limit(ta_model, ta_ss):
    """χ → 0 recovers the unregularized split CONTINUOUSLY: applying the
    Bellman operator to the same continuation value, the policy distance to
    the χ = 0 policies shrinks ~linearly in χ and is negligible by χ = 1e-7
    — so the shipped χ = 1e-3 default is a small, controlled perturbation of
    the knife-edge model and `params={'portfolio_reg': 0.0}` is its exact
    limit (the economics users expect after on-chip certification)."""
    import dataclasses as dc

    from hank_tpu.models.hank_two_asset import ValueFunction

    V = ta_ss.value
    xv = {k: jnp.asarray(float(ta_ss.vars[k])) for k in ("r", "ra", "tau", "w")}

    def pol_at(chi):
        m = dc.replace(ta_model,
                       params={**ta_model.params, "portfolio_reg": chi})
        out = ValueFunction(V, xv, m)
        return out["A"][..., 1], out["B"][..., 1]

    A0, B0 = pol_at(0.0)
    dists = {}
    for chi in (1e-3, 1e-5, 1e-7):
        A, B = pol_at(chi)
        dists[chi] = max(float(jnp.max(jnp.abs(A - A0))),
                         float(jnp.max(jnp.abs(B - B0))))
    # Monotone decay, ~linear in χ (allow 5x slack per 100x χ-step: the
    # local penalty scale W̄/g′ varies across cells).
    assert dists[1e-5] < dists[1e-3] / 5
    assert dists[1e-7] < dists[1e-5] / 5
    # The χ = 1e-7 operator is numerically the unregularized one.
    assert dists[1e-7] < 1e-5
    # And χ = 1e-3 itself is a small model change (policy units are asset
    # levels up to ~300).
    assert dists[1e-3] < 0.5


def test_hat_vs_gather_bellman_step(ta_model, ta_ss, monkeypatch):
    """The hat-basis Bellman lowering (an override) == the gather lowering
    on CPU f64 — guards the hat-only code paths (`_bilinear_hat`,
    `_bilinear2_hat`, `_interp_fixed_axis1_hat`) that no other CPU test
    exercises (caught a real operand-order bug in `_bilinear2_hat`)."""
    V = ta_ss.value
    xv = {k: jnp.asarray(float(ta_ss.vars[k])) for k in ("r", "ra", "tau", "w")}
    from hank_tpu.models.hank_two_asset import ValueFunction

    monkeypatch.setenv("HANK_TPU_BILINEAR", "gather")
    monkeypatch.setenv("HANK_TPU_INTERP", "gather")
    ref = ValueFunction(V, xv, ta_model)
    monkeypatch.setenv("HANK_TPU_BILINEAR", "hat")
    monkeypatch.setenv("HANK_TPU_INTERP", "hat")
    hat = ValueFunction(V, xv, ta_model)
    for k in ("Value", "B", "A", "C"):
        err = float(jnp.max(jnp.abs(hat[k] - ref[k])))
        assert err < 1e-8, (k, err)


def test_one_minus_semantics():
    """`ops/precision.one_minus` must be semantically identical to 1 - x.

    It exists ONLY as an emulated-f64 erratum workaround (jitted
    literal-minus-traced-scalar can round at f32 there); on every IEEE
    backend both forms are exactly rounded and bitwise equal.
    """
    import jax
    from hank_tpu.ops.precision import one_minus

    vals = jnp.asarray([0.0, 1.0, 0.181243817238974, -2.5, 1e-12, 1e12])
    direct = 1.0 - vals
    assert bool(jnp.all(one_minus(vals) == direct))
    assert bool(jnp.all(jax.jit(one_minus)(vals) == direct))
    # scalar form (the production use: per-period tau)
    s = jnp.asarray(0.181243817238974)
    assert float(jax.jit(one_minus)(s)) == float(1.0 - s)


def test_two_asset_income_uses_one_minus():
    """The per-period income scalar must route through `one_minus` — a
    plain `1.0 - tau` re-introduces a ~2e-8 scalar-subtract bias on an
    emulated-f64 backend, a certification floor of the two-asset model.
    Source-level guard: the erratum cannot be reproduced on the CPU test
    mesh."""
    import inspect

    from hank_tpu.models.hank_two_asset import ValueFunction

    src = inspect.getsource(ValueFunction)
    assert "one_minus(tau)" in src
    assert "(1.0 - tau)" not in src
