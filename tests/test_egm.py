"""EGM step and interpolation primitives."""

import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.ops.egm import egm_consumption, interp_columns


def test_interp_columns_matches_numpy():
    rng = np.random.default_rng(0)
    knots = np.sort(rng.uniform(0, 10, size=(17, 3)), axis=0)
    vals = rng.normal(size=(17, 3))
    x = np.linspace(-1.0, 11.0, 25)  # includes out-of-range queries
    out = np.asarray(interp_columns(jnp.asarray(x), jnp.asarray(knots), jnp.asarray(vals)))
    for e in range(3):
        expected = np.interp(x, knots[:, e], vals[:, e])  # flat extrapolation
        assert np.allclose(out[:, e], expected, atol=1e-14)


def test_interp_columns_hat_matches_gather():
    """Gather-free hat-basis lowering == gather lerp on monotone knots,
    including out-of-range (flat extrapolation) and exact-knot queries, and
    its JVP matches too (the batched-ensemble hot path differentiates it)."""
    import jax

    rng = np.random.default_rng(1)
    knots = np.sort(rng.uniform(0, 10, size=(33, 5)), axis=0)
    vals = rng.normal(size=(33, 5))
    x = np.concatenate([np.linspace(-1.0, 11.0, 40), knots[7, :]])
    args = (jnp.asarray(x), jnp.asarray(knots), jnp.asarray(vals))
    ref = interp_columns(*args, mode="gather")
    hat = interp_columns(*args, mode="hat")
    assert np.allclose(np.asarray(hat), np.asarray(ref), atol=1e-12)

    tangents = tuple(jnp.asarray(rng.normal(size=a.shape)) for a in args)
    _, d_ref = jax.jvp(lambda *a: interp_columns(*a, mode="gather"),
                       args, tangents)
    _, d_hat = jax.jvp(lambda *a: interp_columns(*a, mode="hat"),
                       args, tangents)
    # Derivatives differ only at measure-zero kink points (exact knots);
    # the interior queries here avoid them except the appended knot hits,
    # where both conventions clamp consistently for value but the knot
    # tangent may pick either bracket — compare away from the knots.
    assert np.allclose(np.asarray(d_hat)[:40], np.asarray(d_ref)[:40],
                       atol=1e-12)


def test_interp_columns_hat_tied_interior_knots():
    """An interior TIED knot pair degrades exactly: hat weights still sum to
    1 and the interpolant matches the gather form's values everywhere except
    at the tie itself, where the two forms pick different duplicates (a
    genuine value ambiguity — see `_interp_columns_hat`). Regression for the
    round-3 advisor finding (weights summed to 0.5 on [0, 1, 1, 2])."""
    knots = np.array([[0.0], [1.0], [1.0], [2.0]])
    vals = np.array([[10.0], [20.0], [30.0], [40.0]])
    x = np.array([-0.5, 0.25, 0.999, 1.25, 1.0, 2.0, 2.5])
    hat = np.asarray(interp_columns(jnp.asarray(x), jnp.asarray(knots),
                                    jnp.asarray(vals), mode="hat"))[:, 0]
    # Left interval interpolates knot0..knot1 (left dup), right interval
    # knot2 (right dup)..knot3; flat extrapolation at the ends.
    expected = np.array([10.0, 12.5, 10.0 + 0.999 * 10.0,
                         30.0 + 0.25 * 10.0, 30.0, 40.0, 40.0])
    assert np.allclose(hat, expected, atol=1e-12)

    # On strictly increasing knots the tied-knot handling must be inert:
    rng = np.random.default_rng(2)
    k2 = np.sort(rng.uniform(0, 5, size=(9, 2)), axis=0)
    v2 = rng.normal(size=(9, 2))
    q = np.concatenate([np.linspace(-1, 6, 31), k2[4, :]])
    a = interp_columns(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                       mode="hat")
    b = interp_columns(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                       mode="gather")
    assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_egm_consumption_euler_inversion():
    Pi = jnp.asarray([[0.9, 0.1], [0.2, 0.8]])
    v_next = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    beta, gamma = 0.95, 2.0
    c = egm_consumption(v_next, Pi, beta, gamma)
    expected = (0.95 * np.array([[0.9 * 1 + 0.1 * 2, 0.2 * 1 + 0.8 * 2],
                                 [0.9 * 3 + 0.1 * 4, 0.2 * 3 + 0.8 * 4]])) ** (-0.5)
    assert np.allclose(np.asarray(c), expected, atol=1e-14)


def test_ks_value_fn_properties(ks_small):
    """One EGM step: budget identity, borrowing constraint, monotonicity."""
    model = ks_small
    n_a = model.heterogeneity["wealth"].n
    n_e = model.heterogeneity["productivity"].n
    grid = model.heterogeneity["wealth"].grid
    zgrid = model.heterogeneity["productivity"].grid
    xvals = {"Y": 2.1, "KS": 8.0, "r": 0.015, "w": 1.35, "KD": 8.0, "Z": 1.0}

    v0 = jnp.ones((n_a, n_e))
    out = model.value_fn(v0, xvals, model)
    assert set(out.keys()) == {"Value", "KD"}
    pol = np.asarray(out["KD"])
    val = np.asarray(out["Value"])
    assert pol.shape == (n_a, n_e) and val.shape == (n_a, n_e)

    # Borrowing constraint respected
    assert pol.min() >= model.params["borrow_cons"] - 1e-15

    # Savings policy weakly increasing in wealth (monotone EGM)
    assert np.all(np.diff(pol, axis=0) >= -1e-10)

    # Marginal value = (1+r) c^(-gamma) with c from the budget constraint
    r, w, gamma = xvals["r"], xvals["w"], model.params["γ"]
    c = (1 + r) * np.asarray(grid)[:, None] + w * np.asarray(zgrid)[None, :] - pol
    assert np.all(c > 0)
    assert np.allclose(val, (1 + r) * c ** (-gamma), atol=1e-10)


def test_vfi_converges_and_is_stationary(ks_small):
    """The VFI fixed point satisfies v* = Bellman(v*) to tolerance."""
    from hank_tpu.solvers.steady_state import make_vfi_solver

    model = ks_small
    vfi = make_vfi_solver(model)
    xvec = jnp.asarray([2.11, 8.01, 0.01506, 1.3535, 8.01, 1.0])
    v_star = vfi(xvec)
    names = model.var_names()
    xvals = {n: xvec[i] for i, n in enumerate(names)}
    v_again = model.value_fn(v_star, xvals, model)["Value"]
    assert float(jnp.max(jnp.abs(v_again - v_star))) < 1e-9


def test_vfi_implicit_jvp_matches_finite_difference(ks_small):
    """Implicit-diff tangent vs central finite difference through the solve."""
    import jax

    from hank_tpu.solvers.steady_state import make_vfi_solver

    model = ks_small
    vfi = make_vfi_solver(model)
    xvec = jnp.asarray([2.11, 8.01, 0.01506, 1.3535, 8.01, 1.0])
    dx = jnp.zeros(6).at[2].set(1.0)  # perturb r

    _, dv = jax.jvp(vfi, (xvec,), (dx,))
    h = 1e-6
    fd = (vfi(xvec + h * dx) - vfi(xvec - h * dx)) / (2 * h)
    denom = float(jnp.max(jnp.abs(fd))) + 1.0
    assert float(jnp.max(jnp.abs(dv - fd))) / denom < 1e-4


@pytest.mark.parametrize("env_mode,expected", [(None, "gather"),
                                               ("hat", "hat"),
                                               ("gather", "gather")])
def test_interp_mode_default_and_override(monkeypatch, env_mode, expected):
    """`interp_columns` defaults to the gathers on every backend; the
    HANK_TPU_INTERP probe override selects a form, and the exact-lowerings
    mode always pins the gathers."""
    from hank_tpu.config import exact_lowerings
    from hank_tpu.ops.egm import _interp_mode

    if env_mode is None:
        monkeypatch.delenv("HANK_TPU_INTERP", raising=False)
    else:
        monkeypatch.setenv("HANK_TPU_INTERP", env_mode)
    assert _interp_mode(200) == expected
    with exact_lowerings():
        assert _interp_mode(200) == "gather"


def test_interp_mode_rejects_unknown(monkeypatch):
    from hank_tpu.ops.egm import _interp_mode

    monkeypatch.setenv("HANK_TPU_INTERP", "bogus")
    with pytest.raises(ValueError, match="HANK_TPU_INTERP"):
        _interp_mode(200)
