"""Path solvers: Boehl y-iteration, Newton-Krylov, dense Newton — agreement,
convergence, and boundary behavior under a transitory TFP shock."""

import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.solvers.newton import (
    make_full_residual_fn,
    newton_raphson_hank,
    solve_path_dense,
)
from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian


@pytest.fixture(scope="module")
def path_setup(ks_small, ks_small_ss):
    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    t = jnp.arange(1, T, dtype=jnp.float64)
    exog = {"Z": 1.0 + 0.1 * 0.8 ** t}
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), T - 1)
    Jbar = get_steady_state_jacobian(ss, model)
    return model, ss, exog, x0, Jbar


def test_newton_krylov_converges(path_setup):
    model, ss, exog, x0, Jbar = path_setup
    x, info = newton_raphson_hank(x0, Jbar, exog, model, ss, ss,
                                  method="newton_krylov", eps=1e-9)
    assert float(info["residual_norm"]) < 1e-9
    assert int(info["iterations"]) <= 10


def test_boehl_converges(path_setup):
    model, ss, exog, x0, Jbar = path_setup
    x, info = newton_raphson_hank(x0, Jbar, exog, model, ss, ss,
                                  method="boehl", eps=1e-9)
    assert float(info["residual_norm"]) < 1e-8
    assert int(info["iterations"]) <= 20


def test_boehl_host_inner_matches_traced(path_setup):
    """host_inner=True (a few small compiled programs, the stall-rescue
    configuration) reproduces the traced boehl solve."""
    from hank_tpu.solvers.newton import make_path_solver

    model, ss, exog, x0, Jbar = path_setup
    solve_t = make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                               eps=1e-9)
    solve_h = make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                               eps=1e-9, host_inner=True)
    x_t, info_t = solve_t(x0)
    x_h, info_h = solve_h(x0)
    assert float(info_h["residual_norm"]) < 1e-9
    assert int(info_h["iterations"]) == int(info_t["iterations"])
    assert float(jnp.max(jnp.abs(x_h - x_t))) < 1e-10

    with pytest.raises(ValueError):
        make_path_solver(Jbar, exog, model, ss, ss, method="newton_krylov",
                         host_inner=True)


def test_boehl_endgame_only_from_linear_start(path_setup):
    """richardson_max_outer=0 (host_inner boehl) skips the Richardson
    phase and drives the GMRES endgame directly — the endgame-only route
    for warm starts already in the quadratic basin (the linear IRF). Must
    converge and agree with the default two-phase solve. Also pins that
    an explicit 0 is honored (a `max_outer or default` bug once swallowed
    it)."""
    from hank_tpu.solvers.linear import linear_impulse_response
    from hank_tpu.solvers.newton import make_path_solver

    model, ss, exog, x0, Jbar = path_setup
    x_lin, _ = linear_impulse_response(Jbar, exog, model, ss, ss,
                                       compute_residual=False)
    solve_eg = make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                                eps=1e-9, host_inner=True,
                                richardson_max_outer=0)
    solve_def = make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                                 eps=1e-9, host_inner=True)
    x_eg, info_eg = solve_eg(x_lin)
    x_def, info_def = solve_def(x_lin)
    assert float(info_eg["residual_norm"]) < 1e-9
    # No Richardson sweeps at all on the endgame-only route.
    assert info_eg["prof"]["sweep"]["calls"] == 0
    assert float(info_def["residual_norm"]) < 1e-9
    assert float(jnp.max(jnp.abs(x_eg - x_def))) < 1e-7


def test_solvers_agree_with_dense(path_setup):
    """1e-8 pointwise agreement between the fast solvers and the
    ground-truth dense-Jacobian Newton (build-plan step 6/8)."""
    model, ss, exog, x0, Jbar = path_setup
    x_d, info_d = solve_path_dense(x0, exog, model, ss, ss, eps=1e-10)
    assert float(info_d["residual_norm"]) < 1e-9

    x_nk, _ = newton_raphson_hank(x0, Jbar, exog, model, ss, ss,
                                  method="newton_krylov", eps=1e-10)
    x_bo, _ = newton_raphson_hank(x0, Jbar, exog, model, ss, ss,
                                  method="boehl", eps=1e-10)
    assert float(jnp.max(jnp.abs(x_nk - x_d))) < 1e-8
    assert float(jnp.max(jnp.abs(x_bo - x_d))) < 1e-8


def test_solution_economics(path_setup):
    """The solved path starts above SS output (positive TFP shock) and
    returns to the steady state by the terminal period."""
    model, ss, exog, x0, Jbar = path_setup
    x, _ = newton_raphson_hank(x0, Jbar, exog, model, ss, ss,
                               method="newton_krylov")
    Tm1 = model.compspec.T - 1
    path = np.asarray(x).reshape(Tm1, model.compspec.n_endog)
    names = model.vars_of_type("endogenous")
    Y = path[:, names.index("Y")]
    Y_ss = float(ss.vars["Y"])
    assert Y[0] > Y_ss + 1e-3                      # impact response of output
    # With T=12 the economy hasn't fully reverted; require the deviation to
    # have shrunk substantially from impact.
    assert abs(Y[-1] - Y_ss) < 0.75 * abs(Y[0] - Y_ss)
    r = path[:, names.index("r")]
    assert np.all(np.isfinite(r))


def test_zero_shock_stays_at_ss(path_setup):
    model, ss, _, x0, Jbar = path_setup
    Tm1 = model.compspec.T - 1
    exog0 = {"Z": jnp.full((Tm1,), 1.0)}
    x, info = newton_raphson_hank(x0, Jbar, exog0, model, ss, ss,
                                  method="newton_krylov")
    assert float(jnp.max(jnp.abs(x - x0))) < 1e-8


def test_residual_fn_shape(path_setup):
    model, ss, exog, x0, _ = path_setup
    F = make_full_residual_fn(model, ss, ss, exog)
    out = F(x0)
    assert out.shape == x0.shape  # square system


def test_stall_rescue_hands_off_to_boehl(path_setup, monkeypatch):
    """When the Newton-Krylov direction cannot descend (measured on the
    two-asset fiscal path: a curved valley where every damping of the
    Newton step gains < 1% while boehl converges in 4 outers), the host
    loop must hand the iterate to the boehl y-iteration and still converge.
    Forced here by making GMRES return a zero direction."""
    import warnings

    import hank_tpu.solvers.newton as newton_mod

    model, ss, exog, x0, Jbar = path_setup
    real_gmres = newton_mod.gmres_matfree
    calls = {"n": 0}

    def zero_gmres(A, b, **kw):
        calls["n"] += 1
        d, info = real_gmres(A, b, **kw)
        return jnp.zeros_like(d), info

    monkeypatch.setattr(newton_mod, "gmres_matfree", zero_gmres)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x, info = newton_raphson_hank(x0, Jbar, exog, model, ss, ss,
                                      method="newton_krylov", eps=1e-9)
    assert calls["n"] > 0                      # the stall was actually forced
    assert float(info["residual_norm"]) < 1e-9  # rescue converged anyway

    monkeypatch.setattr(newton_mod, "gmres_matfree", real_gmres)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x_plain, info_plain = newton_raphson_hank(
            x0, Jbar, exog, model, ss, ss, method="newton_krylov",
            eps=1e-9, stall_rescue=False)
    # sanity: rescue-off still behaves (this problem never stalls)
    assert float(info_plain["residual_norm"]) < 1e-9
    assert float(jnp.max(jnp.abs(x - x_plain))) < 1e-7


@pytest.mark.parametrize("method", ["newton_krylov", "boehl"])
def test_path_solver_certifies_with_plain_f64_residual(path_setup, method):
    """The norm a path solver reports is the plain f64 residual of the
    pipeline at the returned path: re-evaluating make_full_residual_fn
    independently reproduces it (no separate residual evaluator)."""
    from hank_tpu.solvers.newton import make_path_solver

    model, ss, exog, x0, Jbar = path_setup
    kw = dict(host_inner=True) if method == "boehl" else {}
    x, info = make_path_solver(Jbar, exog, model, ss, ss, method=method,
                               eps=1e-9, direction_dtype=jnp.float32, **kw)(x0)
    F = make_full_residual_fn(model, ss, ss, exog)
    recheck = float(jnp.linalg.norm(F(x)))
    assert float(info["residual_norm"]) < 1e-9
    assert recheck < 1e-9
    assert abs(recheck - float(info["residual_norm"])) < 1e-12


def test_fd_direction_matches_jvp(path_setup):
    """Central-difference directions (the endgame's fd operator) match the
    true JVP to ~1e-9 per unit tangent: h²‖F‴‖ + ε₆₄‖F‖/h at h = 1e-5."""
    import jax

    model, ss, exog, x0, Jbar = path_setup
    F = make_full_residual_fn(model, ss, ss, exog)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(x0.shape))
    x = x0 + 0.01 * jnp.asarray(rng.standard_normal(x0.shape))
    vn = float(jnp.linalg.norm(v))
    u = v / vn
    h = 1e-5
    fd = (F(x + h * u) - F(x - h * u)) * (vn / (2 * h))
    ad = jax.jvp(F, (x,), (v,))[1]
    assert float(jnp.max(jnp.abs(fd - ad))) / vn < 1e-8


def test_boehl_host_inner_fd_endgame(path_setup, capsys):
    """endgame='fd' wiring: drive the f32-direction phase to its floor
    (eps below reach), confirm the solver enters the host-PGMRES endgame
    and stays finite/convergent rather than wobbling or NaN-ing."""
    from hank_tpu.solvers.newton import make_path_solver

    model, ss, exog, x0, Jbar = path_setup
    records = []
    solve = make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                             eps=1e-30, max_outer=8, max_inner=40,
                             direction_dtype=jnp.float32, host_inner=True,
                             endgame="fd", verbose=True, records=records)
    x, info = solve(x0)
    out = capsys.readouterr().out
    assert "GMRES endgame" in out           # the endgame engaged
    assert np.isfinite(float(info["residual_norm"]))
    assert float(info["residual_norm"]) < 1e-9
    assert all(np.isfinite(r["residual_norm"]) for r in records)

    with pytest.raises(ValueError):
        make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                         host_inner=True, endgame="bogus",
                         direction_dtype=jnp.float32)(x0)


def test_exact_lowerings_residual_matches(path_setup):
    """make_full_residual_fn(exact=True) traces under exact_lowerings and
    matches the default program pointwise (both select the gathers by
    default; the exact form pins them even under a hat/dense override)."""
    from hank_tpu.config import exact_lowerings, exact_lowerings_active
    from hank_tpu.ops.egm import _interp_mode

    model, ss, exog, x0, Jbar = path_setup
    F = make_full_residual_fn(model, ss, ss, exog)
    Fe = make_full_residual_fn(model, ss, ss, exog, exact=True)
    x = x0 + 1e-3
    assert float(jnp.max(jnp.abs(F(x) - Fe(x)))) < 1e-12

    # The trace-time flag actually flips the interpolation gates.
    assert not exact_lowerings_active()
    with exact_lowerings():
        assert exact_lowerings_active()
        assert _interp_mode(64) == "gather"
    assert not exact_lowerings_active()


@pytest.mark.parametrize("endgame", ["auto", "bogus"])
def test_endgame_rejects_unknown(path_setup, endgame):
    """The endgame operator is "jvp" (default) or "fd"; any other value —
    including the retired "auto" — is refused when the solver is built."""
    from hank_tpu.solvers.newton import make_path_solver

    model, ss, exog, x0, Jbar = path_setup
    with pytest.raises(ValueError, match="unknown endgame"):
        make_path_solver(Jbar, exog, model, ss, ss, method="boehl",
                         host_inner=True, endgame=endgame,
                         direction_dtype=jnp.float32)
