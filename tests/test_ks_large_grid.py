"""Large-grid KS (BASELINE config 4): 500-point asset grid, ZLB-style shock.

Runs the FULL 500x7 household state space (no grid shrinking — the point is
the large-grid code paths) at a short horizon. Exercises the scatter lottery
lowering (the default) and the kinked (clamped) shock path the model
exists for.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.models import load_model
from tests.conftest import solve_ss_cached


@pytest.fixture(scope="module")
def lg_model():
    return load_model("ks_large_grid", T=12)


@pytest.fixture(scope="module")
def lg_ss(lg_model):
    return solve_ss_cached(lg_model)


def test_zlb_shock_is_kinked(lg_model):
    from hank_tpu.models.ks_large_grid import exogenousZ

    z = np.asarray(exogenousZ(40))
    assert z.min() == pytest.approx(0.88)
    n_floor = int((z == 0.88).sum())
    assert 5 <= n_floor <= 12          # the clamp binds for ~9 periods
    assert z[-1] == pytest.approx(1.0, abs=2e-2)
    # kink: flat while clamped (n_floor - 1 zero diffs), then a jump at
    # release
    d = np.diff(z)
    assert int((d == 0.0).sum()) == n_floor - 1
    assert d[n_floor - 1] > 1e-3


def test_large_grid_steady_state(lg_model, lg_ss):
    # Same economics as the 200-pt model: K* ≈ 8.0 at Z = 1.
    assert abs(float(lg_ss.vars["KS"]) - 8.0) < 0.1
    assert abs(float(lg_ss.vars["KS"]) - float(lg_ss.vars["KD"])) < 1e-8
    assert lg_ss.D.shape == (500, 7)
    assert abs(float(lg_ss.D.sum()) - 1.0) < 1e-10


def test_scatter_and_dense_lottery_agree(lg_model, lg_ss):
    """The two lowerings of the Young lottery (segment-sum scatter vs one-hot
    einsum) are the same operator — on the real 500-pt policy/distribution."""
    from hank_tpu.ops.transition import lottery_apply

    grid = lg_model.heterogeneity["wealth"].grid
    pol = lg_ss.policies["KD"]
    out_scatter = lottery_apply(pol, lg_ss.D, grid, dense=False)
    out_dense = lottery_apply(pol, lg_ss.D, grid, dense=True)
    assert float(jnp.max(jnp.abs(out_scatter - out_dense))) < 1e-15
    assert abs(float(out_scatter.sum()) - 1.0) < 1e-12


def test_large_grid_zlb_path_solve(lg_model, lg_ss):
    from hank_tpu.models.ks_large_grid import exogenousZ
    from hank_tpu.solvers.newton import newton_raphson_hank
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

    model, ss = lg_model, lg_ss
    Tm1 = model.compspec.T - 1
    exog = {"Z": exogenousZ(Tm1)}
    names = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss.vars[k] for k in names]), Tm1)
    J = get_steady_state_jacobian(ss, model)
    x, info = newton_raphson_hank(x0, J, exog, model, ss, ss,
                                  method="newton_krylov", eps=1e-9)
    assert float(info["residual_norm"]) < 1e-9
    path = np.asarray(x).reshape(Tm1, len(names))
    r_path = path[:, names.index("r")]
    y_path = path[:, names.index("Y")]
    # The productivity collapse cuts output on impact and raises the scarcity
    # return on capital once the stock has depreciated below trend.
    assert y_path[0] < float(ss.vars["Y"]) * 0.95
    assert r_path.max() > float(ss.vars["r"])
