"""Full-size two-asset HANK regression.

The headline config (BASELINE config 3) is 40x20x5x2 = 8000 household
states; until this file, its code path existed only in one-off manual runs.
Covered here:

- the full-size steady state itself (artifact-cached after first solve) and
  a short-horizon path solve through the full pipeline.

Slow on a cold artifact cache (one full-size SS solve); marked `slow`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.models import load_model
from tests.conftest import solve_ss_cached


@pytest.fixture(scope="module")
def full_model():
    """The SHIPPED full-size config: 40x20x5x2, shortened horizon for the
    path solve (T only affects the path machinery, not the SS/state size)."""
    return load_model("hank_two_asset", T=12)


@pytest.fixture(scope="module")
def full_ss(full_model):
    return solve_ss_cached(full_model)


@pytest.mark.slow
def test_full_size_ss_clears_markets(full_model, full_ss):
    model, ss = full_model, full_ss
    assert model.state_shape() == (40, 20, 5, 2)
    p = model.params
    # Liquid bonds clear against supply; illiquid claims = capital.
    assert abs(float(ss.vars["B"]) - p["Bg"]) < 1e-6
    assert abs(float(ss.vars["A"]) - float(ss.vars["KS"])) < 1e-6
    assert float(jnp.min(ss.D)) >= -1e-15
    assert abs(float(jnp.sum(ss.D)) - 1.0) < 1e-10


@pytest.mark.slow
def test_full_size_short_path_solve(full_model, full_ss):
    """Full-size state space through the whole stack: J-bar build + a
    short-horizon fiscal-shock path solved to 1e-8."""
    from hank_tpu.models.hank_two_asset import fiscalShock
    from hank_tpu.solvers.newton import newton_raphson_hank
    from hank_tpu.utils.checkpoint import get_or_solve

    model = full_model
    ss0, ssT, Jbar = get_or_solve(model)
    Tm1 = model.compspec.T - 1
    exog = {"G": fiscalShock(Tm1)}
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), Tm1)
    x, info = newton_raphson_hank(x0, Jbar, exog, model, ss0, ssT,
                                  method="newton_krylov", eps=1e-8,
                                  direction_dtype=jnp.float32)
    assert float(info["residual_norm"]) < 1e-8
    assert bool(jnp.all(jnp.isfinite(x)))
