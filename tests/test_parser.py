"""Model compiler tests: YAML -> SequenceModel, equation compilation.

Reproduces the reference's construction smoke tests (`test_Model.jl:18-93`)
plus exact-value checks on the compiled residual function.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.model.parser import compile_residuals, detect_max_lag_lead
from hank_tpu.models import load_model


def test_detect_max_lag_lead():
    vars_ = ("Y", "KS", "C", "r")
    assert detect_max_lag_lead(["Y = Z * KS(-1)^0.3"], vars_ + ("Z",)) == (1, 0)
    assert detect_max_lag_lead(["C(+2) = r(-3) * Y"], vars_) == (3, 2)
    assert detect_max_lag_lead(["Y = C"], vars_) == (0, 0)


def test_compile_residuals_exact_values():
    eqs = ["Y = Z * KS(-1)^α", "r = Y / KS"]
    names = ("Y", "KS", "r", "Z")
    params = {"α": 0.5}
    fn = compile_residuals(eqs, names, params)

    # T_pad = 5 with max_lag=1, max_lead=0 -> 4 valid periods.
    xMat = jnp.array([
        [1.0, 2.0, 3.0, 4.0, 5.0],    # Y
        [4.0, 9.0, 16.0, 25.0, 36.0],  # KS
        [0.5, 0.5, 0.5, 0.5, 0.5],    # r
        [1.0, 1.0, 1.0, 1.0, 1.0],    # Z
    ])
    out = np.asarray(fn(xMat, params))
    assert out.shape == (8,)  # 2 eqs x 4 valid periods

    # Residual eq1 at valid period t (cols 1..4): Y_t - Z_t * sqrt(KS_{t-1})
    expected_r1 = [2 - 2.0, 3 - 3.0, 4 - 4.0, 5 - 5.0]
    expected_r2 = [0.5 - 2 / 9, 0.5 - 3 / 16, 0.5 - 4 / 25, 0.5 - 5 / 36]
    # Ordering: all equations at t, then t+1, ... (`ModelParser.jl:214-216`).
    expected = np.array(list(zip(expected_r1, expected_r2))).ravel()
    assert np.allclose(out, expected, atol=1e-13)


def test_compile_residuals_lead():
    eqs = ["C = C(+1) * R"]
    names = ("C", "R")
    fn = compile_residuals(eqs, names, set())
    xMat = jnp.array([[1.0, 2.0, 3.0], [0.5, 0.5, 0.5]])
    # max_lead=1: valid cols 0..1; residual = C_t - C_{t+1}*R_t
    out = np.asarray(fn(xMat, {}))
    assert np.allclose(out, [1 - 2 * 0.5, 2 - 3 * 0.5], atol=1e-14)


def test_unknown_symbol_raises():
    with pytest.raises(ValueError, match="Unknown symbol"):
        compile_residuals(["Y = bogus * 2"], ("Y",), set())


def test_build_ks_model():
    model = load_model("krusell_smith")
    cs = model.compspec
    assert cs.T == 150 and cs.n_v == 6 and cs.n_endog == 4
    assert cs.max_lag == 1 and cs.max_lead == 0
    assert model.var_names() == ("Y", "KS", "r", "w", "KD", "Z")
    assert model.vars_of_type("endogenous") == ("Y", "KS", "r", "w")
    assert model.vars_of_type("heterogeneous") == ("KD",)
    assert model.vars_of_type("exogenous") == ("Z",)
    assert model.n_total() == 1400
    assert model.state_shape() == (200, 7)
    assert model.heterogeneity["wealth"].policy_var == "KD"
    assert model.ss_initial.fixed == {"Z": 1.0}
    assert model.ss_ending.fixed == {"Z": 2.0}


def test_compspec_dx_parsed_and_consumed():
    """CompSpec.dx carries the YAML fd-step (reference semantics,
    `ModelParser.jl:312-317`: yaml value or default 1e-8) and is consumed as
    `direct_jacobian_columns`' default FD step."""
    import inspect

    from hank_tpu.config import config
    from hank_tpu.solvers.ss_jacobian import direct_jacobian_columns

    model = load_model("krusell_smith")
    assert model.compspec.dx == 0.001          # KrusellSmith.yaml dx
    model2 = load_model("hank_two_asset")
    assert model2.compspec.dx == config.default_dx   # parser default 1e-8

    # The default fd_step is None -> resolved to model.compspec.dx.
    sig = inspect.signature(direct_jacobian_columns)
    assert sig.parameters["fd_step"].default is None
    src = inspect.getsource(direct_jacobian_columns)
    assert "model.compspec.dx" in src


def test_residuals_smoke_on_ones(ks_small):
    """The reference's ones-matrix smoke test (`test_Model.jl:84-92`)."""
    model = ks_small
    cs = model.compspec
    xMat = jnp.ones((cs.n_v, cs.T_pad))
    out = model.residuals_fn(xMat, model.params)
    assert out.shape == (len(model.equations) * (cs.T - 1),)
    assert bool(jnp.all(jnp.isfinite(out)))
