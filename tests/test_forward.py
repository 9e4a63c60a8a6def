"""Distribution transition ops: lottery, exogenous mixing, invariant dist."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hank_tpu.ops.linalg import invariant_dist_colstoch
from hank_tpu.ops.transition import (
    dense_full_transition,
    exog_apply,
    exog_kron,
    forward_step,
    lottery_apply,
    lottery_apply_multi,
    lottery_weights,
)


def _rand_setup(seed=0, n_a=11, n_e=3):
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.uniform(0, 10, n_a))
    policy = rng.uniform(-1.0, 11.0, size=(n_a, n_e))  # includes out-of-grid
    D = rng.uniform(0.1, 1.0, size=(n_a, n_e))
    D = D / D.sum()
    Pi = rng.uniform(0.1, 1.0, size=(n_e, n_e))
    Pi = Pi / Pi.sum(axis=1, keepdims=True)
    return jnp.asarray(grid), jnp.asarray(policy), jnp.asarray(D), jnp.asarray(Pi)


def test_lottery_weights_reference_semantics():
    grid = jnp.asarray([0.0, 1.0, 3.0])
    policy = jnp.asarray([-0.5, 0.0, 0.5, 2.0, 3.0, 99.0])
    jc, w = lottery_weights(policy, grid)
    # below grid: all mass at point 0 -> w=0, bracket (0,1)
    assert int(jc[0]) == 1 and float(w[0]) == 0.0
    # exactly at a knot
    assert float(w[1]) == 0.0
    # interior: 0.5 between 0 and 1 -> w=0.5
    assert abs(float(w[2]) - 0.5) < 1e-15
    # 2.0 between 1 and 3 -> w=0.5 at index 2
    assert int(jc[3]) == 2 and abs(float(w[3]) - 0.5) < 1e-15
    # at top knot: w=1 mass on last point
    assert abs(float(w[4]) - 1.0) < 1e-15
    # above grid: clamped to last point
    assert int(jc[5]) == 2 and float(w[5]) == 1.0


def test_lottery_apply_conserves_mass_and_mean():
    grid, policy, D, _ = _rand_setup()
    out = np.asarray(lottery_apply(policy, D, grid))
    assert abs(out.sum() - 1.0) < 1e-14
    assert np.all(out >= -1e-16)
    # Young's lottery preserves the conditional mean of the (clamped) policy
    clamped = np.clip(np.asarray(policy), float(grid[0]), float(grid[-1]))
    mean_policy = (clamped * np.asarray(D)).sum()
    mean_out = (np.asarray(grid)[:, None] * out).sum()
    assert abs(mean_policy - mean_out) < 1e-12


def test_lottery_modes_agree():
    """hat / dense / scatter lowerings are the same transition (ulp-level:
    1 − (p−lo)/Δ vs (hi−p)/Δ differ in the last bits)."""
    import jax

    grid, policy, D, _ = _rand_setup()
    # Include exactly-clamped and off-grid policies (constrained region).
    policy = policy.at[0, :].set(float(grid[0]))
    policy = policy.at[-1, :].set(float(grid[-1]) + 1.0)
    outs = {m: np.asarray(lottery_apply(policy, D, grid, mode=m))
            for m in ("hat", "dense", "scatter")}
    assert np.allclose(outs["hat"], outs["scatter"], atol=1e-13)
    assert np.allclose(outs["dense"], outs["scatter"], atol=1e-13)

    # JVP agreement (tangents flow through the lottery weights): perturb
    # policies away from exact knots, keep the clamped rows (their policy
    # tangents are zeroed by EGM's clip in real use — zero them here too).
    rng = np.random.default_rng(11)
    dpol = jnp.asarray(rng.normal(size=policy.shape))
    dpol = dpol.at[0, :].set(0.0).at[-1, :].set(0.0)
    dD = jnp.asarray(rng.normal(size=D.shape)) * 1e-3
    jvps = {}
    for m in ("hat", "dense", "scatter"):
        f = lambda p, d: lottery_apply(p, d, grid, mode=m)  # noqa: E731
        jvps[m] = np.asarray(jax.jvp(f, (policy, D), (dpol, dD))[1])
    assert np.allclose(jvps["hat"], jvps["scatter"], atol=1e-12)
    assert np.allclose(jvps["dense"], jvps["scatter"], atol=1e-12)


def test_forward_step_equals_dense_transition():
    grid, policy, D, Pi = _rand_setup()
    out = np.asarray(forward_step(policy, D, grid, [Pi]))
    lam = np.asarray(dense_full_transition(policy, grid, [Pi]))
    # Column-stochastic check
    assert np.allclose(lam.sum(axis=0), 1.0, atol=1e-13)
    out_dense = (lam @ np.asarray(D).reshape(-1)).reshape(out.shape)
    assert np.allclose(out, out_dense, atol=1e-13)


def test_exog_apply_matches_kron():
    rng = np.random.default_rng(3)
    n_a, n1, n2 = 4, 3, 2
    D = rng.uniform(size=(n_a, n1, n2))
    P1 = rng.uniform(0.1, 1, size=(n1, n1)); P1 /= P1.sum(1, keepdims=True)
    P2 = rng.uniform(0.1, 1, size=(n2, n2)); P2 /= P2.sum(1, keepdims=True)
    out = np.asarray(exog_apply(jnp.asarray(D), [jnp.asarray(P1), jnp.asarray(P2)], 1))
    # Reference: D'[a, e1', e2'] = sum_{e1,e2} P1[e1,e1'] P2[e2,e2'] D[a,e1,e2]
    expected = np.einsum("aij,ik,jl->akl", D, P1, P2)
    assert np.allclose(out, expected, atol=1e-14)
    # And the flattened version equals the Kronecker total
    PK = np.asarray(exog_kron([jnp.asarray(P1), jnp.asarray(P2)]))
    out2 = (D.reshape(n_a, -1) @ PK).reshape(n_a, n1, n2)
    assert np.allclose(out, out2, atol=1e-14)


def test_lottery_apply_multi_two_dims():
    """2-endogenous-dim joint lottery: product weights over 4 corners."""
    rng = np.random.default_rng(5)
    g1 = np.sort(rng.uniform(0, 5, 6))
    g2 = np.sort(rng.uniform(0, 3, 4))
    shape = (6, 4, 2)  # (n1, n2, n_e)
    p1 = rng.uniform(0, 5, size=shape)
    p2 = rng.uniform(0, 3, size=shape)
    D = rng.uniform(0.1, 1, size=shape); D /= D.sum()
    out = np.asarray(lottery_apply_multi(
        [jnp.asarray(p1), jnp.asarray(p2)], jnp.asarray(D),
        [jnp.asarray(g1), jnp.asarray(g2)]))
    assert abs(out.sum() - 1.0) < 1e-13
    # Brute-force reference
    expected = np.zeros(shape)
    for i in range(6):
        for j in range(4):
            for e in range(2):
                j1 = np.clip(np.searchsorted(g1, p1[i, j, e]), 1, 5)
                w1 = np.clip((p1[i, j, e] - g1[j1-1]) / (g1[j1] - g1[j1-1]), 0, 1)
                j2 = np.clip(np.searchsorted(g2, p2[i, j, e]), 1, 3)
                w2 = np.clip((p2[i, j, e] - g2[j2-1]) / (g2[j2] - g2[j2-1]), 0, 1)
                m = D[i, j, e]
                expected[j1-1, j2-1, e] += (1-w1)*(1-w2)*m
                expected[j1,   j2-1, e] += w1*(1-w2)*m
                expected[j1-1, j2,   e] += (1-w1)*w2*m
                expected[j1,   j2,   e] += w1*w2*m
    assert np.allclose(out, expected, atol=1e-13)


def test_forward_exact_lowerings_match_default():
    """Under `config.exact_lowerings` the exogenous mixing switches to
    exactly-rounded unrolled FMAs instead of the tensordot contraction.
    Same operator on CPU f64 to ~1e-15."""
    from hank_tpu.config import exact_lowerings

    rng = np.random.default_rng(23)
    # exog_apply: two exogenous axes.
    D3 = rng.uniform(size=(7, 5, 2))
    P1 = rng.uniform(0.1, 1, size=(5, 5)); P1 /= P1.sum(1, keepdims=True)
    P2 = rng.uniform(0.1, 1, size=(2, 2)); P2 /= P2.sum(1, keepdims=True)
    base = np.asarray(exog_apply(jnp.asarray(D3),
                                 [jnp.asarray(P1), jnp.asarray(P2)], 1))
    with exact_lowerings(True):
        ex = np.asarray(exog_apply(jnp.asarray(D3),
                                   [jnp.asarray(P1), jnp.asarray(P2)], 1))
    assert np.abs(base - ex).max() < 1e-15


def test_invariant_dist_colstoch():
    rng = np.random.default_rng(7)
    n = 12
    Lam = rng.uniform(0.01, 1.0, size=(n, n))
    Lam = Lam / Lam.sum(axis=0, keepdims=True)  # column-stochastic
    D = np.asarray(invariant_dist_colstoch(jnp.asarray(Lam)))
    assert abs(D.sum() - 1.0) < 1e-12
    assert np.allclose(Lam @ D, D, atol=1e-11)


def test_invariant_dist_transient_state():
    """Pinned-state-free formulation survives a transient first state
    (the reference's trick is singular here, `ForwardIteration.jl:436-442`)."""
    # State 0 leaks into state 1 and is never re-entered.
    Lam = jnp.asarray(np.array([
        [0.0, 0.0, 0.0],
        [0.5, 0.6, 0.3],
        [0.5, 0.4, 0.7],
    ]))
    D = np.asarray(invariant_dist_colstoch(Lam))
    assert abs(D[0]) < 1e-12
    assert np.allclose(np.asarray(Lam) @ D, D, atol=1e-12)


def test_invariant_dist_gradient():
    """Implicit derivative through the solve vs finite differences."""
    rng = np.random.default_rng(9)
    n = 6
    A = rng.uniform(0.01, 1.0, size=(n, n))

    def make_lam(s):
        M = jnp.asarray(A).at[0, 0].mul(1.0 + s)
        return M / M.sum(axis=0, keepdims=True)

    def f(s):
        return invariant_dist_colstoch(make_lam(s))[2]

    g = float(jax.grad(f)(0.0))
    h = 1e-6
    fd = (float(f(h)) - float(f(-h))) / (2 * h)
    assert abs(g - fd) < 1e-7


def test_forward_iteration_at_ss_is_constant(ks_small, ks_small_ss):
    """Pushing the stationary distribution with SS policies keeps aggregates
    at their SS values for every period."""
    from hank_tpu.blocks.forward import forward_iteration

    model, ss = ks_small, ks_small_ss
    Tm1 = model.compspec.T - 1
    pol = {k: jnp.broadcast_to(v, (Tm1, *v.shape)) for k, v in ss.policies.items()}
    aggs = forward_iteration(pol, model, ss.D)
    kd = np.asarray(aggs["KD"])
    assert np.allclose(kd, float(ss.vars["KD"]), atol=1e-9)





@pytest.mark.parametrize("env_mode", ["scatter", "hat", "dense"])
def test_lottery_mode_override_env(monkeypatch, env_mode):
    """HANK_TPU_LOTTERY selects the lowering when no explicit mode is given
    (the A/B probe override); every form is the same transition."""
    grid, policy, D, _ = _rand_setup(seed=3)
    explicit = np.asarray(lottery_apply(policy, D, grid, mode=env_mode))
    monkeypatch.setenv("HANK_TPU_LOTTERY", env_mode)
    via_env = np.asarray(lottery_apply(policy, D, grid))
    assert np.array_equal(via_env, explicit)
    scatter = np.asarray(lottery_apply(policy, D, grid, mode="scatter"))
    assert np.allclose(via_env, scatter, atol=1e-13)


def test_lottery_default_is_scatter(monkeypatch):
    monkeypatch.delenv("HANK_TPU_LOTTERY", raising=False)
    grid, policy, D, _ = _rand_setup(seed=4)
    assert np.array_equal(np.asarray(lottery_apply(policy, D, grid)),
                          np.asarray(lottery_apply(policy, D, grid,
                                                   mode="scatter")))


def test_lottery_unknown_mode_raises(monkeypatch):
    monkeypatch.setenv("HANK_TPU_LOTTERY", "bogus")
    grid, policy, D, _ = _rand_setup(seed=5)
    with pytest.raises(ValueError, match="unknown lottery mode"):
        lottery_apply(policy, D, grid)


@pytest.mark.parametrize("mode", ["hat", "dense"])
@pytest.mark.parametrize("n_a,n_e", [(5, 2), (64, 7)])
def test_lottery_explicit_modes_match_scatter(mode, n_a, n_e):
    """The explicit hat / dense forms equal the default scatter form at a
    tiny and a production-like grid (incl. off-grid policies)."""
    grid, policy, D, _ = _rand_setup(seed=n_a, n_a=n_a, n_e=n_e)
    out = np.asarray(lottery_apply(policy, D, grid, mode=mode))
    ref = np.asarray(lottery_apply(policy, D, grid, mode="scatter"))
    assert np.allclose(out, ref, atol=1e-13)
    assert abs(out.sum() - 1.0) < 1e-12
