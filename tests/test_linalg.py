"""f64-accurate linear algebra on f32 factorizations."""

import jax
import jax.numpy as jnp
import numpy as np

from hank_tpu.ops.linalg import dense_solve, make_reusable_solver


def _random_system(n=50, seed=0, cond=1e3):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    A = U @ np.diag(s) @ V.T
    b = rng.normal(size=n)
    return A, b


def test_dense_solve_f64_accuracy():
    A, b = _random_system()
    x = np.asarray(dense_solve(jnp.asarray(A), jnp.asarray(b)))
    x_ref = np.linalg.solve(A, b)
    assert np.max(np.abs(x - x_ref)) / np.max(np.abs(x_ref)) < 1e-12


def test_dense_solve_grad_b():
    A, b = _random_system(n=8, seed=1)
    A_j, b_j = jnp.asarray(A), jnp.asarray(b)

    def f(bb):
        return dense_solve(A_j, bb)[3]

    g = np.asarray(jax.grad(f)(b_j))
    # d x_3 / d b = (A^{-1})[3, :]
    expected = np.linalg.inv(A)[3, :]
    assert np.allclose(g, expected, atol=1e-10)


def test_dense_solve_grad_A():
    A, b = _random_system(n=6, seed=2, cond=10)
    b_j = jnp.asarray(b)

    def f(s):
        Aj = jnp.asarray(A).at[1, 2].add(s)
        return dense_solve(Aj, b_j)[0]

    g = float(jax.grad(f)(0.0))
    h = 1e-6
    fd = (float(f(h)) - float(f(-h))) / (2 * h)
    assert abs(g - fd) < 1e-6 * max(1.0, abs(fd))


def test_dense_solve_jvp():
    A, b = _random_system(n=7, seed=3, cond=10)
    A_j, b_j = jnp.asarray(A), jnp.asarray(b)
    db = jnp.asarray(np.random.default_rng(4).normal(size=7))
    _, dx = jax.jvp(lambda bb: dense_solve(A_j, bb), (b_j,), (db,))
    expected = np.linalg.solve(A, np.asarray(db))
    assert np.allclose(np.asarray(dx), expected, atol=1e-10)


def test_reusable_solver_many_rhs():
    A, _ = _random_system(n=30, seed=5)
    solve = make_reusable_solver(jnp.asarray(A))
    rng = np.random.default_rng(6)
    for _ in range(3):
        b = rng.normal(size=30)
        x = np.asarray(solve(jnp.asarray(b)))
        assert np.max(np.abs(A @ x - b)) < 1e-11


def test_rayleigh_quotient_zero_y_is_zero():
    """y = 0 (the boehl endgame's restart) must give ray = 0, alpha = 1 —
    and must NOT rely on a sub-f32-range guard literal: an emulated f64
    underflows 1e-300 to zero on device, where a max(dot, 1e-300) guard
    gives 0/0 = NaN and NaNs the whole two-asset endgame."""
    import jax.numpy as jnp

    from hank_tpu.config import TINY
    from hank_tpu.ops.linalg import rayleigh_quotient
    from hank_tpu.solvers.newton import _boehl_alpha

    y = jnp.zeros(7, dtype=jnp.float64)
    ray = rayleigh_quotient(jnp.zeros(7, dtype=jnp.float64), y)
    assert float(ray) == 0.0
    assert float(_boehl_alpha(ray)) == 1.0
    # The shared guard constant stays inside the emulated-f64 (f32 exponent)
    # range so it cannot silently flush to zero on device.
    assert TINY >= 1.2e-38
    # Nonzero y unchanged by the guard rewrite.
    y2 = jnp.asarray([1.0, 2.0]); My2 = jnp.asarray([3.0, 4.0])
    assert abs(float(rayleigh_quotient(My2, y2)) - 11.0 / 5.0) < 1e-15
