"""Linear algebra for f64-accurate solves.

The solver targets 1e-8 pointwise accuracy; dense systems are solved by
mixed-precision **iterative refinement**: factor once in f32, then recover
full f64 accuracy with a few cheap f64 residual sweeps (r = b - A x in f64,
correction solve in f32) — which also serves backends whose LU
decomposition exists only in f32. For well-conditioned
systems (the reduced invariant-distribution matrix, the steady-state Jacobian
J̄) a handful of sweeps reaches ~1e-14 relative error.

All solves are wrapped in `lax.custom_linear_solve`, which supplies exact
implicit-function-theorem derivatives through both the right-hand side and the
matrix — the JAX-native equivalent of the reference's hand-derived
Dual-number IFT + Sherman-Morrison machinery (`ForwardIteration.jl:480-558`).

Capability map to the reference:
- `dense_solve` / `make_reusable_solver` ↔ `J \\ z`, `gmres!(·, J̄, ·)`
  (`SteadyState.jl:197`, `NewtonRaphson.jl:97-98`)
- `invariant_dist_colstoch` ↔ `invariant_dist` (`ForwardIteration.jl:436-442`)
- `rayleigh_quotient` ↔ `GeneralStructures.jl:559-561`
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.scipy.linalg import lu_factor, lu_solve

from hank_tpu.config import TINY, config


def _ruiz_scales(A: jnp.ndarray, sweeps: int = 6):
    """Ruiz equilibration: diagonal r, c with R·A·C having ~unit max-abs
    rows and columns (sqrt-of-max scaling, a few fixed sweeps).

    Why: iterative refinement off an f32 factorization contracts like
    κ(Ã)·eps_f32 — the two-asset J̄ has κ_∞ ≈ 5e8 raw (equation rows mix
    asset-clearing and Euler scales), marginally past the f32 limit: one
    f32 LU may land on the good side while another stalls the whole outer
    solve at 1.4e-6. Equilibration cuts κ_∞ to ~2e7 (measured, 22×),
    restoring uniform convergence on every backend. O(sweeps·n²) setup —
    negligible next to the O(n³) factorization."""
    r = jnp.ones((A.shape[0],), A.dtype)
    c = jnp.ones((A.shape[1],), A.dtype)
    for _ in range(sweeps):
        As = A * r[:, None] * c[None, :]
        rm = jnp.max(jnp.abs(As), axis=1)
        cm = jnp.max(jnp.abs(As), axis=0)
        r = r / jnp.sqrt(jnp.where(rm > 0, rm, 1.0))
        c = c / jnp.sqrt(jnp.where(cm > 0, cm, 1.0))
    return r, c


def _refined_solver(A: jnp.ndarray):
    """Factor A in f32 once; return `solve(b, trans)` accurate to f64.

    Ruiz-equilibrates before factoring (see `_ruiz_scales`), then runs
    mixed-precision iterative refinement: with Ã = R·A·C factored in f32,
    A⁻¹v = C·Ã⁻¹·R·v seeds and corrects, residuals measured against the
    ORIGINAL A in f64.

    `trans=0` solves A x = b, `trans=1` solves Aᵀ x = b (reusing the same
    factorization — needed for reverse-mode transpose solves; Aᵀ's scales
    are the swapped (c, r))."""
    out_dtype = A.dtype
    r, c = _ruiz_scales(A)
    lu, piv = lu_factor((A * r[:, None] * c[None, :]).astype(jnp.float32))
    AT = A.T

    def apply_inv(v: jnp.ndarray, trans: int) -> jnp.ndarray:
        lscale, rscale = (c, r) if trans else (r, c)
        y = lu_solve((lu, piv), (lscale * v).astype(jnp.float32), trans=trans)
        return rscale * y.astype(out_dtype)

    def solve(b: jnp.ndarray, trans: int = 0) -> jnp.ndarray:
        x0 = apply_inv(b, trans)
        if out_dtype == jnp.float32:
            return x0
        M = AT if trans else A

        def sweep(_, x):
            res = b - M @ x
            return x + apply_inv(res, trans)

        return jax.lax.fori_loop(0, config.refine_iters, sweep, x0)

    return solve


def dense_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Differentiable f64-accurate dense solve of A x = b.

    Uses f32 LU + iterative refinement inside `lax.custom_linear_solve`, so
    forward/reverse derivatives w.r.t. both `A` and `b` come from implicit
    differentiation (tangent/cotangent systems reuse the same factorization).
    """
    solve = _refined_solver(A)
    matvec = lambda x: A @ x  # noqa: E731
    return jax.lax.custom_linear_solve(
        matvec, b,
        solve=lambda _, rhs: solve(rhs, 0),
        transpose_solve=lambda _, rhs: solve(rhs, 1))


def make_reusable_solver(A: jnp.ndarray) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Factor A once; return a cheap `solve(b)` for many right-hand sides.

    The path solver applies J̄⁻¹ twice per inner iteration
    (`NewtonRaphson.jl:97-98` does this with restarted GMRES against a sparse
    J̄). A triangular LU backsolve is SEQUENTIAL (two dependent sweeps of n
    steps) and would dominate the inner iteration. So the application is a
    dense matvec with the PRECOMPUTED refined inverse: one GEMV. The inverse is built
    column-block-wise from the refined LU (f32 LU + f64 iterative
    refinement, `ops/linalg.dense_solve` machinery), so ‖A·A⁻¹ − I‖ stays at
    f64 roundoff × cond(A) — more than enough for a preconditioner and for
    the Boehl iteration's R-maps. The returned closure is differentiable
    w.r.t. `b` only (A is a constant).
    """
    solve = _refined_solver(A)
    n = A.shape[0]
    A_inv = jax.vmap(lambda e: solve(e, 0), in_axes=1, out_axes=1)(
        jnp.eye(n, dtype=A.dtype))
    apply = lambda b: A_inv @ b  # noqa: E731
    # The explicit inverse is exposed for callers that can tolerate a
    # lower-precision application (a GMRES preconditioner in f32, half the
    # bytes of the f64 matvec).
    apply.A_inv = A_inv
    return apply


def invariant_dist_colstoch(Lam: jnp.ndarray) -> jnp.ndarray:
    """Stationary distribution of a column-stochastic transition matrix.

    Solves (I − Λ) D = 0 with the normalization Σ D = 1 by replacing the last
    (redundant — columns of I − Λ sum to zero) balance equation with the
    normalization row. Unlike the reference's pin-the-first-state trick
    (`ForwardIteration.jl:436-442`), this stays nonsingular when the pinned
    state is *transient* (e.g. a coarse productivity grid where no household
    dissaves to the borrowing constraint), requiring only a unique recurrent
    class. Fully differentiable w.r.t. Λ via `dense_solve`'s implicit
    derivatives — replacing the reference's manual IFT + Sherman-Morrison
    Dual overload (`ForwardIteration.jl:480-558`).
    """
    n = Lam.shape[0]
    A = jnp.eye(n, dtype=Lam.dtype) - Lam
    A = A.at[-1, :].set(1.0)
    b = jnp.zeros((n,), Lam.dtype).at[-1].set(1.0)
    D = dense_solve(A, b)
    return D / jnp.sum(D)


def make_invariant_solver(apply_fn, *, eps: float = 1e-13,
                          max_iter: int = 200_000):
    """Matrix-free stationary distribution with implicit differentiation.

    `apply_fn(params, D) -> D'` is one period of the (column-stochastic)
    transition expressed as ops (lottery scatter/einsum + Markov matmuls) —
    the n_m × n_m matrix is never formed, so this scales to state spaces
    where the dense path (`invariant_dist_colstoch`) cannot (two-asset HANK:
    n_b·n_a·n_e ≳ 10⁴ states).

    Primal: Aitken-accelerated power iteration D ← apply(params, D).
    Tangent (custom_jvp): the IFT system dD = ∂_D apply·dD + ∂_p apply·dp
    with Σ dD = 0, solved by the same accelerated affine fixed point — the
    same mathematics as the reference's Dual-number Sherman-Morrison overload
    (`ForwardIteration.jl:480-558`) without any factorization.
    """

    def _accel_fixed_point(step, x0):
        def cond(carry):
            _, _, diff, it = carry
            return (diff > eps) & (it < max_iter)

        def body(carry):
            x, diff_prev, _, it = carry
            x_new = step(x)
            diff = jnp.max(jnp.abs(x_new - x))
            lam = jnp.clip(diff / jnp.maximum(diff_prev, TINY), 0.0, 0.995)
            do_ex = (it % 20 == 19) & (it > 40)

            # SAFEGUARDED Aitken: a max-norm ratio cannot distinguish an
            # oscillating (negative/complex-eigenvalue) mode from a geometric
            # tail, and the λ/(1−λ) factor then amplifies it — compounding
            # ×100+ overshoots overflow through the linear map into NaN
            # (observed on the two-asset access chain). So an extrapolation
            # is accepted only if one verification apply shows its one-step
            # residual actually beats the plain iterate's. Costs one extra
            # apply on extrapolation iterations only (~5%).
            def try_extrapolate(_):
                x_ex = x_new + (x_new - x) * (lam / (1 - lam))
                d_ex = jnp.max(jnp.abs(step(x_ex) - x_ex))
                ok = jnp.isfinite(d_ex) & (d_ex < diff)
                return jnp.where(ok, x_ex, x_new)

            x_next = jax.lax.cond(do_ex, try_extrapolate,
                                  lambda _: x_new, None)
            return x_next, diff, diff, it + 1

        x, _, _, _ = jax.lax.while_loop(cond, body, (x0, jnp.inf, jnp.inf, 0))
        return x

    @jax.custom_jvp
    def solve(params, D0):
        D = _accel_fixed_point(lambda d: apply_fn(params, d), D0)
        return D / jnp.sum(D)

    @solve.defjvp
    def solve_jvp(primals, tangents):
        (params, D0), (dparams, _) = primals, tangents
        D_star = solve(params, D0)

        # The IFT system is LINEAR: (I − ∂_D apply) dD = ∂_p apply · dp on
        # the sum-zero subspace (where I − P is nonsingular for an ergodic
        # column-stochastic chain). Power iteration with Aitken acceleration
        # is fragile here — with the chain's second eigenvalue near one, a
        # max-norm ratio estimate cannot distinguish oscillating/complex
        # modes from a geometric tail, and a single overshoot overflows
        # through the linear map into NaN (observed on the two-asset access
        # chain). Matrix-free GMRES on the projected operator is
        # unconditionally stable and far fewer applies at λ₂ ≈ 1.
        shape = D_star.shape
        b = jax.jvp(lambda p: apply_fn(p, D_star), (params,), (dparams,))[1]
        b = (b - jnp.sum(b) / b.size).ravel()

        # Deflated operator A'v = (I − P)v + mean(v)·1: nonsingular on the
        # FULL space (A'v = 0 forces Σv = 0, then v ∈ ker(I−P) = span(D*)
        # with Σv = 0 ⇒ v = 0), with the same sum-zero solution for the
        # sum-zero b. Without deflation the exact kernel direction D* is
        # invisible to the GMRES residual, and near-breakdown Arnoldi steps
        # (tiny hn on a small-support chain) amplify roundoff into exactly
        # that direction — a mean-subtraction cannot remove D*'s shape
        # (observed: returned tangent with Σ dD ≈ 1.6 on a 24-state-support
        # toy chain, wrecking the SS Newton direction).
        def matvec(v):
            vD = v.reshape(shape)
            Pv = jax.jvp(lambda d: apply_fn(params, d), (D_star,), (vD,))[1]
            out = vD - Pv + jnp.sum(vD) / vD.size
            return out.ravel()

        dD, _ = gmres_matfree(matvec, b, jnp.zeros_like(b),
                              restart=40, maxiter=8, tol=1e-12,
                              atol=eps * jnp.linalg.norm(b))
        dD_star = dD.reshape(shape)
        dD_star = dD_star - jnp.sum(dD_star) / dD_star.size
        return D_star, dD_star

    return solve


def gmres_matfree(matvec: Callable[[jnp.ndarray], jnp.ndarray],
                  b: jnp.ndarray,
                  x0: jnp.ndarray,
                  M: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
                  *,
                  restart: int = 20,
                  maxiter: int = 2,
                  tol: float = 1e-12,
                  atol: float = 0.0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Left-preconditioned restarted GMRES with an OPAQUE operator.

    `jax.scipy.sparse.linalg.gmres` wraps the solve in
    `lax.custom_linear_solve`, which must *transpose* the matvec — impossible
    when the operator is opaque (a kernel without a transpose rule). This
    implementation treats `matvec` as a black box: CGS2 Arnoldi (two-pass
    classical Gram-Schmidt — MGS-grade stability, fully vectorized), the
    small (restart+1, restart) Hessenberg least-squares solved by Givens
    rotations + back-substitution (the standard GMRES recurrence — no
    normal-equations conditioning-squaring, no ridge, no device SVD/QR:
    the rotations are scalar-cheap ops on an (m+1, m) array).

    Semantics match the reference's `gmres!(R, J̄, ·)` role
    (`NewtonRaphson.jl:97-98`): solve M(A(d)) = M(b), stopping when the
    preconditioned residual norm is ≤ max(tol·‖M b‖, atol).

    Returns (x, preconditioned_residual_norm_estimate).
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    m = restart
    dtype = b.dtype
    n = b.shape[0]

    def Ahat(v):
        return M(matvec(v))

    bhat = M(b)
    tol_abs = jnp.maximum(tol * jnp.linalg.norm(bhat), atol)

    def hessenberg_ls(H, beta):
        """min_y ‖β e₁ − H y‖ for upper-Hessenberg H via Givens QR.

        Returns (y, |residual|). Columns zeroed by a happy breakdown leave a
        ~0 diagonal in R; those y entries are pinned to 0 (their basis
        vectors are zero too, so they cannot contribute).
        """
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)

        def rotate(j, Hg):
            Hm, g = Hg
            a, c_ = Hm[j, j], Hm[j + 1, j]
            r = jnp.sqrt(a * a + c_ * c_)
            safe = jnp.maximum(r, TINY)
            cs = jnp.where(r > 0, a / safe, 1.0)
            sn = jnp.where(r > 0, c_ / safe, 0.0)
            row_j = cs * Hm[j] + sn * Hm[j + 1]
            row_j1 = -sn * Hm[j] + cs * Hm[j + 1]
            Hm = Hm.at[j].set(row_j).at[j + 1].set(row_j1)
            gj, gj1 = g[j], g[j + 1]
            g = g.at[j].set(cs * gj + sn * gj1)
            g = g.at[j + 1].set(-sn * gj + cs * gj1)
            return Hm, g

        R, g = jax.lax.fori_loop(0, m, rotate, (H, g))
        diag = jnp.diagonal(R[:m, :])
        good = jnp.abs(diag) > TINY

        def back_sub(i, y):
            j = m - 1 - i
            s = g[j] - jnp.dot(R[j, :m], y)
            yj = jnp.where(good[j], s / jnp.where(good[j], diag[j], 1.0), 0.0)
            return y.at[j].set(yj)

        y = jax.lax.fori_loop(0, m, back_sub, jnp.zeros((m,), dtype))
        return y, jnp.abs(g[m])

    def cycle(carry):
        x, _, it = carry
        r = bhat - Ahat(x)
        beta = jnp.linalg.norm(r)
        V0 = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.maximum(beta, TINY))
        H0 = jnp.zeros((m + 1, m), dtype)

        def arnoldi(j, VH):
            V, H = VH
            w = Ahat(V[j])
            # Rows > j of V are still zero, so V @ w projects onto the built
            # basis only; second pass makes classical GS as stable as MGS.
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            h = h1 + h2
            hn = jnp.linalg.norm(w)
            # Happy breakdown (the Krylov space is exhausted — always hit
            # when restart exceeds the operator's dimension): dividing the
            # ~0 remainder by max(hn, eps) fills the basis with garbage
            # that poisons H. Emit a ZERO basis vector instead: A·0 = 0 for
            # a linear operator, so every later column stays zero and the
            # Givens least-squares pins their y entries to 0.
            ok = hn > 1e-12 * jnp.maximum(jnp.linalg.norm(h), TINY)
            V = V.at[j + 1].set(jnp.where(ok, w / jnp.maximum(hn, TINY),
                                          jnp.zeros_like(w)))
            H = H.at[:, j].set(h).at[j + 1, j].set(jnp.where(ok, hn, 0.0))
            return V, H

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V0, H0))
        y, _ = hessenberg_ls(H, beta)
        # Recompute the residual against the ORIGINAL H: the rotation-chain
        # estimate |g_m| is exact only when every diagonal survives, and
        # breakdown columns are pinned rather than solved.
        resid = jnp.linalg.norm(
            jnp.zeros(m + 1, dtype).at[0].set(beta) - H @ y)
        return x + V[:m].T @ y, resid, it + 1

    def cond(carry):
        _, rnorm, it = carry
        return (rnorm > tol_abs) & (it < maxiter)

    init = (x0, jnp.asarray(jnp.inf, dtype), jnp.asarray(0))
    x, rnorm, _ = jax.lax.while_loop(cond, cycle, init)
    return x, rnorm


def rayleigh_quotient(My: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """⟨y, M y⟩ / ⟨y, y⟩ given the precomputed product M y
    (`GeneralStructures.jl:559-561`; drives Boehl step-size adaptation in
    `solvers/newton.py`). Guarded against y = 0 (first inner iteration) with
    the double-where pattern: a `max(·, eps)` guard relies on the eps literal
    being representable ON DEVICE, and an emulated f64 underflows anything
    below ~1e-38 to zero (0/0 = NaN — see `config.TINY`)."""
    den = jnp.dot(y, y)
    pos = den > 0
    return jnp.where(pos, jnp.dot(y, My) / jnp.where(pos, den, 1.0), 0.0)
