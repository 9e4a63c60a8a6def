"""Path solvers: Boehl (2024) quasi-Newton and matrix-free Newton-Krylov.

Capability parity with the reference's `NewtonRaphson.jl`:

- `make_full_residual_fn` composes the equilibrium map
  F(x) = Residuals(assemble(x, Forward(Backward(x)))) exactly as
  `NewtonRaphson.jl:77-83` — here as one jit-compiled function whose JVP is a
  single `jax.jvp` through both scans.
- `newton_raphson_hank(method="boehl")` is the outer loop + y-iteration
  (`NewtonRaphson.jl:27-114`), with a real adaptive step size in place of the
  reference's hard-coded α = 0.5 stub (`NewtonRaphson.jl:100-103, 117-120`).
- `newton_raphson_hank(method="newton_krylov")` solves J(x)·d = F(x) by GMRES
  with the JVP operator and J̄⁻¹ preconditioning — the SURVEY §7 north-star
  formulation.
- `solve_path_dense` is the naive dense-Jacobian Newton (build-plan step 6),
  used for small-T cross-validation.

Everything runs on-device under one `jit`: the outer and inner loops are
`lax.while_loop`s, J̄ is factored once (f32 LU + f64 refinement) and reused.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Callable, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from hank_tpu.blocks.assemble import assemble_full_xmat, residuals as eval_residuals
from hank_tpu.blocks.backward import backward_iteration
from hank_tpu.blocks.forward import forward_iteration
from hank_tpu.config import TINY, config, exact_lowerings
from hank_tpu.ops.linalg import (dense_solve, gmres_matfree,
                                 make_reusable_solver, rayleigh_quotient)


def make_full_residual_fn(model, ss_initial, ss_ending,
                          exog_paths: Mapping[str, jnp.ndarray],
                          exact: bool = False) -> Callable:
    """The equilibrium map F(x) (`NewtonRaphson.jl:77-83`).

    x is the flat (n_endog·(T-1),) endogenous sequence; the return is the
    stacked residual vector of the same length (square system,
    `SteadyStateJacobian.jl:43-46`).

    exact=True traces the pipeline under `config.exact_lowerings()` —
    the gather/elementwise interpolation forms, which round at ~1e-15
    regardless of any hat-basis or dense override selected for the default
    program. Used for the host_inner full-precision residual/certification
    programs; with the default lowerings the two programs are the same.
    """
    def F(x):
        with exact_lowerings(exact):
            policies = backward_iteration(x, exog_paths, model,
                                          ss_ending.vars, ss_ending.value)
            aggs = forward_iteration(policies, model, ss_initial.D)
            x_mat = assemble_full_xmat(x, aggs, exog_paths, model,
                                       ss_initial.vars, ss_ending.vars)
            return eval_residuals(x_mat, model)
    return F


def _check_finite(fnorm: float, method: str, iteration: int, x: jnp.ndarray) -> None:
    """NaN/Inf guard around Newton steps (the analogue of the reference's
    `safe_eval` Inf-fill diagnostics, `SteadyState.jl:199`). Raises
    unconditionally — a silently-returned NaN path is useless, and with
    strict-descent backtracking a non-finite norm here means even the
    INITIAL residual was non-finite."""
    if not math.isfinite(fnorm):
        n_bad = int(jnp.sum(~jnp.isfinite(x)))
        raise FloatingPointError(
            f"[{method}] non-finite residual norm {fnorm} at outer iteration "
            f"{iteration} ({n_bad}/{x.size} non-finite entries in x). "
            "Likely an infeasible aggregate path (e.g. r < -1); loosen the "
            "shock or start closer to the steady state.")


def _boehl_alpha(ray: jnp.ndarray) -> jnp.ndarray:
    """Adaptive Richardson step size from the Rayleigh-quotient estimate.

    The inner iteration is y ← y + α(J̄⁻¹F − J̄⁻¹J y); with P = J̄⁻¹J it
    converges for α < 2/λ_max(P). `ray = ⟨y, Py⟩/⟨y, y⟩` tracks the dominant
    curvature along the current direction, so α = 1/max(ray, 1) keeps the
    spectral radius of (I − αP) below 1 while taking full steps when P ≈ I
    (near the steady state). Clipped to [0.05, 1]. Replaces the reference's
    `alphaUpdate` stub (`NewtonRaphson.jl:117-120`).
    """
    return jnp.clip(1.0 / jnp.maximum(ray, 1.0), 0.05, 1.0)


@functools.lru_cache(maxsize=8)
def _cgs2_program(n: int, dtype_name: str):
    """One compiled CGS2 projection step over a FIXED-shape (m+1, n) basis.

    Projects w against the first `k` rows of Vm (rows ≥ k are zero, so a
    full-basis matvec with a row mask is shape-stable — one compiled
    program serves every Arnoldi step). Two projection passes (classical
    Gram-Schmidt twice ≡ MGS stability at f64), then the new column's
    coefficients, the orthogonalized w and its norm come back in ONE
    device round trip, where modified Gram-Schmidt would fetch each h_ij
    as a separate scalar (j+2 host round trips per Arnoldi step)."""
    dtype = jnp.dtype(dtype_name)

    @jax.jit
    def step(Vm, w, k):
        rows = jnp.arange(Vm.shape[0], dtype=jnp.int32) < k
        h1 = jnp.where(rows, Vm @ w, 0.0)
        w1 = w - Vm.T @ h1
        h2 = jnp.where(rows, Vm @ w1, 0.0)
        w2 = w1 - Vm.T @ h2
        return h1 + h2, w2, jnp.linalg.norm(w2)

    return step


def _host_pgmres_cycle(apply_A, b, m: int, tol: float):
    """One Arnoldi/CGS2 cycle of host-driven GMRES (numpy f64 LS).

    The Krylov basis is a device-resident (m+1, n) array; per Arnoldi step
    the host fetches exactly TWO results (the Hessenberg column and the
    new norm) instead of one scalar per projection.

    Returns (dx, rel_residual, matvecs); dx is None if a matvec came back
    non-finite (caller escalates to a more robust operator).
    """
    bn = float(jnp.linalg.norm(b))
    if bn == 0.0 or not math.isfinite(bn):
        return None, float("inf"), 0
    cgs2 = _cgs2_program(b.shape[0], str(b.dtype))
    Vm = jnp.zeros((m + 1, b.shape[0]), b.dtype)
    Vm = Vm.at[0].set(b / bn)
    H = np.zeros((m + 1, m))
    y = np.zeros(0)
    k = 0
    rrel = float("inf")
    for j in range(m):
        w = apply_A(Vm[j])
        hcol_d, w, hn_d = cgs2(Vm, w, jnp.asarray(j + 1, jnp.int32))
        hcol = np.asarray(hcol_d[:j + 1])
        hn = float(hn_d)
        if not (math.isfinite(hn) and np.isfinite(hcol).all()):
            return None, float("inf"), j + 1
        H[:j + 1, j] = hcol
        H[j + 1, j] = hn
        k = j + 1
        e1 = np.zeros(k + 1)
        e1[0] = bn
        y, *_ = np.linalg.lstsq(H[:k + 1, :k], e1, rcond=None)
        rrel = float(np.linalg.norm(H[:k + 1, :k] @ y - e1)) / bn
        if hn < 1e-14 * bn or rrel < tol:
            break
        Vm = Vm.at[j + 1].set(w / hn)
    dx = Vm[:k].T @ jnp.asarray(y[:k], b.dtype)
    return dx, rrel, k


def _host_pgmres(apply_A, b, m: int, tol: float, restarts: int = 1):
    """Host-driven restarted GMRES on compiled matvecs (Arnoldi/MGS).

    Solves A·dx = b to relative tolerance `tol` with at most `m` matvecs
    per cycle and up to `restarts` extra cycles. Used by the host_inner
    boehl endgame: unlike the Richardson y-iteration, GMRES contracts even
    when the preconditioned operator is INDEFINITE along the current
    direction — which is exactly what happens at a kinked residual's f32
    noise floor (measured two-asset at the floor point: Rayleigh quotients
    of J̄⁻¹J in [-2.3, -0.3], where Richardson diverges at any step size).
    The Krylov basis lives on device; the (m+1, m) Hessenberg least-squares
    runs on the host in numpy f64 (no normal equations, no conditioning
    squaring).

    A cycle that stops at m without reaching tol is NOT silently treated as
    a full solve (round-3 weakness): if it made real progress the residual
    is re-evaluated exactly (one extra matvec) and another cycle runs from
    the deflated right-hand side; a stagnant cycle (< 10% residual drop)
    stops — restarting it would burn m matvecs for nothing and the caller's
    LM damping is the right escalation.

    Returns (dx, rel_residual, matvecs); dx is None if a matvec came back
    non-finite on the FIRST cycle (caller escalates the operator); later
    non-finite cycles return the best accumulated iterate.
    """
    bn = float(jnp.linalg.norm(b))
    if bn == 0.0 or not math.isfinite(bn):
        return None, float("inf"), 0
    dx_total = None
    r = b
    rrel_prev = 1.0
    total_mv = 0
    rrel = float("inf")
    for cycle in range(restarts + 1):
        dx, rrel_c, mv = _host_pgmres_cycle(apply_A, r, m, tol / rrel_prev)
        total_mv += mv
        if dx is None:
            if dx_total is None:
                return None, float("inf"), total_mv
            return dx_total, rrel, total_mv
        dx_total = dx if dx_total is None else dx_total + dx
        rrel = rrel_c * rrel_prev            # vs the ORIGINAL b
        if rrel < tol or cycle == restarts:
            break
        # True deflated residual (Arnoldi's estimate drifts across cycles).
        r = b - apply_A(dx_total)
        total_mv += 1
        rn = float(jnp.linalg.norm(r))
        if not math.isfinite(rn):
            break
        rrel = rn / bn
        if rrel < tol or rrel > 0.9 * rrel_prev:
            break
        rrel_prev = rrel
    return dx_total, rrel, total_mv


def newton_raphson_hank(
    x0: jnp.ndarray,
    Jbar: jnp.ndarray,
    exog_paths: Mapping[str, jnp.ndarray],
    model,
    ss_initial,
    ss_ending,
    **kwargs,
) -> tuple[jnp.ndarray, dict]:
    """Solve F(x) = 0 for the perfect-foresight transition path.

    One-shot convenience over `make_path_solver` (which returns a reusable
    jit-compiled solver — use that when solving repeatedly with one model).

    Args:
      x0: initial guess, flat (n_endog·(T-1),) (typically the SS sequence).
      Jbar: dense steady-state sequence-space Jacobian from
        `get_steady_state_jacobian` (factored once, reused throughout).
      method: "boehl" (y-iteration, `NewtonRaphson.jl:65-114`) or
        "newton_krylov" (preconditioned GMRES on the JVP operator).
      direction_dtype: optional lower precision (jnp.float32) for the JVP
        sweeps that build search directions — inexact Newton: residuals and
        the solution stay in x0's dtype (f64), so the final accuracy is
        unchanged while the hot sweeps run at f32 speed.
      stall_rescue: newton_krylov + host_outer only — when backtracking finds
        no descent along the Newton direction (strongly nonlinear valleys,
        e.g. the two-asset fiscal impact response), hand the iterate to the
        adaptively-damped boehl y-iteration instead of stopping (default on).

    Returns (x_solution, info) with info = {"iterations", "residual_norm"}
    plus, for method="boehl", {"inner_iterations", "y_norm"} (the last
    Newton-step norm — the reference's stopping quantity,
    `NewtonRaphson.jl:38-44`).
    """
    return make_path_solver(Jbar, exog_paths, model, ss_initial, ss_ending,
                            **kwargs)(x0)


def make_path_solver(
    Jbar: jnp.ndarray,
    exog_paths: Mapping[str, jnp.ndarray],
    model,
    ss_initial,
    ss_ending,
    *,
    eps: float = 1e-9,
    method: str = "boehl",
    max_outer: int | None = None,
    richardson_max_outer: int | None = None,
    max_inner: int = 500,
    gmres_restart: int = 20,
    gmres_maxiter: int = 2,
    direction_dtype=None,
    host_outer: bool = True,
    host_inner: bool = False,
    verbose: bool = False,
    records: list | None = None,
    stall_rescue: bool = True,
    endgame: str = "jvp",
    endgame_gmres_tol: float = 1e-3,
):
    """Build a reusable jit-compiled path solver `run(x0) -> (x, info)`.

    Compiles once; call with many initial guesses. See `newton_raphson_hank`
    for parameter semantics.

    host_outer: drive the outer Newton loop from the host (a handful of
      iterations; enables per-iteration records). Set False for the
      fully-traced variant (required under vmap — ensembles).
    host_inner: (boehl, requires host_outer) drive the inner Richardson loop
      from the host as well, compiling only a few SMALL programs (jvp_dir,
      J̄⁻¹ apply, F) instead of one traced outer_step — much cheaper to
      compile for the large two-asset program, and the per-iteration host
      dispatch is small next to the sweep cost. The stall-rescue path uses
      this.
    records: optional list; appended one dict per outer iteration
      (residual norm, inner sweeps) when host_outer is set — the structured
      observability the reference's println lines lack (SURVEY §5).
    endgame: operator of the endgame's second rung (host_inner only) —
      "jvp" (AD through the full-precision pipeline) or "fd" (central
      difference of the full-precision residual).
    endgame_gmres_tol: relative tolerance of the host-PGMRES inner solve in
      the endgame (host_inner only). Tighter values trade extra f32 matvecs
      for fewer Newton outers, each of which costs one full-precision
      residual evaluation (floor: the f32 direction operator's ~1e-6
      relative noise).
    """
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    if host_inner and (method != "boehl" or not host_outer):
        raise ValueError("host_inner requires method='boehl' and host_outer")
    solve_jbar = make_reusable_solver(Jbar)
    max_outer = config.path_newton_max_iter if max_outer is None else max_outer
    # Cap on the boehl host_inner RICHARDSON phase only (the GMRES endgame
    # keeps the full max_outer budget). An explicit 0 skips Richardson
    # entirely — the endgame-only route for warm starts that already sit in
    # the quadratic basin (e.g. the linear IRF).
    rich_max_outer = (max_outer if richardson_max_outer is None
                      else min(richardson_max_outer, max_outer))
    x_dtype = config.dtype

    F32 = None     # f32 residual for the mixed-precision outer schedule
    if direction_dtype is not None and direction_dtype != x_dtype:
        from hank_tpu.ops.precision import cast_model, cast_paths, cast_ss

        m_lo = cast_model(model, direction_dtype)
        s0_lo = cast_ss(ss_initial, direction_dtype)
        sT_lo = cast_ss(ss_ending, direction_dtype)
        ex_lo = cast_paths(exog_paths, direction_dtype)

        # Mixed-tail direction map: the household scans (all the FLOPs)
        # run at direction_dtype, but the assemble/residual tail — a few
        # n_v × T scalar equations with pow()s (K^α prices, market
        # clearing) — is promoted back to full precision, so the f32
        # rounding of those pow()s does not cap the direction accuracy;
        # the tail costs O(n_v·T) — nothing next to the scans.
        def F_dir(x_lo):
            pols = backward_iteration(x_lo, ex_lo, m_lo, sT_lo.vars,
                                      sT_lo.value)
            aggs = forward_iteration(pols, m_lo, s0_lo.D)
            aggs_hi = {k: v.astype(x_dtype) for k, v in aggs.items()}
            x_mat = assemble_full_xmat(x_lo.astype(x_dtype), aggs_hi,
                                       exog_paths, model,
                                       ss_initial.vars, ss_ending.vars)
            return eval_residuals(x_mat, model)

        def jvp_dir(x, v):
            out = jax.jvp(F_dir, (x.astype(direction_dtype),),
                          (v.astype(direction_dtype),))[1]
            return out.astype(x.dtype)

        def F32(x):
            return F_dir(x.astype(direction_dtype)).astype(x.dtype)
    else:
        def jvp_dir(x, v):
            return jax.jvp(F, (x,), (v,))[1]

    if method == "boehl":
        # Inexact-Newton inner stop: R = J̄⁻¹(F(x) − J(x)y) is the
        # preconditioned residual of the linear system J y = F(x) (computed
        # in the body anyway); stop when it has dropped by `inner_eta`
        # relative to the initial preconditioned residual J̄⁻¹F(x). With f32
        # directions the achievable floor is the f32 noise, so η is looser —
        # the outer loop still converges to full f64 accuracy since residuals
        # stay full-precision (classic inexact Newton). η = 1e-5 balances
        # inner sweeps against outer iterations: each outer contraction is
        # ~η, so ~2-3 outers cover 1 → 1e-9 while the inner Richardson stops
        # as soon as the linear model is solved to the useful accuracy.
        inner_eta = 1e-5

        def y_iteration(x, y0, Fx):
            R0_norm = jnp.linalg.norm(solve_jbar(Fx))
            tol = jnp.maximum(inner_eta * R0_norm, TINY)

            def cond(carry):
                _, rnorm, it = carry
                return (rnorm > tol) & (it < max_inner)

            def body(carry):
                y, _, it = carry
                Lxy = jvp_dir(x, y)
                R = solve_jbar(Fx - Lxy)
                M = solve_jbar(Lxy)
                alpha = _boehl_alpha(rayleigh_quotient(M, y))
                y_new = y + alpha * R
                return y_new, jnp.linalg.norm(R), it + 1

            y, _, inner_its = jax.lax.while_loop(
                cond, body, (y0, jnp.inf, 0))
            return y, inner_its

        @jax.jit
        def outer_step(x, y, Fx):
            # Fx = F(x) is carried in from the previous outer's convergence
            # evaluation — one full-precision residual per outer, not two.
            y_new, inner_its = y_iteration(x, y, Fx)
            x_new = x - y_new
            Fx_new = F(x_new)
            return x_new, y_new, Fx_new, jnp.linalg.norm(Fx_new), inner_its

        if host_outer and host_inner:
            # Host-driven inner Richardson: the same iteration as
            # y_iteration, dispatched as a handful of SMALL compiled
            # programs. ONE full-precision residual program steers descent
            # and certifies: the exact lowerings (gathers + elementwise
            # expectation), the plain f64 pipeline.
            F_exact = make_full_residual_fn(model, ss_initial, ss_ending,
                                            exog_paths, exact=True)
            solve_j = jax.jit(solve_jbar)
            F_j = jax.jit(F_exact)

            # One Richardson inner step as ONE program: jvp + both J̄⁻¹
            # applications + the adaptive Boehl step fused into a single
            # dispatch.
            @jax.jit
            def rich_body(x, y, Fx):
                Lxy = jvp_dir(x, y)
                R = solve_jbar(Fx - Lxy)
                alpha = _boehl_alpha(
                    rayleigh_quotient(solve_jbar(Lxy), y))
                return y + alpha * R, jnp.linalg.norm(R)
            # Endgame: with f32 direction sweeps the Newton step carries
            # ~1e-6-relative noise, so the Richardson outer floors around
            # 1e-6 instead of descending to eps. Worse, at a KINKED
            # residual's floor the preconditioned operator J̄⁻¹J can be
            # indefinite along the iterate (two-asset: Rayleigh quotients
            # in [-2.3, -0.3]) — Richardson then diverges at ANY step size
            # and at ANY operator precision. The endgame therefore switches
            # ALGORITHM, not just precision: host-driven preconditioned
            # GMRES (`_host_pgmres`) with a backtracking line search, over
            # an operator ladder escalated only when a step fails to
            # descend:
            #   1. the f32 direction jvp (already compiled, cheap);
            #   2. "jvp" — AD through the full-precision pipeline
            #      (endgame="jvp", mixed precision only);
            #   3. "fd"  — central difference of the full-precision
            #      residual, J·v ≈ (F(x+hu) − F(x−hu))·|v|/(2h), u = v/|v|,
            #      reusing the already-compiled residual program. FD
            #      directional error ~ h²‖F‴‖ + ε₆₄‖F‖/h ≈ 1e-10 per unit
            #      tangent at h = 1e-5.
            # Non-finite matvecs escalate down the ladder.
            mixed = direction_dtype is not None and direction_dtype != x_dtype
            if endgame not in ("jvp", "fd"):
                raise ValueError(f"unknown endgame {endgame!r}")
            jvp_full = (jax.jit(lambda x, v: jax.jvp(F_exact, (x,), (v,))[1])
                        if mixed and endgame == "jvp" else None)
            # FD step: the model's CompSpec.dx (the YAML fd-step parameter,
            # reference `ModelParser.jl:312-317`), clamped into the window
            # where the central-difference error h²·‖F‴‖/6 + ε₆₄‖F‖/h stays
            # ≲ 1e-10 per unit tangent — the endgame certifies 1e-8 norms,
            # so a raw model dx of 0.001 (KS yaml) or 1e-8 (parser default)
            # would poison the operator with truncation/cancellation noise.
            fd_h = float(min(max(model.compspec.dx, 1e-6), 1e-5))

            def jvp_fd(x, v):
                vn = float(jnp.linalg.norm(v))
                if vn == 0.0 or not math.isfinite(vn):
                    return jnp.zeros_like(x)
                u = v * (1.0 / vn)
                return (F_j(x + fd_h * u)
                        - F_j(x - fd_h * u)) * (vn / (2.0 * fd_h))

            # Operator ladder for the GMRES endgame, cheapest first (the
            # non-mixed AD rung is already full-precision). Each rung IS
            # the preconditioned matvec v ↦ J̄⁻¹·J·v: the AD rung fuses the
            # J̄⁻¹ application into the jvp program (one dispatch per
            # Arnoldi step); the host-composed fd rung applies solve_j
            # around its two residual evaluations.
            sjvp_j = jax.jit(lambda x, v: solve_jbar(jvp_dir(x, v)))
            ladder = [("f32" if mixed else "ad", sjvp_j)]
            if jvp_full is not None:
                ladder.append(("f64-ad",
                               lambda x, v: solve_j(jvp_full(x, v))))
            ladder.append(("fd", lambda x, v: solve_j(jvp_fd(x, v))))

            def run(x0):
                # Per-program wall-clock accumulators (host-driven loop, so
                # timing is exact): the solve's cost model lives in the
                # returned info dict — "prof" maps program -> [calls, secs].
                prof = {"sweep": [0, 0.0], "solve_j": [0, 0.0],
                        "F": [0, 0.0], "pgmres_mv": [0, 0.0]}

                def _timed(key, fn, *a):
                    t0 = time.perf_counter()
                    out = jax.block_until_ready(fn(*a))
                    prof[key][0] += 1
                    prof[key][1] += time.perf_counter() - t0
                    return out

                x, y = x0, x0
                Fx = _timed("F", F_j, x)
                fnorm = float(jnp.linalg.norm(Fx))
                iters = total_inner = 0
                best = fnorm
                since_improve = 0
                x_best, F_best = x, Fx
                # Phase 1: Richardson y-iteration with the cheap direction
                # operator — fast global progress down to its noise floor.
                while fnorm > eps and iters < rich_max_outer:
                    tol = max(inner_eta * float(jnp.linalg.norm(
                        _timed("solve_j", solve_j, Fx))), 1e-300)
                    rnorm, inner_its = float("inf"), 0
                    best_r, y_best_in = float("inf"), y
                    while rnorm > tol and inner_its < max_inner:
                        y_new, rn = _timed("sweep", rich_body, x, y, Fx)
                        rnew = float(rn)
                        if rnew < best_r:
                            best_r, y_best_in = rnew, y
                        elif (not math.isfinite(rnew)
                              or rnew > 10.0 * max(best_r, tol)):
                            # Inner Richardson divergence: keep the best
                            # inner iterate instead of spinning to NaN;
                            # the GMRES endgame below handles the
                            # indefinite region.
                            y = y_best_in
                            rnorm = rnew
                            break
                        y = y_new
                        rnorm = rnew
                        inner_its += 1
                    if not bool(jnp.all(jnp.isfinite(y))):
                        break                        # endgame from the best
                    x = x - y
                    Fx = _timed("F", F_j, x)
                    fnorm = float(jnp.linalg.norm(Fx))
                    _check_finite(fnorm, "boehl", iters + 1, x)
                    iters += 1
                    total_inner += inner_its
                    if fnorm < 0.5 * best:
                        since_improve = 0
                    else:
                        since_improve += 1
                    if fnorm < best:
                        best, x_best, F_best = fnorm, x, Fx
                    if verbose:
                        print(f"[boehl/host] outer {iters}: |F| = {fnorm:.3e} "
                              f"(+{inner_its} sweeps)", flush=True)
                    if records is not None:
                        records.append({"iteration": iters,
                                        "residual_norm": fnorm,
                                        "inner_sweeps": inner_its})
                    if since_improve >= 1:
                        # Richardson floor. One non-halving outer is proof
                        # enough: with inner forcing η = 1e-5 a healthy
                        # outer contracts by ~1e-2+, so < 2x progress means
                        # the f32-direction noise floor — and the GMRES
                        # endgame is strictly stronger from there (on the
                        # two-asset T=300 path ONE preconditioned-GMRES
                        # outer of 4 matvecs took 9.1e-6 -> 6.6e-9, while
                        # each extra floor-probing Richardson outer burned
                        # 14-18 sweeps + an exact F eval for < 0.1%
                        # improvement).
                        break
                    if fnorm > 3.0 * best:
                        # Ascending well above the best iterate: the f32
                        # direction operator is at its noise floor and
                        # further Richardson outers only burn sweeps
                        # (two-asset: 49 sweeps climbing 1.6e-6 -> 2.6e-5).
                        # Hand the best iterate to the endgame now.
                        break
                # Phase 2: host-PGMRES Newton endgame from the best iterate
                # (see the ladder comment above). Each outer solves
                # J̄⁻¹J·dx = J̄⁻¹F by GMRES and backtracks on the TRUE
                # residual norm; a step that fails to descend escalates the
                # operator, and a stall on the top operator keeps the best.
                if fnorm > eps:
                    x, Fx, fnorm = x_best, F_best, best
                    level = 0
                    m_kry = min(40, x.shape[0])
                    # Levenberg-Marquardt damping: the two-asset (r, ra)
                    # block makes J near-singular (model yaml), so the
                    # undamped Newton step rides the near-null direction
                    # far outside the linearization radius and no line-
                    # search fraction descends. Solving (J̄⁻¹J + λI)dx =
                    # J̄⁻¹F bounds the step; λ shrinks on success and
                    # grows on failure (escalating the operator only once
                    # damping itself is exhausted).
                    lam = 0.0
                    eg_stall = 0
                    if verbose and iters:
                        print(f"[boehl/host] Richardson floor at |F| = "
                              f"{best:.3e}; GMRES endgame "
                              f"({ladder[level][0]} operator)", flush=True)
                    while fnorm > eps and iters < max_outer:
                        # Noise-floor cutoff: when 3 consecutive outers
                        # (accepted or not) each improve the best norm by
                        # < 2%, the iterate is at the residual's own
                        # evaluation-noise floor — grinding damping ladders
                        # past that point triples wall-clock for single-
                        # digit-% gains (each stall costs a GMRES cycle +
                        # a line search of exact residual evaluations).
                        if eg_stall >= 3:
                            break
                        name, op = ladder[level]
                        dx, rrel, mv = _host_pgmres(
                            lambda v: _timed("pgmres_mv",
                                             lambda u: op(x, u), v)
                            + lam * v,
                            solve_j(Fx), m=m_kry, tol=endgame_gmres_tol)
                        total_inner += mv
                        iters += 1
                        if dx is None:
                            # Non-finite matvec: LM damping cannot fix a NaN
                            # operator (solve_j(op(x, v)) stays NaN whatever
                            # λ·v adds) — escalate the operator immediately
                            # instead of burning outer iterations on the
                            # damping ladder.
                            if level + 1 < len(ladder):
                                level += 1
                                lam = 0.0
                                x, Fx, fnorm = x_best, F_best, best
                                if verbose:
                                    print(f"[boehl/host] non-finite {name} "
                                          "matvec; escalating to "
                                          f"{ladder[level][0]}", flush=True)
                                continue
                            break                    # no operator left
                        accepted = False
                        if bool(jnp.all(jnp.isfinite(dx))):
                            # Full backtracking ladder only while outers
                            # are ACCEPTING: once an outer fails at this
                            # damping level the iterate is at/near the
                            # residual floor and the deep fractions never
                            # rescue it — retries probe the two ends only.
                            steps = ((1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
                                     if eg_stall == 0 else (1.0, 0.1))
                            for s in steps:
                                xt = x - s * dx
                                Ft = _timed("F", F_j, xt)
                                fn = float(jnp.linalg.norm(Ft))
                                if math.isfinite(fn) and fn < fnorm:
                                    x, Fx, fnorm = xt, Ft, fn
                                    accepted = True
                                    break
                        if accepted:
                            lam *= 0.3
                            if lam < 1e-6:
                                lam = 0.0
                            eg_stall = eg_stall + 1 if fnorm > 0.98 * best \
                                else 0
                            if fnorm < best:
                                best, x_best, F_best = fnorm, x, Fx
                            if verbose:
                                print(f"[boehl/host] endgame outer {iters}: "
                                      f"|F| = {fnorm:.3e} ({name}, "
                                      f"+{mv} matvecs, step {s}, "
                                      f"lam {lam:.1e})", flush=True)
                            if records is not None:
                                records.append({"iteration": iters,
                                                "residual_norm": fnorm,
                                                "inner_sweeps": mv,
                                                "operator": name})
                        elif lam < 1e1:
                            lam = max(30.0 * lam, 1e-2)
                            eg_stall += 1
                            x, Fx, fnorm = x_best, F_best, best
                            if verbose:
                                print(f"[boehl/host] no descent ({name}); "
                                      f"raising LM damping to {lam:.1e}",
                                      flush=True)
                        else:
                            if level + 1 < len(ladder):
                                level += 1
                                lam = 0.0
                                x, Fx, fnorm = x_best, F_best, best
                                if verbose:
                                    print("[boehl/host] damping exhausted "
                                          f"with {name} operator; escalating "
                                          f"to {ladder[level][0]}", flush=True)
                            else:
                                break                # genuine stall
                if best < fnorm:
                    x, fnorm = x_best, best
                return x, {"iterations": iters, "inner_iterations": total_inner,
                           "residual_norm": fnorm,
                           "y_norm": float(jnp.linalg.norm(y)),
                           "prof": {k: {"calls": v[0], "secs": round(v[1], 3)}
                                    for k, v in prof.items()}}

            return run

        if host_outer:
            def run(x0):
                x, y = x0, x0
                Fx = F(x0)
                fnorm = float(jnp.linalg.norm(Fx))
                iters = total_inner = 0
                while fnorm > eps and iters < max_outer:
                    x, y, Fx, fn, inner_its = outer_step(x, y, Fx)
                    fnorm = float(fn)
                    _check_finite(fnorm, "boehl", iters + 1, x)
                    iters += 1
                    total_inner += int(inner_its)
                    if verbose:
                        print(f"[boehl] outer {iters}: |F| = {fnorm:.3e} "
                              f"(+{int(inner_its)} sweeps)")
                    if records is not None:
                        records.append({"iteration": iters,
                                        "residual_norm": fnorm,
                                        "inner_sweeps": int(inner_its)})
                return x, {"iterations": iters, "inner_iterations": total_inner,
                           "residual_norm": fnorm,
                           "y_norm": float(jnp.linalg.norm(y))}

            return run

        @jax.jit
        def run(x0):
            def cond(carry):
                _, _, _, fnorm, it, _ = carry
                return (fnorm > eps) & (it < max_outer)

            def body(carry):
                x, y, Fx, _, it, tot = carry
                x_new, y_new, Fx_new, fnorm, inner_its = outer_step(x, y, Fx)
                return x_new, y_new, Fx_new, fnorm, it + 1, tot + inner_its

            Fx0 = F(x0)
            fnorm0 = jnp.linalg.norm(Fx0)
            x, y, _, fnorm, iters, total_inner = jax.lax.while_loop(
                cond, body, (x0, x0, Fx0, fnorm0, 0, 0))
            return x, {"iterations": iters, "inner_iterations": total_inner,
                       "residual_norm": fnorm,
                       "y_norm": jnp.linalg.norm(y)}

        return run

    if method == "newton_krylov":
        # f32 operator floor: don't ask GMRES for more than the JVP noise.
        gmres_tol = 3e-7 if direction_dtype == jnp.float32 else 1e-12

        # Preconditioner applications run per Arnoldi iteration; with f32
        # directions the matvec with the precomputed J̄⁻¹ runs in f32 too
        # (half the bytes of the f64 one). The f64 closure
        # still seeds x0 (and serves the Boehl R-maps elsewhere); GMRES's
        # convergence metric is preconditioned, so M's f32 roundoff only
        # perturbs the preconditioner, not the solution.
        if direction_dtype == jnp.float32:
            _Jinv32 = solve_jbar.A_inv.astype(jnp.float32)

            def precond(v):
                return (_Jinv32 @ v.astype(jnp.float32)).astype(v.dtype)
        else:
            precond = solve_jbar

        def make_nk_step(Fres):
            @jax.jit
            def nk_step(x, Fx, fnorm, fnorm_prev):
                # Eisenstat-Walker (choice 2) forcing: solve the Newton
                # system only as tightly as the outer convergence rate
                # warrants — η_k = 0.9·(‖F_k‖/‖F_{k-1}‖)², floored at the
                # direction-dtype noise and at what the final target still
                # requires. Early outers (far from the path) then stop
                # after a handful of JVP sweeps instead of over-solving a
                # linear model that Newton discards anyway.
                eta = jnp.clip(0.9 * (fnorm / fnorm_prev) ** 2, gmres_tol, 0.5)
                eta = jnp.maximum(eta, 0.1 * eps / jnp.maximum(fnorm, TINY))
                A = lambda v: jvp_dir(x, v)  # noqa: E731
                d, _ = gmres_matfree(
                    A, Fx, x0=solve_jbar(Fx), M=precond,
                    tol=eta, atol=0.0,
                    restart=gmres_restart, maxiter=gmres_maxiter)

                # Backtracking: a full step across a policy-clip kink can
                # land on the far side with a higher residual and two-cycle
                # forever (observed on the two-asset model near the liquid
                # grid-top clip). Halve the step until the residual
                # decreases (≤ 6 halvings); the while_loop costs ZERO extra
                # residual evaluations when the full step already descends
                # — the common case on smooth stretches.
                x_full = x - d
                Fx_full = Fres(x_full)
                fn_full = jnp.linalg.norm(Fx_full)

                def bt_cond(c):
                    _, _, fn_t, _, tries = c
                    return (~(jnp.isfinite(fn_t) & (fn_t < fnorm))) & (tries < 6)

                def bt_body(c):
                    _, _, _, alpha, tries = c
                    alpha = 0.5 * alpha
                    x_t = x - alpha * d
                    Fx_t = Fres(x_t)
                    return x_t, Fx_t, jnp.linalg.norm(Fx_t), alpha, tries + 1

                x_t, Fx_t, fn_t, _, _ = jax.lax.while_loop(
                    bt_cond, bt_body, (x_full, Fx_full, fn_full, 1.0, 0))
                # Strict descent: if all 6 halvings failed (or produced a
                # non-finite residual), keep the INCUMBENT (x, Fx, fnorm)
                # rather than the last tried iterate — a silent NaN would
                # otherwise end the jitted while_loop (NaN > eps is False)
                # and return a poisoned path. The outer loops detect the
                # resulting fnorm stall and stop.
                ok = jnp.isfinite(fn_t) & (fn_t < fnorm)
                x_new = jnp.where(ok, x_t, x)
                Fx_new = jnp.where(ok, Fx_t, Fx)
                fn_new = jnp.where(ok, fn_t, fnorm)
                return x_new, Fx_new, fn_new
            return nk_step

        nk_step = make_nk_step(F)

        if host_outer:
            # Mixed-residual outer schedule: while the residual norm is far
            # above the f32 noise floor, evaluate residuals (GMRES rhs,
            # backtracking, progress norm) with the f32 path. Switch to
            # full-precision residuals for the endgame; the reported
            # convergence is always genuine f64
            # (classic inexact Newton: early-phase residual error only
            # perturbs the step, never the answer).
            residual_switch = max(1e-3, 100.0 * eps)
            use_fast_phase = F32 is not None
            nk_step32 = make_nk_step(F32) if use_fast_phase else None
            F_fast = F32 if use_fast_phase else F

            def run(x0):
                x = x0
                Fx = F_fast(x0)
                fnorm = fprev = float(jnp.linalg.norm(Fx))
                iters = 0
                in_fast_phase = nk_step32 is not None
                while fnorm > eps and iters < max_outer:
                    if in_fast_phase and fnorm <= residual_switch:
                        # Re-anchor in full precision at the phase switch
                        # (the f32 Fx carries ~1e-6-scale noise).
                        in_fast_phase = False
                        Fx = F(x)
                        fprev = fnorm
                        fnorm = float(jnp.linalg.norm(Fx))
                        if fnorm <= eps:
                            break
                    step = nk_step32 if in_fast_phase else nk_step
                    x, Fx, fn = step(x, Fx, fnorm, fprev)
                    fprev, fnorm = fnorm, float(fn)
                    _check_finite(fnorm, "newton_krylov", iters + 1, x)
                    iters += 1
                    if fnorm >= fprev:
                        if in_fast_phase:
                            # The f32 noise floor can stall the fast phase
                            # before `residual_switch` is crossed — hand
                            # over to full precision instead of giving up.
                            in_fast_phase = False
                            Fx = F(x)
                            fnorm = float(jnp.linalg.norm(Fx))
                            continue
                        # Backtracking exhausted without descent. On strongly
                        # nonlinear models the Newton step can be trapped in a
                        # curved valley it cannot traverse: measured on the
                        # two-asset fiscal path, every damping of the (well-
                        # solved, descent-at-first-order) Newton direction
                        # gains < 1% per iteration while the adaptively-damped
                        # Boehl y-iteration converges from the same point in 4
                        # outers (the globalization the reference's
                        # `y_Iteration`, NewtonRaphson.jl:65-114, exists for).
                        # Hand the iterate to boehl instead of giving up.
                        import warnings
                        if stall_rescue and fnorm > eps:
                            warnings.warn(
                                f"[newton_krylov] no descent at |F| = "
                                f"{fnorm:.3e} after {iters} outers — "
                                "switching to the boehl y-iteration")
                            rescue = make_path_solver(
                                Jbar, exog_paths, model, ss_initial,
                                ss_ending, method="boehl", eps=eps,
                                max_outer=max(max_outer - iters, 4),
                                max_inner=max_inner,
                                direction_dtype=direction_dtype,
                                host_outer=True, host_inner=True,
                                verbose=verbose, records=records)
                            x, rinfo = rescue(x)
                            fnorm = float(rinfo["residual_norm"])
                            iters += int(rinfo["iterations"])
                            break
                        warnings.warn(
                            f"[newton_krylov] stalled at |F| = {fnorm:.3e} "
                            f"after {iters} outer iterations (no descent "
                            "direction found)")
                        break
                    if verbose:
                        print(f"[newton_krylov] outer {iters}: |F| = {fnorm:.3e}"
                              + (" (f32 phase)" if in_fast_phase else ""))
                    if records is not None:
                        records.append({"iteration": iters,
                                        "residual_norm": fnorm})
                return x, {"iterations": iters, "residual_norm": fnorm}

            return run

        @jax.jit
        def run(x0):
            def cond(carry):
                x, Fx, fnorm, fprev, it = carry
                # Strict descent holds except on a backtracking stall
                # (fnorm == fprev after the incumbent-return) — stop there
                # instead of spinning to max_outer.
                return (fnorm > eps) & (it < max_outer) & \
                    ((it == 0) | (fnorm < fprev))

            def body(carry):
                x, Fx, fnorm, fprev, it = carry
                x_new, Fx_new, fn = nk_step(x, Fx, fnorm, fprev)
                return x_new, Fx_new, fn, fnorm, it + 1

            Fx0 = F(x0)
            fnorm0 = jnp.linalg.norm(Fx0)
            x, _, fnorm, _, iters = jax.lax.while_loop(
                cond, body, (x0, Fx0, fnorm0, fnorm0, 0))
            return x, {"iterations": iters, "residual_norm": fnorm}

        return run

    raise ValueError(f"unknown method '{method}' (expected 'boehl' or 'newton_krylov')")


def solve_path_dense(
    x0: jnp.ndarray,
    exog_paths: Mapping[str, jnp.ndarray],
    model,
    ss_initial,
    ss_ending,
    *,
    eps: float = 1e-9,
    max_iter: int = 50,
) -> tuple[jnp.ndarray, dict]:
    """Naive dense-Jacobian Newton on the full path (small T only).

    Builds J(x) with `jax.jacfwd` through the whole pipeline each iteration —
    O(n_endog·(T-1)) JVP sweeps per step. Used as the ground-truth
    cross-check for the fast solvers (build-plan step 6).
    """
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    J = jax.jacfwd(F)

    @jax.jit
    def step(x):
        Fx = F(x)
        dx = dense_solve(J(x), Fx)
        return x - dx, jnp.linalg.norm(Fx)

    x = x0
    fnorm = jnp.inf
    for it in range(max_iter):
        x, fnorm = step(x)
        if float(fnorm) < eps:
            break
    final = jnp.linalg.norm(F(x))
    return x, {"iterations": it + 1, "residual_norm": final}
