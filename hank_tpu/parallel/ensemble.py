"""Ensemble solving: vmap whole shock ensembles, sharded across the mesh.

The data parallelism the reference lacks (SURVEY §2.10 row "DP"):
each mesh device solves a shard of the shock-path ensemble; the solver's
while_loops run in lockstep under vmap (a batch element that has converged
keeps iterating harmlessly until all have).
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hank_tpu.config import TINY, config
from hank_tpu.ops.linalg import make_reusable_solver, rayleigh_quotient
from hank_tpu.solvers.newton import (_boehl_alpha, make_full_residual_fn,
                                     newton_raphson_hank)


def _rows(arg, sl, B: int):
    """Slice the leading batch axis of a batched arg (dicts recurse)."""
    if isinstance(arg, dict):
        return {k: p[sl] for k, p in arg.items()}
    return arg[sl] if hasattr(arg, "ndim") and arg.ndim >= 1 \
        and arg.shape[0] == B else arg


def _pad_rows(arg, pad: int):
    """Append `pad` copies of row 0 along the batch axis (dicts recurse) —
    ragged final chunks run through the SAME compiled chunk-width program
    (the whole point of the width workaround); pad rows are dropped by
    `_trim`."""
    if pad <= 0:
        return arg
    if isinstance(arg, dict):
        return {k: _pad_rows(p, pad) for k, p in arg.items()}
    if hasattr(arg, "ndim") and arg.ndim >= 1:
        return jnp.concatenate(
            [arg, jnp.broadcast_to(arg[:1], (pad, *arg.shape[1:]))])
    return arg


def _trim(out, B: int, chunk: int, is_last: bool):
    rem = B % chunk
    return out[:rem] if (is_last and rem) else out


def _probe_width_consistency(inner_full, inner_chunked, x0, exog_batch,
                             B: int, n: int, dtype, rtol: float = 1e-3) -> bool:
    """Build-time batch-width miscompile probe.

    Runs ONE lockstep Richardson sweep with IDENTICAL rows through the
    full-width compiled `inner_step` and through chunk-width calls of the
    same computation. Healthy programs agree row-for-row and across widths
    to well below f32-direction noise; a width-dependent miscompilation
    shows as tangent norms off by an order of magnitude in some rows.
    Returns True when the full-width program is safe to use.
    """
    x_row = x0[0] if x0.ndim == 2 else x0
    xp = jnp.broadcast_to(x_row, (B, n)).astype(dtype)
    yp = jnp.full((B, n), 1e-3, dtype)
    Fxp = jnp.zeros((B, n), dtype)
    tol0 = jnp.zeros((B,), dtype)
    ex_p = {k: jnp.broadcast_to(v[:1], v.shape) for k, v in exog_batch.items()}
    _, r_full = inner_full(xp, yp, Fxp, tol0, ex_p)
    _, r_chunk = inner_chunked(xp, yp, Fxp, tol0, ex_p)
    scale = float(jnp.max(jnp.abs(r_chunk))) + 1e-30
    cross_dev = float(jnp.max(jnp.abs(r_full - r_chunk)))
    row_dev = float(jnp.max(jnp.abs(r_full - r_full[0])))
    return cross_dev <= rtol * scale and row_dev <= rtol * scale


def residual_ensemble(x_batch: jnp.ndarray,
                      exog_batch: Mapping[str, jnp.ndarray],
                      model, ss_initial, ss_ending,
                      mesh: Mesh | None = None) -> jnp.ndarray:
    """Batched F(x) over an ensemble of (x, shock-path) pairs.

    x_batch: (B, n_endog*(T-1)); exog_batch leaves: (B, T-1).
    With a mesh, inputs/outputs are sharded over the leading axis.
    """
    def F_one(x, exog):
        return make_full_residual_fn(model, ss_initial, ss_ending, exog)(x)

    fn = jax.vmap(F_one)
    if mesh is not None:
        shard = NamedSharding(mesh, P("dp"))
        fn = jax.jit(fn, in_shardings=(shard, {k: shard for k in exog_batch}),
                     out_shardings=shard)
    else:
        fn = jax.jit(fn)
    return fn(x_batch, exog_batch)


def solve_ensemble(x0: jnp.ndarray,
                   Jbar: jnp.ndarray,
                   exog_batch: Mapping[str, jnp.ndarray],
                   model, ss_initial, ss_ending,
                   mesh: Mesh | None = None,
                   method: str = "boehl",
                   **solver_kwargs) -> tuple[jnp.ndarray, dict]:
    """Solve the transition path for every shock in the ensemble.

    x0: (n,) shared initial guess (broadcast) or (B, n) per-path guesses.
    exog_batch leaves: (B, T-1). J̄ is shared (replicated) — the SS Jacobian
    does not depend on the shock path.

    Returns (x_paths (B, n), info dict of (B,) diagnostics).
    """
    def solve_one(x0_one, exog):
        # host_outer=False: the outer loop must be traced under vmap.
        return newton_raphson_hank(x0_one, Jbar, exog, model,
                                   ss_initial, ss_ending,
                                   method=method, host_outer=False,
                                   **solver_kwargs)

    B = next(iter(exog_batch.values())).shape[0]
    if x0.ndim == 1:
        x0 = jnp.broadcast_to(x0, (B, x0.shape[0]))

    fn = jax.vmap(solve_one)
    if mesh is not None:
        # Everything batched is dp-sharded: the paths (B, n) and the info
        # diagnostics (each a (B,) leaf) alike; J̄ and the model close over
        # the function and are replicated by XLA.
        shard = NamedSharding(mesh, P("dp"))
        fn = jax.jit(fn,
                     in_shardings=(shard, {k: shard for k in exog_batch}),
                     out_shardings=(shard, shard))
    else:
        fn = jax.jit(fn)
    return fn(x0, exog_batch)


def solve_ensemble_host(x0: jnp.ndarray,
                        Jbar: jnp.ndarray,
                        exog_batch: Mapping[str, jnp.ndarray],
                        model, ss_initial, ss_ending,
                        mesh: Mesh | None = None,
                        eps: float = 1e-8,
                        max_outer: int | None = None,
                        max_inner: int = 500,
                        inner_eta: float = 1e-5,
                        direction_dtype=jnp.float32,
                        chunk: int | None = 64,
                        method: str = "boehl",
                        gmres_m: int = 30,
                        verbose: bool = False,
                        records: list | None = None) -> tuple[jnp.ndarray, dict]:
    """Batched Boehl solve with a HOST-driven outer loop (production path).

    `solve_ensemble` traces the whole solver under vmap. This variant is
    the batched analogue of host_inner: the host drives the outer/inner
    Richardson iterations over three BATCHED compiled programs — vmapped
    F, vmapped direction JVP, and the J̄⁻¹ application (one (B, n) × (n, n)
    GEMM — J̄ is shock-independent and shared).
    All B paths iterate in lockstep; rows whose inner residual (or outer
    norm) has converged are frozen with `where` masks so finished paths
    don't wobble at the f32 direction-noise floor while stragglers finish.

    x0: (n,) shared guess (broadcast) or (B, n). exog_batch leaves: (B, T-1).
    With a mesh, the batch axis is dp-sharded (`NamedSharding(mesh, P("dp"))`)
    through every compiled program; J̄ and the model are replicated.

    chunk: width guard against batch-width-dependent miscompilation. For
    B > chunk the full-width programs are PROBED against chunk-width calls
    on identical rows (`_probe_width_consistency`) and used only when they
    agree; on mismatch the solve runs as host-level chunked calls of one
    compiled chunk-width program (ragged B pads the last chunk with row-0
    copies). None disables both the probe and the workaround.

    method: "boehl" (default) runs the lockstep Richardson y-iteration;
    "newton_krylov" runs a lockstep inexact-Newton outer with a HOST-driven
    batched GMRES inner (fixed-shape Arnoldi over the batched preconditioned
    matvec J̄⁻¹·J_x·v, per-path Hessenberg least-squares on the host,
    Eisenstat-Walker forcing, lockstep backtracking). Same per-path
    keep-best/freeze resilience; typically an order of magnitude fewer
    lockstep direction sweeps than Richardson, whose inner loop is gated by
    the worst path.
    gmres_m: Arnoldi iterations per cycle (newton_krylov only).

    Returns (x (B, n), info) with (B,)-shaped "residual_norm" plus scalar
    "iterations" / "inner_iterations" (lockstep counts).
    """
    if method not in ("boehl", "newton_krylov"):
        raise ValueError(f"method={method!r}: expected 'boehl'|'newton_krylov'")
    x_dtype = config.dtype
    B = next(iter(exog_batch.values())).shape[0]
    n = x0.shape[-1]
    if x0.ndim == 1:
        x0 = jnp.broadcast_to(x0, (B, n))
    max_outer = max_outer or config.path_newton_max_iter

    def F_one(x, ex):
        return make_full_residual_fn(model, ss_initial, ss_ending, ex)(x)

    solve_one = make_reusable_solver(Jbar)

    if direction_dtype is not None and direction_dtype != x_dtype:
        from hank_tpu.blocks.assemble import assemble_full_xmat
        from hank_tpu.blocks.assemble import residuals as eval_residuals
        from hank_tpu.blocks.backward import backward_iteration
        from hank_tpu.blocks.forward import forward_iteration
        from hank_tpu.ops.precision import cast_model, cast_ss

        m_lo = cast_model(model, direction_dtype)
        s0_lo = cast_ss(ss_initial, direction_dtype)
        sT_lo = cast_ss(ss_ending, direction_dtype)

        def jvp_one(x, v, ex):
            # Mixed-tail direction map — scans at direction_dtype, the
            # cheap assemble/residual tail in full precision (same design
            # and rationale as solvers/newton.py's F_dir).
            ex_lo = {k: p.astype(direction_dtype) for k, p in ex.items()}

            def F_dir(x_lo):
                pols = backward_iteration(x_lo, ex_lo, m_lo, sT_lo.vars,
                                          sT_lo.value)
                aggs = forward_iteration(pols, m_lo, s0_lo.D)
                aggs_hi = {k: a.astype(x_dtype) for k, a in aggs.items()}
                x_mat = assemble_full_xmat(x_lo.astype(x_dtype), aggs_hi,
                                           ex, model,
                                           ss_initial.vars, ss_ending.vars)
                return eval_residuals(x_mat, model)

            out = jax.jvp(F_dir, (x.astype(direction_dtype),),
                          (v.astype(direction_dtype),))[1]
            return out.astype(x_dtype)
    else:
        def jvp_one(x, v, ex):
            return jax.jvp(lambda z: F_one(z, ex), (x,), (v,))[1]

    F_b = jax.vmap(F_one)
    jvp_b = jax.vmap(jvp_one)
    solve_b = jax.vmap(solve_one)
    ray_b = jax.vmap(rayleigh_quotient)

    def inner_step(x, y, Fx, tol, ex):
        """One lockstep Richardson sweep over all B paths."""
        Lxy = jvp_b(x, y, ex)
        R = solve_b(Fx - Lxy)
        alpha = _boehl_alpha(ray_b(solve_b(Lxy), y))            # (B,)
        rnorm = jnp.linalg.norm(R, axis=-1)                     # (B,)
        upd = (rnorm > tol)[:, None]
        return jnp.where(upd, y + alpha[:, None] * R, y), rnorm

    def outer_update(x, y, Fx, fnorm, ex):
        active = (fnorm > eps)[:, None]
        x_new = jnp.where(active, x - y, x)
        Fx_new = F_b(x_new, ex)
        return x_new, Fx_new, jnp.linalg.norm(Fx_new, axis=-1)

    def matvec(x, v, ex):
        """Preconditioned batched Newton matvec: J̄⁻¹·(J_x·v) per path."""
        return solve_b(jvp_b(x, v, ex))

    if mesh is not None:
        shard = NamedSharding(mesh, P("dp"))
        rep = NamedSharding(mesh, P())
        ex_sh = {k: shard for k in exog_batch}
        inner_step = jax.jit(
            inner_step,
            in_shardings=(shard, shard, shard, shard, ex_sh),
            out_shardings=(shard, shard))
        outer_update = jax.jit(
            outer_update,
            in_shardings=(shard, shard, shard, shard, ex_sh),
            out_shardings=(shard, shard, shard))
        F_b0 = jax.jit(F_b, in_shardings=(shard, ex_sh), out_shardings=shard)
        solve_b_j = jax.jit(solve_b, in_shardings=(shard,),
                            out_shardings=shard)
        matvec_j = jax.jit(matvec, in_shardings=(shard, shard, ex_sh),
                           out_shardings=shard)
        del rep
    else:
        inner_step = jax.jit(inner_step)
        outer_update = jax.jit(outer_update)
        F_b0 = jax.jit(F_b)
        solve_b_j = jax.jit(solve_b)
        matvec_j = jax.jit(matvec)

    if mesh is None and chunk is not None and B > chunk:
        # Width guard: compile the full-width program, run one
        # identical-rows tangent through it and through chunk-width calls
        # (`_probe_width_consistency`), and fall back to host-level chunked
        # calls of ONE compiled chunk-width program only on mismatch.
        # Ragged B pads the final chunk with copies of row 0 (computed then
        # dropped), so the workaround applies for ANY B > chunk. The meshed
        # path shards rows across devices (per-device width stays small)
        # and is exempt.
        def _chunked(call, n_out=None):
            def run(*args):
                outs = []
                for i in range(0, B, chunk):
                    lo, hi = i, min(i + chunk, B)
                    pad = chunk - (hi - lo)
                    outs.append(call(*(_pad_rows(_rows(a, slice(lo, hi), B),
                                                 pad) for a in args)))
                if isinstance(outs[0], tuple):
                    return tuple(
                        jnp.concatenate([_trim(o[j], B, chunk, k == len(outs) - 1)
                                         for k, o in enumerate(outs)])
                        for j in range(len(outs[0])))
                return jnp.concatenate([_trim(o, B, chunk, k == len(outs) - 1)
                                        for k, o in enumerate(outs)])
            return run

        chunked_inner = _chunked(inner_step)
        if _probe_width_consistency(inner_step, chunked_inner, x0, exog_batch,
                                    B, n, x_dtype):
            pass          # full-width programs verified healthy — keep them
        else:
            import warnings

            warnings.warn(
                f"[ensemble] width-{B} direction program disagrees with "
                f"width-{chunk} on identical rows (a batch-width "
                "miscompilation) — driving the solve through chunked "
                "calls")
            inner_step = chunked_inner
            outer_update = _chunked(outer_update)
            F_b0 = _chunked(F_b0)
            solve_b_j = _chunked(solve_b_j)
            matvec_j = _chunked(matvec_j)

    if method == "newton_krylov":
        gmres_tol = 3e-7 if direction_dtype == jnp.float32 else 1e-12
        return _run_ensemble_nk(
            x0, exog_batch, B, x_dtype, F_b0, matvec_j, solve_b_j,
            eps=eps, max_outer=max_outer, gmres_m=gmres_m,
            gmres_tol=gmres_tol, verbose=verbose, records=records)

    x = x0.astype(x_dtype)
    y = jnp.zeros_like(x)
    Fx = F_b0(x, exog_batch)
    fnorm = jnp.linalg.norm(Fx, axis=-1)
    # Per-path resilience — the batched analogue of the single-path
    # host_inner guards in solvers/newton.py: keep the best iterate per
    # path, revert non-finite rows to it, and freeze rows that have
    # genuinely stalled, so one infeasible shock draw (e.g. a tail draw
    # that pushes r < -1 mid-path) cannot poison or hard-fail the other
    # B-1 paths. Frozen rows are reported unconverged in the info dict.
    x_best, F_best, f_best = x, Fx, fnorm
    since_improve = jnp.zeros((B,), dtype=jnp.int32)
    frozen = ~jnp.isfinite(fnorm)
    iters = total_inner = 0
    while bool(((fnorm > eps) & ~frozen).any()) and iters < max_outer:
        tol = jnp.maximum(
            inner_eta * jnp.linalg.norm(solve_b_j(Fx), axis=-1), TINY)
        rnorm = jnp.full((B,), jnp.inf, dtype=x_dtype)
        best_r = jnp.full((B,), jnp.inf, dtype=x_dtype)
        y_best = y
        diverged = frozen            # frozen rows sit out the inner loop too
        inner_its = 0
        while (bool(((rnorm > tol) & ~diverged).any())
               and inner_its < max_inner):
            y_prev = y
            y, rnorm = inner_step(x, y, Fx, tol, exog_batch)
            improved_r = rnorm < best_r
            y_best = jnp.where(improved_r[:, None], y_prev, y_best)
            best_r = jnp.minimum(best_r, rnorm)
            diverged = (diverged | ~jnp.isfinite(rnorm)
                        | (rnorm > 10.0 * jnp.maximum(best_r, tol)))
            inner_its += 1
        # Inner Richardson divergence (indefinite preconditioned operator
        # at a kink or noise floor): keep that row's best inner iterate.
        y = jnp.where(diverged[:, None], y_best, y)
        x_new, Fx_new, fn_new = outer_update(x, y, Fx, fnorm, exog_batch)
        bad = ~jnp.isfinite(fn_new)
        x = jnp.where(frozen[:, None], x,
                      jnp.where(bad[:, None], x_best, x_new))
        Fx = jnp.where(frozen[:, None], Fx,
                       jnp.where(bad[:, None], F_best, Fx_new))
        fnorm = jnp.where(frozen, fnorm, jnp.where(bad, f_best, fn_new))
        y = jnp.where((bad | frozen)[:, None], jnp.zeros_like(y), y)
        since_improve = jnp.where(fnorm < 0.5 * f_best, 0, since_improve + 1)
        improved = fnorm < f_best
        x_best = jnp.where(improved[:, None], x, x_best)
        F_best = jnp.where(improved[:, None], Fx, F_best)
        f_best = jnp.where(improved, fnorm, f_best)
        frozen = frozen | (since_improve >= 4)
        iters += 1
        total_inner += inner_its
        n_conv = int(jnp.sum(fnorm <= eps))
        n_stall = int(jnp.sum(frozen & (fnorm > eps)))
        if verbose:
            print(f"[ensemble/host] outer {iters}: max|F| = "
                  f"{float(jnp.where(frozen, 0.0, fnorm).max()):.3e}, "
                  f"{n_conv}/{B} converged, {n_stall} stalled "
                  f"(+{inner_its} sweeps)", flush=True)
        if records is not None:
            records.append({"iteration": iters,
                            "max_residual_norm": float(fnorm.max()),
                            "converged": n_conv,
                            "stalled": n_stall,
                            "inner_sweeps": inner_its})
    better = f_best < fnorm
    x = jnp.where(better[:, None], x_best, x)
    fnorm = jnp.where(better, f_best, fnorm)
    return x, {"iterations": iters, "inner_iterations": total_inner,
               "residual_norm": fnorm,
               "stalled_paths": int(jnp.sum(frozen & (fnorm > eps)))}


def _run_ensemble_nk(x0, exog_batch, B: int, x_dtype, F_b0, matvec,
                     solve_b_j, *, eps: float, max_outer: int, gmres_m: int,
                     gmres_tol: float, verbose: bool,
                     records: list | None) -> tuple[jnp.ndarray, dict]:
    """Lockstep batched inexact-Newton with host-driven batched GMRES.

    The batched analogue of solvers/newton.py's newton_krylov: each outer
    solves the preconditioned Newton system J̄⁻¹J_x·dx = −J̄⁻¹F per path
    with ONE shared Arnoldi schedule — every Arnoldi step costs one lockstep
    batched direction sweep (`matvec`). The Krylov
    basis is a FIXED-shape zero-padded (B, m+1, n) device array (one
    compiled CGS2 program serves every step); the per-path (m+1, m)
    Hessenberg least-squares runs on the host in numpy f64. Per-path
    Eisenstat-Walker forcing, lockstep backtracking with per-path step
    halving, and the same keep-best/freeze resilience as the Richardson
    loop. Richardson needs O(100s) of lockstep sweeps per solve (worst-path
    gated); GMRES contracts in O(10s).
    """
    import numpy as _np

    n = x0.shape[-1]
    m = gmres_m

    @jax.jit
    def _ortho(Vs, w):
        # CGS2 against the zero-padded basis: padded rows contribute 0.
        h1 = jnp.einsum("bkn,bn->bk", Vs, w)
        w = w - jnp.einsum("bk,bkn->bn", h1, Vs)
        h2 = jnp.einsum("bkn,bn->bk", Vs, w)
        w = w - jnp.einsum("bk,bkn->bn", h2, Vs)
        return w, h1 + h2

    @jax.jit
    def _insert(Vs, v, j):
        return jax.lax.dynamic_update_slice(Vs, v[:, None, :], (0, j, 0))

    @jax.jit
    def _get_row(Vs, j):
        return jax.lax.dynamic_slice(Vs, (0, j, 0), (B, 1, n))[:, 0]

    @jax.jit
    def _normalize(w):
        wn = jnp.linalg.norm(w, axis=-1)
        good = wn > TINY
        v = jnp.where(good[:, None], w / jnp.maximum(wn, TINY)[:, None], 0.0)
        return v, wn

    @jax.jit
    def _expand(Vs, y):
        return jnp.einsum("bk,bkn->bn", y, Vs)

    @jax.jit
    def _rownorm(a):
        return jnp.linalg.norm(a, axis=-1)

    def _ls_rrel(H, bn, k):
        """Per-path Hessenberg least squares (host, numpy f64).

        Returns y (B, k) and the relative GMRES residual per path."""
        y = _np.zeros((B, k))
        rrel = _np.ones(B)
        for b in range(B):
            if bn[b] <= TINY:
                rrel[b] = 0.0
                continue
            Hb = H[b, :k + 1, :k]
            e1 = _np.zeros(k + 1)
            e1[0] = bn[b]
            yb, *_ = _np.linalg.lstsq(Hb, e1, rcond=None)
            y[b] = yb
            rrel[b] = float(_np.linalg.norm(Hb @ yb - e1)) / bn[b]
        return y, rrel

    def gmres_cycle(x, r0, eta, active):
        """One lockstep Arnoldi cycle; early exit when every active path's
        projected residual meets its forcing tolerance."""
        bn = _np.asarray(_rownorm(r0))
        v0, _ = _normalize(r0)
        Vs = _insert(jnp.zeros((B, m + 1, n), x_dtype), v0, 0)
        H = _np.zeros((B, m + 1, m))
        k = 0
        y = _np.zeros((B, 0))
        rrel = _np.where(bn > TINY, 1.0, 0.0)
        for j in range(m):
            w = matvec(x, _get_row(Vs, j), exog_batch)
            w, h = _ortho(Vs, w)
            v_next, wn = _normalize(w)
            Vs = _insert(Vs, v_next, j + 1)
            h_np = _np.asarray(h)
            wn_np = _np.asarray(wn)
            if not _np.isfinite(h_np).all() or not _np.isfinite(wn_np).all():
                break                      # caller keeps best-so-far iterate
            H[:, :m + 1, j] = h_np
            H[:, j + 1, j] = wn_np
            k = j + 1
            y, rrel = _ls_rrel(H, bn, k)
            if not (active & (rrel > eta)).any():
                break
        if k == 0:
            return jnp.zeros_like(r0), rrel, 0
        y_pad = _np.zeros((B, m + 1))
        y_pad[:, :k] = y
        dx = _expand(Vs, jnp.asarray(y_pad, x_dtype))
        return dx, rrel, k

    x = x0.astype(x_dtype)
    Fx = F_b0(x, exog_batch)
    fnorm = _rownorm(Fx)
    x_best, F_best, f_best = x, Fx, fnorm
    since_improve = jnp.zeros((B,), dtype=jnp.int32)
    frozen = ~jnp.isfinite(fnorm)
    fprev = _np.asarray(fnorm)       # first-outer forcing: eta clips to 0.5
    iters = total_mv = 0
    while bool(((fnorm > eps) & ~frozen).any()) and iters < max_outer:
        fn_np = _np.asarray(fnorm)
        active = _np.asarray(~frozen) & (fn_np > eps)
        # Eisenstat-Walker (choice 2) per path, floored at the direction
        # noise and at what the final target still requires.
        eta = _np.clip(0.9 * (fn_np / _np.maximum(fprev, TINY)) ** 2,
                       gmres_tol, 0.5)
        eta = _np.maximum(eta, 0.1 * eps / _np.maximum(fn_np, TINY))
        b_rhs = -solve_b_j(Fx)
        dx, rrel, mv = gmres_cycle(x, b_rhs, eta, active)
        total_mv += mv
        if mv and (active & (rrel > eta)).any():
            # One restart from the deflated residual (mirrors _host_pgmres):
            # a cycle that hit m without meeting the forcing term usually
            # still made progress; deflate and run one more.
            r = b_rhs - matvec(x, dx, exog_batch)
            total_mv += 1
            if bool(jnp.isfinite(_rownorm(r)).all()):
                dx2, _, mv2 = gmres_cycle(x, r, eta, active)
                dx = dx + dx2
                total_mv += mv2
        # Lockstep backtracking: per-path step halving, accepted paths hold.
        accepted = frozen | (fnorm <= eps)
        alpha = jnp.ones((B,), x_dtype)
        x_new, Fx_new, fn_new = x, Fx, fnorm
        for _ in range(6):
            x_try = jnp.where(accepted[:, None], x_new,
                              x + alpha[:, None] * dx)
            Fx_try = F_b0(x_try, exog_batch)
            fn_try = _rownorm(Fx_try)
            ok = (~accepted) & jnp.isfinite(fn_try) & (fn_try < fnorm)
            x_new = jnp.where(ok[:, None], x_try, x_new)
            Fx_new = jnp.where(ok[:, None], Fx_try, Fx_new)
            fn_new = jnp.where(ok, fn_try, fn_new)
            accepted = accepted | ok
            if bool(accepted.all()):
                break
            alpha = jnp.where(accepted, alpha, 0.5 * alpha)
        fprev = fn_np
        x, Fx, fnorm = x_new, Fx_new, fn_new
        improved = fnorm < f_best
        x_best = jnp.where(improved[:, None], x, x_best)
        F_best = jnp.where(improved[:, None], Fx, F_best)
        f_best = jnp.where(improved, fnorm, f_best)
        since_improve = jnp.where(fnorm < 0.99 * fprev, 0, since_improve + 1)
        frozen = frozen | (since_improve >= 3)
        iters += 1
        n_conv = int(jnp.sum(fnorm <= eps))
        n_stall = int(jnp.sum(frozen & (fnorm > eps)))
        if verbose:
            print(f"[ensemble/nk] outer {iters}: max|F| = "
                  f"{float(jnp.where(frozen, 0.0, fnorm).max()):.3e}, "
                  f"{n_conv}/{B} converged, {n_stall} stalled "
                  f"(+{mv} matvecs)", flush=True)
        if records is not None:
            records.append({"iteration": iters,
                            "max_residual_norm": float(fnorm.max()),
                            "converged": n_conv,
                            "stalled": n_stall,
                            "matvecs": total_mv})
    better = f_best < fnorm
    x = jnp.where(better[:, None], x_best, x)
    fnorm = jnp.where(better, f_best, fnorm)
    return x, {"iterations": iters, "inner_iterations": total_mv,
               "residual_norm": fnorm,
               "stalled_paths": int(jnp.sum(frozen & (fnorm > eps)))}
