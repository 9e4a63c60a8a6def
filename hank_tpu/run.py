"""End-to-end driver: model -> steady states -> J̄ -> transition path.

Capability parity with the reference's driver layer (`RunMain.jl:12-61`,
`solveModel`): build the model, solve both steady states, compute the SS
sequence-space Jacobian, generate the shock path, run the Newton solver, and
report/save the solved transition. Usable as a library call (`solve_model`)
or CLI:

    python -m hank_tpu.run --model krusell_smith --T 300 \
        --method newton_krylov --mixed --out /tmp/path.csv
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _accept_warm_start(x_ss, x_lin, lin_info, verbose):
    """Keep-best guard for `warm_start="linear"`: on a shock large enough
    that the linear step lands infeasible (non-finite residual) or outside
    the region where it helps (no improvement on the first-order forcing
    ‖F(x_ss)‖), start the nonlinear solver from the SS path instead of
    poisoning it with a worse iterate."""
    r_lin = float(lin_info["residual_norm"])
    if np.isfinite(r_lin) and r_lin < float(lin_info["f0_norm"]):
        return x_lin
    if verbose:
        print(f"[warm_start=linear] linear step rejected "
              f"(‖F(x_lin)‖ = {r_lin:.3g} vs forcing "
              f"{float(lin_info['f0_norm']):.3g}) — "
              f"starting from the SS path")
    return x_ss


def solve_model(model, exog_paths=None, *, method: str = "newton_krylov",
                direction_dtype=None, eps: float = 1e-8, verbose: bool = True,
                cache: bool = True, records: list | None = None,
                warm_start: str = "ss",
                **solver_kwargs):
    """Full solve: steady states + J̄ (cached) + transition path.

    warm_start: initial guess for the nonlinear path solvers — "ss" (the
    steady-state path, the reference's choice `NewtonRaphson.jl:88-90`) or
    "linear" (the first-order IRF x_ss − J̄⁻¹F(x_ss), one residual + one
    precomputed-J̄⁻¹ matvec, `solvers/linear.py` — lands O(shock²) from the
    root so Newton skips its opening contractions). Combine with
    `richardson_max_outer=0` (boehl host_inner) for the endgame-only route
    of the two-asset model.

    Extra keyword arguments are forwarded to `make_path_solver` (e.g.
    host_inner, richardson_max_outer, gmres_restart, endgame_gmres_tol).

    Returns (x_path (T-1, n_endog), info, ss_initial, ss_ending).
    The reference's `solveModel(mod, stst, j̅)` equivalent.
    """
    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.utils.checkpoint import get_or_solve
    from hank_tpu.utils.timing import phase

    recs = records if records is not None else []
    with phase("steady states + SS Jacobian", recs, verbose):
        ss0, ssT, Jbar = get_or_solve(model, verbose=verbose, cache=cache)

    Tm1 = model.compspec.T - 1
    if exog_paths is None:
        exog_paths = generate_exog_paths(model, Tm1)

    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), Tm1)

    if method == "linear":
        from hank_tpu.solvers.linear import linear_impulse_response

        with phase("linear impulse response", recs, verbose):
            x, info = linear_impulse_response(Jbar, exog_paths, model,
                                              ss0, ssT)
        info = {"iterations": 1,
                "residual_norm": float(info["residual_norm"]),
                "f0_norm": float(info["f0_norm"])}
    elif method == "dense":
        from hank_tpu.solvers.newton import solve_path_dense

        with phase("path solve (dense)", recs, verbose):
            x, info = solve_path_dense(x0, exog_paths, model, ss0, ssT, eps=eps)
    else:
        if warm_start == "linear":
            from hank_tpu.solvers.linear import linear_impulse_response

            with phase("linear warm start", recs, verbose):
                x_lin, lin_info = linear_impulse_response(
                    Jbar, exog_paths, model, ss0, ssT)
                x0 = _accept_warm_start(x0, x_lin, lin_info, verbose)
        elif warm_start != "ss":
            raise ValueError(f"warm_start must be 'ss' or 'linear', "
                             f"got {warm_start!r}")
        solver = make_path_solver(Jbar, exog_paths, model, ss0, ssT,
                                  method=method, direction_dtype=direction_dtype,
                                  eps=eps, verbose=verbose, records=records,
                                  **solver_kwargs)
        with phase("path solve", recs, verbose):
            x, info = solver(x0)
    x_path = np.asarray(x).reshape(Tm1, len(endog))
    return x_path, info, ss0, ssT


def main(argv=None):
    parser = argparse.ArgumentParser(description="hank_tpu end-to-end solver")
    parser.add_argument("--model", default="krusell_smith",
                        help="shipped model name or path to a YAML spec")
    parser.add_argument("--T", type=int, default=None, help="override horizon")
    parser.add_argument("--method", default="newton_krylov",
                        choices=["newton_krylov", "boehl", "dense", "linear"],
                        help="'linear' = first-order IRF (one preconditioned "
                             "Newton step, solvers/linear.py)")
    parser.add_argument("--mixed", action="store_true",
                        help="f32 direction sweeps (inexact Newton)")
    parser.add_argument("--eps", type=float, default=1e-8)
    parser.add_argument("--warm-start", default="ss", choices=["ss", "linear"],
                        help="nonlinear-solver initial guess: steady-state "
                             "path or the first-order IRF (solvers/linear.py)")
    parser.add_argument("--out", default=None, help="CSV output path")
    parser.add_argument("--plot", default=None, metavar="PNG",
                        help="write a transition-path plot "
                             "(the reference driver's plot step, "
                             "RunMain.jl:57-60)")
    parser.add_argument("--no-cache", action="store_true")
    args = parser.parse_args(argv)

    from hank_tpu.models import SHIPPED, load_model
    from hank_tpu.model.parser import build_model_from_yaml

    if args.model in SHIPPED:
        model = load_model(args.model, **({"T": args.T} if args.T else {}))
    else:
        model = build_model_from_yaml(args.model)
        if args.T:
            import dataclasses
            model = dataclasses.replace(
                model, compspec=dataclasses.replace(model.compspec, T=args.T))

    t0 = time.time()
    x_path, info, ss0, ssT = solve_model(
        model, method=args.method,
        direction_dtype=jnp.float32 if args.mixed else None,
        eps=args.eps, cache=not args.no_cache, warm_start=args.warm_start)
    wall = time.time() - t0

    endog = model.vars_of_type("endogenous")
    summary = {
        "model": model.name or args.model,
        "T": model.compspec.T,
        "method": args.method + ("-mixed" if args.mixed else ""),
        "iterations": int(info["iterations"]),
        "residual_norm": float(info["residual_norm"]),
        "wall_seconds": round(wall, 2),
        "impact": {k: float(x_path[0, i]) for i, k in enumerate(endog)},
        "terminal": {k: float(x_path[-1, i]) for i, k in enumerate(endog)},
    }
    print(json.dumps(summary, indent=2))

    if args.out:
        header = ",".join(("t",) + endog)
        rows = np.column_stack([np.arange(1, x_path.shape[0] + 1), x_path])
        np.savetxt(args.out, rows, delimiter=",", header=header, comments="")
        print(f"path written to {args.out}")

    if args.plot:
        from hank_tpu.utils.plotting import plot_transition

        plot_transition(x_path, endog, args.plot, ss_initial=ss0,
                        ss_ending=ssT, title=summary["model"])
        print(f"plot written to {args.plot}")


if __name__ == "__main__":
    main()
