"""Measure the BASELINE configs end-to-end (SURVEY §6 / BASELINE.json:6-12).

For each config: load the model, get-or-solve SS + J̄ (cached artifacts),
build the mixed-precision path solver, then time the WARM full solve to
‖F‖ < 1e-8. Prints one row per config; run on CPU for the comparator column
and on the GPU for the device column.

CPU:  JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/measure_configs.py [names...]
GPU:  PYTHONPATH=. python scripts/measure_configs.py [names...]
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp


def build(name):
    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.models import load_model

    if name == "ks_T200":
        model = load_model("krusell_smith", T=200)
        from hank_tpu.models.krusell_smith import exogenousZ
        exog = {"Z": exogenousZ(199, rho=0.8, z_start=1.0, z_end=2.0)}
    elif name == "ks_T300":
        model = load_model("krusell_smith", T=300)
        from hank_tpu.models.krusell_smith import exogenousZ
        exog = {"Z": exogenousZ(299, rho=0.8, z_start=1.0, z_end=2.0)}
    elif name == "hank1_T300":
        model = load_model("hank_one_asset", T=300)
        exog = generate_exog_paths(model, 299)
    elif name == "hank2_T300":
        model = load_model("hank_two_asset", T=300)
        exog = generate_exog_paths(model, 299)
    elif name == "kslg_T150":
        model = load_model("ks_large_grid", T=150)
        exog = generate_exog_paths(model, 149)
    else:
        raise SystemExit(f"unknown config {name}")
    return model, exog


def measure(name):
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.utils.checkpoint import get_or_solve

    model, exog = build(name)
    t0 = time.perf_counter()
    ss0, ssT, Jbar = get_or_solve(model)
    setup_s = time.perf_counter() - t0

    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), Tm1)
    solver = make_path_solver(Jbar, exog, model, ss0, ssT,
                              method="newton_krylov",
                              direction_dtype=jnp.float32, eps=1e-8)
    x, info = solver(x0)                      # compile + warm
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    x, info = solver(x0)
    jax.block_until_ready(x)
    solve_s = time.perf_counter() - t0
    row = {
        "config": name,
        "backend": jax.default_backend(),
        "solve_seconds": round(solve_s, 3),
        "residual": float(info["residual_norm"]),
        "outer_iters": int(info["iterations"]),
        "setup_seconds": round(setup_s, 1),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    names = sys.argv[1:] or ["ks_T200", "hank1_T300", "kslg_T150", "hank2_T300"]
    for n in names:
        try:
            measure(n)
        except Exception as e:  # keep going; report the failure
            print(json.dumps({"config": n, "error": repr(e)[:200]}), flush=True)
