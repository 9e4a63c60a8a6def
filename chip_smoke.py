#!/usr/bin/env python3
"""On-GPU smoke test of the solver's main path, in one process.

    python chip_smoke.py               # default phases, one GPU
    python chip_smoke.py --two-asset   # two-asset HANK 40x20x5x2, T=300
    python chip_smoke.py --four-cards  # dp-sharded ensemble on 4 GPUs

Default phases: (1) the device; (2) Krusell-Smith 200x7, T=300, cold:
steady states, J̄ and the certified path solve through `solve_model`, then
an independent f64 re-check of the GPU path on the CPU; (3) the same for
one-asset HANK 50x7, T=300; (4) the traced `solve_ensemble` at B=4 against
`solve_ensemble_host`. Each option runs the device phase plus its own.

Any failed check exits non-zero. The last line of standard output is one
JSON object naming the device; the card's name and power limit are printed
on an earlier line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# The independent re-check evaluates on the host CPU: keep the CPU backend
# available next to the GPU when the environment names only the GPU.
if os.environ.get("JAX_PLATFORMS") in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

EPS = 1e-8


def device_check(min_count: int = 1):
    """The process's devices; raises unless they are `min_count`+ GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devs[0].platform!r}")
    if len(devs) < min_count:
        raise RuntimeError(f"{len(devs)} GPU(s), need {min_count}")
    return devs


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def median_time(fn, *args, iters: int = 10) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_device(min_count: int = 1) -> None:
    devs = device_check(min_count)
    import hank_tpu  # noqa: F401  (x64, matmul precision, compile cache)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log("== device")
    log(smi.stdout.strip())
    log(f"  jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    log(f"  matmul precision: {jax.config.jax_default_matmul_precision}")
    log(f"  compile cache: {jax.config.jax_compilation_cache_dir}")


def _cpu_recheck(name: str, T: int, x_path, ss0, ssT, exog) -> float:
    """‖F(x)‖ of the GPU path, evaluated from scratch in f64 on the CPU."""
    import jax.numpy as jnp

    from hank_tpu.models import load_model
    from hank_tpu.solvers.newton import make_full_residual_fn
    from hank_tpu.solvers.steady_state import SteadyState

    def host_ss(ss):
        return SteadyState(
            vars={k: jnp.asarray(np.asarray(v)) for k, v in ss.vars.items()},
            policies={k: jnp.asarray(np.asarray(v))
                      for k, v in ss.policies.items()},
            D=jnp.asarray(np.asarray(ss.D)),
            value=jnp.asarray(np.asarray(ss.value)))

    with jax.default_device(jax.devices("cpu")[0]):
        model = load_model(name, T=T)
        F = make_full_residual_fn(
            model, host_ss(ss0), host_ss(ssT),
            {k: jnp.asarray(np.asarray(v)) for k, v in exog.items()},
            exact=True)
        x = jnp.asarray(np.asarray(x_path).reshape(-1))
        return float(jnp.linalg.norm(jax.jit(F)(x)))


def phase_solve(name: str, T: int = 300) -> dict:
    """Cold steady states + J̄ + certified path solve through solve_model,
    then warm solves and the CPU re-check. Returns the solved state."""
    import jax.numpy as jnp

    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.models import load_model
    from hank_tpu.run import solve_model
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.utils.checkpoint import cache_root, get_or_solve

    log(f"== {name}, T={T}, cold")
    os.makedirs(cache_root(), exist_ok=True)
    art = tempfile.mkdtemp(prefix="chip_smoke_", dir=cache_root())
    old = os.environ.get("HANK_TPU_CACHE")
    os.environ["HANK_TPU_CACHE"] = art          # empty: set-up really runs
    try:
        model = load_model(name, T=T)
        kw = dict(method="newton_krylov", direction_dtype=jnp.float32,
                  eps=EPS)
        recs = []
        x_path, info, ss0, ssT = solve_model(model, verbose=False,
                                             records=recs, **kw)
        secs = {r["phase"]: r["seconds"] for r in recs if "phase" in r}
        _, _, Jbar = get_or_solve(model)        # the artifacts just saved
    finally:
        if old is None:
            os.environ.pop("HANK_TPU_CACHE", None)
        else:
            os.environ["HANK_TPU_CACHE"] = old
        shutil.rmtree(art, ignore_errors=True)
    fnorm = float(info["residual_norm"])
    log(f"  set-up (steady states + J̄): "
        f"{secs['steady states + SS Jacobian']:.3f} s")
    log(f"  first solve (compile + solve): {secs['path solve']:.3f} s")
    log(f"  outer iterations {int(info['iterations'])}, ‖F‖ = {fnorm:.3e}")
    check(fnorm < EPS, f"{name} solver ‖F‖ {fnorm:.3e} < {EPS}")

    exog = generate_exog_paths(model, T - 1)
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), T - 1)
    solver = make_path_solver(Jbar, exog, model, ss0, ssT, **kw)
    warm = median_time(lambda: solver(x0)[0], iters=3)
    log(f"  warm solve: {warm:.3f} s (median of 3)")
    r_cpu = _cpu_recheck(name, T, x_path, ss0, ssT, exog)
    log(f"  CPU f64 re-check ‖F_cpu(x_gpu)‖ = {r_cpu:.3e}")
    check(r_cpu < EPS, f"{name} CPU re-check {r_cpu:.3e} < {EPS}")
    return dict(model=model, ss0=ss0)


def _shock_batch(model, B: int, scale: float = 0.05):
    """B transitory TFP paths Z_t = 1 + scale·ρ_b^t, ρ_b spread over
    [0.5, 0.9) — the ensemble the sharding tests use."""
    import jax.numpy as jnp

    t = jnp.arange(1, model.compspec.T, dtype=jnp.float64)
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
    return {"Z": 1.0 + scale * rhos[:, None] ** t[None, :]}


def _transitory(model, ss0):
    """(J̄, x_ss) about the INITIAL steady state: the ensembles' shocks are
    transitory, so each path starts and ends there."""
    import jax.numpy as jnp

    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss0.vars[k] for k in endog]),
                  model.compspec.T - 1)
    return jax.block_until_ready(get_steady_state_jacobian(ss0, model)), x0


def phase_ensemble(ks: dict, B: int = 4) -> None:
    """Traced solve_ensemble (nested while_loops under vmap) against the
    host-driven ensemble solver on the same batch."""
    import jax.numpy as jnp

    from hank_tpu.parallel.ensemble import solve_ensemble, solve_ensemble_host

    log(f"== traced solve_ensemble vs solve_ensemble_host (KS, B={B})")
    model, ss0 = ks["model"], ks["ss0"]
    Jbar, x0 = _transitory(model, ss0)
    ex_b = _shock_batch(model, B)
    kw = dict(method="newton_krylov", eps=EPS)
    t0 = time.perf_counter()
    x_t, info_t = solve_ensemble(x0, Jbar, ex_b, model, ss0, ss0,
                                 direction_dtype=jnp.float32, **kw)
    x_t = jax.block_until_ready(x_t)
    t_traced = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_h, info_h = solve_ensemble_host(x0, Jbar, ex_b, model, ss0, ss0, **kw)
    x_h = jax.block_until_ready(x_h)
    t_host = time.perf_counter() - t0
    log(f"  traced {t_traced:.3f} s, host {t_host:.3f} s (compile included)")
    worst = max(float(jnp.max(info_t["residual_norm"])),
                float(jnp.max(info_h["residual_norm"])))
    check(worst < EPS, f"every path ‖F‖ < {EPS} (worst {worst:.3e})")
    dx = float(jnp.max(jnp.abs(x_t - x_h)))
    check(dx < 1e-7, f"traced vs host max|Δx| {dx:.3e} < 1e-7")


def phase_two_asset(T: int = 300) -> None:
    """Two-asset HANK, cold set-up on the card, then the benchmark's route:
    linear-IRF warm start + endgame-only boehl, falling back to the
    two-phase boehl from the steady-state path."""
    import jax.numpy as jnp

    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.models import load_model
    from hank_tpu.solvers.linear import linear_impulse_response
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.utils.checkpoint import get_or_solve

    log(f"== hank_two_asset 40x20x5x2, T={T}, cold")
    model = load_model("hank_two_asset", T=T)
    t0 = time.perf_counter()
    ss0, ssT, Jbar = get_or_solve(model, cache=False)
    jax.block_until_ready(Jbar)
    log(f"  set-up (steady states + J̄): {time.perf_counter() - t0:.3f} s")
    exog = generate_exog_paths(model, T - 1)
    endog = model.vars_of_type("endogenous")
    x_ss = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), T - 1)
    x_lin, li = linear_impulse_response(Jbar, exog, model, ss0, ssT)
    lin_ok = (np.isfinite(float(li["residual_norm"]))
              and float(li["residual_norm"]) < float(li["f0_norm"]))
    log(f"  linear IRF ‖F(x_lin)‖ = {float(li['residual_norm']):.3e} vs "
        f"‖F(x_ss)‖ = {float(li['f0_norm']):.3e}"
        + ("" if lin_ok else " (rejected: start from the SS path)"))
    routes = ([("linstart_endgame_only", 0, x_lin)] if lin_ok else []) + [
        ("ss_two_phase", None, x_ss)]
    for route, rich_cap, x_start in routes:
        solver = make_path_solver(Jbar, exog, model, ss0, ssT, method="boehl",
                                  direction_dtype=jnp.float32, eps=EPS,
                                  host_inner=True,
                                  richardson_max_outer=rich_cap)
        t0 = time.perf_counter()
        x, info = solver(x_start)
        first = time.perf_counter() - t0
        fnorm = float(info["residual_norm"])
        log(f"  route {route}: first solve (compile + solve) {first:.3f} s, "
            f"outer iterations {int(info['iterations'])}, ‖F‖ = {fnorm:.3e}")
        if fnorm < EPS:
            break
    check(fnorm < EPS, f"two-asset ‖F‖ {fnorm:.3e} < {EPS}")
    warm = median_time(lambda: solver(x_start)[0], iters=3)
    log(f"  warm solve ({route}): {warm:.3f} s (median of 3)")
    r_cpu = _cpu_recheck("hank_two_asset", T, x, ss0, ssT, exog)
    log(f"  CPU f64 re-check ‖F_cpu(x_gpu)‖ = {r_cpu:.3e}")
    check(r_cpu < EPS, f"two-asset CPU re-check {r_cpu:.3e} < {EPS}")


def phase_four_cards(B: int = 32, T: int = 300) -> None:
    """dp-sharded host ensemble on a 4-card mesh against one card."""
    import jax.numpy as jnp

    from hank_tpu.models import load_model
    from hank_tpu.parallel.ensemble import solve_ensemble_host
    from hank_tpu.parallel.mesh import make_mesh
    from hank_tpu.solvers.steady_state import find_ss

    log(f"== KS 200x7 T={T}, B={B}: 4-card dp mesh vs one card")
    model = load_model("krusell_smith", T=T)
    t0 = time.perf_counter()
    ss0 = find_ss(model, model.ss_initial, "initial")
    Jbar, x0 = _transitory(model, ss0)
    log(f"  set-up (steady state + J̄): {time.perf_counter() - t0:.3f} s")
    ex_b = _shock_batch(model, B)
    out = {}
    for label, mesh in (("4 cards", make_mesh(4)), ("1 card", None)):
        for run in ("first", "warm"):
            t0 = time.perf_counter()
            x, info = solve_ensemble_host(x0, Jbar, ex_b, model, ss0, ss0,
                                          mesh=mesh, method="newton_krylov",
                                          eps=EPS)
            x = jax.block_until_ready(x)
            log(f"  {label}, {run} call: {time.perf_counter() - t0:.3f} s")
        worst = float(jnp.max(info["residual_norm"]))
        check(worst < EPS, f"{label}: every path ‖F‖ < {EPS} "
              f"(worst {worst:.3e})")
        out[label] = np.asarray(x)
    dx = float(np.max(np.abs(out["4 cards"] - out["1 card"])))
    check(dx < 1e-9, f"sharded vs single-card max|Δx| {dx:.3e} < 1e-9")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--two-asset", action="store_true",
                       help="two-asset HANK 40x20x5x2 at T=300 only")
    group.add_argument("--four-cards", action="store_true",
                       help="dp-sharded ensemble on 4 cards only")
    args = ap.parse_args(argv)

    phase_device(4 if args.four_cards else 1)
    if args.two_asset:
        phase_two_asset()
    elif args.four_cards:
        phase_four_cards()
    else:
        ks = phase_solve("krusell_smith")
        phase_solve("hank_one_asset")
        phase_ensemble(ks)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
