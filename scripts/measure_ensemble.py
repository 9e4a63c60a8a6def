"""BASELINE config 5: batched shock-path ensembles (vmap over paths).

Measures the production mixed-precision primitive — batched f32 JVP sweeps
of the full equilibrium map over B distinct shock paths — at several batch
sizes, plus a full batched Boehl ensemble solve at a moderate B. Throughput
should grow ~linearly until the device saturates.

    PYTHONPATH=. python scripts/measure_ensemble.py
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from hank_tpu.models import load_model
from hank_tpu.ops.precision import cast_model, cast_ss
from hank_tpu.solvers.newton import make_full_residual_fn
from hank_tpu.utils.checkpoint import get_or_solve

f32 = jnp.float32


def med(fn, *a, n=3):
    jax.block_until_ready(fn(*a))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(lottery_mode=None, do_solve=True):
    if lottery_mode:
        import os
        os.environ["HANK_TPU_LOTTERY"] = lottery_mode
    T = 300
    Tm1 = T - 1
    model = load_model("krusell_smith", T=T)
    ss0, ssT, Jbar = get_or_solve(model)
    endog = model.vars_of_type("endogenous")
    x32 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]),
                   Tm1).astype(f32)
    v32 = jnp.full_like(x32, 1e-3)
    model32 = cast_model(model, f32)
    ss0_32, ssT_32 = cast_ss(ss0, f32), cast_ss(ssT, f32)
    t = jnp.arange(1, T, dtype=f32)

    def sweep_one(x, v, ex):
        F = make_full_residual_fn(model32, ss0_32, ssT_32, ex)
        return jax.jvp(F, (x,), (v,))[1]

    batched = jax.jit(jax.vmap(sweep_one, in_axes=(None, None, 0)))
    base = 1.0 / med(jax.jit(
        lambda x, v: sweep_one(x, v, {"Z": 1.0 + 0.1 * 0.8 ** t})), x32, v32)
    out = {"single_f32_sweeps_per_sec": round(base, 2)}
    if lottery_mode:
        out["lottery_mode"] = lottery_mode
    for B in (64, 256, 1024):
        rhos = 0.5 + 0.4 * jnp.arange(B, dtype=f32) / B
        exog_b = {"Z": 1.0 + 0.1 * rhos[:, None] ** t[None, :]}
        bt = med(batched, x32, v32, exog_b)
        out[f"ensemble_B{B}_sweeps_per_sec"] = round(B / bt, 2)
        out[f"ensemble_B{B}_speedup_vs_single"] = round(B / bt / base, 2)
    print(json.dumps(out), flush=True)

    # Phase split at B=256: backward (EGM interp gathers) vs forward
    # (lottery contraction) vs residual tail, all vmapped — tells WHICH
    # batched scan the next optimization round should target.
    from hank_tpu.blocks.backward import backward_iteration
    from hank_tpu.blocks.forward import forward_iteration

    B = 256
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=f32) / B
    exog_b = {"Z": 1.0 + 0.1 * rhos[:, None] ** t[None, :]}

    def back_one(x, ex):
        return backward_iteration(x, ex, model32, ssT_32.vars, ssT_32.value)

    bck = jax.jit(jax.vmap(back_one, in_axes=(None, 0)))
    tb = med(bck, x32, exog_b)
    pols = bck(x32, exog_b)
    fwd = jax.jit(jax.vmap(lambda p: forward_iteration(p, model32, ss0_32.D)))
    tf = med(fwd, pols)
    print(json.dumps({"phase_split_B": B,
                      "backward_batched_s": round(tb, 3),
                      "forward_batched_s": round(tf, 3)}), flush=True)

    if do_solve:
        # A real batched solve on the device — the host-driven batched
        # Boehl (the production ensemble path).
        from hank_tpu.parallel.ensemble import solve_ensemble_host

        for B in (64, 256):
            rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
            t64 = jnp.arange(1, T, dtype=jnp.float64)
            exog_b = {"Z": 2.0 + (1.0 - 2.0) * rhos[:, None] ** t64[None, :]}
            endog = model.vars_of_type("endogenous")
            x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), Tm1)
            F0 = make_full_residual_fn(model, ss0, ssT,
                                       {k: v[0] for k, v in exog_b.items()})

            def run():
                return solve_ensemble_host(x0, Jbar, exog_b, model, ss0, ssT,
                                           eps=1e-8, direction_dtype=f32)

            xs, info = run()
            jax.block_until_ready(xs)
            t0 = time.perf_counter()
            xs, info = run()
            jax.block_until_ready(xs)
            solve_s = time.perf_counter() - t0
            resid0 = float(jnp.linalg.norm(F0(xs[0])))
            out2 = {
                "batched_solve_B": B,
                "batched_solve_seconds": round(solve_s, 2),
                "batched_solve_paths_per_sec": round(B / solve_s, 2),
                "batched_solve_max_residual":
                    float(jnp.max(info["residual_norm"])),
                "batched_solve_path0_f64_residual": resid0,
                "batched_solve_outer": int(info["iterations"]),
                "batched_solve_inner": int(info["inner_iterations"]),
            }
            print(json.dumps(out2), flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--lottery", default=None,
                    help="override lottery lowering (hat|dense|scatter)")
    ap.add_argument("--no-solve", action="store_true")
    a = ap.parse_args()
    main(lottery_mode=a.lottery, do_solve=not a.no_solve)
