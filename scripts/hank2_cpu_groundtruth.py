"""Solve the full-size two-asset T=300 path to true f64 convergence on CPU
(newton_krylov, native-f64 AD operator) and save x* — the cross-backend
ground truth for a device endgame diagnosis:

- ||F_device(x*)||: is the device residual faithful at the true root?
- |x_floor - x*|: is the device's f32-phase floor in the root's basin?

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/hank2_cpu_groundtruth.py
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from hank_tpu.models import load_model
from hank_tpu.model.structures import generate_exog_paths
from hank_tpu.solvers.newton import make_path_solver
from hank_tpu.utils.checkpoint import get_or_solve

model = load_model("hank_two_asset", T=300)
exog = generate_exog_paths(model, 299)
ss0, ssT, Jbar = get_or_solve(model)
Tm1 = model.compspec.T - 1
endog = model.vars_of_type("endogenous")
x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), Tm1)
solver = make_path_solver(Jbar, exog, model, ss0, ssT,
                          method="newton_krylov",
                          direction_dtype=jnp.float32, eps=1e-10,
                          verbose=True)
t0 = time.perf_counter()
x, info = solver(x0)
jax.block_until_ready(x)
np.save("/tmp/hank2_xstar.npy", np.asarray(x))
out = {"solve_seconds": round(time.perf_counter() - t0, 1),
       "residual": float(info["residual_norm"]),
       "outer_iters": int(info["iterations"])}
try:
    xf = np.load("/tmp/hank2_final_x.npy")
    out["dist_floor_to_xstar"] = float(np.max(np.abs(xf - np.asarray(x))))
except FileNotFoundError:
    pass
print(json.dumps(out), flush=True)
