"""Two-asset T=300 via pure boehl host_inner (no newton_krylov stall phase).

The newton_krylov trajectory can stall in a curved valley at
‖F‖ ≈ 7.4e-4 and hand off to this same boehl configuration (the
stall-rescue); running boehl host_inner from the start skips the doomed
NK phase entirely. host_inner keeps every compiled program small (the
traced boehl outer_step at this model size is a very large program).
CPU-verified on the small two-asset model: 4 outers / 84 inner sweeps to
‖F‖ = 2.3e-10.

    PYTHONPATH=. python scripts/measure_two_asset_boehl.py
"""
import json
import sys
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
records = []
solver = make_path_solver(Jbar, exog, model, ss0, ssT, method="boehl",
                          direction_dtype=jnp.float32, eps=1e-8,
                          host_inner=True, records=records, verbose=True)
t0 = time.perf_counter()
x, info = solver(x0)
jax.block_until_ready(x)
t1 = time.perf_counter()
records.clear()
x, info = solver(x0)
jax.block_until_ready(x)
np.save("/tmp/hank2_final_x.npy", np.asarray(x))   # for cross-backend checks
print(json.dumps({"config": "hank2_T300_boehl_host_inner",
                  "cold_seconds": round(t1 - t0, 1),
                  "solve_seconds": round(time.perf_counter() - t1, 3),
                  "residual": float(info["residual_norm"]),
                  "outer_iters": int(info["iterations"]),
                  "inner": int(info["inner_iterations"]),
                  "prof": info.get("prof"),
                  "records": records}), flush=True)
