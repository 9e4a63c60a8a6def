"""Force each alternative lowering ON CPU at a saved iterate and print ||F||.

With x = the CPU-solved root (scripts/hank2_cpu_groundtruth.py), every
alternative lowering (HANK_TPU_INTERP/BILINEAR/LOTTERY=hat, dense) should
match the default-lowering residual to ~1e-11: a larger deviation on a
device is then execution-level, not a lowering bug.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/ablate_lowerings_cpu.py <tag>
"""
import os, sys, json
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_enable_x64", True)
from hank_tpu.models import load_model
from hank_tpu.model.structures import generate_exog_paths
from hank_tpu.solvers.newton import make_full_residual_fn
from hank_tpu.utils.checkpoint import get_or_solve

model = load_model("hank_two_asset", T=300)
exog = generate_exog_paths(model, 299)
ss0, ssT, Jbar = get_or_solve(model)
x = jnp.asarray(np.load("/tmp/hank2_xstar.npy"))
F = jax.jit(make_full_residual_fn(model, ss0, ssT, exog))
Fx = np.asarray(F(x))
print(json.dumps({"config": sys.argv[1], "norm": float(np.linalg.norm(Fx)),
                  "max": float(np.abs(Fx).max())}), flush=True)
