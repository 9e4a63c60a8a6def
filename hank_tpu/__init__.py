"""hank_tpu — sequence-space Newton-Raphson HANK solver in JAX.

A brand-new JAX framework with the capabilities of the Julia reference
(vasudeva-ram/Julia-NewtonRaphsonHANK, Boehl 2024 "HANK on Speed"): YAML model
specs compile to pure traced residual functions; the EGM backward recursion and
the distribution push-forward are `lax.scan`s; steady states, the block-Toeplitz
steady-state sequence-space Jacobian, and matrix-free Newton path solvers all
run on-device under `jit`, with `vmap`/`pjit` batching shock ensembles across a
`jax.sharding.Mesh`.

Double precision is enabled on import (the solver targets 1e-8 pointwise
accuracy; dense factorizations use f32 LU + f64 iterative refinement — see
`hank_tpu.ops.linalg`).
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# On a GPU, f32 matmuls may otherwise run in TF32 (~3 decimal digits); the
# solver's f32 direction sweeps and the f32 J̄⁻¹ preconditioner application
# (`ops/linalg.make_reusable_solver`) need true f32 accuracy.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache: the solver's jitted pipelines (scans +
# while_loops + refinement solves) are expensive to compile. JAX reads
# JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache lives
# at a fixed path inside the checkout (the path is part of the cache key).
REPO_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    try:
        _os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    except OSError:  # pragma: no cover — cache is best-effort
        pass
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from hank_tpu import config  # noqa: E402
from hank_tpu.model.structures import (  # noqa: E402
    CompSpec,
    HeterogeneityDimension,
    SequenceModel,
    SteadyStateSpec,
    Variable,
)
from hank_tpu.model.parser import build_model_from_yaml  # noqa: E402
from hank_tpu.solvers.steady_state import SteadyState, find_ss, get_steady_states  # noqa: E402
from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian  # noqa: E402
from hank_tpu.solvers.newton import (  # noqa: E402
    make_full_residual_fn,
    make_path_solver,
    newton_raphson_hank,
)
from hank_tpu.solvers.linear import irf_table, linear_impulse_response  # noqa: E402
from hank_tpu.run import solve_model  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "CompSpec",
    "HeterogeneityDimension",
    "SequenceModel",
    "SteadyStateSpec",
    "SteadyState",
    "Variable",
    "build_model_from_yaml",
    "config",
    "find_ss",
    "get_steady_states",
    "get_steady_state_jacobian",
    "irf_table",
    "linear_impulse_response",
    "make_full_residual_fn",
    "make_path_solver",
    "newton_raphson_hank",
    "solve_model",
]
