"""Checkpoint / resume: cache steady states and the SS Jacobian on disk.

The reference has no checkpointing (SURVEY §5); its natural serialization
unit is the `SteadyState` struct (`SteadyState.jl:21-27`) and the expensive
artifact is the SS sequence-space Jacobian. Here both are cached as .npz
files keyed on a structural hash of the model (parameters, grids, equations,
horizon), so repeated solves of the same model skip straight to the path
solver.
"""

from __future__ import annotations

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np

from hank_tpu.config import config


def cache_root() -> str:
    """Artifact root: `HANK_TPU_CACHE`, else `.hank_cache` in the checkout."""
    return os.environ.get("HANK_TPU_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".hank_cache")


def default_cache_dir() -> str:
    path = os.path.join(cache_root(), "artifacts")
    os.makedirs(path, exist_ok=True)
    return path


def model_hash(model, include_horizon: bool = False) -> str:
    """Structural hash: anything that changes the SS (or, with
    `include_horizon`, the T-dependent J̄) changes the key. The steady state
    does not depend on the transition horizon, so SS artifacts are shared
    across T."""
    h = hashlib.sha256()
    payload = {
        "name": model.name,
        "equations": list(model.equations),
        "params": {k: float(v) for k, v in model.params.items()},
        "eps": model.compspec.eps,
        "vars": [(k, v.var_type) for k, v in model.variables.items()],
        # bounds matter: changing them can move the projected Newton to a
        # different basin (a different steady state); dtype matters: runs at
        # different compute precisions must not share cache entries.
        "ss_initial": [sorted(model.ss_initial.fixed.items()),
                       sorted(model.ss_initial.guesses.items()),
                       sorted(model.ss_initial.bounds.items())],
        "ss_ending": [sorted(model.ss_ending.fixed.items()),
                      sorted(model.ss_ending.guesses.items()),
                      sorted(model.ss_ending.bounds.items())],
        "dtype": str(config.dtype.__name__ if hasattr(config.dtype, "__name__")
                     else config.dtype),
    }
    if include_horizon:
        payload["T"] = model.compspec.T
    h.update(json.dumps(payload, sort_keys=True).encode())
    # The household Bellman step defines the steady state: key on its source
    # so editing a model's function file invalidates cached artifacts.
    try:
        import inspect

        h.update(inspect.getsource(model.value_fn).encode())
    except (OSError, TypeError):  # builtins / dynamically defined fns
        pass
    for name, dim in model.heterogeneity.items():
        h.update(name.encode())
        # f32-canonicalized bytes: a backend whose f64 is not bit-faithful
        # across a device round-trip would hash raw f64 bytes differently
        # and silently miss artifacts solved elsewhere. Any real
        # calibration change still moves the f32 image.
        h.update(np.asarray(dim.grid, np.float64).astype(np.float32).tobytes())
        if dim.transition is not None:
            h.update(np.asarray(dim.transition,
                                np.float64).astype(np.float32).tobytes())
    return h.hexdigest()[:16]


def save_steady_state(ss, model, label: str, cache_dir: str | None = None) -> str:
    path = os.path.join(cache_dir or default_cache_dir(),
                        f"ss_{model_hash(model)}_{label}.npz")
    names = list(model.var_names())
    het = list(model.vars_of_type("heterogeneous"))
    np.savez(
        path,
        var_names=np.array(names),
        var_values=np.array([np.asarray(ss.vars[k]) for k in names]),
        het_names=np.array(het),
        D=np.asarray(ss.D),
        value=np.asarray(ss.value),
        **{f"policy_{k}": np.asarray(ss.policies[k]) for k in het},
    )
    return path


def load_steady_state(model, label: str, cache_dir: str | None = None):
    """Returns the cached SteadyState or None."""
    from hank_tpu.solvers.steady_state import SteadyState

    path = os.path.join(cache_dir or default_cache_dir(),
                        f"ss_{model_hash(model)}_{label}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        names = [str(s) for s in z["var_names"]]
        het = [str(s) for s in z["het_names"]]
        return SteadyState(
            vars={k: jnp.asarray(v) for k, v in zip(names, z["var_values"])},
            policies={k: jnp.asarray(z[f"policy_{k}"]) for k in het},
            D=jnp.asarray(z["D"]),
            value=jnp.asarray(z["value"]),
        )


def save_jacobian(J, model, cache_dir: str | None = None) -> str:
    path = os.path.join(cache_dir or default_cache_dir(),
                        f"jbar_{model_hash(model, include_horizon=True)}.npz")
    np.savez(path, J=np.asarray(J))
    return path


def load_jacobian(model, cache_dir: str | None = None):
    path = os.path.join(cache_dir or default_cache_dir(),
                        f"jbar_{model_hash(model, include_horizon=True)}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return jnp.asarray(z["J"])


def get_or_solve(model, verbose: bool = False, cache: bool = True):
    """Steady states + J̄ with disk caching; the standard model-setup call."""
    from hank_tpu.solvers.steady_state import find_ss
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

    ss0 = load_steady_state(model, "initial") if cache else None
    if ss0 is None:
        ss0 = find_ss(model, model.ss_initial, "initial", verbose)
        if cache:
            save_steady_state(ss0, model, "initial")

    if model.ss_initial == model.ss_ending:
        ssT = ss0
    else:
        ssT = load_steady_state(model, "ending") if cache else None
        if ssT is None:
            ssT = find_ss(model, model.ss_ending, "ending", verbose)
            if cache:
                save_steady_state(ssT, model, "ending")

    J = load_jacobian(model) if cache else None
    if J is None:
        J = get_steady_state_jacobian(ssT, model)
        if cache:
            save_jacobian(J, model)

    return ss0, ssT, J
