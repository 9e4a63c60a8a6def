"""Precision utilities: dtype-cast views of models and steady states.

f64 arithmetic costs at least twice the f32 rate and bytes on an
accelerator, and the sequential scans are launch-bound either way. The
solver therefore runs
**inexact Newton**: search directions come from an f32 copy of the pipeline
(fast), while residuals and the solution itself stay f64 (accurate) — the
standard mixed-precision Newton scheme, converging to full f64 accuracy with
only a mild rate penalty from the ~1e-7-relative direction error.

`cast_model` / `cast_ss` build the f32 views (jnp type promotion would
silently upcast any op touching an f64 constant, so every on-device constant
must be cast).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import jax.numpy as jnp


def cast_model(model, dtype):
    """Model copy with all on-device constants (grids, transitions) in `dtype`."""
    het = {}
    for name, dim in model.heterogeneity.items():
        het[name] = dataclasses.replace(
            dim,
            grid=dim.grid.astype(dtype),
            transition=None if dim.transition is None else dim.transition.astype(dtype))
    return dataclasses.replace(model, heterogeneity=het)


def cast_ss(ss, dtype):
    """SteadyState copy with arrays in `dtype`."""
    return dataclasses.replace(
        ss,
        vars={k: jnp.asarray(v, dtype=dtype) for k, v in ss.vars.items()},
        policies={k: v.astype(dtype) for k, v in ss.policies.items()},
        D=ss.D.astype(dtype),
        value=ss.value.astype(dtype))


def cast_paths(paths: Mapping[str, jnp.ndarray], dtype) -> dict[str, jnp.ndarray]:
    return {k: jnp.asarray(v, dtype=dtype) for k, v in paths.items()}


def one_minus(x):
    """1 − x for traced f64 SCALARS — emulated-f64 erratum workaround.

    On a backend that emulates f64, a jitted `literal − traced_scalar`
    subtract can lower through an f32 constant path and round at ~2e-8
    RELATIVE, while `literal + (−x)`, `x − literal`, `x − y`, and all
    array-shaped subtracts stay exact to ~1e-15. In the two-asset model
    the per-period income scalar (1 − tau)·w then deviates one-sidedly per
    Bellman step, compounding over the T-long backward recursion into a
    ~6e-6 residual floor. Use this for any literal-minus-traced-scalar in
    per-period price arithmetic. Semantically identical to `1.0 - x`
    everywhere.
    """
    return 1.0 + (-x)
