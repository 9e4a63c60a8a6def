"""Core model data structures.

Capability parity with the reference's L2 layer (`GeneralStructures.jl:24-226`):
`HeterogeneityDimension`, `SteadyStateSpec`, `Variable`, `ComputationalSpec`,
`SequenceModel`, plus accessors `var_names` / `vars_of_type` / `n_total`.

Design differences (accelerator-first, not a port):

- Grids and transition matrices are `jnp` arrays so they become on-device
  constants inside traced functions.
- The model object is *static* with respect to JAX tracing: solver entry
  points close over it and `jit` the resulting pure array functions. This is
  the JAX analogue of the reference's fully-concrete 7-type-parameter struct.
- Multiple endogenous heterogeneity dimensions are a first-class part of the
  layout (`state_shape`, `endog_dims`, `exog_dims`) — the reference restricts
  to exactly one (`ForwardIteration.jl:267-269`) which blocks two-asset HANK.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class HeterogeneityDimension:
    """One dimension of household heterogeneity (wealth, productivity, ...).

    dim_type: "endogenous" (chosen by the household; has a `policy_var`
        linking it to the aggregated heterogeneous variable) or "exogenous"
        (has an (n, n) row-stochastic `transition` matrix).
    Reference: `GeneralStructures.jl:43-49`.
    """

    name: str
    dim_type: str                     # "endogenous" | "exogenous"
    n: int
    grid: jnp.ndarray                 # (n,)
    transition: jnp.ndarray | None    # (n, n) row-stochastic, exogenous only
    policy_var: str | None            # endogenous only

    def __post_init__(self):
        if self.dim_type not in ("endogenous", "exogenous"):
            raise ValueError(
                f"dimension '{self.name}': dim_type must be 'endogenous' or "
                f"'exogenous', got '{self.dim_type}'")
        if self.dim_type == "exogenous" and self.transition is None:
            raise ValueError(
                f"exogenous dimension '{self.name}' requires a transition matrix")
        if self.dim_type == "endogenous" and self.policy_var is None:
            raise ValueError(
                f"endogenous dimension '{self.name}' requires a policy_var")


@dataclasses.dataclass(frozen=True)
class SteadyStateSpec:
    """Pinned values + Newton starting guesses for one steady state.

    Reference: `GeneralStructures.jl:73-76`. `bounds` (not in the reference)
    optionally boxes each free variable: the SS Newton projects every iterate
    into the box, keeping the search out of spurious basins (e.g. r → −1, or
    r above 1/β − 1 where household wealth explodes to the grid edge and the
    aggregate response is flat).
    """

    fixed: Mapping[str, float]
    guesses: Mapping[str, float]
    bounds: Mapping[str, tuple[float, float]] = dataclasses.field(default_factory=dict)

    def __eq__(self, other):
        if not isinstance(other, SteadyStateSpec):
            return NotImplemented
        return (dict(self.fixed) == dict(other.fixed)
                and dict(self.guesses) == dict(other.guesses)
                and dict(self.bounds) == dict(other.bounds))


@dataclasses.dataclass(frozen=True)
class Variable:
    """Aggregate-variable metadata (`GeneralStructures.jl:106-120`).

    var_type: "endogenous" (Newton search variable), "exogenous" (pinned at SS,
    path from `seq_fn(T) -> (T,) array`), or "heterogeneous" (aggregated from
    the household distribution).
    """

    name: str
    var_type: str
    description: str = ""
    seq_fn: Callable[..., jnp.ndarray] | None = None


@dataclasses.dataclass(frozen=True)
class CompSpec:
    """Computational parameters (`GeneralStructures.jl:166-174`).

    T: transition horizon; the path solver searches the T-1 interior periods.
    max_lag / max_lead: boundary padding depths detected from the equations.
    """

    T: int
    eps: float
    dx: float
    n_v: int
    n_endog: int
    max_lag: int
    max_lead: int

    @property
    def T_pad(self) -> int:
        return (self.T - 1) + self.max_lag + self.max_lead


@dataclasses.dataclass(frozen=True)
class SequenceModel:
    """Complete model specification (`GeneralStructures.jl:216-226`).

    variables: ordered mapping name -> Variable. The ordering defines the row
        ordering of xMat everywhere (endogenous, heterogeneous, exogenous —
        matching the reference's construction order, `ModelParser.jl:357`).
    equations: equilibrium equation strings ("LHS = RHS" with VAR(-k)/VAR(+k)
        lag/lead notation).
    residuals_fn: compiled `(xMat (n_v, T_pad), params) -> (n_eq*(T-1),)`
        pure-jnp function from `model.parser.compile_residuals`.
    heterogeneity: ordered mapping name -> HeterogeneityDimension. Endogenous
        dimensions are the *leading* (slow in C-order... see below) axes of
        policy/distribution arrays; exogenous dimensions follow.
    value_fn: household Bellman-step `F: (value_next, xvals, model) -> dict`
        with a "Value" key plus one key per heterogeneous variable
        (`BackwardIteration.jl:95-107` contract).

    State-array convention: policies and distributions are stored as arrays of
    shape `state_shape = (*endog_dims.n, *exog_dims.n)`. For KS this is
    (n_a, n_e) with wealth as axis 0 — equivalent to the reference's
    "wealth fastest" vectorised ordering (`ForwardIteration.jl:8-10`) under
    Fortran-order flattening of (n_a, n_e).
    """

    variables: Mapping[str, Variable]
    equations: Sequence[str]
    compspec: CompSpec
    params: Mapping[str, float]
    residuals_fn: Callable[[jnp.ndarray, Mapping[str, float]], jnp.ndarray]
    ss_initial: SteadyStateSpec
    ss_ending: SteadyStateSpec
    heterogeneity: Mapping[str, HeterogeneityDimension]
    value_fn: Callable[..., Mapping[str, jnp.ndarray]]
    name: str = ""

    # ── Accessors (`GeneralStructures.jl:129-139`) ───────────────────────────
    def var_names(self) -> tuple[str, ...]:
        return tuple(self.variables.keys())

    def vars_of_type(self, t: str) -> tuple[str, ...]:
        return tuple(k for k, v in self.variables.items() if v.var_type == t)

    def var_index(self, name: str) -> int:
        return self.var_names().index(name)

    # ── Heterogeneity layout ────────────────────────────────────────────────
    def endog_dims(self) -> tuple[HeterogeneityDimension, ...]:
        return tuple(d for d in self.heterogeneity.values()
                     if d.dim_type == "endogenous")

    def exog_dims(self) -> tuple[HeterogeneityDimension, ...]:
        return tuple(d for d in self.heterogeneity.values()
                     if d.dim_type == "exogenous")

    def state_shape(self) -> tuple[int, ...]:
        return tuple(d.n for d in self.endog_dims()) + tuple(
            d.n for d in self.exog_dims())

    def n_total(self) -> int:
        """Total household states (`GeneralStructures.jl:59`)."""
        n = 1
        for d in self.heterogeneity.values():
            n *= d.n
        return n


def generate_exog_paths(model: SequenceModel, T: int, **kwargs: Any) -> dict[str, jnp.ndarray]:
    """Call each exogenous variable's `seq_fn(T)` (`GeneralStructures.jl:279-289`).

    Extra kwargs (e.g. a PRNG key / shock scale) are forwarded to every seq_fn,
    making shocks explicit and seedable (the reference's `exogenousZ` uses
    global `randn()` — `KrusellSmith.jl:14-20` — which we deliberately avoid).
    """
    paths = {}
    for name in model.vars_of_type("exogenous"):
        var = model.variables[name]
        if var.seq_fn is None:
            raise ValueError(
                f"Exogenous variable '{name}' has no seq_fn. "
                "Specify a seq_function in the YAML.")
        paths[name] = jnp.asarray(var.seq_fn(T, **kwargs))
    return paths
