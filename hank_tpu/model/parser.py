"""YAML model specification -> SequenceModel, with equation compilation.

Capability parity with the reference's model compiler (`ModelParser.jl`):

- `compile_residuals` turns equation strings like ``"Y = Z * KS(-1)^α"`` into
  a single pure function ``(xMat, params) -> residual vector`` operating on the
  padded ``(n_v, T_pad)`` variable matrix (`ModelParser.jl:217-259`).
- `detect_max_lag_lead` walks the equation ASTs for the deepest VAR(-k)/VAR(+k)
  notation (`ModelParser.jl:137-172`).
- `build_model_from_yaml` is the main entry (`ModelParser.jl:296-379`).

Accelerator-first design: instead of Julia AST -> `eval`, equations are parsed with
Python's `ast`, rewritten into jnp row-slice expressions, and compiled once at
model-build time into an ordinary Python function that JAX traces. All
arithmetic is elementwise over the time axis natively (no broadcast-operator
rewriting needed). The compiled function is jit/vmap/grad-compatible.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import sys
from typing import Callable, Iterable, Mapping, Sequence

import jax.numpy as jnp
import numpy as np

from hank_tpu.blocks.assemble import shift_lag, shift_lead
from hank_tpu.config import config
from hank_tpu.model import grids as _grids
from hank_tpu.model import yaml_subset
from hank_tpu.model.structures import (
    CompSpec,
    HeterogeneityDimension,
    SequenceModel,
    SteadyStateSpec,
    Variable,
)

# Math functions permitted inside equations, mapped onto jnp.
_EQ_FUNCS = {
    "log": jnp.log,
    "exp": jnp.exp,
    "sqrt": jnp.sqrt,
    "abs": jnp.abs,
    "min": jnp.minimum,
    "max": jnp.maximum,
    "tanh": jnp.tanh,
}

# Greek-letter aliases so YAML files may use unicode or ascii names
# interchangeably for grid-function kwargs.
_GREEK_ASCII = {"ρ": "rho", "σ": "sigma", "α": "alpha", "β": "beta",
                "γ": "gamma", "δ": "delta", "ε": "eps", "μ": "mu"}


def _normalize_equation(eq: str) -> str:
    """DSL -> Python: `^` is exponentiation in the model DSL."""
    return eq.replace("^", "**")


def _const_int(node: ast.AST) -> int | None:
    """Extract a literal (possibly signed) integer from an AST node."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand, ast.Constant) \
            and isinstance(node.operand.value, int):
        if isinstance(node.op, ast.USub):
            return -node.operand.value
        if isinstance(node.op, ast.UAdd):
            return node.operand.value
    return None


class _EquationTransformer(ast.NodeTransformer):
    """Rewrite variable/parameter references for vectorized evaluation.

    - `KS`        -> `xMat[i]`            (row slice over time)
    - `KS(-1)`    -> `shift_lag(xMat[i], 1)`
    - `C(+1)`     -> `shift_lead(xMat[i], 1)`
    - `α`         -> `params['α']`
    - `log(...)`  -> `_fn_log(...)` (bound to jnp.log)

    Reference semantics: `ModelParser.jl:54-119`.
    """

    def __init__(self, var_indices: Mapping[str, int], param_names: Iterable[str]):
        self.var_indices = dict(var_indices)
        self.param_names = set(param_names)

    def _row(self, name: str) -> ast.expr:
        idx = self.var_indices[name]
        return ast.parse(f"xMat[{idx}]", mode="eval").body

    def visit_Name(self, node: ast.Name) -> ast.expr:
        if node.id in self.var_indices:
            return self._row(node.id)
        if node.id in self.param_names:
            return ast.parse(f"params[{node.id!r}]", mode="eval").body
        if node.id in _EQ_FUNCS:
            return ast.Name(id=f"_fn_{node.id}", ctx=ast.Load())
        raise ValueError(
            f"Unknown symbol '{node.id}' in equation: not a variable, "
            f"parameter, or supported function ({sorted(_EQ_FUNCS)}).")

    def visit_Call(self, node: ast.Call) -> ast.expr:
        func = node.func
        if isinstance(func, ast.Name) and func.id in self.var_indices \
                and len(node.args) == 1 and not node.keywords:
            k = _const_int(node.args[0])
            if k is not None:
                if k < 0:
                    inner = ast.unparse(self._row(func.id))
                    return ast.parse(f"shift_lag({inner}, {-k})", mode="eval").body
                if k > 0:
                    inner = ast.unparse(self._row(func.id))
                    return ast.parse(f"shift_lead({inner}, {k})", mode="eval").body
                return self._row(func.id)
        return self.generic_visit(node)


def detect_max_lag_lead(equations: Sequence[str], var_names: Iterable[str]) -> tuple[int, int]:
    """Deepest lag and lead across all equations (`ModelParser.jl:137-172`)."""
    var_set = set(var_names)
    max_lag = 0
    max_lead = 0
    for eq in equations:
        parts = eq.split("=", 1)
        if len(parts) != 2:
            continue
        for part in parts:
            tree = ast.parse(_normalize_equation(part.strip()), mode="eval")
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                        and node.func.id in var_set and len(node.args) == 1:
                    k = _const_int(node.args[0])
                    if k is not None:
                        if k < 0:
                            max_lag = max(max_lag, -k)
                        elif k > 0:
                            max_lead = max(max_lead, k)
    return max_lag, max_lead


def compile_residuals(
    equations: Sequence[str],
    var_names: Sequence[str],
    param_names: Iterable[str],
) -> Callable[[jnp.ndarray, Mapping[str, float]], jnp.ndarray]:
    """Compile equation strings into one pure residual function.

    The compiled function expects a padded ``(n_v, T_pad)`` matrix with
    `max_lag` initial-SS boundary columns prepended and `max_lead` ending-SS
    columns appended; residuals are evaluated over all columns and sliced to
    the valid middle range, returning ``n_eq * (T_pad - max_lag - max_lead)``
    values ordered all-equations-at-t1, then t2, ... — identical layout to the
    reference (`ModelParser.jl:188-216`).
    """
    var_indices = {name: i for i, name in enumerate(var_names)}
    max_lag, max_lead = detect_max_lag_lead(equations, var_names)
    transformer = _EquationTransformer(var_indices, param_names)

    lines = ["def _residuals_fn(xMat, params):"]
    res_names = []
    for i, eq in enumerate(equations):
        parts = eq.split("=", 1)
        if len(parts) != 2:
            raise ValueError(f"Equation must contain exactly one '=': {eq}")
        lhs = ast.parse(_normalize_equation(parts[0].strip()), mode="eval")
        rhs = ast.parse(_normalize_equation(parts[1].strip()), mode="eval")
        lhs_t = ast.unparse(ast.fix_missing_locations(transformer.visit(lhs)).body)
        rhs_t = ast.unparse(ast.fix_missing_locations(transformer.visit(rhs)).body)
        rn = f"_r_{i}"
        res_names.append(rn)
        lines.append(f"    {rn} = ({lhs_t}) - ({rhs_t})")
    lines.append(f"    R = jnp.stack([{', '.join(res_names)}])")
    hi = f"R.shape[1] - {max_lead}" if max_lead else "R.shape[1]"
    lines.append(f"    R = R[:, {max_lag}:{hi}]")
    lines.append("    return R.T.reshape(-1)")
    src = "\n".join(lines)

    namespace: dict = {
        "jnp": jnp,
        "shift_lag": shift_lag,
        "shift_lead": shift_lead,
        **{f"_fn_{k}": v for k, v in _EQ_FUNCS.items()},
    }
    code = compile(src, filename=f"<hank_tpu residuals: {len(equations)} eqs>", mode="exec")
    exec(code, namespace)  # noqa: S102 — model-build-time codegen, sources are model YAML
    fn = namespace["_residuals_fn"]
    fn.__source__ = src  # for debugging / inspection
    return fn


# ─────────────────────────────────────────────────────────────────────────────
# YAML model construction
# ─────────────────────────────────────────────────────────────────────────────

def _load_function_module(path: str):
    """Import the model's Python function file (`ModelParser.jl:300-302`)."""
    mod_name = "hank_tpu_model_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"Cannot import model function file: {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def _lookup_fn(module, name: str):
    """Function lookup with descriptive errors (`ModelParser.jl:404-413`)."""
    fn = getattr(module, name, None)
    if fn is None:
        fn = _grids.BUILTIN_GRID_FUNCTIONS.get(name)
    if fn is None:
        raise ValueError(
            f"Function '{name}' not found in the model function file or the "
            "built-in grid library. Check the function_file in your YAML.")
    if not callable(fn):
        raise TypeError(f"'{name}' is defined but is not callable ({type(fn)}).")
    return fn


def _ascii_kwargs(params_raw: Mapping) -> dict:
    out = {}
    for k, v in params_raw.items():
        out[_GREEK_ASCII.get(str(k), str(k))] = v
    return out


def _build_dimension(dim_dict: Mapping, module) -> HeterogeneityDimension:
    """Build one HeterogeneityDimension, validating the grid-function contract
    (`ModelParser.jl:452-511`)."""
    dim_type = str(dim_dict["type"])
    name = str(dim_dict["name"])
    fn_name = str(dim_dict["grid_function"])
    params_raw = dim_dict.get("params", {})
    n = int(params_raw["n"])
    policy_var = dim_dict.get("policy_var")

    grid_fn = _lookup_fn(module, fn_name)
    result = grid_fn(**_ascii_kwargs(params_raw))
    dtype = config.dtype

    if dim_type == "endogenous":
        arr = np.asarray(result, dtype=np.float64)
        if arr.ndim != 1:
            raise ValueError(
                f"Grid function '{fn_name}' for endogenous dimension '{name}' "
                f"must return a 1-D vector, got shape {arr.shape}.")
        if arr.shape[0] != n:
            raise ValueError(
                f"Grid function '{fn_name}' for '{name}': expected {n} points, "
                f"got {arr.shape[0]}.")
        return HeterogeneityDimension(
            name=name, dim_type="endogenous", n=n,
            grid=jnp.asarray(arr, dtype=dtype), transition=None,
            policy_var=str(policy_var) if policy_var else None)

    if dim_type == "exogenous":
        if not (isinstance(result, tuple) and len(result) == 2):
            raise ValueError(
                f"Grid function '{fn_name}' for exogenous dimension '{name}' "
                f"must return a 2-tuple (grid, transition), got {type(result)}.")
        grid, Pi = (np.asarray(result[0], dtype=np.float64),
                    np.asarray(result[1], dtype=np.float64))
        if grid.shape != (n,):
            raise ValueError(
                f"Grid from '{fn_name}' for '{name}': expected ({n},), got {grid.shape}.")
        if Pi.shape != (n, n):
            raise ValueError(
                f"Transition from '{fn_name}' for '{name}': expected ({n},{n}), "
                f"got {Pi.shape}.")
        return HeterogeneityDimension(
            name=name, dim_type="exogenous", n=n,
            grid=jnp.asarray(grid, dtype=dtype),
            transition=jnp.asarray(Pi, dtype=dtype), policy_var=None)

    raise ValueError(
        f"Unknown dimension type '{dim_type}' for '{name}' "
        "(expected 'endogenous' or 'exogenous').")


def _parse_ss_spec(spec_dict: Mapping) -> SteadyStateSpec:
    """YAML steady-state subsection -> SteadyStateSpec (`ModelParser.jl:422-435`).

    An optional `bounds:` mapping ("var: [lo, hi]") boxes the Newton search.
    """
    fixed = {str(k): float(v) for k, v in (spec_dict.get("fixed") or {}).items()}
    guesses = {str(k): float(v) for k, v in (spec_dict.get("guesses") or {}).items()}
    bounds = {}
    for k, v in (spec_dict.get("bounds") or {}).items():
        if not (isinstance(v, (list, tuple)) and len(v) == 2):
            raise ValueError(
                f"bounds for '{k}' must be a [lo, hi] pair, got {v!r}")
        bounds[str(k)] = (float(v[0]), float(v[1]))
    return SteadyStateSpec(fixed=fixed, guesses=guesses, bounds=bounds)


def build_model_from_yaml(file_path: str) -> SequenceModel:
    """Main entry: YAML specification file -> SequenceModel.

    Mirrors `ModelParser.jl:296-379`: parse YAML, import the function file,
    build dimensions, build Variables (order: endogenous, heterogeneous,
    exogenous), compile equations, parse steady-state specs.
    """
    spec = yaml_subset.load_file(file_path)
    directory = os.path.dirname(os.path.abspath(file_path))

    func_file = spec["file"]["function_file"]
    module = _load_function_module(os.path.join(directory, func_file))

    # 1. Parameters
    model_params_list = spec.get("parameters", {}).get("model", [])
    params = {str(p["name"]): float(p["value"]) for p in model_params_list}

    comp_list = spec.get("parameters", {}).get("computational", []) or []
    cs = {str(p["name"]): p["value"] for p in comp_list}
    T = int(cs.get("T", config.default_T))
    eps = float(cs.get("ε", cs.get("eps", config.default_eps)))
    dx = float(cs.get("dx", config.default_dx))

    # 2. Heterogeneity dimensions
    heterogeneity = {}
    for d in spec.get("dimensions", []):
        dim = _build_dimension(d, module)
        heterogeneity[dim.name] = dim

    # 3. Variables (ordering: endogenous -> heterogeneous -> exogenous)
    vs = spec["variables"]
    variables: dict[str, Variable] = {}
    for v in vs.get("endogenous", []) or []:
        variables[str(v["name"])] = Variable(
            str(v["name"]), "endogenous", v.get("description", ""))

    het_raw = vs.get("heterogeneous", []) or []
    het_var_defs = [v for v in het_raw if "name" in v]
    het_fn_defs = [v for v in het_raw if "function" in v]
    if len(het_fn_defs) != 1:
        raise ValueError(
            "The 'heterogeneous' variables section must contain exactly one "
            f"'function' entry (got {len(het_fn_defs)}). This function maps "
            "the next-period marginal value to (Value, <het policy vars>...).")
    value_fn = _lookup_fn(module, str(het_fn_defs[0]["function"]))
    for v in het_var_defs:
        variables[str(v["name"])] = Variable(
            str(v["name"]), "heterogeneous", v.get("description", ""))

    for v in vs.get("exogenous", []) or []:
        seq_fn = _lookup_fn(module, str(v["seq_function"])) if "seq_function" in v else None
        variables[str(v["name"])] = Variable(
            str(v["name"]), "exogenous", v.get("description", ""), seq_fn)

    n_endog = len([v for v in variables.values() if v.var_type == "endogenous"])
    var_names = tuple(variables.keys())

    # 4. Equations
    equations = tuple(str(e) for e in spec["equations"])
    param_names = set(params.keys())
    max_lag, max_lead = detect_max_lag_lead(equations, var_names)
    residuals_fn = compile_residuals(equations, var_names, param_names)

    compspec = CompSpec(T=T, eps=eps, dx=dx, n_v=len(variables),
                        n_endog=n_endog, max_lag=max_lag, max_lead=max_lead)

    # 5. Steady states (ending defaults to initial: transitory shock,
    #    `ModelParser.jl:374-375`)
    ss_section = spec["steady_states"]
    ss_initial = _parse_ss_spec(ss_section["initial"])
    ss_ending = (_parse_ss_spec(ss_section["ending"])
                 if "ending" in ss_section else ss_initial)

    return SequenceModel(
        variables=variables, equations=equations, compspec=compspec,
        params=params, residuals_fn=residuals_fn, ss_initial=ss_initial,
        ss_ending=ss_ending, heterogeneity=heterogeneity, value_fn=value_fn,
        name=str(spec.get("file", {}).get("name", "")))
