"""Steady-state sequence-space Jacobian (Boehl 2024 decomposition).

Capability parity with the reference's `SteadyStateJacobian.jl`: the full
residual map F(x) is decomposed by the chain rule into

  JDI — direct:   ∂F/∂x with policies held at SS      (`:112-145`)
  JBI — backward: ∂(policy paths)/∂x                  (`:187-243`)
  JFI — forward:  ∂F/∂(policy paths)                  (`:245-253`)

and, exploiting block-Toeplitz time-translation invariance at the steady
state, only ONE block column of each is computed; the full (T-1)×(T-1) block
Jacobian is recovered by a diagonal-cumsum recursion (`:358-387`).

Accelerator-first redesign:
- JDI/JBI columns are `vmap`ped `jax.jvp` sweeps; JFI is ONE `jax.vjp` of the
  forward scan pulled back against n_endog seeds — no hand-written rrules.
- The O(T²) block products (`:299-304`) are a single einsum.
- The Toeplitz recursion is a diagonal gather → cumsum → gather (O(T²)
  memory, no sequential loop) instead of the O(T²) sequential recursion.
- Everything is dense f64 on-device: the PR#481 sparsity-at-zero hazard
  (`ForwardDiff.jl/README.md:16-21`) cannot arise because nothing is ever
  sparsified by value.

Boundary corrections: the reference adds `J[1,1] += lag-1 block` and leaves
lead corrections as an open TODO (`:374-384`). Here the assembly is validated
directly against a dense `jax.jacfwd` of the full pipeline (see
tests/test_jacobian.py), which is the ground truth for finite horizons; the
correction is exposed via `boundary_correction` and defaults to what the
dense check confirms.
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp

from hank_tpu.blocks.assemble import assemble_full_xmat, residuals as eval_residuals
from hank_tpu.blocks.backward import backward_iteration
from hank_tpu.blocks.forward import forward_iteration
from hank_tpu.config import config


def _ss_paths(ss, model):
    """Constant-at-SS flat x, exog paths, and aggregate paths
    (`SteadyStateJacobian.jl:52-57`)."""
    Tm1 = model.compspec.T - 1
    dtype = config.dtype
    endog_keys = model.vars_of_type("endogenous")
    x_ss = jnp.tile(jnp.asarray([ss.vars[k] for k in endog_keys], dtype=dtype), Tm1)
    exog_ss = {k: jnp.full((Tm1,), ss.vars[k], dtype=dtype)
               for k in model.vars_of_type("exogenous")}
    agg_ss = {k: jnp.full((Tm1,), ss.vars[k], dtype=dtype)
              for k in model.vars_of_type("heterogeneous")}
    return x_ss, exog_ss, agg_ss


def _unit_tangents(n: int, rows: jnp.ndarray, dtype) -> jnp.ndarray:
    """(len(rows), n) matrix of unit vectors e_row."""
    return jnp.zeros((len(rows), n), dtype=dtype).at[jnp.arange(len(rows)), rows].set(1.0)


def _shard_seed_sweep(fn, mesh):
    """Shard a vmapped seed sweep's leading (seed) axis over the mesh's "dp"
    axis — the solver's true sequence parallelism (SURVEY §2.10 SP row): the
    J̄ seed sweeps are independent (`SteadyStateJacobian.jl:241-243`), so each
    device runs its shard of the JVP/VJP columns with no communication until
    the final gather."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P("dp"))
    return jax.jit(fn, in_shardings=shard, out_shardings=shard)


def direct_jacobian_blocks(ss, model, mesh=None) -> tuple[jnp.ndarray, int]:
    """Direct blocks B_δ = ∂z_{p+δ}/∂x_p with policies frozen at SS.

    Perturbs one interior period p = T-1-k (k = max(max_lag, max_lead)) with
    n_endog JVPs and extracts the 2k+1 consecutive blocks
    (`SteadyStateJacobian.jl:112-145`). Returns (blocks, k) with
    blocks[j] (n_endog, n_endog), j = δ + k, element [res_eq, x_var].
    """
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    x_ss, exog_ss, agg_ss = _ss_paths(ss, model)

    def g(x):
        x_mat = assemble_full_xmat(x, agg_ss, exog_ss, model, ss.vars, ss.vars)
        return eval_residuals(x_mat, model)

    k = max(cs.max_lag, cs.max_lead)
    p0 = Tm1 - 1 - k
    assert p0 >= 0 and p0 + k <= Tm1 - 1, (
        f"perturbed period p={p0} out of range for T={cs.T}, k={k}")

    rows = p0 * nE + jnp.arange(nE)
    seeds = _unit_tangents(Tm1 * nE, rows, x_ss.dtype)
    sweep = jax.vmap(lambda t: jax.jvp(g, (x_ss,), (t,))[1])
    if mesh is not None:
        sweep = _shard_seed_sweep(sweep, mesh)
    raw = sweep(seeds)                                             # (nE, Tm1*nE)

    blocks = jnp.stack([
        raw[:, (p0 + d) * nE:(p0 + d + 1) * nE].T  # [res_eq, x_var]
        for d in range(-k, k + 1)
    ])
    return blocks, k


def intermediate_jacobians(ss, model, mesh=None) -> tuple[dict, dict]:
    """JBI and JFI one-block-columns (`SteadyStateJacobian.jl:187-256`).

    JBI[v]: (n_endog, T-1, *state_shape) — ∂policy_v[s]/∂x_{T-1, i} via
      n_endog vmapped JVPs through the backward scan.
    JFI[v]: (n_endog, T-1, *state_shape) — ∂z_{T-1, j}/∂policy_v[t] via ONE
      `jax.vjp` of the forward pipeline pulled back on n_endog seeds.
    """
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    x_ss, exog_ss, agg_ss = _ss_paths(ss, model)
    het_keys = model.vars_of_type("heterogeneous")

    def back(x):
        return backward_iteration(x, exog_ss, model, ss.vars, ss.value)

    last_rows = (Tm1 - 1) * nE + jnp.arange(nE)
    seeds_x = _unit_tangents(Tm1 * nE, last_rows, x_ss.dtype)
    jbi_sweep = jax.vmap(lambda t: jax.jvp(back, (x_ss,), (t,))[1])
    if mesh is not None:
        jbi_sweep = _shard_seed_sweep(jbi_sweep, mesh)
    JBI = jbi_sweep(seeds_x)

    pol_ss = {v: jnp.broadcast_to(ss.policies[v],
                                  (Tm1, *ss.policies[v].shape)).astype(x_ss.dtype)
              for v in het_keys}

    def fwd(policies):
        aggs = forward_iteration(policies, model, ss.D)
        x_mat = assemble_full_xmat(x_ss, aggs, exog_ss, model, ss.vars, ss.vars)
        return eval_residuals(x_mat, model)

    _, pullback = jax.vjp(fwd, pol_ss)
    seeds_z = _unit_tangents(Tm1 * nE, last_rows, x_ss.dtype)
    jfi_sweep = jax.vmap(lambda s: pullback(s)[0])
    if mesh is not None:
        jfi_sweep = _shard_seed_sweep(jfi_sweep, mesh)
    JFI = jfi_sweep(seeds_z)

    return JBI, JFI


def _diag_cumsum(G: jnp.ndarray) -> jnp.ndarray:
    """J[r, c] = Σ_{d=0}^{min(r,c)} G[r-d, c-d] for a block array G.

    The block-Toeplitz recursion (`SteadyStateJacobian.jl:358-371`) as a
    gather → cumsum-along-diagonals → gather, fully parallel on device.
    """
    n = G.shape[0]
    offs = jnp.arange(-(n - 1), n)                       # (2n-1,)
    t = jnp.arange(n)
    s_ids = t[None, :] + offs[:, None]                   # (2n-1, n)
    valid = (s_ids >= 0) & (s_ids < n)
    s_clip = jnp.clip(s_ids, 0, n - 1)
    t_ids = jnp.broadcast_to(t[None, :], s_ids.shape)
    A = G[s_clip, t_ids]
    A = A * valid.reshape(*valid.shape, *([1] * (G.ndim - 2)))
    Acum = jnp.cumsum(A, axis=1)
    r = jnp.arange(n)[:, None]
    c = jnp.arange(n)[None, :]
    return Acum[r - c + n - 1, c]


def assemble_jacobian(blocks: jnp.ndarray, k: int, JBI: Mapping, JFI: Mapping,
                      model, boundary_correction: bool = False) -> jnp.ndarray:
    """Combine direct blocks + indirect products into the dense SS Jacobian.

    Returns the (n_endog·(T-1), n_endog·(T-1)) matrix (consolidated layout of
    `SteadyStateJacobian.jl:399-410`: row = residual period-major, column =
    x period-major).
    """
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    het_keys = model.vars_of_type("heterogeneous")

    # Indirect helper blocks H[t, s, j, i] = Σ_v ⟨JFI_v[j, t], JBI_v[i, s]⟩
    # — the O(T²) block products (`:299-304`) as one einsum.
    H = jnp.zeros((Tm1, Tm1, nE, nE), dtype=config.dtype)
    for v in het_keys:
        fi = JFI[v].reshape(nE, Tm1, -1)
        bi = JBI[v].reshape(nE, Tm1, -1)
        H = H + jnp.einsum("jtm,ism->tsji", fi, bi)

    # Direct edge placement (`:307-319`): corner = δ=0, right column = lags,
    # top row = leads.
    L = Tm1 - 1
    H = H.at[L, L].add(blocks[k])
    for d in range(1, k + 1):
        H = H.at[L - d, L].add(blocks[k + d])   # lag-δ
        H = H.at[L, L - d].add(blocks[k - d])   # lead-δ

    # Toeplitz recursion over reversed indices.
    G = H[::-1, ::-1]
    J = _diag_cumsum(G)

    if boundary_correction and k >= 1:
        # The reference's left-boundary fix (`:374-379`). Off by default: the
        # dense-jacfwd ground-truth check (tests/test_jacobian.py) governs.
        J = J.at[0, 0].add(blocks[k + 1])

    return J.transpose(0, 2, 1, 3).reshape(Tm1 * nE, Tm1 * nE)


def get_steady_state_jacobian(ss, model, boundary_correction: bool = False,
                              mesh=None) -> jnp.ndarray:
    """Top-level entry (`SteadyStateJacobian.jl:41-65`).

    `ss` should be the ending steady state (the linearisation point for the
    transition path). Asserts the system is square (n_eq == n_endog,
    `SteadyStateJacobian.jl:43-46`).

    With `mesh`, the independent JDI/JBI JVP seed sweeps and the JFI pullback
    seeds are sharded across the mesh's "dp" axis (the mesh size must divide
    n_endog); results are identical to the single-device build.
    """
    if len(model.equations) != model.compspec.n_endog:
        raise ValueError(
            f"System is not square: {len(model.equations)} equations but "
            f"{model.compspec.n_endog} endogenous variables. "
            "Newton-Raphson requires n_eq == n_endog.")

    blocks, k = direct_jacobian_blocks(ss, model, mesh=mesh)
    JBI, JFI = intermediate_jacobians(ss, model, mesh=mesh)
    return assemble_jacobian(blocks, k, JBI, JFI, model,
                             boundary_correction=boundary_correction)


def direct_jacobian_columns(ss_initial, ss_ending, model,
                            columns,
                            exog_paths: Mapping[str, jnp.ndarray] | None = None,
                            mode: str = "jvp",
                            fd_step: float | None = None) -> jnp.ndarray:
    """Selected Jacobian columns of the FULL pipeline by JVP or finite
    differences — the reference's AD-validation tools `directJVPJacobian` /
    `directNumJacobian` (`SteadyState.jl:296-356`), generalized to arbitrary
    column sets.

    fd_step defaults to the model's `CompSpec.dx` — the YAML computational
    parameter the reference wires as its FD step (`ModelParser.jl:312-317`,
    default 1e-8; the KS yaml sets 0.001).

    Returns (n, len(columns)).
    """
    if fd_step is None:
        fd_step = model.compspec.dx
    from hank_tpu.solvers.newton import make_full_residual_fn

    Tm1 = model.compspec.T - 1
    if exog_paths is None:
        exog_paths = {k: jnp.full((Tm1,), ss_ending.vars[k], dtype=config.dtype)
                      for k in model.vars_of_type("exogenous")}
    endog_keys = model.vars_of_type("endogenous")
    x_ss = jnp.tile(jnp.asarray([ss_ending.vars[k] for k in endog_keys],
                                dtype=config.dtype), Tm1)
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    n = x_ss.shape[0]

    if mode == "jvp":
        @jax.jit
        def col(tangent):
            return jax.jvp(F, (x_ss,), (tangent,))[1]

        cols = [col(jnp.zeros(n, config.dtype).at[c].set(1.0)) for c in columns]
    elif mode == "fd":
        F_jit = jax.jit(F)
        base = F_jit(x_ss)
        cols = []
        for c in columns:
            e = jnp.zeros(n, config.dtype).at[c].set(fd_step)
            cols.append((F_jit(x_ss + e) - base) / fd_step)
    else:
        raise ValueError(f"mode must be 'jvp' or 'fd', got {mode!r}")
    return jnp.stack(cols, axis=1)


def dense_path_jacobian(ss_initial, ss_ending, model,
                        exog_paths: Mapping[str, jnp.ndarray] | None = None) -> jnp.ndarray:
    """Ground-truth dense ∂F/∂x via `jax.jacfwd` through the full pipeline.

    The JAX analogue of `directJVPJacobian` (`SteadyState.jl:296-320`) but for
    ALL columns — O(n_endog·(T-1)) JVP sweeps; small T only. Used to validate
    the Toeplitz assembly, including its finite-horizon boundary behaviour.
    """
    from hank_tpu.solvers.newton import make_full_residual_fn

    Tm1 = model.compspec.T - 1
    if exog_paths is None:
        exog_paths = {k: jnp.full((Tm1,), ss_ending.vars[k], dtype=config.dtype)
                      for k in model.vars_of_type("exogenous")}
    endog_keys = model.vars_of_type("endogenous")
    x_ss = jnp.tile(jnp.asarray([ss_ending.vars[k] for k in endog_keys],
                                dtype=config.dtype), Tm1)
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)

    # One jitted JVP sweep, looped over columns (compiles once; batching all
    # columns through the scans via jacfwd/vmap compiles pathologically).
    n = x_ss.shape[0]

    @jax.jit
    def col(tangent):
        return jax.jvp(F, (x_ss,), (tangent,))[1]

    eye = jnp.eye(n, dtype=x_ss.dtype)
    return jnp.stack([col(eye[i]) for i in range(n)], axis=1)
