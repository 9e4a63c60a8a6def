"""Household-state-axis sharding (the TP analogue — SURVEY §2.10 TP row).

For very large household state spaces (the 500-pt grid config, two-asset
states), policies and distributions can be sharded over a mesh "state" axis
with `NamedSharding`. The natural shardable axis is an EXOGENOUS dimension:
the Young lottery acts independently per exogenous state (block-diagonal in
e — `ForwardIteration.jl:8-10`), so the push-forward runs with zero
communication, and the only collective is the (tiny) Markov-mixing matmul
plus the aggregation psum — both inserted by XLA from the shardings.

The reference has no distributed machinery at all (SURVEY §2.10); this
module supplies the device-sharded equivalent.
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hank_tpu.blocks.backward import backward_iteration
from hank_tpu.blocks.forward import forward_iteration


def state_sharding(mesh: Mesh, model, *, time_axis: bool = False,
                   axis: str = "state") -> NamedSharding:
    """NamedSharding placing the LAST exogenous household axis on `axis`.

    State arrays are (*endog_shape, *exog_shape); with `time_axis` a leading
    T axis is left unsharded (policy paths).
    """
    n_state_axes = len(model.heterogeneity)
    spec = [None] * (n_state_axes + (1 if time_axis else 0))
    spec[-1] = axis
    return NamedSharding(mesh, P(*spec))


def forward_iteration_sharded(
    policy_seqs: Mapping[str, jnp.ndarray],
    model,
    D_initial: jnp.ndarray,
    mesh: Mesh,
    axis: str = "state",
) -> dict[str, jnp.ndarray]:
    """`blocks.forward.forward_iteration` with the household state sharded.

    Policies (T-1, *state) and the distribution (*state) are laid out with
    the last exogenous axis split across the mesh; each device pushes its
    shard of households through the lottery locally, XLA inserts the
    collectives for the exogenous-mixing matmul and the aggregation
    reductions. Results are bitwise-identical modulo reduction order.
    """
    shard_t = state_sharding(mesh, model, time_axis=True, axis=axis)
    shard_d = state_sharding(mesh, model, axis=axis)
    repl = NamedSharding(mesh, P())

    fn = jax.jit(
        lambda pol, d0: forward_iteration(pol, model, d0),
        in_shardings=({k: shard_t for k in policy_seqs}, shard_d),
        out_shardings=repl)
    return fn(dict(policy_seqs), D_initial)


def backward_iteration_sharded(
    x_endog: jnp.ndarray,
    exog_paths: Mapping[str, jnp.ndarray],
    model,
    ss_end_vars: Mapping[str, jnp.ndarray],
    terminal_value: jnp.ndarray,
    mesh: Mesh,
    axis: str = "state",
) -> dict[str, jnp.ndarray]:
    """`blocks.backward.backward_iteration` with the value/policy state
    sharded over the mesh (the EGM step's expectation matmul contracts the
    sharded exogenous axis — XLA turns it into a local matmul + collective)."""
    shard_v = state_sharding(mesh, model, axis=axis)
    shard_t = state_sharding(mesh, model, time_axis=True, axis=axis)
    repl = NamedSharding(mesh, P())

    het = model.vars_of_type("heterogeneous")
    fn = jax.jit(
        lambda x, ex, vT: backward_iteration(x, ex, model, ss_end_vars, vT),
        in_shardings=(repl, {k: repl for k in exog_paths}, shard_v),
        out_shardings={k: shard_t for k in het})
    return fn(x_endog, dict(exog_paths), terminal_value)
