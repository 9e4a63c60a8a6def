"""Distribution transition ops: Young (2010) lottery + exogenous mixing.

Capability parity with the reference's forward block internals
(`ForwardIteration.jl:37-99`), redesigned for an accelerator:

- No sparse matrices. The endogenous "lottery" transition is a vectorized
  searchsorted + scatter-add (XLA-native, differentiable); the exogenous
  transition is a dense matmul with the (small) Markov matrix.
- The per-period transition `D' = Λ_exog · Λ_endog(policy) · D` becomes
  `exog_apply(lottery_apply(policy, D))` with no n_m × n_m matrix formed.
- The reference's hand-written rrule for `transition_step`
  (`ForwardIteration.jl:131-192`) is unnecessary: scatter-add and the clipped
  lottery weights are natively differentiable with exactly the same
  piecewise-linear chain rule (zero gradient at clamped boundary states).

State-array convention: distributions/policies have shape
``(*endog_shape, *exog_shape)``; helper functions flatten the exogenous axes
to one trailing axis internally.
"""

from __future__ import annotations

from functools import reduce
from typing import Sequence

import jax.numpy as jnp
import numpy as np


def searchsorted_left(grid: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """First index j with grid[j] >= p, as a comparison-sum.

    Equivalent to `jnp.searchsorted(grid, p, side="left")` but lowers to one
    vectorized compare+reduce instead of a binary-search loop — far fewer
    kernels per scan step (grids are small: n_a ≲ 1000).
    """
    return jnp.sum(grid[(None,) * p.ndim + (slice(None),)] < p[..., None],
                   axis=-1).astype(jnp.int32)


def lottery_weights(policy: jnp.ndarray, grid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bracket index and upper weight of the Young lottery.

    For each policy value p: find the first grid index j with grid[j] >= p
    (clipped to [1, n-1]); mass `w` goes to grid[j], mass `1-w` to grid[j-1],
    with w = (p - grid[j-1]) / (grid[j] - grid[j-1]) clipped to [0, 1].

    Boundary convention matches `ForwardIteration.jl:54-73`: below the grid all
    mass lands on the first point, above it on the last — and the clip kills
    the gradient at clamped states, matching the reference rrule's "zero at
    clamped bounds" (`ForwardIteration.jl:171-184`).
    """
    n = grid.shape[0]
    j = searchsorted_left(grid, policy)
    jc = jnp.clip(j, 1, n - 1)
    lo = grid[jc - 1]
    hi = grid[jc]
    w = jnp.clip((policy - lo) / (hi - lo), 0.0, 1.0)
    return jc, w


def hat_basis_weights(policy: jnp.ndarray, grid: jnp.ndarray) -> jnp.ndarray:
    """Lottery masses as piecewise-linear hat-function evaluations.

    The Young lottery is EXACTLY interpolation against the linear basis: the
    mass state a sends to grid point b is hat_b(clip(policy[a])), where
    hat_b rises on [g_{b-1}, g_b] and falls on [g_b, g_{b+1}] (sentinel
    neighbors beyond the ends). Returns H[..., n_b] with
    H[..., b] = hat_b(policy[...]) — pure broadcast/min/relu ops, no
    searchsorted, no integer one-hots, fusible by XLA into a single
    reduction pass. Matches `lottery_weights` up to f.p. roundoff
    (1 − (p−lo)/Δ vs (hi−p)/Δ differ by ulps).
    """
    n = grid.shape[0]
    step_lo = grid[1] - grid[0]
    step_hi = grid[-1] - grid[-2]
    g_lo = jnp.concatenate([grid[:1] - step_lo, grid[:-1]])   # g_{b-1}
    g_hi = jnp.concatenate([grid[1:], grid[-1:] + step_hi])   # g_{b+1}
    p = jnp.clip(policy, grid[0], grid[-1])[..., None]
    up = (p - g_lo) / (grid - g_lo)
    down = (g_hi - p) / (g_hi - grid)
    return jnp.maximum(jnp.minimum(up, down), 0.0)


def lottery_apply(policy: jnp.ndarray, D: jnp.ndarray, grid: jnp.ndarray,
                  axis: int = 0, dense: bool | None = None,
                  mode: str | None = None) -> jnp.ndarray:
    """Push the distribution through the endogenous savings transition.

    D'[a', rest] = Σ_a weight(a -> a'; policy[a, rest]) · D[a, rest]

    for each fixed combination of the non-`axis` states — the block-diagonal
    structure of `make_endogenous_transition` (`ForwardIteration.jl:37-78`).

    Three lowerings (`mode`):
    - "scatter" (default): the O(n_m) scatter-add.
    - "hat": contract D against hat-basis evaluations of the policy
      (`hat_basis_weights`) — one fused broadcast-multiply-reduce, no
      searchsorted/one-hot/W materialization.
    - "dense": one-hot masks + einsum contraction (kept as the reference
      lowering for the hat path and for `dense=True` callers).
    `HANK_TPU_LOTTERY` ∈ {scatter, hat, dense} overrides for A/B probes.
    """
    if axis != 0:
        policy = jnp.moveaxis(policy, axis, 0)
        D = jnp.moveaxis(D, axis, 0)
    shape = D.shape
    n_a = shape[0]
    rest = int(np.prod(shape[1:])) if len(shape) > 1 else 1

    p2 = policy.reshape(n_a, rest)
    d2 = D.reshape(n_a, rest)

    if mode is None:
        import os
        env = os.environ.get("HANK_TPU_LOTTERY")   # A/B probe override
        if env:
            mode = env
        elif dense:
            mode = "dense"
        else:
            mode = "scatter"

    if mode == "hat":
        # (rest, a_from, a_to) layout: a_to stays the contiguous axis.
        H = hat_basis_weights(p2.T, grid)             # (rest, a_from, a_to)
        out2 = jnp.sum(H * d2.T[..., None], axis=1).T
    elif mode == "dense":
        jc, w = lottery_weights(p2, grid)
        a_to = jnp.arange(n_a, dtype=jnp.int32)
        jc_t = jc.T                                   # (rest, n_a_from)
        w_t = w.T
        lo_hot = (a_to[None, None, :] == (jc_t - 1)[..., None])
        hi_hot = (a_to[None, None, :] == jc_t[..., None])
        Wmat = (lo_hot * (1.0 - w_t)[..., None] + hi_hot * w_t[..., None])
        out2 = jnp.einsum("rab,ra->rb", Wmat.astype(d2.dtype), d2.T).T
    elif mode == "scatter":
        jc, w = lottery_weights(p2, grid)
        cols = jnp.broadcast_to(jnp.arange(rest)[None, :], (n_a, rest))
        out2 = jnp.zeros_like(d2)
        out2 = out2.at[jc - 1, cols].add((1.0 - w) * d2)
        out2 = out2.at[jc, cols].add(w * d2)
    else:
        raise ValueError(f"unknown lottery mode {mode!r}")

    out = out2.reshape(shape)
    if axis != 0:
        out = jnp.moveaxis(out, 0, axis)
    return out


def exog_apply(D: jnp.ndarray, transitions: Sequence[jnp.ndarray],
               n_endog_axes: int) -> jnp.ndarray:
    """Mix the distribution across exogenous states.

    D'[..., e'] = Σ_e Pi[e, e'] D[..., e] applied per exogenous axis. With one
    exogenous dimension and state shape (n_a, n_e) this is `D @ Pi` — exactly
    the reference's `Λ_exog = kron(Πᵀ, I)` applied to the wealth-fastest
    vectorised state (`ForwardIteration.jl:280-284`), as a dense matmul.

    Under `config.exact_lowerings` the contraction UNROLLS to elementwise
    scalar·map FMAs (same rationale as the model-side `_expect_income`):
    elementwise FMAs round at ~1e-15 whatever the backend's contraction
    precision, and the forward scan compounds the per-step rounding over
    T-1 periods into the full-precision residual.
    """
    from hank_tpu.config import exact_lowerings_active

    exact = exact_lowerings_active()
    for i, Pi in enumerate(transitions):
        axis = n_endog_axes + i
        if exact:
            n = Pi.shape[0]
            Dm = jnp.moveaxis(D, axis, -1)
            cols = []
            for e2 in range(n):
                acc = Pi[0, e2] * Dm[..., 0]
                for e1 in range(1, n):
                    acc = acc + Pi[e1, e2] * Dm[..., e1]
                cols.append(acc)
            D = jnp.moveaxis(jnp.stack(cols, axis=-1), -1, axis)
        else:
            D = jnp.tensordot(D, Pi, axes=([axis], [0]))
            # tensordot moves the contracted axis to the end; restore it.
            D = jnp.moveaxis(D, -1, axis)
    return D


def forward_step(policy: jnp.ndarray, D: jnp.ndarray, grid: jnp.ndarray,
                 transitions: Sequence[jnp.ndarray],
                 n_endog_axes: int = 1) -> jnp.ndarray:
    """One period of distribution evolution: D' = Λ_exog (Λ_endog(policy) D).

    Reference: `transition_step`, `ForwardIteration.jl:95-99`.
    """
    return exog_apply(lottery_apply(policy, D, grid), transitions, n_endog_axes)


def lottery_apply_multi(policies: Sequence[jnp.ndarray], D: jnp.ndarray,
                        grids: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Joint Young lottery over k endogenous axes (k = len(policies)).

    Each policy is a full state-shaped array giving the next-period value of
    its endogenous state; mass splits over the 2^k bracketing corners with
    product weights. Generalises the reference's single-endogenous-dimension
    lottery (`ForwardIteration.jl:267-269` hard-errors for k > 1; two-asset
    HANK needs k = 2).
    """
    k = len(policies)
    if k == 1:
        return lottery_apply(policies[0], D, grids[0], axis=0)

    shape = D.shape
    endog_shape = shape[:k]
    F = int(np.prod(shape[k:])) if len(shape) > k else 1
    d2 = D.reshape(*endog_shape, F)

    idx_w = []
    for i in range(k):
        p2 = policies[i].reshape(*endog_shape, F)
        jc, w = lottery_weights(p2, grids[i])
        idx_w.append((jc, w))

    f_idx = jnp.broadcast_to(jnp.arange(F), (*endog_shape, F))

    out = jnp.zeros_like(d2)
    for corner in range(1 << k):
        weight = d2
        idxs = []
        for i in range(k):
            jc, w = idx_w[i]
            if corner >> i & 1:
                idxs.append(jc)
                weight = weight * w
            else:
                idxs.append(jc - 1)
                weight = weight * (1.0 - w)
        out = out.at[(*idxs, f_idx)].add(weight)
    return out.reshape(shape)


# ─────────────────────────────────────────────────────────────────────────────
# Dense transition assembly# ─────────────────────────────────────────────────────────────────────────────
# Dense transition assembly (for the direct invariant-distribution solve)
# ─────────────────────────────────────────────────────────────────────────────

def dense_endog_transition(policy: jnp.ndarray, grid: jnp.ndarray) -> jnp.ndarray:
    """Dense (n_a, n_a, F) lottery matrices W[a', a, f] per exogenous state.

    W[:, a, f] is the column-stochastic mass split of state (a, f)'s policy.
    Only used for small state spaces (invariant-distribution dense path).
    """
    n_a = grid.shape[0]
    F = int(np.prod(policy.shape[1:])) if policy.ndim > 1 else 1
    p2 = policy.reshape(n_a, F)
    jc, w = lottery_weights(p2, grid)
    a_idx = jnp.broadcast_to(jnp.arange(n_a)[:, None], (n_a, F))
    f_idx = jnp.broadcast_to(jnp.arange(F)[None, :], (n_a, F))
    W = jnp.zeros((n_a, n_a, F), dtype=policy.dtype)
    W = W.at[jc - 1, a_idx, f_idx].add(1.0 - w)
    W = W.at[jc, a_idx, f_idx].add(w)
    return W


def exog_kron(transitions: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Total exogenous transition over the flattened exogenous index.

    Row-stochastic (F, F) Kronecker product of the per-dimension matrices,
    ordered so the *last* exogenous dimension varies fastest (C-order flatten
    of the exogenous axes).
    """
    if not transitions:
        return jnp.ones((1, 1))
    return reduce(jnp.kron, transitions)


def dense_full_transition(policy: jnp.ndarray, grid: jnp.ndarray,
                          transitions: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Dense column-stochastic (n_m, n_m) one-period transition matrix.

    Λ[(a'·F + f'), (a·F + f)] = Π_total[f, f'] · W[a', a, f] — the flattened
    C-order state index (endogenous axis slow, exogenous fast). Used by the
    dense invariant-distribution path; the scan hot path never materialises it
    (`ForwardIteration.jl:92-94` keeps the same discipline with sparse MVMs).
    """
    W = dense_endog_transition(policy, grid)       # (n_a', n_a, F)
    P = exog_kron(transitions)                     # (F, F) row-stochastic
    n_a, _, F = W.shape
    lam = jnp.einsum("baf,fg->bgaf", W, P)         # [a', f', a, f]
    return lam.reshape(n_a * F, n_a * F)
