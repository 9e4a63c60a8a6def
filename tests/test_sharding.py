"""Multi-device sharding on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_make_mesh():
    from hank_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    assert mesh.shape == {"dp": 8}
    mesh2 = make_mesh(8, ("dp", "state"))
    assert mesh2.shape["dp"] * mesh2.shape["state"] == 8


def test_residual_ensemble_matches_per_path(ks_small, ks_small_ss):
    from hank_tpu.parallel.ensemble import residual_ensemble
    from hank_tpu.parallel.mesh import make_mesh
    from hank_tpu.solvers.newton import make_full_residual_fn

    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    Tm1 = T - 1
    B = 8
    t = jnp.arange(1, T, dtype=jnp.float64)
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
    exog_b = {"Z": 1.0 + 0.05 * rhos[:, None] ** t[None, :]}
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), Tm1)
    x_b = jnp.broadcast_to(x0, (B, x0.shape[0]))

    mesh = make_mesh(8)
    out = residual_ensemble(x_b, exog_b, model, ss, ss, mesh=mesh)
    assert out.shape == (B, x0.shape[0])

    # Sharded output must equal the independently computed per-path residual.
    for i in (0, 3, 7):
        F = make_full_residual_fn(model, ss, ss, {"Z": exog_b["Z"][i]})
        expected = F(x0)
        assert float(jnp.max(jnp.abs(out[i] - expected))) < 1e-12

    # Leading axis actually sharded across the mesh.
    assert len(out.sharding.device_set) == 8


def test_solve_ensemble_sharded(ks_small, ks_small_ss):
    from hank_tpu.parallel.ensemble import solve_ensemble
    from hank_tpu.parallel.mesh import make_mesh
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu.solvers.newton import newton_raphson_hank

    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    Tm1 = T - 1
    B = 8
    t = jnp.arange(1, T, dtype=jnp.float64)
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
    exog_b = {"Z": 1.0 + 0.05 * rhos[:, None] ** t[None, :]}
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), Tm1)
    Jbar = get_steady_state_jacobian(ss, model)

    mesh = make_mesh(8)
    x_paths, info = solve_ensemble(x0, Jbar, exog_b, model, ss, ss,
                                   mesh=mesh, method="boehl", eps=1e-9)
    assert x_paths.shape == (B, x0.shape[0])
    assert bool(jnp.all(jnp.isfinite(x_paths)))

    # Each sharded solve matches a standalone single-path solve.
    x_one, _ = newton_raphson_hank(x0, Jbar, {"Z": exog_b["Z"][2]},
                                   model, ss, ss, method="boehl", eps=1e-9)
    assert float(jnp.max(jnp.abs(x_paths[2] - x_one))) < 1e-7


def test_dryrun_multichip():
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_solve_ensemble_host_matches_per_path(ks_small, ks_small_ss):
    """Host-driven batched Boehl (the production ensemble path) matches
    standalone per-path solves
    and shards the batch axis across the mesh."""
    from hank_tpu.parallel.ensemble import solve_ensemble_host
    from hank_tpu.parallel.mesh import make_mesh
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu.solvers.newton import newton_raphson_hank

    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    Tm1 = T - 1
    B = 8
    t = jnp.arange(1, T, dtype=jnp.float64)
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
    exog_b = {"Z": 1.0 + 0.05 * rhos[:, None] ** t[None, :]}
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), Tm1)
    Jbar = get_steady_state_jacobian(ss, model)

    mesh = make_mesh(8)
    records = []
    x_paths, info = solve_ensemble_host(x0, Jbar, exog_b, model, ss, ss,
                                        mesh=mesh, eps=1e-9, records=records)
    assert x_paths.shape == (B, x0.shape[0])
    assert bool(jnp.all(info["residual_norm"] < 1e-9))
    assert len(x_paths.sharding.device_set) == 8
    assert records and records[-1]["converged"] == B

    for i in (0, 5):
        x_one, _ = newton_raphson_hank(
            x0, Jbar, {"Z": exog_b["Z"][i]}, model, ss, ss,
            method="boehl", eps=1e-9, direction_dtype=jnp.float32)
        assert float(jnp.max(jnp.abs(x_paths[i] - x_one))) < 1e-7

    # Unmeshed variant agrees too (single-device batched programs).
    x_nm, info_nm = solve_ensemble_host(x0, Jbar, exog_b, model, ss, ss,
                                        eps=1e-9)
    assert float(jnp.max(jnp.abs(x_nm - x_paths))) < 1e-8


def test_solve_ensemble_host_survives_bad_path(ks_small, ks_small_ss):
    """Per-path resilience: one infeasible shock draw (Z dips negative →
    non-finite residual mid-solve) must not hard-fail or poison the other
    paths — the bad row freezes at its best iterate and is reported in
    `stalled_paths`, the rest converge to eps."""
    from hank_tpu.parallel.ensemble import solve_ensemble_host
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    Tm1 = T - 1
    B = 4
    t = jnp.arange(1, T, dtype=jnp.float64)
    Z = jnp.stack([
        1.0 + 0.05 * 0.8 ** t,
        1.0 + 0.08 * 0.6 ** t,
        1.0 - 1.5 * 0.999 ** t,          # Z < 0: infeasible economy
        1.0 + 0.03 * 0.9 ** t,
    ])
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), Tm1)
    Jbar = get_steady_state_jacobian(ss, model)

    x_paths, info = solve_ensemble_host(x0, Jbar, {"Z": Z}, model, ss, ss,
                                        eps=1e-9, max_outer=30)
    assert x_paths.shape == (B, x0.shape[0])
    good = jnp.asarray([0, 1, 3])
    assert bool(jnp.all(info["residual_norm"][good] < 1e-9))
    assert bool(jnp.all(jnp.isfinite(x_paths[good])))
    assert info["stalled_paths"] >= 1


def test_solve_ensemble_host_newton_krylov(ks_small, ks_small_ss):
    """Batched lockstep Newton-Krylov (host-driven batched GMRES) reaches
    the same per-path solutions as the Richardson loop and as standalone
    per-path solves, in far fewer lockstep direction sweeps."""
    from hank_tpu.parallel.ensemble import solve_ensemble_host
    from hank_tpu.parallel.mesh import make_mesh
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu.solvers.newton import newton_raphson_hank

    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    Tm1 = T - 1
    B = 6
    t = jnp.arange(1, T, dtype=jnp.float64)
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
    exog_b = {"Z": 1.0 + 0.05 * rhos[:, None] ** t[None, :]}
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), Tm1)
    Jbar = get_steady_state_jacobian(ss, model)

    records = []
    x_nk, info_nk = solve_ensemble_host(x0, Jbar, exog_b, model, ss, ss,
                                        eps=1e-9, method="newton_krylov",
                                        records=records)
    assert x_nk.shape == (B, x0.shape[0])
    assert bool(jnp.all(info_nk["residual_norm"] < 1e-9))
    assert records and records[-1]["converged"] == B

    x_rich, info_rich = solve_ensemble_host(x0, Jbar, exog_b, model, ss, ss,
                                            eps=1e-9)
    assert float(jnp.max(jnp.abs(x_nk - x_rich))) < 1e-7
    # The point of the method: an order of magnitude fewer lockstep sweeps.
    assert info_nk["inner_iterations"] < info_rich["inner_iterations"] / 3

    x_one, _ = newton_raphson_hank(
        x0, Jbar, {"Z": exog_b["Z"][2]}, model, ss, ss,
        method="boehl", eps=1e-9, direction_dtype=jnp.float32)
    assert float(jnp.max(jnp.abs(x_nk[2] - x_one))) < 1e-7

    # Meshed: batch axis dp-sharded through the GMRES programs.
    mesh = make_mesh(8)
    exog_m = {"Z": jnp.concatenate([exog_b["Z"], exog_b["Z"][:2]])}
    x_m, info_m = solve_ensemble_host(x0, Jbar, exog_m, model, ss, ss,
                                      mesh=mesh, eps=1e-9,
                                      method="newton_krylov")
    assert bool(jnp.all(info_m["residual_norm"] < 1e-9))
    assert float(jnp.max(jnp.abs(x_m[:B] - x_nk))) < 1e-8


def test_solve_ensemble_host_chunked_matches(ks_small, ks_small_ss,
                                             monkeypatch):
    """Host-level batch chunking (the batch-width miscompilation guard)
    is numerically invisible — including a RAGGED final chunk (B=7 over
    chunk=3 pads with row-0 copies; round-3 advisor finding). The probe is
    forced to report a mismatch so the chunked path actually engages on the
    healthy CPU backend."""
    from hank_tpu.parallel import ensemble
    from hank_tpu.parallel.ensemble import solve_ensemble_host
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

    model, ss = ks_small, ks_small_ss
    T = model.compspec.T
    B = 7
    t = jnp.arange(1, T, dtype=jnp.float64)
    rhos = 0.5 + 0.4 * jnp.arange(B, dtype=jnp.float64) / B
    exog_b = {"Z": 1.0 + 0.05 * rhos[:, None] ** t[None, :]}
    x0 = jnp.tile(jnp.asarray(
        [ss.vars[k] for k in model.vars_of_type("endogenous")]), T - 1)
    Jbar = get_steady_state_jacobian(ss, model)

    x_u, info_u = solve_ensemble_host(x0, Jbar, exog_b, model, ss, ss,
                                      eps=1e-9, chunk=None)
    monkeypatch.setattr(ensemble, "_probe_width_consistency",
                        lambda *a, **k: False)
    with pytest.warns(UserWarning, match="disagrees"):
        x_c, info_c = solve_ensemble_host(x0, Jbar, exog_b, model, ss, ss,
                                          eps=1e-9, chunk=3)
    assert bool(jnp.all(info_c["residual_norm"] < 1e-9))
    assert float(jnp.max(jnp.abs(x_c - x_u))) < 1e-12


def test_ensemble_width_probe_detects_corruption(ks_small, ks_small_ss):
    """`_probe_width_consistency` returns True for the healthy programs and
    False when the full-width program returns corrupted tangent norms (a
    width-dependent miscompilation: row norms off ~20x)."""
    from hank_tpu.parallel.ensemble import _probe_width_consistency

    n, B = 12, 6
    x0 = jnp.linspace(0.5, 1.5, n)
    exog_b = {"Z": jnp.ones((B, 4))}

    def inner_healthy(x, y, Fx, tol, ex):
        r = jnp.full((x.shape[0],), 2.9e5)
        return y, r

    def chunked(x, y, Fx, tol, ex):
        return inner_healthy(x, y, Fx, tol, ex)

    assert _probe_width_consistency(inner_healthy, chunked, x0, exog_b,
                                    B, n, jnp.float64)

    def inner_bad(x, y, Fx, tol, ex):       # row 0 corrupted, 20x off
        r = jnp.full((x.shape[0],), 2.9e5).at[0].set(1.4e4)
        return y, r

    assert not _probe_width_consistency(inner_bad, chunked, x0, exog_b,
                                        B, n, jnp.float64)
