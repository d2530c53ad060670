"""Distributed bundle adjustment: observations sharded over the device
mesh, Schur-complement reduction over psum collectives.

BASELINE north star config #5 ("distributed BA solved via Schur-complement
reduction over psum/all-gather collectives").  Decomposition:

* The observation table (cam_idx, pt_idx, uv, valid) is sharded on the
  mesh's data axis — observations are the O(N) axis in SfM.
* Each device computes its shard's contribution to the normal-equation
  terms (geometry/ba.normal_equation_terms — every term is a sum over
  observations, so sharded sums + psum is exact).
* Two camera-system solvers:
  - ``solver="dense"``: the reduced [6C, 6C] system is solved replicated
    on all devices — exact, right for windowed VO BA (tens of cameras).
  - ``solver="cg"``: block-Jacobi-preconditioned CG with observation-space
    S-matvecs (geometry/ba.solve_schur_cg, psum-reduced) — nothing dense
    in C is ever formed, so global BA scales to thousands of cameras.

Implemented with shard_map so the psums are explicit collectives.

Elastic recovery: make_lm_stepper exposes the LM loop as a resumable
(init, step) pair over the replicated BAState, so a host loop can
checkpoint between chunks (perf/checkpoint.py save/load_ba_state) and a
restarted cluster resumes bit-identically — see
tests/test_multihost.py::test_worker_loss_resume_from_checkpoint.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sift_jax.geometry.ba import (BAProblem, BAState, apply_step,
                                  normal_equation_terms, solve_schur,
                                  solve_schur_cg)

_OBS_SPEC_FIELDS = dict(
    rotations=P(), translations=P(), points=P(),
    cam_idx=None, pt_idx=None, uv=None, valid=None,
    fx=P(), fy=P(), cx=P(), cy=P())

_STATE_SPEC = BAState(rotations=P(), translations=P(), points=P(),
                      cost=P(), lm_lambda=P())


def _obs_spec(axis: str) -> BAProblem:
    d = dict(_OBS_SPEC_FIELDS)
    for k in ("cam_idx", "pt_idx", "uv", "valid"):
        d[k] = P(axis)
    return BAProblem(**d)


def _pad_observations(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the observation axis to a multiple of the shard count (padding
    rows are invalid and contribute zero)."""
    o = p.cam_idx.shape[0]
    pad = (-o) % n_shards
    if pad == 0:
        return p
    zi = jnp.zeros((pad,), jnp.int32)
    return p._replace(
        cam_idx=jnp.concatenate([p.cam_idx, zi]),
        pt_idx=jnp.concatenate([p.pt_idx, zi]),
        uv=jnp.concatenate([p.uv, jnp.zeros((pad, 2), p.uv.dtype)]),
        valid=jnp.concatenate([p.valid, jnp.zeros((pad,), bool)]))


def _cost_of(p: BAProblem, axis: str, rot, tr, pts):
    from sift_jax.geometry.ba import _residuals_and_jacobians
    q = p._replace(rotations=rot, translations=tr, points=pts)
    res, _, _ = _residuals_and_jacobians(q)
    num = jax.lax.psum(jnp.sum(res * res), axis)
    den = jax.lax.psum(jnp.sum(p.valid), axis)
    return num / jnp.maximum(den, 1)


def make_lm_stepper(mesh: Mesh, axis: str = "data", chunk: int = 5,
                    init_lambda: float = 1e-4, solver: str = "dense",
                    cg_iters: int = 25):
    """Resumable distributed LM: returns (init, step, place).

    ``init(problem) -> BAState`` (replicated), ``step(problem, state) ->
    BAState`` runs ``chunk`` LM iterations from ``state``.  Running
    k chunks of n is bit-identical to one chunk of k*n (the scan body
    depends only on (problem, state)), which is what makes host-side
    checkpoint/resume exact."""
    n = mesh.shape[axis]
    obs_spec = _obs_spec(axis)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(obs_spec,),
        out_specs=_STATE_SPEC)
    def init_fn(p: BAProblem) -> BAState:
        return BAState(
            rotations=p.rotations, translations=p.translations,
            points=p.points,
            cost=_cost_of(p, axis, p.rotations, p.translations, p.points),
            lm_lambda=jnp.asarray(init_lambda))

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(obs_spec, _STATE_SPEC),
        out_specs=_STATE_SPEC)
    def step_fn(p: BAProblem, state: BAState) -> BAState:
        def body(state, _):
            q = p._replace(rotations=state.rotations,
                           translations=state.translations,
                           points=state.points)
            if solver == "cg":
                d_cam, d_pt = solve_schur_cg(
                    q, state.lm_lambda, cg_iters=cg_iters,
                    reduce=lambda x: jax.lax.psum(x, axis))
            else:
                local = normal_equation_terms(q)
                # The Schur reduction: every normal-equation term is a
                # sum over observations -> psum over the shards.
                terms = jax.lax.psum(local, axis)
                d_cam, d_pt = solve_schur(*terms, state.lm_lambda)
            rot, tr, pts = apply_step(q, d_cam, d_pt)
            new_cost = _cost_of(p, axis, rot, tr, pts)
            accept = new_cost < state.cost
            lam = jnp.clip(jnp.where(accept, state.lm_lambda * 0.5,
                                     state.lm_lambda * 4.0), 1e-8, 1e4)
            pick = lambda a, b: jnp.where(accept, a, b)
            return BAState(
                rotations=pick(rot, state.rotations),
                translations=pick(tr, state.translations),
                points=pick(pts, state.points),
                cost=pick(new_cost, state.cost), lm_lambda=lam), None

        out, _ = jax.lax.scan(body, state, None, length=chunk)
        return out

    def place(p: BAProblem) -> BAProblem:
        p = _pad_observations(p, n)
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            p, obs_spec)

    return jax.jit(init_fn), jax.jit(step_fn), place


def make_distributed_lm(mesh: Mesh, axis: str = "data",
                        iterations: int = 10,
                        init_lambda: float = 1e-4, solver: str = "dense",
                        cg_iters: int = 25):
    """Returns (fn, place) where fn(problem) runs the full LM loop with
    observations sharded over ``mesh[axis]`` and place(problem) shards a
    host-built BAProblem accordingly."""
    init, step, place = make_lm_stepper(
        mesh, axis, chunk=iterations, init_lambda=init_lambda,
        solver=solver, cg_iters=cg_iters)

    # jit the composition so callers keep .lower()/.compile() (the
    # multihost worker AOT-compiles before its cross-process barrier).
    fn = jax.jit(lambda p: step(p, init(p)))
    return fn, place
