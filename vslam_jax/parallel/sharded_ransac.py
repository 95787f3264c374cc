"""RANSAC with the hypothesis axis sharded across a device mesh.

The multi-chip completion of the reference's CUDA sketch
(reference src/ransac.cu:8-26): every device fits and scores its own slice of
the hypothesis batch (data-parallel model fits), then a cross-device
arg-best reduction — all_gather of per-device best (count, score, model) over
ICI — selects the winner. Matches/masks are replicated (they are small:
(N, 2) pixel arrays).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geometry import ransac as ransac_mod
from ..geometry.ransac import RansacResult

# Stage-2 leader count of ransac_pose_hypsharded. Shared with the
# sharded-tracker fallback gate (sharded_tracker.py): selection parity
# requires every device's per-device hypothesis count H/D >= this top-k,
# and the gate + the trace-time assert below must agree on the value
# (ADVICE r04 — a hardcoded literal in the gate could silently diverge).
POSE_TOPK = 16


def ransac_fundamental_sharded(
    mesh: Mesh,
    axis_name: str,
    key,
    uv1,
    uv2,
    valid_mask,
    num_hypotheses: int = 2048,
    inlier_threshold: float = 2.0,
    min_inliers: int = 15,
) -> RansacResult:
    """Hypotheses split evenly across ``mesh``'s ``axis_name`` axis.

    num_hypotheses is the GLOBAL count; each device runs its share with an
    independent PRNG key, then the best model is selected globally.
    """
    n_dev = mesh.shape[axis_name]
    assert num_hypotheses % n_dev == 0
    local_h = num_hypotheses // n_dev
    keys = jax.random.split(key, n_dev)  # (n_dev, 2) — sharded along axis

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(), P(), P()),
        out_specs=P(),
        check_vma=False,  # outputs ARE replicated (post all_gather/psum) but
                          # the static checker cannot prove it
    )
    def run(local_keys, uv1, uv2, mask):
        res = ransac_mod.ransac_fundamental(
            local_keys[0], uv1, uv2, mask,
            num_hypotheses=local_h,
            inlier_threshold=inlier_threshold,
            min_inliers=min_inliers,
            refine=False,
        )
        # global arg-best: gather per-device (count, score, model)
        counts = jax.lax.all_gather(res.num_inliers, axis_name)   # (n_dev,)
        scores = jax.lax.all_gather(res.best_score, axis_name)
        models = jax.lax.all_gather(res.model, axis_name)          # (n_dev,3,3)
        combined = counts.astype(jnp.float32) - scores / (scores.max() + 1.0)
        best = jnp.argmax(combined)
        F = models[best]
        # recompute inliers of the winning model (replicated, cheap)
        from ..geometry import epipolar
        resid = epipolar.sampson_error(F, uv1, uv2)
        inl = (resid <= inlier_threshold) & mask
        num = inl.sum().astype(jnp.int32)
        return RansacResult(
            model=F,
            inliers=inl,
            num_inliers=num,
            best_score=scores[best],
            success=num >= min_inliers,
        )

    result = run(keys, uv1, uv2, valid_mask)
    # final polish on all inliers (single-device, replicated inputs)
    w = result.inliers.astype(uv1.dtype)
    F = ransac_mod._weighted_eight_point(uv1, uv2, w)
    from ..geometry import epipolar
    resid = epipolar.sampson_error(F, uv1, uv2)
    inl = (resid <= inlier_threshold) & valid_mask
    better = inl.sum() >= result.num_inliers
    F = jnp.where(better, F, result.model)
    inl = jnp.where(better, inl, result.inliers)
    return result._replace(model=F, inliers=inl,
                           num_inliers=inl.sum().astype(jnp.int32))


def ransac_pose_hypsharded(
    axis_name: str,
    n_dev: int,
    key,
    uv1,
    uv2,
    valid_mask,
    K,
    num_hypotheses: int = 2048,
    inlier_threshold: float = 2.0,
    min_inliers: int = 15,
    fit_sweeps: int = 4,
    vote_stride: int = 6,
    verify_stride: int = 4,
    topk: int = POSE_TOPK,
    refine_iters: int = 10,
):
    """``geometry.ransac.ransac_pose`` with the hypothesis axis split over
    an ALREADY-ENTERED shard_map axis (call this INSIDE the shard_map body —
    sharded_tracker.run_sharded does).

    The multi-chip completion of the reference CUDA sketch's reduction
    (reference src/ransac.cu:20-24) for the POSE estimator: the heavy
    stage-1 work (per-hypothesis 8-point fits + subset Sampson scores +
    cheirality votes) runs on a 1/D slice of one GLOBAL sample batch per
    device; each device's local top-k leaders are all_gather'd (k models +
    scores, tiny), the
    union is re-ranked with a deterministic (score desc, global-index asc)
    order, and the exact full-N stage-2 selection + LO/multistart refine
    run replicated — so the outputs are replicated and the SELECTED MODEL
    is the one the unsharded program would pick from the same global batch
    (identical sampling: every device draws the same (H, 8) index batch
    from the same key and slices its share).

    Model-selection parity with the unsharded ransac_pose holds because
    the union of per-device top-k contains the global top-k (k_local ==
    k_global) and stage-2 scores are computed identically; per-hypothesis
    f32 stage-1 scores can drift at compilation-tiling level across batch
    shapes, which only matters for near-exact score ties among leaders
    (tests/test_sharded_tracking.py asserts the selection agreement).
    """
    from ..geometry.ransac import (PoseRansacResult, _pose_refine,
                                   _pose_stage1, _pose_stage2)

    H = num_hypotheses
    assert H % n_dev == 0, (H, n_dev)
    Hl = H // n_dev
    # parity requires each local top-k to be able to contain the global
    # top-k; callers fall back to the replicated path below this
    # (sharded_tracker.run_sharded does)
    assert Hl >= topk, (Hl, topk)
    # one GLOBAL sample batch, identical on every device (the (H, 8) int
    # sampling is negligible next to one device's fits)
    idx = ransac_mod.sample_minimal_sets(
        key, valid_mask.astype(jnp.float32), H, 8)          # (H, 8)
    me = jax.lax.axis_index(axis_name)
    idx_l = jax.lax.dynamic_slice_in_dim(idx, me * Hl, Hl, axis=0)

    from ..geometry import epipolar
    fit = lambda s1, s2: epipolar.fundamental_from_8pt(s1, s2,
                                                       sweeps=fit_sweeps)
    Fs = jax.vmap(fit)(uv1[idx_l], uv2[idx_l])              # (Hl,3,3)

    cv, Rs, ts = _pose_stage1(
        Fs, uv1, uv2, valid_mask, K, inlier_threshold, verify_stride,
        vote_stride,
        score_norm_fn=lambda m: jax.lax.pmax(m, axis_name))

    k = int(topk)
    sc_l, lead_l = jax.lax.top_k(cv, k)                     # local leaders
    gid_l = me * Hl + lead_l                                # global hyp ids

    # gather the k leaders of every device: (D*k) candidates, tiny payload
    sc = jax.lax.all_gather(sc_l, axis_name).reshape(-1)
    gid = jax.lax.all_gather(gid_l, axis_name).reshape(-1)
    Fg = jax.lax.all_gather(Fs[lead_l], axis_name).reshape(-1, 3, 3)
    Rg = jax.lax.all_gather(Rs[lead_l], axis_name).reshape(-1, 4, 3, 3)
    tg = jax.lax.all_gather(ts[lead_l], axis_name).reshape(-1, 4, 3)

    # deterministic global re-rank: score desc, global index asc on ties —
    # the same order a single top_k over the full batch would produce
    order = jnp.lexsort((gid, -sc))
    sel = order[:k]
    # stage-2 ranking SHARDED OVER THE MATCH AXIS (a replicated stage-2 +
    # refine tail would not shrink with D): each device scores the k
    # leaders on its N/D match
    # slice; the per-leader (votes, score) sums psum to the exact full-N
    # quantities, so selection is identical to the replicated program.
    # The winner's single-model inlier mask and the multistart refine stay
    # replicated (1/k of the ranking work and latency-bound respectively).
    N = uv1.shape[0]
    if N % n_dev == 0:
        Nl = N // n_dev
        s0 = me * Nl
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s0, Nl, axis=0)
        votes_k, score_k = ransac_mod._pose_stage2_rank(
            Fg[sel], Rg[sel], tg[sel], sl(uv1), sl(uv2), sl(valid_mask),
            K, inlier_threshold)
        votes_k = jax.lax.psum(votes_k, axis_name)
        score_k = jax.lax.psum(score_k, axis_name)
    else:
        votes_k, score_k = ransac_mod._pose_stage2_rank(
            Fg[sel], Rg[sel], tg[sel], uv1, uv2, valid_mask, K,
            inlier_threshold)
    F, R, t, best_votes, inl, num = ransac_mod._pose_stage2_select(
        Fg[sel], Rg[sel], tg[sel], votes_k, score_k, uv1, uv2, valid_mask,
        K, inlier_threshold)
    F, R, t, inl, num = _pose_refine(
        R, t, inl, uv1, uv2, valid_mask, K, inlier_threshold, refine_iters)

    return PoseRansacResult(
        model=F, R=R, t=t, inliers=inl, num_inliers=num,
        votes=best_votes, success=num >= min_inliers,
    )
