"""Generic massively-parallel RANSAC.

This is the completed, batched form of the reference's two unfinished /
serial robust estimators:

  * the 100-iteration serial hypothesize-and-verify loop
    (reference src/RansacFilter.cpp:36-67), and
  * the CUDA kernel sketch where each thread fits a model on one minimal
    sample and a tree reduction selects the best
    (reference src/ransac.cu:8-26 — non-compiling intent statement).

Design: the hypothesis count H is a *batch dimension*. Minimal samples are
drawn with a Gumbel top-k trick (vectorized sampling without replacement),
the model fit is ``vmap``-ed over H (thousands of 9x9 eigendecompositions in
one XLA op), verification is one (H, N) residual broadcast, and selection is
an argmax over inlier counts — the "tree reduction" of ransac.cu:20-24,
expressed as a single collective-friendly reduction. When a device mesh is
present, H shards across chips and the argmax rides ICI (see
parallel/sharded.py).

Scoring: inlier count with MSAC-style truncated-loss tie-breaking (lower
truncated residual sum wins among equal counts) — strictly better than the
reference's buggy tie-break that preferred *larger* residual sums
(src/RansacFilter.cpp:59).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: jnp.ndarray        # best model parameters
    inliers: jnp.ndarray      # (N,) bool inlier mask for the best model
    num_inliers: jnp.ndarray  # () i32
    best_score: jnp.ndarray   # () f32 truncated residual sum of best model
    success: jnp.ndarray      # () bool


def sample_minimal_sets(key, weights, num_hypotheses: int, sample_size: int):
    """Draw (H, S) index sets over the valid entries.

    Vectorized equivalent of the reference's swap-and-pop Fisher-Yates
    sampler (src/RansacFilter.cpp:19-32), batched: the valid indices are
    compacted once (one N-element sort), then each hypothesis draws S
    uniform positions into the compacted list. Within-set duplicates are
    possible but rare (p ≈ S²/2n); a duplicated row only degrades that one
    hypothesis's fit, which the inlier vote discards — far cheaper than the
    per-hypothesis Gumbel top-k (an (H, N) sort) that exact
    without-replacement sampling would cost.

    Args:
      key: PRNG key.
      weights: (N,) nonnegative sampling weights (0 excludes an index).
    Returns:
      (H, S) int32 indices (entries with weight 0 are never selected,
      provided at least one weight is positive).
    """
    n = weights.shape[0]
    valid = weights > 0
    n_valid = jnp.maximum(valid.sum().astype(jnp.int32), 1)
    # compact: valid indices first (stable argsort of the invalid flag)
    order = jnp.argsort(jnp.where(valid, 0, 1), stable=True).astype(jnp.int32)
    pos = jax.random.randint(key, (num_hypotheses, sample_size), 0, n_valid)
    return order[pos]


def ransac(
    key,
    fit_fn: Callable,
    residual_fn: Callable,
    data_fit,
    data_verify,
    valid_mask,
    num_hypotheses: int,
    sample_size: int,
    inlier_threshold: float,
    min_inliers: int = 8,
) -> RansacResult:
    """Generic batched hypothesize-and-verify.

    Args:
      fit_fn: pytree_of_(S,…)-samples -> model. Will be vmapped over H.
      residual_fn: (model, data_verify) -> (N,) squared residuals. vmapped.
      data_fit: pytree of (N, …) arrays gathered for minimal samples.
      data_verify: pytree passed whole to residual_fn.
      valid_mask: (N,) bool — which of the N rows are real data.
      inlier_threshold: squared-residual threshold.
    """
    n = valid_mask.shape[0]
    idx = sample_minimal_sets(
        key, valid_mask.astype(jnp.float32), num_hypotheses, sample_size
    )  # (H, S)

    samples = jax.tree_util.tree_map(lambda a: a[idx], data_fit)  # (H, S, …)
    models = jax.vmap(fit_fn)(samples)

    resid = jax.vmap(lambda m: residual_fn(m, data_verify))(models)  # (H, N)
    resid = jnp.where(valid_mask[None, :], resid, jnp.inf)
    inlier = resid <= inlier_threshold
    counts = inlier.sum(axis=1)  # (H,)
    # MSAC truncated loss (for tie-breaking and refinement quality signal)
    trunc = jnp.minimum(resid, inlier_threshold)
    trunc = jnp.where(jnp.isfinite(trunc), trunc, 0.0)
    score = trunc.sum(axis=1)

    # Select: max count, then min truncated score. Combine into one sort key:
    # the normalized score term is < 1, so it only breaks count ties.
    combined = counts.astype(jnp.float32) - score / (score.max() + 1.0)
    best = jnp.argmax(combined)

    best_model = jax.tree_util.tree_map(lambda m: m[best], models)
    best_inliers = inlier[best] & valid_mask
    num = best_inliers.sum().astype(jnp.int32)
    return RansacResult(
        model=best_model,
        inliers=best_inliers,
        num_inliers=num,
        best_score=score[best],
        success=num >= min_inliers,
    )


def ransac_fundamental(
    key,
    uv1,
    uv2,
    valid_mask,
    num_hypotheses: int = 2048,
    inlier_threshold: float = 2.0,
    min_inliers: int = 15,
    refine: bool = True,
) -> RansacResult:
    """RANSAC fundamental-matrix estimation over padded match arrays.

    The batched replacement for RansacFilter::find_fundamental
    (reference src/RansacFilter.cpp:36-67).

    Args:
      uv1, uv2: (N, 2) matched pixel coordinates (padded).
      valid_mask: (N,) bool.
    """
    from . import epipolar

    def fit(sample):
        s1, s2 = sample
        return epipolar.fundamental_from_8pt(s1, s2)

    def residual(F, data):
        d1, d2 = data
        return epipolar.sampson_error(F, d1, d2)

    result = ransac(
        key,
        fit,
        residual,
        data_fit=(uv1, uv2),
        data_verify=(uv1, uv2),
        valid_mask=valid_mask,
        num_hypotheses=num_hypotheses,
        sample_size=8,
        inlier_threshold=inlier_threshold,
        min_inliers=min_inliers,
    )
    if refine:
        # One least-squares polish on all inliers (weighted 8-point): the
        # classical local-optimization step the reference lacks.
        w = result.inliers.astype(uv1.dtype)
        F = _weighted_eight_point(uv1, uv2, w)
        resid = epipolar.sampson_error(F, uv1, uv2)
        inl = (resid <= inlier_threshold) & valid_mask
        better = inl.sum() >= result.num_inliers
        F = jnp.where(better, F, result.model)
        inl = jnp.where(better, inl, result.inliers)
        result = result._replace(
            model=F, inliers=inl, num_inliers=inl.sum().astype(jnp.int32)
        )
    return result


class PoseRansacResult(NamedTuple):
    model: jnp.ndarray        # (3, 3) fundamental matrix of the winner
    R: jnp.ndarray            # (3, 3) rotation, x2 = R x1 + t
    t: jnp.ndarray            # (3,) unit translation
    inliers: jnp.ndarray      # (N,) bool — Sampson inliers in front of both cams
    num_inliers: jnp.ndarray  # () i32
    votes: jnp.ndarray        # (4,) cheirality votes of the winning hypothesis
    success: jnp.ndarray      # () bool


def ransac_pose(
    key,
    uv1,
    uv2,
    valid_mask,
    K,
    num_hypotheses: int = 2048,
    inlier_threshold: float = 2.0,
    min_inliers: int = 15,
    refine: bool = True,
    fit_sweeps: int = 4,
    vote_stride: int = 6,
    verify_stride: int = 4,
    topk: int = 16,
    refine_iters: int = 10,
) -> PoseRansacResult:
    """Relative-pose RANSAC with cheirality-aware model selection.

    Plain F-RANSAC scores hypotheses by Sampson-inlier count alone, which is
    treacherous under near-forward motion: a geometrically wrong F can cover
    one extra false match and win while triangulating points *behind* the
    cameras (measured: 59 deg translation error on a synthetic pair where the
    runner-up model had 0.6 deg). Here every hypothesis is decomposed to its
    four (R, t) candidates and scored by the number of Sampson inliers that
    are also in front of BOTH cameras — the physically meaningful consensus.

    Two-stage verification: the (H, N) residual broadcast and the
    (H, 4, N') depth votes dominate the stage's device-memory
    traffic, yet their only job is to RANK hypotheses — the winner's exact
    inlier set is recomputed anyway. Stage 1 therefore scores every
    hypothesis on a ``verify_stride``-strided subset of the matches (plus
    the further ``vote_stride``-strided cheirality votes), and stage 2
    re-scores only the ``topk`` leaders on the full match set, selecting
    the final winner from those exact counts. With ~50% inlier rates a
    768-match subset misranks the true best out of the top 16 with
    vanishing probability, and the final selection never sees subset
    counts.

    This is the completed, physically-grounded form of the reference's
    find_fundamental + extract_Rt pipeline (src/RansacFilter.cpp:36-67,
    src/helpers.cpp:3-35 — which picked R by a trace heuristic and forced
    t.z >= 0 instead of voting).
    """
    from . import epipolar

    idx = sample_minimal_sets(
        key, valid_mask.astype(jnp.float32), num_hypotheses, 8
    )  # (H, 8)
    # Low-sweep Jacobi for the hypothesis fits: a hypothesis only needs to
    # rank well; the winner is re-fit at full accuracy in the LO step.
    fit = lambda s1, s2: epipolar.fundamental_from_8pt(s1, s2,
                                                       sweeps=fit_sweeps)
    Fs = jax.vmap(fit)(uv1[idx], uv2[idx])                  # (H,3,3)

    combined_v, Rs, ts = _pose_stage1(
        Fs, uv1, uv2, valid_mask, K, inlier_threshold,
        verify_stride, vote_stride)

    # ---- stage 2: full-N re-scoring of the top-k leaders ----------------
    k = min(int(topk), num_hypotheses)
    _, lead = jax.lax.top_k(combined_v, k)                  # (k,)
    F, R, t, best_votes, inl, num = _pose_stage2(
        Fs[lead], Rs[lead], ts[lead], uv1, uv2, valid_mask, K,
        inlier_threshold)

    if refine:
        F, R, t, inl, num = _pose_refine(
            R, t, inl, uv1, uv2, valid_mask, K, inlier_threshold,
            refine_iters)

    return PoseRansacResult(
        model=F,
        R=R,
        t=t,
        inliers=inl,
        num_inliers=num,
        votes=best_votes,
        success=num >= min_inliers,
    )


def _pose_stage1(Fs, uv1, uv2, valid_mask, K, inlier_threshold,
                 verify_stride, vote_stride, score_norm_fn=None):
    """Subset scoring of a batch of F hypotheses.

    Returns (combined (H,) selection score, Rs (H,4,3,3), ts (H,4,3)).
    ``score_norm_fn``: optional reducer applied to the local
    ``score.max()`` normalizer — the hypothesis-sharded caller passes
    ``lambda m: lax.pmax(m, axis)`` so per-device scores share one global
    normalizer and are comparable across shards.
    """
    from . import epipolar

    sv = max(int(verify_stride), 1)
    uv1v, uv2v = uv1[::sv], uv2[::sv]
    maskv = valid_mask[::sv]
    resid_v = epipolar.sampson_error(Fs, uv1v, uv2v)        # (H, N/sv)
    resid_v = jnp.where(maskv[None, :], resid_v, jnp.inf)
    samp_v = resid_v <= inlier_threshold

    # 4-way decomposition + in-front votes for every hypothesis at once,
    # on a further-strided subsample of the subset.
    Es = jnp.einsum("ji,hjk,kl->hil", K, Fs, K)             # K^T F K, (H,3,3)
    Rs, ts = jax.vmap(epipolar.decompose_essential)(Es)     # (H,4,3,3),(H,4,3)
    # effective global vote stride = sv * vs: round so it lands nearest
    # the requested vote_stride (6 // 4 floored to 1 silently voted over
    # the WHOLE verify subset — 1.5x the device-memory traffic of the r03 code this
    # stage replaced)
    vs = max(round(int(vote_stride) / sv), 1)
    uv1s, uv2s = uv1v[::vs], uv2v[::vs]
    z1, z2 = epipolar.triangulate_midpoint_depths(K, Rs, ts, uv1s, uv2s)
    good = samp_v[:, None, ::vs] & (z1 > 0) & (z2 > 0)
    votes_s = good.sum(axis=2)                              # (H, 4) sampled
    counts_v = votes_s.max(axis=1)                          # (H,)

    # MSAC truncated loss for tie-breaking among equal subset counts.
    trunc = jnp.minimum(resid_v, inlier_threshold)
    trunc = jnp.where(jnp.isfinite(trunc), trunc, 0.0)
    score_v = trunc.sum(axis=1)
    norm = score_v.max()
    if score_norm_fn is not None:
        norm = score_norm_fn(norm)
    combined_v = counts_v.astype(jnp.float32) - score_v / (norm + 1.0)
    return combined_v, Rs, ts


def _pose_stage2_rank(Fk, Rk, tk, uv1, uv2, valid_mask, K,
                      inlier_threshold):
    """The per-match half of stage 2 over (a slice of) the match axis:
    per-leader cheirality votes (k, 4) and truncated-residual scores (k,).
    Pure sums over matches — a sharded caller computes this on an N/D
    slice per device and psums the two outputs
    (parallel/sharded_ransac.py); the sums are then identical to the
    single-device full-N quantities."""
    from . import epipolar

    resid_k = epipolar.sampson_error(Fk, uv1, uv2)          # (k, N)
    resid_k = jnp.where(valid_mask[None, :], resid_k, jnp.inf)
    samp_k = resid_k <= inlier_threshold
    z1k, z2k = epipolar.triangulate_midpoint_depths(
        K, Rk, tk, uv1, uv2)                                # (k, 4, N)
    good_k = samp_k[:, None, :] & (z1k > 0) & (z2k > 0)
    votes_k = good_k.sum(axis=2)                            # (k, 4)
    trunc_k = jnp.minimum(resid_k, inlier_threshold)
    trunc_k = jnp.where(jnp.isfinite(trunc_k), trunc_k, 0.0)
    score_k = trunc_k.sum(axis=1)                           # (k,)
    return votes_k, score_k


def _pose_stage2_select(Fk, Rk, tk, votes_k, score_k, uv1, uv2, valid_mask,
                        K, inlier_threshold):
    """Winner selection from (full-N) votes/scores + the winner's exact
    inlier mask. The single-model mask recompute is 1/k of the ranking
    work, so a sharded caller runs it replicated."""
    from . import epipolar

    counts_k = votes_k.max(axis=1)
    cand_k = votes_k.argmax(axis=1)
    combined_k = counts_k.astype(jnp.float32) \
        - score_k / (score_k.max() + 1.0)
    bk = jnp.argmax(combined_k)

    F = Fk[bk]
    R = Rk[bk, cand_k[bk]]
    t = tk[bk, cand_k[bk]]
    best_votes = votes_k[bk]                                # (4,)
    resid = epipolar.sampson_error(F[None], uv1, uv2)[0]
    samp = (resid <= inlier_threshold) & valid_mask
    z1, z2 = epipolar.triangulate_midpoint_depths(K, R, t, uv1, uv2)  # (N,)
    inl = samp & (z1 > 0) & (z2 > 0)
    num = inl.sum().astype(jnp.int32)
    return F, R, t, best_votes, inl, num


def _pose_stage2(Fk, Rk, tk, uv1, uv2, valid_mask, K, inlier_threshold):
    """Full-N re-scoring of the k leader hypotheses; exact winner pick.

    Returns (F, R, t, votes (4,), inliers (N,), num ()).
    """
    votes_k, score_k = _pose_stage2_rank(
        Fk, Rk, tk, uv1, uv2, valid_mask, K, inlier_threshold)
    return _pose_stage2_select(
        Fk, Rk, tk, votes_k, score_k, uv1, uv2, valid_mask, K,
        inlier_threshold)


def _pose_refine(R, t, inl, uv1, uv2, valid_mask, K, inlier_threshold,
                 refine_iters):
    """LO + multistart ML polish of the RANSAC winner.

    LO: least-squares F on the physically-consistent consensus gives a
    statistically stronger linear estimate; its four (R, t) decompositions
    join the multistart fan as EXTRA STARTS rather than running as a
    serial accept/reject stage — the r03 pipeline chained weighted-8pt ->
    recover_pose -> re-vote -> multistart sequentially, ~1.5 ms of
    latency-bound small kernels; as fan starts they ride the same vmap
    for free and the robust-cost argmin keeps whichever basin wins
    (measured equal accuracy on the forward-motion suite).
    """
    from . import epipolar

    w = inl.astype(uv1.dtype)
    F2 = _weighted_eight_point(uv1, uv2, w, sweeps=6)
    E2 = K.T @ F2 @ K
    R4, t4 = epipolar.decompose_essential(E2)               # (4,3,3),(4,3)
    # Robust multi-start IRLS-LM on the essential manifold (the linear
    # 8-point estimate is far from the ML optimum for near-forward
    # motion; see epipolar.refine_pose_gn*). Pass the full valid mask,
    # not the frozen consensus: the refiner re-derives robust weights
    # per iteration, so true inliers the (possibly wrong) winner
    # missed are reclaimed and false ones down-weighted.
    R, t = epipolar.refine_pose_gn_multistart(
        R, t, K, uv1, uv2, valid_mask.astype(uv1.dtype),
        iters=refine_iters, extra_starts=(R4, t4))
    from ..core import lie
    E3 = lie.hat(t) @ R
    K_inv = jnp.linalg.inv(K)
    F = K_inv.T @ E3 @ K_inv
    F = F / (jnp.linalg.norm(F) + 1e-12)
    r3 = epipolar.sampson_error(F, uv1, uv2)
    s3 = (r3 <= inlier_threshold) & valid_mask
    z1g, z2g = epipolar.triangulate_midpoint_depths(K, R, t, uv1, uv2)
    inl = s3 & (z1g > 0) & (z2g > 0)
    num = inl.sum().astype(jnp.int32)
    return F, R, t, inl, num


def _weighted_eight_point(uv1, uv2, w, sweeps: int = 10):
    """Weighted least-squares F over all (masked) correspondences."""
    from . import epipolar

    from ..ops import jacobi

    mask = w > 0
    n1, T1 = epipolar.hartley_normalize(uv1, mask)
    n2, T2 = epipolar.hartley_normalize(uv2, mask)
    A = epipolar._constraint_rows(n1, n2) * w[:, None]
    F = jacobi.null_vector(A, sweeps=sweeps).reshape(3, 3)
    F = jacobi.rank2_project(F, sweeps=8)
    F = T2.T @ F @ T1
    return F / (jnp.linalg.norm(F) + 1e-12)
