"""Two-view epipolar geometry, batched.

Rebuild of the reference's RansacFilter::compute_fundamental /
compute_fundamental_residual (reference src/RansacFilter.cpp:69-140) and
extract_Rt (reference src/helpers.cpp:3-35), with the reference's known
defects fixed rather than replicated:

  * Hartley point normalization before the 8-point solve (the reference's
    TODO at src/RansacFilter.cpp:40).
  * Sampson error with the correct denominator (the reference's residual has
    an operator-precedence bug at src/RansacFilter.cpp:126: ``a/b + c`` where
    ``a/(b+c)`` was intended).
  * Full 4-candidate cheirality voting for E -> (R, t) (the reference picks R
    by a trace heuristic and forces t.z >= 0, src/helpers.cpp:28-33, both
    flagged TODO).

Everything is shaped for ``vmap``: the minimal solve maps over a hypotheses
axis, so thousands of 8-point problems run as one batched eigendecomposition —
the completed form of the per-thread model fit sketched in the reference's
unfinished CUDA kernel (src/ransac.cu:10-26).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def hartley_normalize(uv, mask):
    """Similarity transform sending masked points to zero-mean, mean distance
    sqrt(2). Returns (uv_norm (N,2), T (3,3))."""
    w = mask.astype(uv.dtype)
    n = jnp.maximum(w.sum(), 1.0)
    mean = (uv * w[:, None]).sum(axis=0) / n
    centered = (uv - mean) * w[:, None]
    dist = jnp.sqrt((centered ** 2).sum(axis=1) + 1e-12)
    mean_dist = (dist * w).sum() / n
    s = jnp.sqrt(2.0) / jnp.maximum(mean_dist, 1e-9)
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=uv.dtype
    )
    T = T.at[0, 0].set(s).at[1, 1].set(s).at[0, 2].set(-s * mean[0]).at[1, 2].set(-s * mean[1])
    return (uv - mean) * s, T


def _constraint_rows(uv1, uv2):
    """Epipolar constraint rows x2' F x1 = 0 (reference RansacFilter.cpp:79-89).
    uv1, uv2: (..., N, 2) -> (..., N, 9)."""
    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    one = jnp.ones_like(u1)
    return jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )


def fundamental_from_8pt(uv1, uv2, method: str = "jacobi", sweeps: int = 8):
    """Least-squares fundamental matrix from >=8 correspondences.

    Two null-space backends:
      * ``"jacobi"`` (default, the hot path): eigendecomposition of the
        9x9 normal matrix A^T A with the batched fixed-sweep Jacobi solver
        (ops/jacobi.py) and closed-form rank-2 projection F(I - v3 v3ᵀ).
        Branch-free, vmap-friendly — this is what runs inside RANSAC at
        thousands of hypotheses per frame.
      * ``"svd"``: LAPACK-grade SVD of A itself (error ∝ cond(A), not
        cond(A)^2) + SVD rank-2 projection. Use when a single maximally
        accurate estimate is needed.

    (The reference solves SVD-of-A serially per hypothesis,
    src/RansacFilter.cpp:94-101, and never normalizes points — TODO at :40.)

    Args:
      uv1, uv2: (N, 2) matched pixel coordinates (N static, typically 8).
    Returns:
      (3, 3) fundamental matrix with ||F|| = 1, rank 2, in pixel coordinates.
    """
    from ..ops import jacobi

    n1, T1 = hartley_normalize(uv1, jnp.ones(uv1.shape[0], bool))
    n2, T2 = hartley_normalize(uv2, jnp.ones(uv2.shape[0], bool))
    A = _constraint_rows(n1, n2)  # (N, 9)
    if method == "jacobi":
        f = jacobi.null_vector(A, sweeps=sweeps)
        F = f.reshape(3, 3)
        F = jacobi.rank2_project(F, sweeps=sweeps)
    else:
        _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        F = Vt[-1].reshape(3, 3)
        U, D, Vt = jnp.linalg.svd(F)
        F = (U * D.at[2].set(0.0)[None, :]) @ Vt
    # Denormalize: F_px = T2^T F T1
    F = T2.T @ F @ T1
    norm = jnp.linalg.norm(F) + 1e-12
    return F / norm


def sampson_error(F, uv1, uv2):
    """First-order geometric (Sampson) epipolar error, squared, in px^2.

    Correct form of the reference residual (src/RansacFilter.cpp:119-126).

    Args:
      F: (..., 3, 3); uv1, uv2: (N, 2).
    Returns:
      (..., N) squared Sampson distance.
    """
    ones = jnp.ones_like(uv1[..., :1])
    x1 = jnp.concatenate([uv1, ones], axis=-1)  # (N, 3)
    x2 = jnp.concatenate([uv2, ones], axis=-1)
    Fx1 = jnp.einsum("...ij,nj->...ni", F, x1)      # (..., N, 3)
    Ftx2 = jnp.einsum("...ji,nj->...ni", F, x2)     # (..., N, 3)
    num = jnp.einsum("ni,...ni->...n", x2, Fx1) ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    )
    return num / jnp.maximum(den, 1e-12)


def essential_from_fundamental(F, K):
    """E = K^T F K (reference src/helpers.cpp:4), with (1,1,0) singular-value
    projection so E is a valid essential matrix. 3x3 SVD via the batched
    Jacobi backend (ops/jacobi.py) — no LAPACK lowering inside the jit."""
    from ..ops import jacobi

    E = K.T @ F @ K
    U, D, Vt = jacobi.svd3(E)
    s = (D[0] + D[1]) * 0.5
    E = (U * jnp.array([1.0, 1.0, 0.0], E.dtype)[None, :] * s) @ Vt
    return E


def decompose_essential(E):
    """SVD decomposition of E into the 4 (R, t) candidates.

    Returns:
      Rs: (4, 3, 3) rotations (det +1), ts: (4, 3) unit translations.
    Convention: x2 = R x1 + t maps camera-1 coordinates to camera-2.
    """
    from ..ops import jacobi

    U, _, Vt = jacobi.svd3(E)
    # Keep proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / (jnp.linalg.norm(t) + 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def triangulate_midpoint_depths(K, R, t, uv1, uv2):
    """Fast two-view depths for cheirality voting (no SVD needed).

    Solves, per correspondence, the 2-unknown least-squares problem
    z2 * r2 = z1 * R r1 + t for (z1, z2), where r are unit rays.

    Returns (z1, z2): (..., N) depths in each camera.
    """
    K_inv = jnp.linalg.inv(K)
    ones = jnp.ones_like(uv1[..., :1])
    r1 = jnp.einsum("ij,nj->ni", K_inv, jnp.concatenate([uv1, ones], -1))
    r2 = jnp.einsum("ij,nj->ni", K_inv, jnp.concatenate([uv2, ones], -1))
    Rr1 = jnp.einsum("...ij,nj->...ni", R, r1)  # (..., N, 3)
    r2b = jnp.broadcast_to(r2, Rr1.shape)
    # minimize || z1 * Rr1 - z2 * r2 + t ||^2 over (z1, z2)
    a = jnp.sum(Rr1 * Rr1, -1)
    b = -jnp.sum(Rr1 * r2b, -1)
    c = jnp.sum(r2b * r2b, -1)
    tb = jnp.broadcast_to(t[..., None, :], Rr1.shape)
    d = -jnp.sum(Rr1 * tb, -1)
    e = jnp.sum(r2b * tb, -1)
    det = a * c - b * b
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    z1 = (d * c - b * e) / det
    z2 = (a * e - b * d) / det
    return z1, z2


def _t_basis(t):
    """(3, 2) orthonormal basis of the plane orthogonal to unit t, branch-free
    (Householder of t against the axis it is least aligned with)."""
    ax = jnp.argmin(jnp.abs(t))
    e = jnp.zeros(3, t.dtype).at[ax].set(1.0)
    b1 = jnp.cross(t, e)
    b1 = b1 / (jnp.linalg.norm(b1) + 1e-12)
    b2 = jnp.cross(t, b1)
    return jnp.stack([b1, b2], axis=1)


def refine_pose_gn(R, t, K, uv1, uv2, w, iters: int = 16,
                   huber_px: float = 1.0):
    """Robust IRLS Levenberg-Marquardt polish of (R, t) on the essential
    manifold SO(3) x S^2, minimizing Cauchy-robustified squared Sampson error
    (the Cauchy scale is ``huber_px`` converted to normalized coordinates).

    Why: the linear 8-point fit is statistically inefficient for
    near-forward motion — measured 40 deg translation-direction error on an
    oracle inlier set at 0.4 px noise where the maximum-likelihood estimate
    is ~1 deg. Five unknowns (3 rotation tangent + 2 translation-direction
    tangent), re-linearized each iteration; the (N,5) Jacobian comes from
    jacfwd over the 5 tangent params, so the whole solve is branch-free and
    jit/vmap-friendly (the reference has no counterpart — its extract_Rt
    heuristic stops at the linear estimate, src/helpers.cpp:3-35).

    Robustness design (both matter in practice):
      * IRLS weights are RE-DERIVED from the current residuals each
        iteration (Cauchy influence, normalized-coordinate residuals scaled
        to ~pixels by the focal length) rather than frozen from the caller's
        inlier mask — a frozen mask computed from a wrong starting model
        both excludes true inliers and keeps false ones, which biases the
        optimum by several degrees.
      * Adaptive LM damping (accept → lambda/4, reject → lambda*8) instead
        of a fixed epsilon: plain GN with step rejection stalls from starts
        tens of degrees away; LM converges from them.

    Args:
      R, t: initial rotation / unit translation (x2 = R x1 + t convention).
      w: (N,) prior weights treated as a BINARY mask (match participates iff
         w > 0); fractional weights are not honored — the per-iteration
         robust weights are derived from residuals alone.
      huber_px: robust-loss scale in pixels on the Sampson residual
         (Cauchy scale, historical name).
    Returns:
      (R, t, final_robust_cost) — the refined pose and the Cauchy cost of
      its final residuals (used by multi-start selection).
    """
    from ..core import lie

    K_inv = jnp.linalg.inv(K)
    ones = jnp.ones_like(uv1[..., :1])
    x1 = jnp.einsum("ij,nj->ni", K_inv, jnp.concatenate([uv1, ones], -1))
    x2 = jnp.einsum("ij,nj->ni", K_inv, jnp.concatenate([uv2, ones], -1))
    # Sampson residuals below live in normalized coords; scale the Huber
    # threshold to that unit (1 px ≈ 1/f in normalized coords).
    f = 0.5 * (K[0, 0] + K[1, 1])
    delta_h = huber_px / f
    valid = (w > 0).astype(uv1.dtype)

    def sampson_res(params, R0, t0):
        dw, dt = params[:3], params[3:]
        Rn = R0 @ lie.so3_exp(dw)
        tn = t0 + _t_basis(t0) @ dt
        tn = tn / (jnp.linalg.norm(tn) + 1e-12)
        E = lie.hat(tn) @ Rn
        Ex1 = jnp.einsum("ij,nj->ni", E, x1)
        Etx2 = jnp.einsum("ji,nj->ni", E, x2)
        num = jnp.einsum("ni,ni->n", x2, Ex1)
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return num / jnp.sqrt(jnp.maximum(den, 1e-18))

    def robust_w(r, c):
        # Cauchy influence weight: redescending, so gross outliers exert
        # ~zero pull. Huber is NOT enough here — its linear tail lets a
        # handful of gross false matches outweigh hundreds of inliers'
        # quadratic terms and shift the optimum by tens of degrees
        # (measured: Huber's global minimum sat 36 deg off ground truth on
        # a 300-inlier/6-outlier forward-motion pair; Cauchy's sits ~1 deg).
        return valid / (1.0 + (r / c) ** 2)

    def cost(r, c):
        # Cauchy rho, so accept/reject decisions match the IRLS objective.
        return jnp.sum(valid * 0.5 * c ** 2 * jnp.log1p((r / c) ** 2))

    def step(carry, c):
        R0, t0, lam = carry
        z = jnp.zeros(5, R0.dtype)
        r = sampson_res(z, R0, t0)
        rw = robust_w(r, c)
        J = jax.jacfwd(sampson_res)(z, R0, t0)          # (N, 5)
        Jw = J * rw[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        Hd = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-12)) \
            + 1e-10 * jnp.eye(5, dtype=R0.dtype)
        delta = -jnp.linalg.solve(Hd, g)
        r_new = sampson_res(delta, R0, t0)
        better = cost(r_new, c) < cost(r, c)
        delta = jnp.where(better, delta, jnp.zeros_like(delta))
        lam = jnp.where(better, lam * 0.25, lam * 8.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        R1 = R0 @ lie.so3_exp(delta[:3])
        t1 = t0 + _t_basis(t0) @ delta[3:]
        t1 = t1 / (jnp.linalg.norm(t1) + 1e-12)
        return (R1, t1, lam), None

    # NOTE: no scale annealing (GNC) here — a coarse Cauchy scale
    # reintroduces the outlier-biased landscape and anneals INTO its wrong
    # basin (measured 36 deg). Basin coverage is the caller's job via
    # multi-start (refine_pose_gn_multistart); each start polishes at the
    # fine, unbiased scale.
    sched = jnp.full((iters,), delta_h, R.dtype)
    lam0 = jnp.asarray(1e-3, R.dtype)
    (R, t, lam), _ = jax.lax.scan(step, (R, t, lam0), sched)
    r_fin = sampson_res(jnp.zeros(5, R.dtype), R, t)
    return R, t, cost(r_fin, jnp.asarray(delta_h, R.dtype))


def refine_pose_gn_multistart(R, t, K, uv1, uv2, w, iters: int = 16,
                              huber_px: float = 1.0,
                              spread_deg=(30.0, 60.0),
                              extra_starts=None):
    """Multi-start robust pose polish: run refine_pose_gn from the given
    (R, t) plus a fan of translation-direction perturbations on t's tangent
    plane, and keep the result with the lowest final robust cost.

    Why multi-start: the fine-scale Cauchy-Sampson landscape is nonconvex
    with local minima tens of degrees apart in translation direction for
    near-forward motion, and a RANSAC winner can start in the wrong basin
    (measured: single-start LM stuck at 26-45 deg; the correct basin's
    minimum sits at ~1.5 deg and has strictly lower robust cost). The
    rotation is well-observed — only t-direction needs basin coverage — so
    1 + 4*len(spread_deg) starts suffice. All starts run as one vmap; the
    selection is a single argmin, branch-free under jit.

    ``extra_starts``: optional (Rs (E,3,3), ts (E,3)) appended to the fan —
    e.g. the 4 decompositions of a consensus-refit essential matrix
    (geometry/ransac.py LO step). They cost nothing extra in latency: the
    scan depth is unchanged and the per-iteration work is batched over
    starts.
    """
    B = _t_basis(t)  # (3, 2)
    angs = jnp.deg2rad(jnp.asarray(spread_deg, t.dtype))
    ca, sa = jnp.cos(angs), jnp.sin(angs)
    dirs = []
    for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        d = B[:, 0] * sx + B[:, 1] * sy
        dirs.append(ca[:, None] * t[None, :] + sa[:, None] * d[None, :])
    t0s = jnp.concatenate([t[None, :]] + dirs, axis=0)     # (S, 3)
    R0s = jnp.broadcast_to(R, (t0s.shape[0], 3, 3))
    if extra_starts is not None:
        Re, te = extra_starts
        t0s = jnp.concatenate([t0s, te], axis=0)
        R0s = jnp.concatenate([R0s, Re], axis=0)
    t0s = t0s / (jnp.linalg.norm(t0s, axis=1, keepdims=True) + 1e-12)
    S = t0s.shape[0]

    run = lambda R0, t0: refine_pose_gn(R0, t0, K, uv1, uv2, w,
                                        iters=iters, huber_px=huber_px)
    Rs, ts, costs = jax.vmap(run)(R0s, t0s)
    costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)  # degenerate starts

    # Cheirality gate: the Cauchy-Sampson cost is exactly invariant under
    # t -> -t, so argmin alone can select a behind-camera solution when two
    # basins' costs nearly tie. Disambiguate each start's +/-t by in-front
    # vote, and disqualify starts whose cheirality support collapses.
    z1p, z2p = triangulate_midpoint_depths(K, Rs, ts, uv1, uv2)    # (S, N)
    z1m, z2m = triangulate_midpoint_depths(K, Rs, -ts, uv1, uv2)
    valid = (w > 0)[None, :]
    vp = ((z1p > 0) & (z2p > 0) & valid).sum(axis=1)
    vm = ((z1m > 0) & (z2m > 0) & valid).sum(axis=1)
    ts = jnp.where((vm > vp)[:, None], -ts, ts)
    votes = jnp.maximum(vp, vm)
    supported = votes >= jnp.maximum((0.5 * jnp.max(votes)).astype(votes.dtype), 1)
    costs = jnp.where(supported, costs, jnp.inf)
    best = jnp.argmin(costs)
    return Rs[best], ts[best]


def recover_pose(E, K, uv1, uv2, mask):
    """Select the (R, t) candidate with the most points in front of both
    cameras — the proper 4-way cheirality check the reference skipped
    (src/helpers.cpp:28-33).

    Args:
      E: (3,3); K: (3,3); uv1, uv2: (N,2) matches; mask: (N,) inlier mask.
    Returns:
      R (3,3), t (3,), votes (4,) in-front counts per candidate.
    """
    Rs, ts = decompose_essential(E)  # (4,3,3), (4,3)
    z1, z2 = triangulate_midpoint_depths(K, Rs, ts, uv1, uv2)  # (4, N)
    good = (z1 > 0) & (z2 > 0) & mask[None, :]
    votes = good.sum(axis=1)
    best = jnp.argmax(votes)
    return Rs[best], ts[best], votes
