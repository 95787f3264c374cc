"""Bundle adjustment: Gauss-Newton / Levenberg-Marquardt with Schur complement.

This is the component the reference declared but never built — its
``optimzer.cpp`` is a 9-line non-compiling stub holding exactly the three
ingredients of a BA problem: initial poses, landmark priors, measurements
(reference src/optimzer.cpp:4-8). Completed here as static-shape array
programs:

  * **Static shapes**: the problem is (C cams, P points, K obs-slots/point) in
    point-major layout — every point owns up to K observations
    ``(cam_idx, uv, mask)``. Point-major is the layout that makes landmark
    elimination local: all of a point's data sits in one row, so the Schur
    products never need gather-by-point.
  * **Batched small algebra**: per-observation 2x6 / 2x3 Jacobians in closed
    form, 3x3 landmark Hessians inverted in closed form, everything vmapped.
  * **Schur complement**: S = H_cc - W H_pp^-1 W^T assembled by scanning
    fixed-size point blocks and scatter-adding 6x6 camera blocks — bounded
    memory at any P. The reduced (6C, 6C) system is solved densely (window
    BA keeps C small).
  * **LM loop** under ``lax.scan`` with accept/reject and damping adaptation —
    no host round-trips inside the optimization.
  * **Sharding**: the point axis is the natural shard dimension; the
    distributed variant (parallel/sharded_ba.py) psums the camera-side
    reductions (H_cc, b_c, S contributions) across the mesh, which is the
    collective pattern SURVEY.md §5 calls for.

Conventions: cameras are stored as T_cw (world->camera); updates are
left-multiplicative se(3): T_cw <- exp(xi) T_cw.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import BAConfig
from ..core import lie
from ..core.types import pytree_dataclass


@pytree_dataclass
class BAProblem:
    """Point-major bundle-adjustment problem (all shapes static)."""
    T_cw: jnp.ndarray        # (C, 4, 4) world->camera extrinsics
    cam_fixed: jnp.ndarray   # (C,) bool — gauge-fixed cameras (no update)
    cam_mask: jnp.ndarray    # (C,) bool — camera slot in use
    points: jnp.ndarray      # (P, 3) world landmarks
    point_mask: jnp.ndarray  # (P,) bool
    obs_cam: jnp.ndarray     # (P, K) i32 camera index per observation
    obs_uv: jnp.ndarray      # (P, K, 2) f32 pixel measurement
    obs_mask: jnp.ndarray    # (P, K) bool

    @property
    def num_cams(self) -> int:
        return self.T_cw.shape[0]


class BAStats(NamedTuple):
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    accepted: jnp.ndarray      # (iters,) bool
    costs: jnp.ndarray         # (iters,) f32


def _project_residual(T_cw, X, uv, K_intr):
    """Per-observation residual and camera-frame point.

    T_cw: (..., 4, 4); X: (..., 3); uv: (..., 2). Returns r (..., 2), Xc (..., 3).
    """
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    Xc = jnp.einsum("...ij,...j->...i", R, X) + t
    z = Xc[..., 2]
    safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    fx, fy = K_intr[0, 0], K_intr[1, 1]
    cx, cy = K_intr[0, 2], K_intr[1, 2]
    u = fx * Xc[..., 0] / safe + cx
    v = fy * Xc[..., 1] / safe + cy
    r = jnp.stack([u, v], axis=-1) - uv
    return r, Xc


def _jacobians(Xc, R, K_intr):
    """Closed-form Jacobians.

    Xc: (..., 3) camera-frame point; R: (..., 3, 3) rotation of T_cw.
    Returns J_c (..., 2, 6) wrt left se(3) perturbation of T_cw,
            J_p (..., 2, 3) wrt the world point.
    """
    fx, fy = K_intr[0, 0], K_intr[1, 1]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    # dpi/dXc : (..., 2, 3)
    dpi = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1),
        ],
        axis=-2,
    )
    # dXc/dxi = [I | -hat(Xc)] : (..., 3, 6)
    hatX = lie.hat(Xc)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), hatX.shape)
    dX_dxi = jnp.concatenate([eye, -hatX], axis=-1)
    J_c = dpi @ dX_dxi               # (..., 2, 6)
    J_p = dpi @ R                    # (..., 2, 3)
    return J_c, J_p


def _huber_weight(r, delta):
    """Scalar robust weight per observation (applied to both components)."""
    nrm = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
    return jnp.where(nrm <= delta, 1.0, delta / nrm)


def _huber_cost(r, mask, delta):
    n = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
    c = jnp.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return jnp.sum(jnp.where(mask, c, 0.0))


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def compute_cost(problem: BAProblem, K_intr, huber_delta: float,
                 axis_name: str | None = None):
    T = problem.T_cw[jnp.clip(problem.obs_cam, 0, problem.num_cams - 1)]
    r, Xc = _project_residual(T, problem.points[:, None, :], problem.obs_uv, K_intr)
    mask = problem.obs_mask & problem.point_mask[:, None] & (Xc[..., 2] > 1e-3)
    c = _huber_cost(r, mask, huber_delta)
    if axis_name is not None:
        c = jax.lax.psum(c, axis_name)
    return c


def _gn_quantities(T_cw, points, problem: BAProblem, K_intr, huber_delta):
    """All per-observation GN ingredients in point-major layout.

    Returns dict with r (P,K,2), w (P,K), J_c (P,K,2,6), J_p (P,K,2,3), mask.
    """
    C = T_cw.shape[0]
    cam_idx = jnp.clip(problem.obs_cam, 0, C - 1)
    T = T_cw[cam_idx]                                  # (P, K, 4, 4)
    r, Xc = _project_residual(T, points[:, None, :], problem.obs_uv, K_intr)
    mask = problem.obs_mask & problem.point_mask[:, None] & (Xc[..., 2] > 1e-3)
    J_c, J_p = _jacobians(Xc, T[..., :3, :3], K_intr)
    w = _huber_weight(r, huber_delta) * mask.astype(r.dtype)
    return r, w, J_c, J_p, mask


def _schur_reduce(r, w, J_c, J_p, problem: BAProblem, lam, block: int = 512,
                  axis_name: str | None = None,
                  assembly: str = "onehot"):
    """Build the reduced camera system.

    When ``axis_name`` is set, the point axis is assumed sharded across that
    mesh axis: the camera-side reductions (S blocks, b_c) are psum'd so every
    device holds the full reduced system — the Schur-complement collective
    pattern of SURVEY.md §5 (per-shard landmark elimination, camera-block
    Hessian reduction as a collective).

    ``assembly`` picks how camera-indexed reductions are built:
      * "onehot"  — everything is dense matmuls against a (P, K, C) one-hot
        camera-incidence tensor: S = H_cc - A·Bᵀ with A = Σ_k E·(W·Hpp⁻¹),
        B = Σ_k E·W contracted per point. All matmuls, no scatters; cost
        scales with C², where scatter-adding P·K² 6x6 blocks collides on
        camera rows. The S product is one (6C, 3P)x(3P, 6C) matmul.
        One-hot won a race on the earlier accelerator; re-race on the H100
        pending. The auto threshold
        (BAConfig.onehot_max_cams = 256) is a MEMORY bound: the (P, C,
        6, 3) aggregated factors scale as C*P (~2.4 GB at C=256/P=64k),
        not a speed crossover.
      * "scatter" — the original blocked scatter-add; cost independent of
        C, the fallback beyond the one-hot memory ceiling.

    Returns S (6C, 6C), b (6C,), plus landmark back-sub data
    (Hpp_inv (P,3,3), b_p (P,3)) — local to the shard.
    """
    P, K = problem.obs_cam.shape
    C = problem.num_cams
    wJc = w[..., None, None] * J_c                     # (P, K, 2, 6)
    wJp = w[..., None, None] * J_p                     # (P, K, 2, 3)

    # Landmark blocks
    H_pp = jnp.einsum("pkri,pkrj->pij", wJp, J_p)      # (P, 3, 3)
    b_p = -jnp.einsum("pkri,pkr->pi", wJp, r)          # (P, 3)
    H_pp = H_pp + lam * jnp.eye(3, dtype=H_pp.dtype)[None] \
        * jnp.maximum(jnp.einsum("pii->p", H_pp), 1e-6)[:, None, None] / 3.0
    Hpp_inv = _inv3x3(H_pp)

    # Camera blocks
    H_cc_blk = jnp.einsum("pkri,pkrj->pkij", wJc, J_c)  # (P, K, 6, 6)
    b_c_blk = -jnp.einsum("pkri,pkr->pki", wJc, r)      # (P, K, 6)
    W_blk = jnp.einsum("pkri,pkrj->pkij", wJc, J_p)     # (P, K, 6, 3)

    #   S -= W_k G W_l^T  at (cam_k, cam_l);   b_c -= W_k G b_p
    M_blk_all = jnp.einsum("pkij,pjl->pkil", W_blk, Hpp_inv)   # (P, K, 6, 3)
    b_corr = jnp.einsum("pkij,pj->pki", M_blk_all, b_p)        # (P, K, 6)

    if assembly == "onehot":
        # camera incidence as a dense one-hot: E[p,k,c] = obs k of point p
        # sees camera c (and carries weight). Every camera-indexed reduction
        # becomes a matmul over the (p, k) axes — zero scatters.
        E = ((problem.obs_cam[..., None] == jnp.arange(C)[None, None, :])
             & (w > 0)[..., None]).astype(r.dtype)             # (P, K, C)
        H_cc = jnp.einsum("pkc,pkij->cij", E, H_cc_blk)        # (C, 6, 6)
        b_c = jnp.einsum("pkc,pki->ci", E, b_c_blk - b_corr)   # (C, 6)
        # per-point camera-aggregated factors; S = H_cc - Σ_p A_p B_pᵀ
        A = jnp.einsum("pkc,pkim->pcim", E, M_blk_all)         # (P, C, 6, 3)
        Bm = jnp.einsum("pkc,pkim->pcim", E, W_blk)            # (P, C, 6, 3)
        S = -jnp.einsum("pcim,pdjm->cdij", A, Bm)              # (C, C, 6, 6)
        S = S.at[jnp.arange(C), jnp.arange(C)].add(H_cc)
    else:
        flat_cam = jnp.where(w > 0, problem.obs_cam, C).reshape(-1)  # C->drop
        H_cc = jnp.zeros((C, 6, 6), r.dtype).at[flat_cam].add(
            H_cc_blk.reshape(-1, 6, 6), mode="drop"
        )
        b_c = jnp.zeros((C, 6), r.dtype).at[flat_cam].add(
            (b_c_blk - b_corr).reshape(-1, 6), mode="drop"
        )

        # Schur terms, scanned over point blocks to bound memory. Pick the
        # largest block size <= `block` that divides P exactly
        # (dynamic_slice clamps at the end, which would double-count rows).
        block = min(block, P)
        while P % block != 0:
            block -= 1
        n_blocks = P // block

        def body(S, i):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * block, block,
                                                        axis=0)
            M = sl(M_blk_all)                                   # (B, K, 6, 3)
            Wb = sl(W_blk)                                      # (B, K, 6, 3)
            cams = sl(jnp.where(w > 0, problem.obs_cam, C))     # (B, K)
            Bkl = jnp.einsum("pkij,pljm->pklim", M, jnp.swapaxes(Wb, -1, -2))
            # Bkl: (B, K, K, 6, 6); scatter-add at (cams[k], cams[l])
            ck = jnp.broadcast_to(cams[:, :, None], Bkl.shape[:3]).reshape(-1)
            cl = jnp.broadcast_to(cams[:, None, :], Bkl.shape[:3]).reshape(-1)
            S = S.at[ck, cl].add(-Bkl.reshape(-1, 6, 6), mode="drop")
            return S, None

        S0 = jnp.zeros((C + 1, C + 1, 6, 6), r.dtype)
        S0 = S0.at[jnp.arange(C), jnp.arange(C)].add(H_cc)
        S, _ = jax.lax.scan(body, S0, jnp.arange(n_blocks))
        S = S[:C, :C]                                           # (C, C, 6, 6)

    if axis_name is not None:
        # point axis is sharded: reduce the camera-side system over the mesh
        S = jax.lax.psum(S, axis_name)
        b_c = jax.lax.psum(b_c, axis_name)

    # LM damping on camera blocks (scaled by each block's trace)
    diag_blocks = S[jnp.arange(C), jnp.arange(C)]               # (C, 6, 6)
    tr = jnp.maximum(jnp.einsum("cii->c", diag_blocks), 1e-6)   # (C,)
    eye6 = jnp.eye(6, dtype=r.dtype)
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        lam * eye6[None] * tr[:, None, None] / 6.0
    )

    # Gauge fixing: fixed/unused cameras get identity rows/cols, zero rhs.
    # Cameras with no live observations (all rejected/weighted out) are
    # auto-fixed too: their S block is pure damping, and freeing them makes
    # the reduced system indefinite -> NaN Cholesky (observed on endurance
    # runs after a hard outlier-rejection round).
    has_obs = jnp.einsum("cii->c", S[jnp.arange(C), jnp.arange(C)]) > 1e-9
    free = (problem.cam_mask & ~problem.cam_fixed & has_obs)
    free_rc = jnp.repeat(free, 6)
    Sd = S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
    Sd = jnp.where(free_rc[:, None] & free_rc[None, :], Sd, 0.0)
    Sd = Sd + jnp.diag(jnp.where(free_rc, 0.0, 1.0))
    b = jnp.where(free_rc, b_c.reshape(-1), 0.0)
    return Sd, b, Hpp_inv, b_p, W_blk


def _backsub(dx_cam, Hpp_inv, b_p, W_blk, problem: BAProblem):
    """Landmark updates given camera updates.
    dX_p = G_p (b_p - sum_k W_k^T dx_{cam_k})."""
    C = problem.num_cams
    cam_idx = jnp.clip(problem.obs_cam, 0, C - 1)
    dx = dx_cam.reshape(C, 6)[cam_idx]                 # (P, K, 6)
    valid = problem.obs_mask[..., None]
    corr = jnp.einsum("pkij,pki->pj", W_blk, jnp.where(valid, dx, 0.0))
    dX = jnp.einsum("pij,pj->pi", Hpp_inv, b_p - corr)
    return dX


def _solve_impl(problem: BAProblem, K_intr, cfg: BAConfig,
                axis_name: str | None = None):
    """LM loop body. With ``axis_name``, runs SPMD over a sharded point axis
    (call from inside shard_map; see parallel/sharded_ba.py)."""
    K_intr = jnp.asarray(K_intr, jnp.float32)

    assembly = cfg.schur_assembly
    if assembly == "auto":
        assembly = ("onehot" if problem.num_cams <= cfg.onehot_max_cams
                    else "scatter")

    def cost_of(T_cw, points):
        p = problem.replace(T_cw=T_cw, points=points)
        return compute_cost(p, K_intr, cfg.huber_delta, axis_name)

    init_cost = cost_of(problem.T_cw, problem.points)

    def step(carry, _):
        T_cw, points, lam, cost = carry
        r, w, J_c, J_p, mask = _gn_quantities(
            T_cw, points, problem, K_intr, cfg.huber_delta
        )
        S, b, Hpp_inv, b_p, W_blk = _schur_reduce(
            r, w, J_c, J_p, problem, lam, axis_name=axis_name,
            assembly=assembly,
        )
        # dense solve with jitter
        C6 = S.shape[0]
        jitter = 1e-6 * jnp.trace(S) / C6
        L, low = jax.scipy.linalg.cho_factor(
            S + jitter * jnp.eye(C6, dtype=S.dtype), lower=True
        )
        dx_cam = jax.scipy.linalg.cho_solve((L, low), b)
        # LM safeguard: an indefinite S (rank-deficient window geometry at
        # low damping) yields NaN from the Cholesky — treat as a zero step,
        # which the accept test rejects, raising damping until S is PD.
        dx_cam = jnp.where(jnp.isfinite(dx_cam), dx_cam, 0.0)
        dX = _backsub(dx_cam, Hpp_inv, b_p, W_blk, problem)
        dX = jnp.where(jnp.isfinite(dX), dX, 0.0)

        free = (problem.cam_mask & ~problem.cam_fixed)[:, None]
        xi = jnp.where(free, dx_cam.reshape(-1, 6), 0.0)
        T_new = lie.se3_exp(xi) @ T_cw
        pts_new = jnp.where(
            problem.point_mask[:, None], points + dX, points
        )
        new_cost = cost_of(T_new, pts_new)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        T_cw2 = jnp.where(accept, T_new, T_cw)
        points2 = jnp.where(accept, pts_new, points)
        cost2 = jnp.where(accept, new_cost, cost)
        lam2 = jnp.where(accept, lam * cfg.damping_down, lam * cfg.damping_up)
        lam2 = jnp.clip(lam2, 1e-9, 1e6)
        return (T_cw2, points2, lam2, cost2), (accept, cost2)

    (T_fin, pts_fin, lam_fin, cost_fin), (accepts, costs) = jax.lax.scan(
        step,
        (problem.T_cw, problem.points, jnp.float32(cfg.init_damping), init_cost),
        None,
        length=cfg.iterations,
    )
    new_problem = problem.replace(T_cw=T_fin, points=pts_fin)
    return new_problem, BAStats(
        initial_cost=init_cost, final_cost=cost_fin,
        accepted=accepts, costs=costs,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve(problem: BAProblem, K_intr, cfg: BAConfig):
    """Run LM iterations (single device). Returns (new_problem, BAStats)."""
    return _solve_impl(problem, K_intr, cfg)


def observation_residuals(problem: BAProblem, K_intr):
    """Per-observation reprojection error norm (P, K), inf where masked."""
    T = problem.T_cw[jnp.clip(problem.obs_cam, 0, problem.num_cams - 1)]
    r, Xc = _project_residual(T, problem.points[:, None, :], problem.obs_uv,
                              jnp.asarray(K_intr, jnp.float32))
    n = jnp.linalg.norm(r, axis=-1)
    mask = problem.obs_mask & problem.point_mask[:, None]
    return jnp.where(mask & (Xc[..., 2] > 1e-3), n, jnp.inf)


@functools.partial(jax.jit, static_argnames=("cfg", "reject_px", "rounds"))
def solve_robust(problem: BAProblem, K_intr, cfg: BAConfig,
                 reject_px: float = 5.0, rounds: int = 2):
    """LM solve with interleaved gross-outlier rejection.

    Huber bounds an outlier's gradient but cannot eliminate it; the standard
    cure is to re-solve after disabling observations whose residual exceeds
    ``reject_px``. Points left with <2 live observations are dropped too.
    """
    stats = None
    for i in range(rounds):
        problem, stats = solve(problem, K_intr, cfg)
        if i + 1 < rounds:
            res = observation_residuals(problem, K_intr)
            keep = res < reject_px
            new_mask = problem.obs_mask & keep
            pt_alive = problem.point_mask & (new_mask.sum(axis=1) >= 2)
            problem = problem.replace(obs_mask=new_mask, point_mask=pt_alive)
    return problem, stats
