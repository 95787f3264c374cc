"""Batched small symmetric eigendecomposition via cyclic Jacobi sweeps.

Why: the SLAM hot path needs thousands of tiny decompositions per frame —
9x9 normal matrices for vmapped 8-point fits (geometry/epipolar.py), 4x4 for
DLT triangulation, 3x3 for rank-2/essential projections. ``jnp.linalg.svd`` /
``eigh`` lower to general-purpose iterative algorithms built for large
matrices; a fixed-sweep cyclic Jacobi is branch-free, fully unrolled, and
runs as elementwise work across the batch — the "batched small SVD"
strategy SURVEY.md §7 lists as a hard part. Jacobi was chosen over
``jnp.linalg.eigh`` by a race on the earlier accelerator; re-race on the
H100 pending.

Accuracy: quadratic convergence; SWEEPS=8 gives ~1e-6 off-diagonal residual
for well-scaled 9x9 f32 inputs. Inputs should be pre-scaled (e.g. Hartley
normalization) so entries are O(1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _round_robin_schedule(n):
    """Rounds of disjoint (p, q) pairs covering all n(n-1)/2 pairs.

    Circle-method tournament schedule: m = n rounded up to even players, one
    fixed, the rest rotating; each round pairs ⌊n/2⌋ disjoint index pairs
    (the dummy's opponent sits out when n is odd). All pairs in a round
    commute (disjoint rows/columns), so their Givens rotations apply as ONE
    vectorized update — serial depth per sweep drops from n(n-1)/2 to n
    steps, which is what the latency-bound small-batch case pays for.
    """
    m = n + (n % 2)
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


@functools.partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(A, sweeps: int = 8):
    """Symmetric eigendecomposition of (..., n, n), n small and static.

    Returns (eigvals (..., n) ascending, eigvecs (..., n, n) with columns as
    eigenvectors), like jnp.linalg.eigh.

    Parallel-order cyclic Jacobi: each step applies all ⌊n/2⌋ disjoint
    rotations of a round-robin round at once (angles computed from the
    pre-round matrix — the standard parallel-Jacobi ordering), with
    algebraic c/s (one rsqrt each, no arctan2/cos/sin).
    """
    n = A.shape[-1]
    dtype = A.dtype
    V = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)
    rounds = _round_robin_schedule(n)

    def round_step(AV, pairs):
        A, V = AV
        ps = jnp.asarray([p for p, _ in pairs])
        qs = jnp.asarray([q for _, q in pairs])
        diag = jnp.diagonal(A, axis1=-2, axis2=-1)
        app = diag[..., ps]                                # (..., P)
        aqq = diag[..., qs]
        apq = A[..., ps, qs]
        # algebraic Givens: with this application form (p' = c·rp + s·rq),
        # zeroing apq solves t² - 2τt - 1 = 0, τ = (aqq-app)/(2 apq); the
        # small-|t| root is t = -sign(τ)/(|τ|+√(1+τ²)).
        safe = jnp.where(jnp.abs(apq) < 1e-30, 1e-30, 2.0 * apq)
        tau = (aqq - app) / safe
        t = -jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)    # 45° when diagonal entries equal
        c = jax.lax.rsqrt(1.0 + t * t)
        s = t * c
        tiny = jnp.abs(apq) < 1e-30
        c = jnp.where(tiny, 1.0, c)
        s = jnp.where(tiny, 0.0, s)

        # all P rotations touch disjoint rows/cols: one gathered update each
        cc = c[..., None]
        ss = s[..., None]
        rp = A[..., ps, :]                                 # (..., P, n)
        rq = A[..., qs, :]
        A = A.at[..., ps, :].set(cc * rp + ss * rq)
        A = A.at[..., qs, :].set(-ss * rp + cc * rq)
        cp = jnp.swapaxes(A[..., :, ps], -1, -2)           # (..., P, n)
        cq = jnp.swapaxes(A[..., :, qs], -1, -2)
        A = A.at[..., :, ps].set(jnp.swapaxes(cc * cp + ss * cq, -1, -2))
        A = A.at[..., :, qs].set(jnp.swapaxes(-ss * cp + cc * cq, -1, -2))
        A = A.at[..., ps, qs].set(0.0)
        A = A.at[..., qs, ps].set(0.0)

        vp = jnp.swapaxes(V[..., :, ps], -1, -2)
        vq = jnp.swapaxes(V[..., :, qs], -1, -2)
        V = V.at[..., :, ps].set(jnp.swapaxes(cc * vp + ss * vq, -1, -2))
        V = V.at[..., :, qs].set(jnp.swapaxes(-ss * vp + cc * vq, -1, -2))
        return (A, V)

    def sweep(_, AV):
        for pairs in rounds:
            AV = round_step(AV, pairs)
        return AV

    # sweep loop as fori_loop: one sweep's rounds unroll (static indices),
    # the outer loop stays rolled — keeps the XLA graph ~sweeps× smaller.
    A, V = jax.lax.fori_loop(0, sweeps, sweep, (A, V))

    evals = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(evals, axis=-1)
    evals_sorted = jnp.take_along_axis(evals, order, axis=-1)
    V_sorted = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return evals_sorted, V_sorted


def smallest_eigvec(A, sweeps: int = 8):
    """Eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    w, V = jacobi_eigh(A, sweeps=sweeps)
    return V[..., :, 0]


def null_vector(A, sweeps: int = 8):
    """Least-squares null vector of (..., M, n): argmin_{|x|=1} |A x|.

    Forming AᵀA squares the conditioning, so in f32 the Jacobi eigvec of a
    near-degenerate problem (e.g. an 8-point minimal sample whose two
    smallest eigenvalues sit within ~1e-4 of each other) lands anywhere in
    the near-null cluster. A 2-dim Rayleigh-Ritz refinement against A itself
    recovers the lost digits: project A onto the two smallest eigvec
    directions (B = A·V₂, full f32 accuracy of A), then take the closed-form
    smallest eigvec of the well-conditioned 2x2 BᵀB. One extra (M,n)x(n,2)
    matmul per problem; batches under vmap.
    """
    AtA = jnp.einsum("...ji,...jk->...ik", A, A)
    _, V = jacobi_eigh(AtA, sweeps=sweeps)
    V2 = V[..., :, :2]                                   # (..., n, 2)
    B = jnp.einsum("...ij,...jk->...ik", A, V2)          # (..., M, 2)
    a = jnp.sum(B[..., 0] * B[..., 0], axis=-1)
    b = jnp.sum(B[..., 0] * B[..., 1], axis=-1)
    c = jnp.sum(B[..., 1] * B[..., 1], axis=-1)
    # closed-form smallest eigvec of [[a, b], [b, c]]. The difference form
    # (a+c)/2 - sqrt(...) cancels catastrophically when λmin << λmax (the
    # normal case here: a near-null direction vs an O(1) one), so compute
    # λmin = det / λmax instead, and take the eigenvector from whichever
    # row of (M - λI) is better conditioned.
    lmax = 0.5 * (a + c) + jnp.sqrt(0.25 * (a - c) ** 2 + b * b)
    det = a * c - b * b
    lam = det / jnp.maximum(lmax, 1e-30)
    use2 = jnp.abs(c - lam) >= jnp.abs(a - lam)
    vx = jnp.where(use2, c - lam, b)
    vy = jnp.where(use2, -b, lam - a)
    deg = (vx * vx + vy * vy) == 0.0                     # fully degenerate
                                                         # (1e-60 would
                                                         # underflow in f32)
    vx = jnp.where(deg, 1.0, vx)
    vy = jnp.where(deg, 0.0, vy)
    nrm = jnp.sqrt(vx * vx + vy * vy)
    coef = jnp.stack([vx / nrm, vy / nrm], axis=-1)      # (..., 2)
    x = jnp.einsum("...nk,...k->...n", V2, coef)
    return x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + 1e-30)


def rank2_project(F, sweeps: int = 8):
    """Nearest rank-2 matrix (Frobenius) to (..., 3, 3).

    Uses F(I - v3 v3ᵀ) = σ1 u1 v1ᵀ + σ2 u2 v2ᵀ where v3 is the right
    singular vector of the smallest singular value — no SVD of F needed,
    just a 3x3 symmetric eigendecomposition of FᵀF.
    """
    FtF = jnp.einsum("...ji,...jk->...ik", F, F)
    v3 = smallest_eigvec(FtF, sweeps=sweeps)                # (..., 3)
    proj = jnp.eye(3, dtype=F.dtype) - v3[..., :, None] * v3[..., None, :]
    return jnp.einsum("...ij,...jk->...ik", F, proj)


def svd3(E, sweeps: int = 10):
    """Full SVD of (..., 3, 3) built from one symmetric eigendecomposition.

    Returns (U, S, Vt) with S descending, U/V proper (det +1 not enforced —
    callers needing rotations fix signs). u_i = E v_i / σ_i for the two
    largest; u3 completes the basis by cross product (robust when σ3 ~ 0,
    the essential-matrix case).
    """
    EtE = jnp.einsum("...ji,...jk->...ik", E, E)
    w, V = jacobi_eigh(EtE, sweeps=sweeps)                  # ascending
    # descending singular values
    S = jnp.sqrt(jnp.maximum(w[..., ::-1], 0.0))            # (..., 3)
    Vd = V[..., :, ::-1]                                     # columns desc
    Ev = jnp.einsum("...ij,...jk->...ik", E, Vd)            # (..., 3, 3)
    u1 = Ev[..., :, 0] / jnp.maximum(S[..., 0:1], 1e-12)
    u2 = Ev[..., :, 1] / jnp.maximum(S[..., 1:2], 1e-12)
    # re-orthonormalize u2 against u1 (f32 safety), then complete
    u1 = u1 / (jnp.linalg.norm(u1, axis=-1, keepdims=True) + 1e-12)
    u2 = u2 - jnp.sum(u1 * u2, axis=-1, keepdims=True) * u1
    u2 = u2 / (jnp.linalg.norm(u2, axis=-1, keepdims=True) + 1e-12)
    # u3: from E v3 when σ3 is significant (sign matters for reconstruction);
    # orthonormal completion by cross product when σ3 ~ 0 (essential case)
    u3_cross = jnp.cross(u1, u2)
    Ev3 = Ev[..., :, 2]
    degen = S[..., 2] < 1e-6 * jnp.maximum(S[..., 0], 1e-12)
    sign = jnp.where(jnp.sum(u3_cross * Ev3, axis=-1) < 0, -1.0, 1.0)
    u3 = jnp.where(degen[..., None], u3_cross, sign[..., None] * u3_cross)
    U = jnp.stack([u1, u2, u3], axis=-1)
    return U, S, jnp.swapaxes(Vd, -1, -2)
