"""Cholesky factorizations, block extensions and solves on padded buffers.

Adding b points to an N-point factor costs O(cap^2 b) through the block
extension instead of a fresh O(cap^3) factorization, and is exact because
the kernel matrix does not depend on the targets.

All factors live on padded (cap, cap) buffers whose pad block is the
identity (ops/kernels.gram_masked), so triangular solves against padded
right-hand sides are exact with no masking. The factorizations and solves
are cuSOLVER/cuBLAS (or LAPACK) calls through ``torch.linalg``, as the JAX
package leaves them to XLA's library calls.

A failed factorization returns a NaN factor, as ``jnp.linalg.cholesky``
does, so callers test finiteness instead of catching exceptions.
"""
from __future__ import annotations

import torch

# Relative jitter ladder used when a factorization fails.
JITTER_LADDER = (0.0, 1e-10, 1e-8, 1e-6, 1e-4)


def cholesky(K):
    """Lower Cholesky of a (batch of) padded masked Gram matrices; the
    factor of a matrix that is not positive definite is all NaN."""
    L, info = torch.linalg.cholesky_ex(K)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, L, torch.full_like(L, float("nan")))


def cholesky_jittered(K, mask, amp):
    """Cholesky with an adaptive relative-jitter ladder: retries with
    growing diagonal jitter (relative to the amplitude ``amp``) on the
    active rows until the factor is finite. In float64 the first rung
    (zero jitter) virtually always succeeds, so this costs one host read."""
    eye = torch.diag(mask * mask)
    for i, rung in enumerate(JITTER_LADDER):
        L = cholesky(K if rung == 0.0 else K + (rung * amp) * eye)
        if i == len(JITTER_LADDER) - 1 or bool(torch.isfinite(L).all()):
            return L
    return L


def cho_solve(L, b):
    """Solve K x = b given lower Cholesky L (padded-exact). ``b`` may be a
    vector (cap,) or a matrix (cap, m); batched over leading dims of L."""
    vec = b.dim() == L.dim() - 1
    rhs = b[..., None] if vec else b
    out = torch.cholesky_solve(rhs, L, upper=False)
    return out[..., 0] if vec else out


def tri_solve(L, b):
    """Solve L v = b (lower-triangular forward solve); b vector or matrix."""
    vec = b.dim() == L.dim() - 1
    rhs = b[..., None] if vec else b
    out = torch.linalg.solve_triangular(L, rhs, upper=False)
    return out[..., 0] if vec else out


def extend_cholesky_block(L, K21, K22):
    """Extend a Cholesky factor by a block of b rows.

    Given L = chol(K11) (cap, cap, padded-identity), K21 (b, cap) the
    cross-covariance of the new points against the padded training rows, and
    K22 (b, b) their self-covariance (identity rows/cols for pad slots),
    returns (L21, L22) with

        [[K11, K21^T], [K21, K22]] = [[L, 0], [L21, L22]] @ (...)^T
    """
    L21 = torch.linalg.solve_triangular(L, K21.T, upper=False).T
    S = K22 - L21 @ L21.T
    S = 0.5 * (S + S.T)
    L22 = cholesky(S)
    return L21, L22


def rank1_extend(L, k, k_self):
    """Single-point Cholesky extension returning the (n+1, n+1) factor."""
    v = tri_solve(L, k)
    diag = torch.sqrt(k_self - torch.dot(v, v))
    n = L.shape[0]
    out = torch.zeros((n + 1, n + 1), dtype=L.dtype, device=L.device)
    out[:n, :n] = L
    out[n, :n] = v
    out[n, n] = diag
    return out
