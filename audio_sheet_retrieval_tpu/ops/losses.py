"""Pairwise ranking objectives over a batch score matrix.

Behavioural parity with reference:audio_sheet_retrieval/models/objectives.py —
all four variants (kiros sum-form, contrastive cosine hinge, arccos distance
hinge, squared-cosine) with identical margin/clip semantics. The reference
extracts off-diagonal entries with an identity-mask + reshape trick
(objectives.py:42-48); here the same quantity is computed with a mask so the
whole loss stays a fused elementwise epilogue on the score matmul.

All functions take two [n, d] latent batches and return a scalar.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def _score_matrix(lv1: jnp.ndarray, lv2: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(lv1, lv2.T, precision=HIGHEST,
                   preferred_element_type=jnp.float32)


def _offdiag_mask(n: int, dtype=jnp.float32) -> jnp.ndarray:
    return 1.0 - jnp.eye(n, dtype=dtype)


def contrastive_cos_loss(lv1, lv2, *, weight=1.0, gamma=0.7, symmetric=False):
    """Hinge contrastive loss on cosine scores.

    For each matching pair i with score d_i and every non-matching score
    D_ij (j != i): mean over n*(n-1) terms of clip(gamma - d_i + D_ij, 0, 1000).
    Parity: reference objectives.py:30-69 (shipped config weight=1.0,
    gamma=0.7, asymmetric; reference models/mutopia_ccal_cont.py:152-155).
    """

    def one_direction(a, b):
        D = _score_matrix(a, b)
        n = D.shape[0]
        d = jnp.diagonal(D).reshape(-1, 1)
        L = jnp.clip(gamma - d + D, 0.0, 1000.0)
        mask = _offdiag_mask(n, L.dtype)
        # mean over the n*(n-1) off-diagonal entries only
        return jnp.sum(L * mask) / (n * (n - 1))

    loss = one_direction(lv1, lv2)
    if symmetric:
        loss = loss + one_direction(lv2, lv1)
    return weight * loss


def contrastive_loss_kiros(lv1, lv2, *, weight=1.0, gamma=0.7, symmetric=False):
    """Kiros et al. 2014 sum-form ranking loss (both row+column contrast).

    Parity: reference objectives.py:6-27 (sum, diagonals zeroed).
    ``weight``/``symmetric`` accepted for API parity; the reference ignores
    them in this variant too.
    """
    del weight, symmetric
    D = _score_matrix(lv1, lv2)
    n = D.shape[0]
    diag = jnp.diagonal(D)
    cost_s = jnp.maximum(0.0, gamma - diag[None, :] + D)
    cost_im = jnp.maximum(0.0, gamma - diag[:, None] + D)
    mask = _offdiag_mask(n, D.dtype)
    return jnp.sum(cost_s * mask) + jnp.sum(cost_im * mask)


def contrastive_arccos_loss(lv1, lv2, *, weight=1.0, gamma=0.7):
    """Hinge on arccos distances: clip(gamma + d_i - D_ij, 0, 1000).mean().

    Parity: reference objectives.py:72-105. Scores are clipped into [-1, 1]
    before arccos for numerical safety (the reference relies on exactly
    normalized inputs).
    """
    D = _score_matrix(lv1, lv2)
    n = D.shape[0]
    D = jnp.arccos(jnp.clip(D, -1.0, 1.0))
    d = jnp.diagonal(D).reshape(-1, 1)
    L = jnp.clip(gamma + d - D, 0.0, 1000.0)
    mask = _offdiag_mask(n, L.dtype)
    return weight * jnp.sum(L * mask) / (n * (n - 1))


def cos2_distance_loss(lv1, lv2, *, weight=0.0):
    """Squared cosine distance between matching pairs.

    Parity: reference objectives.py:108-118 (returns (1-weight)*loss).
    """
    d = jnp.sum(lv1 * lv2, axis=-1)
    return (1.0 - weight) * jnp.mean(jnp.square(1.0 - d))


def get_contrastive_cos_loss(weight, gamma, symmetric=False):
    """Factory mirroring the reference module contract (objectives.py:30)."""
    return functools.partial(
        contrastive_cos_loss, weight=weight, gamma=gamma, symmetric=symmetric
    )


def get_contrastive_loss_kiros(weight, gamma, symmetric=False):
    return functools.partial(
        contrastive_loss_kiros, weight=weight, gamma=gamma, symmetric=symmetric
    )


def get_contrastive_arccos_loss(weight, gamma):
    return functools.partial(contrastive_arccos_loss, weight=weight, gamma=gamma)


def get_cos2_distance_loss(weight):
    return functools.partial(cos2_distance_loss, weight=weight)
