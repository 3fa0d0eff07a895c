"""Canonical correlation analysis — offline fit and in-graph layer, in JAX.

Two reference components are unified here:

1. The **offline numpy CCA** (reference:audio_sheet_retrieval/utils/cca.py,
   11 method variants). The variants fall into three numerically equivalent
   families, each implemented once on-device:

     * ``svd``    — T = S11^-1/2 S12 S22^-1/2, SVD of T
                    (covers reference 'svd', 'svd-2'; cca.py:199-228)
     * ``eigen``  — eigh of T Tᵀ and Tᵀ T with the diag-sign fix
                    (covers 'eigen', 'eigen-2', 'eigen-3', 'eigen-3b', 'tuw',
                    'theano-2', 'eigen-2-theano'; cca.py:173-335)
     * ``eigen-4``— single eigh, V from S22⁻¹ S21 U / coeffs
                    (covers 'eigen-4', 'eigen-4-theano'; cca.py:322-335)

   Matrix inverse square roots use eigh (the reference's 'svd-2'/'eigen-2'
   path) rather than scipy ``sqrtm`` — identical for SPD matrices and runs on
   the device. Transform semantics match cca.py:432-444.

2. The **in-graph CCA layer** (reference:models/lasagne_extensions/layers/
   cca.py:43-209). Theano carried running statistics through
   ``default_update`` side effects; here state is explicit: the train step is
   a pure function (H1, H2, state) -> (output, new_state, corr). Gradients
   flow through the whitening/eigh exactly as in Theano (sign() has zero
   gradient; the E1 clip only affects the monitored corr, cca.py:161-164).

Sharded large-batch refit: covariances are 32x32, so the exact 25k-sample
statistics are a psum of per-shard moment sums (`cca_moments` +
`cca_fit_from_moments`); see parallel/gallery.py users.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# Every product here runs at full float32 precision: on a GPU a default-
# precision f32 dot may run in TF32 (~10 mantissa bits), which breaks the
# statistics, whitening and projection parity with the float32 reference
# (PARITY.md). The matrices are 32x32 or [B, 32], so the cost is nil.
HIGHEST = jax.lax.Precision.HIGHEST
_dot = functools.partial(jnp.dot, precision=HIGHEST,
                         preferred_element_type=jnp.float32)

DEFAULT_R1 = 1e-3
DEFAULT_R2 = 1e-3
DEFAULT_RT = 1e-3

# reference method name -> canonical family
_METHOD_ALIASES = {
    "svd": "svd",
    "svd-2": "svd",
    "eigen": "eigen",
    "eigen-2": "eigen",
    "eigen-3": "eigen",
    "eigen-3b": "eigen",
    "tuw": "eigen",
    "theano-2": "eigen",
    "eigen-2-theano": "eigen",
    "eigen-4": "eigen-4",
    "eigen-4-theano": "eigen-4",
    "theano-3": "eigen",
}


class CCAResult(NamedTuple):
    U: jnp.ndarray        # [d, d] view-1 projection
    V: jnp.ndarray        # [d, d] view-2 projection
    m1: jnp.ndarray       # [d] view-1 mean
    m2: jnp.ndarray       # [d] view-2 mean
    coeffs: jnp.ndarray   # [d] canonical correlations (descending)


class CCAMoments(NamedTuple):
    n: jnp.ndarray        # scalar sample count
    s1: jnp.ndarray       # [d] sum of H1
    s2: jnp.ndarray       # [d] sum of H2
    s11: jnp.ndarray      # [d, d] sum H1ᵀH1
    s22: jnp.ndarray      # [d, d] sum H2ᵀH2
    s12: jnp.ndarray      # [d, d] sum H1ᵀH2


def inv_sqrt_spd(S: jnp.ndarray) -> jnp.ndarray:
    """S^{-1/2} for a symmetric positive-definite matrix via eigh.

    Matches the reference's diagonalization path (utils/cca.py:216-219).
    """
    d, A = jnp.linalg.eigh(S)
    return _dot(A * (1.0 / jnp.sqrt(d)), A.T)


def inv_sqrt_spd_ns(S: jnp.ndarray, iters: int = 30) -> jnp.ndarray:
    """S^{-1/2} via the coupled Newton-Schulz (Denman-Beavers) iteration.

    Pure 32x32 matmuls — accelerator-friendly and differentiable without the eigh
    JVP's 1/(lambda_i - lambda_j) blowups. Trace normalization puts the
    spectrum in (0, 1]; with the CCA ridge (1e-3) the condition number is
    bounded and ~30 iterations converge to fp32 accuracy.
    """
    d = S.shape[0]
    eye = jnp.eye(d, dtype=S.dtype)
    norm = jnp.trace(S)
    Y = S / norm
    Z = eye

    def body(_, yz):
        Y, Z = yz
        Tm = 0.5 * (3.0 * eye - _dot(Z, Y))
        return _dot(Y, Tm), _dot(Tm, Z)

    Y, Z = jax.lax.fori_loop(0, iters, body, (Y, Z))
    return Z / jnp.sqrt(norm)


def polar_ns(T: jnp.ndarray, iters: int = 40) -> jnp.ndarray:
    """Orthogonal polar factor W = T (TᵀT)^{-1/2} via Newton-Schulz.

    X_{k+1} = X_k (3I - X_kᵀ X_k)/2 with X_0 = T/||T||_F (singular values
    < sqrt(3) guarantees convergence; all flow to 1). Directions with
    near-zero singular values converge slowly — exactly the directions
    whose sign the reference's eigh-based fix leaves arbitrary anyway.
    """
    d2 = T.shape[1]
    eye = jnp.eye(d2, dtype=T.dtype)
    X = T / jnp.linalg.norm(T)

    def body(_, X):
        return 0.5 * _dot(X, 3.0 * eye - _dot(X.T, X))

    return jax.lax.fori_loop(0, iters, body, X)


def cca_moments(H1: jnp.ndarray, H2: jnp.ndarray) -> CCAMoments:
    """Sufficient statistics of a (shard of a) sample for a CCA fit."""
    n = jnp.asarray(H1.shape[0], jnp.float32)
    return CCAMoments(
        n=n,
        s1=jnp.sum(H1, axis=0),
        s2=jnp.sum(H2, axis=0),
        s11=_dot(H1.T, H1),
        s22=_dot(H2.T, H2),
        s12=_dot(H1.T, H2),
    )


def _covariances_from_moments(m: CCAMoments, r1, r2):
    n = m.n
    m1 = m.s1 / n
    m2 = m.s2 / n
    denom = n - 1.0
    S12 = (m.s12 - n * jnp.outer(m1, m2)) / denom
    S11 = (m.s11 - n * jnp.outer(m1, m1)) / denom
    S22 = (m.s22 - n * jnp.outer(m2, m2)) / denom
    d = S11.shape[0]
    eye = jnp.eye(d, dtype=S11.dtype)
    return m1, m2, S12, S11 + r1 * eye, S22 + r2 * eye


def _fit_from_covariances(m1, m2, S12, S11, S22, method: str, rT) -> CCAResult:
    S11si = inv_sqrt_spd(S11)
    S22si = inv_sqrt_spd(S22)
    T = _dot(_dot(S11si, S12), S22si)

    if method == "svd":
        U_, coeffs, Vt = jnp.linalg.svd(T)
        U = _dot(S11si, U_)
        V = _dot(S22si, Vt.T)
    elif method == "eigen":
        M1 = _dot(T, T.T) + rT * jnp.eye(T.shape[0], dtype=T.dtype)
        M2 = _dot(T.T, T) + rT * jnp.eye(T.shape[1], dtype=T.dtype)
        vals, E = jnp.linalg.eigh(M1)
        _, F = jnp.linalg.eigh(M2)
        E = E[:, ::-1]
        F = F[:, ::-1]
        coeffs = jnp.sqrt(jnp.clip(vals[::-1], 0.0, None))
        U = _dot(S11si, E)
        V = _dot(S22si, F)
        # sign fix: two decompositions instead of one SVD (cca.py:196-197)
        s = jnp.sign(jnp.diagonal(_dot(_dot(U.T, S12), V)))
        U = U * s
    elif method == "eigen-4":
        S21 = S12.T
        S22i = jnp.linalg.inv(S22)
        M1 = jnp.linalg.multi_dot(
            [S11si, S12, S22i, S21, S11si.T], precision=HIGHEST)
        vals, E = jnp.linalg.eigh(M1)
        E = E[:, ::-1]
        coeffs = jnp.sqrt(jnp.clip(vals[::-1], 0.0, None))
        U = _dot(S11si.T, E)
        V = _dot(_dot(S22i, S21), U) / coeffs
    else:  # pragma: no cover
        raise NotImplementedError(f"unknown CCA method family: {method}")

    return CCAResult(U=U, V=V, m1=m1, m2=m2, coeffs=coeffs)


@functools.partial(jax.jit, static_argnames=("method",))
def _cca_fit_jit(H1, H2, r1, r2, rT, method: str) -> CCAResult:
    m = cca_moments(H1, H2)
    m1, m2, S12, S11, S22 = _covariances_from_moments(m, r1, r2)
    return _fit_from_covariances(m1, m2, S12, S11, S22, method, rT)


def cca_fit(H1, H2, r1=DEFAULT_R1, r2=DEFAULT_R2, rT=DEFAULT_RT,
            method: str = "svd") -> CCAResult:
    """Fit CCA projections from two [n, d] views.

    ``method`` accepts any of the reference's 11 variant names (mapped onto
    three canonical families) — see module docstring. Only the Theano
    'theano-3' variant applied rT inside the offline fit; for all other
    aliases rT is ignored here, matching reference utils/cca.py.
    """
    family = _METHOD_ALIASES.get(method)
    if family is None:
        raise NotImplementedError(f"Selected method for CCA not implemented: {method}")
    rT_eff = rT if method == "theano-3" else 0.0
    H1 = jnp.asarray(H1, jnp.float32)
    H2 = jnp.asarray(H2, jnp.float32)
    return _cca_fit_jit(H1, H2, jnp.float32(r1), jnp.float32(r2),
                        jnp.float32(rT_eff), family)


def cca_fit_from_moments(m: CCAMoments, r1=DEFAULT_R1, r2=DEFAULT_R2,
                         rT=0.0, method: str = "svd") -> CCAResult:
    """Fit from (possibly psum-combined) sufficient statistics."""
    family = _METHOD_ALIASES.get(method)
    if family is None:
        raise NotImplementedError(f"Selected method for CCA not implemented: {method}")
    m1, m2, S12, S11, S22 = _covariances_from_moments(m, r1, r2)
    return _fit_from_covariances(m1, m2, S12, S11, S22, family, rT)


def cca_transform_v1(res: CCAResult, X):
    """Project view-1 data (reference utils/cca.py:432-439)."""
    return _dot(jnp.asarray(X) - res.m1, res.U)


def cca_transform_v2(res: CCAResult, Y):
    """Project view-2 data (reference utils/cca.py:441-444)."""
    return _dot(jnp.asarray(Y) - res.m2, res.V)


# ---------------------------------------------------------------------------
# In-graph CCA layer (reference CCALayer)
# ---------------------------------------------------------------------------


class CCAState(NamedTuple):
    """Non-trainable state of the CCA projection layer.

    Mirrors the seven shared variables of the reference CCALayer in its
    ``add_param`` order (lasagne cca.py:69-77) — checkpoint importers rely
    on this ordering: U, V, mean1, mean2, S12, S11, S22.
    """

    U: jnp.ndarray
    V: jnp.ndarray
    mean1: jnp.ndarray
    mean2: jnp.ndarray
    S12: jnp.ndarray
    S11: jnp.ndarray
    S22: jnp.ndarray

    @staticmethod
    def zeros(dim: int, dtype=jnp.float32) -> "CCAState":
        z2 = jnp.zeros((dim, dim), dtype)
        z1 = jnp.zeros((dim,), dtype)
        return CCAState(U=z2, V=z2, mean1=z1, mean2=z1, S12=z2, S11=z2, S22=z2)


def cca_layer_train(
    H1: jnp.ndarray,
    H2: jnp.ndarray,
    state: CCAState,
    r1: float = DEFAULT_R1,
    r2: float = DEFAULT_R2,
    rT: float = DEFAULT_RT,
    alpha: float = 1.0,
    whitening: str = "eigh",
    grad_mode: str = "full",
) -> Tuple[jnp.ndarray, jnp.ndarray, CCAState, jnp.ndarray]:
    """Training-mode CCA layer (reference lasagne cca.py:91-203).

    Computes batch statistics, blends them into the running state with
    ``alpha`` (shipped models use alpha=1.0, i.e. pure batch statistics),
    derives the projections, and projects the (mean-centered) inputs.

    ``whitening``:
      * "eigh"  — the reference formulation: inverse sqrts + double eigh of
        TTᵀ/TᵀT with the sign-matching fix (lasagne cca.py:144-173).
      * "polar" — matmul-only equivalent: Newton-Schulz inverse sqrts + the
        orthogonal polar factor W = polar(T). After the reference's sign
        fix, E Fᵀ == polar(T) exactly, and both the training loss and all
        eval retrieval metrics are invariant under the per-view rotations
        that distinguish (U, V) from (S11si·W, S22si) — see PARITY.md.
        Pure matmuls, with stable gradients (no
        eigh-JVP 1/(lambda_i-lambda_j) terms). The monitored corr becomes
        diag(WᵀT) (same sum as the singular values). Requires wl == 0
        (true for all shipped models).

    ``grad_mode``:
      * "full" (default, reference parity) — gradients flow through the
        whitening chain: U, V are functions of the batch statistics and
        Theano differentiated through them (lasagne cca.py computes U/V
        symbolically inside the training graph).
      * "projection" — U/V/means are treated as constants of the step
        (stop_gradient); encoder gradients flow only through the
        projection matmul. KEPT AS A RESEARCH ABLATION with a measured
        negative result (scripts/capstone.py --cca_grad projection):
        from-scratch training COLLAPSES without the whitening
        sensitivity (val MRR 0.0075 vs 0.518 at 120k entities) — the
        reference's differentiate-through-whitening dynamic is
        load-bearing, not incidental.

    Returns (lv1, lv2, new_state, corr). The caller treats ``new_state`` as
    non-differentiable (the Theano original updated shared variables
    out-of-band).
    """
    assert grad_mode in ("full", "projection"), grad_mode
    f32 = jnp.float32
    H1 = H1.astype(f32)
    H2 = H2.astype(f32)
    m = f32(H1.shape[0])
    a = f32(alpha)

    mean1 = (1.0 - a) * state.mean1 + a * jnp.mean(H1, axis=0)
    mean2 = (1.0 - a) * state.mean2 + a * jnp.mean(H2, axis=0)

    H1bar = H1 - mean1
    H2bar = H2 - mean2

    denom = m - 1.0
    eye = jnp.eye(H1.shape[1], dtype=f32)
    S12 = _dot(H1bar.T, H2bar) / denom
    S11 = _dot(H1bar.T, H1bar) / denom + r1 * eye
    S22 = _dot(H2bar.T, H2bar) / denom + r2 * eye

    S12 = (1.0 - a) * state.S12 + a * S12
    S11 = (1.0 - a) * state.S11 + a * S11
    S22 = (1.0 - a) * state.S22 + a * S22

    if whitening == "polar":
        S11si = inv_sqrt_spd_ns(S11)
        S22si = inv_sqrt_spd_ns(S22)
        T = _dot(_dot(S11si, S12), S22si)
        W = polar_ns(T)
        U = _dot(S11si, W)
        V = S22si
        # WᵀT = (TᵀT)^1/2: same trace as the singular values (corr proxy)
        corr = jnp.sqrt(jnp.clip(jnp.abs(jnp.diagonal(_dot(W.T, T))) ** 2,
                                 1e-7, 1.0))
    elif whitening == "eigh":
        S11si = inv_sqrt_spd(S11)
        S22si = inv_sqrt_spd(S22)

        T = _dot(_dot(S11si, S12), S22si)
        M1 = _dot(T, T.T) + rT * eye
        M2 = _dot(T.T, T) + rT * eye

        E1, E = jnp.linalg.eigh(M1)
        _, F = jnp.linalg.eigh(M2)

        corr = jnp.sqrt(jnp.clip(E1, 1e-7, 1.0))

        U = _dot(S11si, E)
        V = _dot(S22si, F)

        # flip signs of projections to match (cca.py:170-173)
        s = jnp.sign(jnp.diagonal(_dot(_dot(U.T, S12), V)))
        U = U * s
    else:  # pragma: no cover
        raise ValueError(f"unknown whitening: {whitening}")

    if grad_mode == "projection":
        lv1 = _dot(H1 - jax.lax.stop_gradient(mean1),
                   jax.lax.stop_gradient(U))
        lv2 = _dot(H2 - jax.lax.stop_gradient(mean2),
                   jax.lax.stop_gradient(V))
    else:
        lv1 = _dot(H1bar, U)
        lv2 = _dot(H2bar, V)

    new_state = CCAState(
        U=jax.lax.stop_gradient(U),
        V=jax.lax.stop_gradient(V),
        mean1=jax.lax.stop_gradient(mean1),
        mean2=jax.lax.stop_gradient(mean2),
        S12=jax.lax.stop_gradient(S12),
        S11=jax.lax.stop_gradient(S11),
        S22=jax.lax.stop_gradient(S22),
    )
    return lv1, lv2, new_state, corr


def cca_layer_eval(H1, H2, state: CCAState):
    """Eval-mode CCA layer: per-view affine projections with stored U/V/means
    (reference lasagne cca.py:185-201)."""
    lv1 = _dot(H1 - state.mean1, state.U)
    lv2 = _dot(H2 - state.mean2, state.V)
    return lv1, lv2
