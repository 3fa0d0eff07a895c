"""Full cross-modal retrieval model: twin encoders + CCA head + length norm.

Parity with reference:models/mutopia_ccal_cont.py:64-145 (build_model):
view encoders -> CCALayer (or LearnedCCALayer) -> per-view slice -> row-L2
normalization. In eval mode the CCA head is a per-view affine projection, so
each view embeds independently — no dummy-second-input hack is needed
(the reference had to feed zero tensors for the unused view,
reference:retrieval_wrapper.py:41-77).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from audio_sheet_retrieval_tpu.models import encoder as enc
from audio_sheet_retrieval_tpu.models.configs import ModelConfig
from audio_sheet_retrieval_tpu.ops import cca as cca_ops

HIGHEST = jax.lax.Precision.HIGHEST


class ModelParams(NamedTuple):
    view1: Dict[str, Any]          # sheet encoder
    view2: Dict[str, Any]          # spectrogram encoder
    cca: cca_ops.CCAState          # projection-head state (U/V trainable
    #                                only for LearnedCCALayer models)


def init_model(key, cfg: ModelConfig) -> ModelParams:
    k1, k2, k3 = jax.random.split(key, 3)
    view1 = enc.init_encoder(k1, cfg.input_shape_1[0], cfg.num_filters,
                             cfg.dim_latent)
    view2 = enc.init_encoder(k2, cfg.input_shape_2[0], cfg.num_filters,
                             cfg.dim_latent)
    cca_state = cca_ops.CCAState.zeros(cfg.dim_latent)
    if not cfg.use_ccal:
        # LearnedCCALayer initializes U/V He-uniform (mutopia_ccal_cont.py:130)
        import numpy as np

        d = cfg.dim_latent
        bound = np.sqrt(6.0 / d)
        ku, kv = jax.random.split(k3)
        cca_state = cca_state._replace(
            U=jax.random.uniform(ku, (d, d), jnp.float32, -bound, bound),
            V=jax.random.uniform(kv, (d, d), jnp.float32, -bound, bound),
        )
    return ModelParams(view1=view1, view2=view2, cca=cca_state)


def length_norm(x: jnp.ndarray) -> jnp.ndarray:
    """Row L2 normalization (reference lasagne cca.py:29-40)."""
    return x / jnp.linalg.norm(x, axis=1, keepdims=True)


def _dtype(cfg: ModelConfig):
    return jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32


def forward_train(
    params: ModelParams, x1: jnp.ndarray, x2: jnp.ndarray, cfg: ModelConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, ModelParams, jnp.ndarray]:
    """Training forward pass of both views.

    Returns (lv1, lv2, new_params, corr): L2-normalized projected latents,
    parameters with updated BN + CCA running state, and the monitored
    canonical correlations.
    """
    dt = _dtype(cfg)
    h1, new_v1 = enc.encoder_apply(
        params.view1, x1, train=True, compute_dtype=dt,
        bn_epsilon=cfg.bn_epsilon, bn_alpha=cfg.bn_alpha,
        conv_precision=cfg.conv_precision)
    h2, new_v2 = enc.encoder_apply(
        params.view2, x2, train=True, compute_dtype=dt,
        bn_epsilon=cfg.bn_epsilon, bn_alpha=cfg.bn_alpha,
        conv_precision=cfg.conv_precision)

    if cfg.use_ccal:
        # polar whitening changes the monitored corr semantics; with a
        # nonzero corr-loss weight the reference eigh form is required
        whitening = cfg.whitening if cfg.weight_tno == 0.0 else "eigh"
        # a nonzero corr-loss weight needs grads through the whitening
        grad_mode = cfg.cca_grad if cfg.weight_tno == 0.0 else "full"
        lv1, lv2, new_cca, corr = cca_ops.cca_layer_train(
            h1, h2, params.cca, r1=cfg.r1, r2=cfg.r2, rT=cfg.rT,
            alpha=cfg.alpha, whitening=whitening, grad_mode=grad_mode)
    else:
        # LearnedCCALayer: U/V are trainable; batch-mean centering in train
        # mode, running means updated with alpha (lasagne cca.py:239-323)
        a = cfg.alpha
        mean1 = (1.0 - a) * params.cca.mean1 + a * jnp.mean(h1, axis=0)
        mean2 = (1.0 - a) * params.cca.mean2 + a * jnp.mean(h2, axis=0)
        lv1 = (h1 - mean1).dot(params.cca.U, precision=HIGHEST)
        lv2 = (h2 - mean2).dot(params.cca.V, precision=HIGHEST)
        corr = jnp.zeros((cfg.dim_latent,), jnp.float32)
        new_cca = params.cca._replace(
            mean1=jax.lax.stop_gradient(mean1),
            mean2=jax.lax.stop_gradient(mean2),
        )

    lv1 = length_norm(lv1)
    lv2 = length_norm(lv2)
    return lv1, lv2, ModelParams(new_v1, new_v2, new_cca), corr


def embed_view1(params: ModelParams, x1: jnp.ndarray,
                cfg: ModelConfig) -> jnp.ndarray:
    """Deterministic view-1 (sheet) embedding: encoder -> affine CCA -> L2."""
    h1, _ = enc.encoder_apply(params.view1, x1, train=False,
                              compute_dtype=_dtype(cfg),
                              conv_precision=cfg.conv_precision)
    lv1 = (h1 - params.cca.mean1).dot(params.cca.U, precision=HIGHEST)
    return length_norm(lv1)


def embed_view2(params: ModelParams, x2: jnp.ndarray,
                cfg: ModelConfig) -> jnp.ndarray:
    """Deterministic view-2 (audio) embedding: encoder -> affine CCA -> L2."""
    h2, _ = enc.encoder_apply(params.view2, x2, train=False,
                              compute_dtype=_dtype(cfg),
                              conv_precision=cfg.conv_precision)
    lv2 = (h2 - params.cca.mean2).dot(params.cca.V, precision=HIGHEST)
    return length_norm(lv2)


def forward_eval(params: ModelParams, x1, x2, cfg: ModelConfig):
    return embed_view1(params, x1, cfg), embed_view2(params, x2, cfg)


def pre_cca_latent_v1(params: ModelParams, x1, cfg: ModelConfig):
    """Deterministic view-1 encoder output BEFORE the CCA head — input to
    the large-batch refinement fit (reference:refine_cca.py:86-97)."""
    h1, _ = enc.encoder_apply(params.view1, x1, train=False,
                              compute_dtype=_dtype(cfg),
                              conv_precision=cfg.conv_precision)
    return h1


def pre_cca_latent_v2(params: ModelParams, x2, cfg: ModelConfig):
    h2, _ = enc.encoder_apply(params.view2, x2, train=False,
                              compute_dtype=_dtype(cfg),
                              conv_precision=cfg.conv_precision)
    return h2


def pre_cca_latents(params: ModelParams, x1, x2, cfg: ModelConfig):
    """Both views' pre-CCA encoder outputs."""
    return (pre_cca_latent_v1(params, x1, cfg),
            pre_cca_latent_v2(params, x2, cfg))


# --- serving fast path -------------------------------------------------------


class FoldedModel(NamedTuple):
    """BN-folded, projection-fused inference model (see fold())."""

    view1: Dict[str, Any]
    view2: Dict[str, Any]
    U: jnp.ndarray
    V: jnp.ndarray
    b1: jnp.ndarray     # -mean1 @ U folded into a bias
    b2: jnp.ndarray


def fold(params: ModelParams) -> FoldedModel:
    return FoldedModel(
        view1=enc.fold_batch_norm(params.view1),
        view2=enc.fold_batch_norm(params.view2),
        U=params.cca.U,
        V=params.cca.V,
        b1=-params.cca.mean1.dot(params.cca.U, precision=HIGHEST),
        b2=-params.cca.mean2.dot(params.cca.V, precision=HIGHEST),
    )


def folded_embed_view1(fm: FoldedModel, x1, compute_dtype=jnp.float32):
    h = enc.encoder_apply_folded(fm.view1, x1, compute_dtype=compute_dtype)
    return length_norm(h.dot(fm.U, precision=HIGHEST) + fm.b1)


def folded_embed_view2(fm: FoldedModel, x2, compute_dtype=jnp.float32):
    h = enc.encoder_apply_folded(fm.view2, x2, compute_dtype=compute_dtype)
    return length_norm(h.dot(fm.V, precision=HIGHEST) + fm.b2)
