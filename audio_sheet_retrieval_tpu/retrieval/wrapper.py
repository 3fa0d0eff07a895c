"""Embedding service API.

Parity with reference:retrieval_wrapper.py — ``compute_view_1/2`` batched
embedding of raw sheet snippets / spectrogram excerpts. Improvements over the
reference: no dummy-second-view inputs (eval-mode CCA is per-view affine),
each view is one jitted function compiled once for a fixed batch size, and an
optional BN-folded fast path for serving.

Accepts both checkpoint formats: this framework's native pytree pickles and
reference Theano/Lasagne .pkl dumps (auto-detected).
"""

from __future__ import annotations

import pickle
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.data.iterators import batch_compute1
from audio_sheet_retrieval_tpu.models import cca_model, lasagne_import
from audio_sheet_retrieval_tpu.models.cca_model import ModelParams
from audio_sheet_retrieval_tpu.models.configs import ModelConfig
from audio_sheet_retrieval_tpu.train.engine import (
    prepare_view1_device,
    prepare_view2_device,
)
from audio_sheet_retrieval_tpu.utils import io as uio


def load_any_checkpoint(path: str, cfg: ModelConfig) -> ModelParams:
    """Load a native pytree checkpoint, a reference lasagne .pkl, or the
    repo's raw-array .npz asset form of a lasagne checkpoint."""
    if path.endswith(".npz"):
        return lasagne_import.load_retrieval_checkpoint(path, cfg)
    with open(path, "rb") as fp:
        payload = pickle.load(fp, encoding="latin1")
    if isinstance(payload, dict) and payload.get("format") == uio.FORMAT_TAG:
        template = cca_model.init_model(jax.random.PRNGKey(0), cfg)
        # uio.load_pytree enforces schema negotiation (version gate +
        # ordered migrations) — don't consume the raw payload directly
        return uio.load_pytree(path, like=template)
    if isinstance(payload, list):
        if payload and isinstance(payload[0], (list, tuple)):
            full = [p for p in payload if len(p) == lasagne_import.N_TOTAL]
            payload = full[0]
        arrays = [np.asarray(a, np.float32) for a in payload]
        return lasagne_import.import_retrieval_params(arrays, cfg)
    raise ValueError(f"unrecognized checkpoint format in {path}")


class RetrievalWrapper:
    """Cross-modality embedding wrapper (reference retrieval_wrapper.py:12-77)."""

    def __init__(self, model_cfg: ModelConfig, param_file: Optional[str] = None,
                 params: Optional[ModelParams] = None, batch_size: int = 100,
                 folded: bool = True):
        self.cfg = model_cfg
        self.code_dim = model_cfg.dim_latent
        self.batch_size = batch_size
        if params is None:
            if param_file is None:
                raise ValueError("need param_file or params")
            params = load_any_checkpoint(param_file, model_cfg)
        self.params = params
        self.shape_view1 = model_cfg.input_shape_1
        self.shape_view2 = model_cfg.input_shape_2

        # NOTE parameters are jit ARGUMENTS, never closures: closed-over
        # weight arrays get inlined as HLO constants, which bloats programs
        # and their compile time.
        cfg = model_cfg
        compute_dtype = (jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                         else jnp.float32)
        if folded:
            fm = jax.device_put(cca_model.fold(params))

            @jax.jit
            def v1_p(m, x):
                return cca_model.folded_embed_view1(
                    m, prepare_view1_device(x, cfg),
                    compute_dtype=compute_dtype)

            @jax.jit
            def v2_p(m, x):
                return cca_model.folded_embed_view2(
                    m, prepare_view2_device(x), compute_dtype=compute_dtype)

            self._v1 = lambda x: v1_p(fm, x)
            self._v2 = lambda x: v2_p(fm, x)
        else:
            p_dev = jax.device_put(params)

            @jax.jit
            def v1_p(p, x):
                return cca_model.embed_view1(
                    p, prepare_view1_device(x, cfg), cfg)

            @jax.jit
            def v2_p(p, x):
                return cca_model.embed_view2(
                    p, prepare_view2_device(x), cfg)

            self._v1 = lambda x: v1_p(p_dev, x)
            self._v2 = lambda x: v2_p(p_dev, x)

    def compute_view_1(self, X: np.ndarray) -> np.ndarray:
        """Embed raw sheet snippets [N, 1, H, W] (uint8 range) -> [N, 32]."""
        X = np.asarray(X, np.float32)
        bs = min(self.batch_size, X.shape[0])
        return batch_compute1(X, lambda e: self._v1(jnp.asarray(e)), bs)

    def compute_view_2(self, Z: np.ndarray) -> np.ndarray:
        """Embed spectrogram excerpts [N, 1, bins, frames] -> [N, 32]."""
        Z = np.asarray(Z, np.float32)
        bs = min(self.batch_size, Z.shape[0])
        return batch_compute1(Z, lambda e: self._v2(jnp.asarray(e)), bs)
