"""One-way importer for reference Theano/Lasagne .pkl checkpoints.

Checkpoint layout (verified against the shipped tutorial checkpoint,
reference:tutorials/params_all_split_mutopia_full_aug.pkl): a flat list of
97 float32 arrays in ``lasagne.layers.get_all_param_values([l_v1latent,
l_v2latent])`` order —

  * view1: 9 conv blocks x (W[OIHW], beta, gamma, mean, inv_std) = 45
  * view2: same = 45
  * CCALayer: U(32,32), V(32,32), mean1(32), mean2(32), S12, S11, S22
    (add_param order, reference lasagne cca.py:69-77)

Conversions applied:
  * conv kernels OIHW -> HWIO (no spatial flip: the reference trains with
    cuDNN Conv2DDNNLayer, flip_filters=False, i.e. cross-correlation —
    reference models/mutopia_ccal_cont.py:12-18),
  * BN running inv_std used verbatim (lasagne stores 1/sqrt(var+eps)).

The legacy "redundant dump" format (list of per-layer lists,
reference run_eval.py:76-79) is handled by extracting the complete
l_v1latent parameter list (which already spans both views + CCA head,
since the CCA layer merges the two branches).
"""

from __future__ import annotations

import pickle
from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.models.cca_model import ModelParams
from audio_sheet_retrieval_tpu.models.configs import ModelConfig
from audio_sheet_retrieval_tpu.ops.cca import CCAState

ARRAYS_PER_BLOCK = 5
BLOCKS_PER_VIEW = 9
ARRAYS_PER_VIEW = ARRAYS_PER_BLOCK * BLOCKS_PER_VIEW  # 45
N_CCA_ARRAYS = 7
N_TOTAL = 2 * ARRAYS_PER_VIEW + N_CCA_ARRAYS  # 97


def load_lasagne_pickle(path: str) -> List[np.ndarray]:
    """Load a py2 lasagne parameter pickle (latin1 for numpy py2 pickles),
    or the repo's raw-array .npz asset form of the same checkpoint."""
    if path.endswith(".npz"):
        from audio_sheet_retrieval_tpu import assets

        return [np.asarray(a, dtype=np.float32)
                for a in assets.load_raw_arrays(path)]
    with open(path, "rb") as fp:
        params = pickle.load(fp, encoding="latin1")
    if params and isinstance(params[0], (list, tuple)):
        # legacy redundant dump: pick the per-layer list that spans the full
        # network (l_v1latent contains both views + CCA head)
        full = [p for p in params if len(p) == N_TOTAL]
        if not full:
            raise ValueError(
                f"legacy dump in {path} has no {N_TOTAL}-array layer list "
                f"(lengths: {[len(p) for p in params]})"
            )
        params = full[0]
    return [np.asarray(a, dtype=np.float32) for a in params]


def _import_view(arrays: Sequence[np.ndarray]):
    blocks = []
    for b in range(BLOCKS_PER_VIEW):
        w, beta, gamma, mean, inv_std = arrays[
            b * ARRAYS_PER_BLOCK:(b + 1) * ARRAYS_PER_BLOCK
        ]
        blocks.append({
            "w": jnp.asarray(np.transpose(w, (2, 3, 1, 0))),  # OIHW -> HWIO
            "beta": jnp.asarray(beta),
            "gamma": jnp.asarray(gamma),
            "mean": jnp.asarray(mean),
            "inv_std": jnp.asarray(inv_std),
        })
    return {"blocks": blocks}


def import_retrieval_params(arrays: Sequence[np.ndarray],
                            cfg: ModelConfig) -> ModelParams:
    if len(arrays) != N_TOTAL:
        raise ValueError(
            f"expected {N_TOTAL} arrays, got {len(arrays)} — not a "
            f"reference retrieval checkpoint"
        )
    view1 = _import_view(arrays[:ARRAYS_PER_VIEW])
    view2 = _import_view(arrays[ARRAYS_PER_VIEW:2 * ARRAYS_PER_VIEW])
    u, v, m1, m2, s12, s11, s22 = arrays[2 * ARRAYS_PER_VIEW:]
    d = cfg.dim_latent
    for name, a, shape in [("U", u, (d, d)), ("V", v, (d, d)),
                           ("mean1", m1, (d,)), ("mean2", m2, (d,))]:
        if a.shape != shape:
            raise ValueError(f"CCA param {name} has shape {a.shape}, want {shape}")
    cca = CCAState(
        U=jnp.asarray(u), V=jnp.asarray(v),
        mean1=jnp.asarray(m1), mean2=jnp.asarray(m2),
        S12=jnp.asarray(s12), S11=jnp.asarray(s11), S22=jnp.asarray(s22),
    )
    # sanity check the first conv against the model config (checked on the
    # host-side source array: no device->host download)
    n_filters = int(arrays[0].shape[0])  # OIHW
    if n_filters != cfg.num_filters:
        raise ValueError(
            f"checkpoint first-conv has {n_filters} filters but model "
            f"'{cfg.name}' expects {cfg.num_filters} — wrong model variant?"
        )
    return ModelParams(view1=view1, view2=view2, cca=cca)


def load_retrieval_checkpoint(path: str, cfg: ModelConfig) -> ModelParams:
    return import_retrieval_params(load_lasagne_pickle(path), cfg)


def export_lasagne_arrays(params: ModelParams) -> List[np.ndarray]:
    """Inverse of import: flat 97-array list (for _est_UV-style re-dumps,
    reference refine_cca.py:109-111)."""
    out: List[np.ndarray] = []
    for view in (params.view1, params.view2):
        for blk in view["blocks"]:
            out.append(np.transpose(np.asarray(blk["w"]), (3, 2, 0, 1)))
            for k in ("beta", "gamma", "mean", "inv_std"):
                out.append(np.asarray(blk[k]))
    for k in ("U", "V", "mean1", "mean2", "S12", "S11", "S22"):
        out.append(np.asarray(getattr(params.cca, k)))
    return out
