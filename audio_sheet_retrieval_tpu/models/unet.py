"""OMR segmentation U-Net + lasagne weight import.

Architecture parity with reference:sheet_utils/system_detector.py:22-76 (the
bar detector is identical; the note detector differs only in INPUT_SHAPE):
encoder 4 blocks (8->64 filters, [conv3x3-BN-ELU x2, maxpool2] with skips
taken pre-pool), decoder 3 stages (2x2 stride-2 transposed conv -> BN ->
ReLU -> elementwise sum with the skip -> BN -> conv3x3-BN-ELU x2 ->
dropout(eval: identity)), sigmoid 1x1 head with bias.

Import conventions (verified against omr_models/system_params.pkl — 99
arrays):
  * plain lasagne Conv2DLayer has flip_filters=True (true convolution), so
    3x3 kernels are spatially flipped on import to cross-correlation form;
  * TransposedConv2DLayer stores W as (C_in, C_out, Kh, Kw) with
    flip_filters=False; the 2x2 stride-2 upsampling is implemented exactly
    as the gradient-of-correlation: out[2i+k, 2j+l, o] = sum_c x[i,j,c] *
    W[c,o,k,l] — one einsum + reshape, no conv ambiguity;
  * the transposed conv's default nonlinearity (ReLU) is moved after its BN
    by the lasagne batch_norm helper.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

N_ENC_BLOCKS = 8
N_DEC_STAGES = 3
N_ARRAYS = 99


_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def _bn_eval(h, bn):
    # fold scale/shift at the activation dtype: on the bf16 path this
    # keeps the elementwise traffic half-width (the U-Net is channel-
    # starved, 8-64ch, so it is memory-bound, not compute-bound — per-layer
    # f32<->bf16 converts COST more than bf16 multiplies save)
    dt = h.dtype
    return (h - bn["mean"].astype(dt)) \
        * (bn["inv_std"] * bn["gamma"]).astype(dt) + bn["beta"].astype(dt)


def _conv_same(x, w, precision=jax.lax.Precision.HIGHEST,
               dtype=jnp.float32):
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), w.astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32, precision=precision)
    return y.astype(dtype)


def _maxpool2(x):
    # init value as a numpy scalar of the operand dtype (a jnp array here
    # would be closed over as a tracer constant under jit)
    return jax.lax.reduce_window(
        x, np.array(-np.inf, x.dtype), jax.lax.max, (1, 2, 2, 1),
        (1, 2, 2, 1), "VALID")


def _tconv2x2(x, w_ciokl, dtype=jnp.float32):
    """Exact lasagne TransposedConv2DLayer (2x2, stride 2, no crop):
    each input pixel expands to a 2x2 block weighted by W[c, o, k, l]."""
    n, h, wdt, c = x.shape
    y = jnp.einsum("nhwc,cokl->nhwokl", x.astype(dtype),
                   w_ciokl.astype(dtype),
                   preferred_element_type=jnp.float32)
    y = y.astype(dtype)
    y = jnp.transpose(y, (0, 1, 4, 2, 5, 3))          # n, h, k, w, l, o
    return y.reshape(n, 2 * h, 2 * wdt, y.shape[-1])


def unet_apply(params: Dict[str, Any], x: jnp.ndarray,
               return_intermediates: bool = False,
               compute_dtype: str = "float32",
               conv_precision: str = "highest"):
    """Eval-mode forward: [N, H, W, 1] float in [0, 1] -> [N, H, W] sigmoid
    probability map. H and W must be multiples of 8 (3 pooling stages).

    ``return_intermediates`` additionally returns the named stage
    activations (the reference Network.compute_layer_output debugging
    facility, omr.py:138-163).

    ``compute_dtype``/``conv_precision``: the OMR arm of the serving
    precision ladder (same methodology as the retrieval encoders,
    models/configs.py conv_precision). On the bfloat16 arm the WHOLE
    pipeline (activations, BN folds, ELU, pools) runs bf16 — this U-Net
    is channel-starved (8-64 ch) and memory-bound, so per-layer f32<->bf16
    converts around f32 elementwise ops cost more traffic than they save;
    convs/tconvs still ACCUMULATE f32 (preferred_element_type). The head
    bias-add and sigmoid stay f32. Gated on detection equality
    (tests/test_omr.py)."""
    precision = _PRECISIONS[conv_precision]
    if compute_dtype not in ("bfloat16", "float32"):
        # fail fast like conv_precision's _PRECISIONS lookup — a silent
        # f32 fallback on a typo ('bf16') would ship f32 latency/accuracy
        # numbers labelled as the bf16 arm
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', "
                         f"got {compute_dtype!r}")
    dtype = (jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32)
    h = x
    skips = []
    inter = {}
    for i, blk in enumerate(params["enc"]):
        h = jax.nn.elu(_bn_eval(_conv_same(h, blk["w"], precision, dtype),
                                blk))
        inter[f"enc{i}"] = h
        if i % 2 == 1 and i < N_ENC_BLOCKS - 1:
            skips.append(h)
            h = _maxpool2(h)
    # skips = [p1(8ch), p2(16ch), p3(32ch)]; bottleneck h is 64ch
    for j, (stage, skip) in enumerate(zip(params["dec"], reversed(skips))):
        h = _tconv2x2(h, stage["tconv_w"], dtype)
        h = jax.nn.relu(_bn_eval(h, stage["tconv_bn"]))
        h = h + skip
        h = _bn_eval(h, stage["sum_bn"])
        for blk in (stage["conv1"], stage["conv2"]):
            h = jax.nn.elu(_bn_eval(_conv_same(h, blk["w"], precision,
                                               dtype), blk))
        inter[f"dec{j}"] = h
        # dropout: identity at eval (reference system_detector.py:58,66)
    head = params["head"]
    h = _conv_same(h, head["w"], precision, dtype) + head["b"]
    out = jax.nn.sigmoid(h[..., 0])
    if return_intermediates:
        return out, inter
    return out


def _import_conv_bn(arrays, i, flip: bool):
    w = arrays[i]
    if flip:
        w = w[:, :, ::-1, ::-1]
    return {
        "w": jnp.asarray(np.transpose(w, (2, 3, 1, 0)).copy()),
        "beta": jnp.asarray(arrays[i + 1]),
        "gamma": jnp.asarray(arrays[i + 2]),
        "mean": jnp.asarray(arrays[i + 3]),
        "inv_std": jnp.asarray(arrays[i + 4]),
    }, i + 5


def _import_bn(arrays, i):
    return {
        "beta": jnp.asarray(arrays[i]),
        "gamma": jnp.asarray(arrays[i + 1]),
        "mean": jnp.asarray(arrays[i + 2]),
        "inv_std": jnp.asarray(arrays[i + 3]),
    }, i + 4


def import_unet_params(arrays: List[np.ndarray],
                       flip_conv_filters: bool = True) -> Dict[str, Any]:
    if len(arrays) != N_ARRAYS:
        raise ValueError(f"expected {N_ARRAYS} arrays, got {len(arrays)}")
    arrays = [np.asarray(a, np.float32) for a in arrays]
    i = 0
    enc = []
    for _ in range(N_ENC_BLOCKS):
        blk, i = _import_conv_bn(arrays, i, flip_conv_filters)
        enc.append(blk)
    dec = []
    for _ in range(N_DEC_STAGES):
        tconv_w = jnp.asarray(arrays[i])  # (C_in, C_out, 2, 2)
        i += 1
        tconv_bn, i = _import_bn(arrays, i)
        sum_bn, i = _import_bn(arrays, i)
        conv1, i = _import_conv_bn(arrays, i, flip_conv_filters)
        conv2, i = _import_conv_bn(arrays, i, flip_conv_filters)
        dec.append({"tconv_w": tconv_w, "tconv_bn": tconv_bn,
                    "sum_bn": sum_bn, "conv1": conv1, "conv2": conv2})
    w_head = arrays[i]
    if flip_conv_filters:
        w_head = w_head[:, :, ::-1, ::-1]
    head = {"w": jnp.asarray(np.transpose(w_head, (2, 3, 1, 0)).copy()),
            "b": jnp.asarray(arrays[i + 1])}
    return {"enc": enc, "dec": dec, "head": head}


def load_unet_checkpoint(path: str,
                         flip_conv_filters: bool = True) -> Dict[str, Any]:
    if path.endswith(".npz"):
        from audio_sheet_retrieval_tpu import assets

        arrays = assets.load_raw_arrays(path)
    else:
        with open(path, "rb") as fp:
            arrays = pickle.load(fp, encoding="latin1")
    return import_unet_params(arrays, flip_conv_filters)
