"""Twin VGG-style convolutional encoder, functional JAX.

Architecture parity with reference:models/mutopia_ccal_cont.py:54-122 —
per view: 4x [conv3x3-BN-ELU x2 + maxpool2] then conv1x1(dim_latent)-BN
(identity) then global average pooling. Lasagne's ``batch_norm`` helper drops
the conv bias and moves the nonlinearity after BN; blocks here do exactly
conv (no bias) -> BN -> activation.

Layout and numerics:
  * NHWC layout / HWIO kernels (XLA hands these convs to cuDNN on the GPU),
  * optional bfloat16 conv compute with float32 accumulation/statistics,
  * explicit parameter pytrees (trainable: w/beta/gamma; running state:
    mean/inv_std, stored exactly as lasagne — inv_std, not variance — so the
    .pkl importer is a pure reshape/transpose),
  * `fold_batch_norm` produces a pure conv+bias network for serving (BN is
    affine before the ELU, so folding is exact).

BN semantics: eval y = (x - mean) * inv_std * gamma + beta with stored
inv_std = 1/sqrt(var + eps); train uses batch statistics and EMA-updates the
running (mean, inv_std) in lasagne fashion (EMA directly on inv_std).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, Any]

# per-block spec: (kernel_size, out_channels multiplier handled by caller)
N_CONV_BLOCKS = 9  # 8x 3x3 + 1x 1x1


def block_channels(num_filters: int, dim_latent: int) -> List[int]:
    f = num_filters
    return [f, f, 2 * f, 2 * f, 4 * f, 4 * f, 4 * f, 4 * f, dim_latent]


def init_encoder(key, in_channels: int, num_filters: int, dim_latent: int,
                 dtype=jnp.float32) -> Params:
    """He-uniform conv init (lasagne init.HeUniform, mutopia_ccal_cont.py:45)."""
    chans = block_channels(num_filters, dim_latent)
    blocks = []
    c_in = in_channels
    for i, c_out in enumerate(chans):
        ks = 1 if i == N_CONV_BLOCKS - 1 else 3
        key, sub = jax.random.split(key)
        fan_in = ks * ks * c_in
        bound = np.sqrt(6.0 / fan_in)
        w = jax.random.uniform(sub, (ks, ks, c_in, c_out), dtype,
                               minval=-bound, maxval=bound)
        blocks.append({
            "w": w,
            "beta": jnp.zeros((c_out,), dtype),
            "gamma": jnp.ones((c_out,), dtype),
            "mean": jnp.zeros((c_out,), dtype),
            "inv_std": jnp.ones((c_out,), dtype),
        })
        c_in = c_out
    return {"blocks": blocks}


_PRECISIONS = {"highest": jax.lax.Precision.HIGHEST,
               "high": jax.lax.Precision.HIGH,
               "default": jax.lax.Precision.DEFAULT}


def _conv(x, w, compute_dtype, conv_precision: str = "highest"):
    # float32 path pins HIGHEST precision by default: full f32 multiplies,
    # the checkpoint-parity arm. "high" and "default" let the backend pick
    # a cheaper algorithm (on the GPU: TF32 tensor cores, ~1e-3 relative
    # error per product); chip_smoke.py prints what each arm lowers to and
    # its deviation from the numpy oracle. The bfloat16 fast path keeps
    # conv output in bf16 (a float32 preferred_element_type breaks the
    # transpose/grad rule with mixed dtypes); callers cast the activations
    # back to float32 for the BN statistics.
    f32 = compute_dtype == jnp.float32
    out = jax.lax.conv_general_dilated(
        x.astype(compute_dtype),
        w.astype(compute_dtype),
        window_strides=(1, 1),
        padding="SAME" if w.shape[0] == 3 else "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32 if f32 else None,
        precision=(_PRECISIONS[conv_precision] if f32
                   else jax.lax.Precision.DEFAULT),
    )
    return out if f32 else out.astype(jnp.float32)


def _maxpool2(x):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, 2, 2, 1),
        window_strides=(1, 2, 2, 1),
        padding="VALID",
    )


def encoder_apply(
    params: Params,
    x: jnp.ndarray,
    *,
    train: bool = False,
    compute_dtype=jnp.float32,
    bn_epsilon: float = 1e-4,
    bn_alpha: float = 1e-2,
    conv_precision: str = "highest",
) -> Tuple[jnp.ndarray, Params]:
    """Run the encoder.

    Args:
      x: [B, H, W, C] float input (sheet snippet or spectrogram excerpt).
      train: batch-statistics BN + running-stat update when True.

    Returns:
      (latent [B, dim_latent] float32, new_params) — new_params carries
      EMA-updated BN statistics in train mode (otherwise params unchanged).
    """
    blocks = params["blocks"]
    new_blocks = []
    h = x
    for i, blk in enumerate(blocks):
        h = _conv(h, blk["w"], compute_dtype, conv_precision)
        if train:
            mu = jnp.mean(h, axis=(0, 1, 2))
            var = jnp.var(h, axis=(0, 1, 2))
            inv_std = jax.lax.rsqrt(var + bn_epsilon)
            new_blk = dict(
                blk,
                mean=(1.0 - bn_alpha) * blk["mean"]
                + bn_alpha * jax.lax.stop_gradient(mu),
                inv_std=(1.0 - bn_alpha) * blk["inv_std"]
                + bn_alpha * jax.lax.stop_gradient(inv_std),
            )
        else:
            mu, inv_std = blk["mean"], blk["inv_std"]
            new_blk = blk
        new_blocks.append(new_blk)
        h = (h - mu) * (inv_std * blk["gamma"]) + blk["beta"]
        if i < N_CONV_BLOCKS - 1:
            h = jax.nn.elu(h)
            if i % 2 == 1:  # after every second 3x3 block
                h = _maxpool2(h)
    # global average pool (lasagne GlobalPoolLayer default = mean)
    latent = jnp.mean(h, axis=(1, 2)).astype(jnp.float32)
    return latent, {"blocks": new_blocks}


def fold_batch_norm(params: Params) -> Params:
    """Fold eval-mode BN into conv weight + bias: serving fast path.

    y = ((x*w) - mean)*inv_std*gamma + beta  ==  x*(w*s) + (beta - mean*s),
    s = inv_std*gamma.
    """
    folded = []
    for blk in params["blocks"]:
        s = blk["inv_std"] * blk["gamma"]
        folded.append({
            "w": blk["w"] * s[None, None, None, :],
            "b": blk["beta"] - blk["mean"] * s,
        })
    return {"blocks": folded}


def encoder_apply_folded(params: Params, x: jnp.ndarray,
                         *, compute_dtype=jnp.float32,
                         conv_precision: str = "highest") -> jnp.ndarray:
    """Inference with BN-folded parameters (see fold_batch_norm)."""
    h = x
    blocks = params["blocks"]
    for i, blk in enumerate(blocks):
        h = _conv(h, blk["w"], compute_dtype, conv_precision) + blk["b"]
        if i < N_CONV_BLOCKS - 1:
            h = jax.nn.elu(h)
            if i % 2 == 1:
                h = _maxpool2(h)
    return jnp.mean(h, axis=(1, 2)).astype(jnp.float32)
