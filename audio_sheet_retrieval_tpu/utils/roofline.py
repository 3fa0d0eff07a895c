"""Analytic FLOP / roofline accounting for the twin-encoder models.

Turns the bench's task-unit figures (emb/s, updates/s) into hardware
terms: model FLOPs per embedding / per training update from the known conv
geometry (models/encoder.py — 8x SAME 3x3 + 1x1 head, maxpool2 after every
second block), achieved FLOP/s, and the share of the card's published peak
for the dtype/precision arm actually run.

Conventions (stated so the numbers are checkable):
  * FLOPs count multiply-adds as 2 (the standard MFU convention); conv
    FLOPs = 2 * H_out * W_out * K^2 * C_in * C_out. BN/ELU/pool
    elementwise work and the window gathers are EXCLUDED from model FLOPs.
  * A training update is counted as 3x forward (forward + input-grad conv
    + weight-grad conv, each the same MAC count) for both views — the
    standard conv-backward accounting. Optimizer/BN/CCA-whitening FLOPs
    are O(params) / O(32^2) and ignored.
  * The peak for an arm: bfloat16 -> the bf16 tensor-core rate; float32
    "highest" -> the plain fp32 rate (no tensor cores); float32 "high" or
    "default" -> the TF32 tensor-core rate, which XLA's GPU backend may
    use for those arms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from audio_sheet_retrieval_tpu.models.encoder import (
    N_CONV_BLOCKS,
    block_channels,
)

# Published peaks per card, keyed by jax ``device_kind``. Dense rates
# without sparsity, at the card's full power limit. Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM part.
CHIP_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9,
        "name": "NVIDIA H100 SXM"},
}


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    index: int
    h: int              # output spatial height
    w: int
    k: int              # kernel size (3 or 1)
    c_in: int
    c_out: int
    flops: int          # 2 * h * w * k^2 * c_in * c_out (per sample)


def conv_stack(cfg, view: int) -> List[ConvBlock]:
    """Per-block geometry of one encoder view, mirroring
    models/encoder.py::encoder_apply (SAME 3x3 convs keep H,W; maxpool2
    after blocks 1,3,5,7; final block is a 1x1 VALID conv)."""
    shape = cfg.encoder_input_shape_1 if view == 1 else cfg.input_shape_2
    c_in, h, w = shape
    chans = block_channels(cfg.num_filters, cfg.dim_latent)
    blocks = []
    for i, c_out in enumerate(chans):
        k = 1 if i == N_CONV_BLOCKS - 1 else 3
        flops = 2 * h * w * k * k * c_in * c_out
        blocks.append(ConvBlock(i, h, w, k, c_in, c_out, flops))
        c_in = c_out
        if i < N_CONV_BLOCKS - 1 and i % 2 == 1:
            h, w = h // 2, w // 2
    return blocks


def embed_flops(cfg, view: int) -> int:
    """Model FLOPs for ONE embedding (forward, conv MACs x2 + the 32x32
    CCA projection; see module conventions)."""
    total = sum(b.flops for b in conv_stack(cfg, view))
    return total + 2 * cfg.dim_latent * cfg.dim_latent  # CCA projection


def train_update_flops(cfg) -> int:
    """Model FLOPs for ONE optimizer update at cfg.batch_size (both
    views, forward + backward = 3x forward)."""
    per_sample = embed_flops(cfg, 1) + embed_flops(cfg, 2)
    return 3 * per_sample * cfg.batch_size


def chip_peaks(device_kind: str) -> Dict[str, float]:
    """Published peaks of the card; an unknown card is an error."""
    try:
        return CHIP_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r} "
            f"(known: {sorted(CHIP_PEAKS)})") from None


def effective_peak_flops(device_kind: str, compute_dtype: str,
                         conv_precision: str) -> float:
    """Matmul/conv peak (FLOP/s) of the card for one dtype/precision arm."""
    peaks = chip_peaks(device_kind)
    if compute_dtype == "bfloat16":
        return peaks["bf16_flops"]
    if conv_precision == "highest":
        return peaks["fp32_flops"]
    return peaks["tf32_flops"]


def mfu(achieved_flops_per_s: float, device_kind: str, compute_dtype: str,
        conv_precision: str) -> float:
    """Model FLOPs utilization in [0,1] vs the arm's peak."""
    return achieved_flops_per_s / effective_peak_flops(
        device_kind, compute_dtype, conv_precision)


def bytes_bound_s(nbytes: float, device_kind: str) -> float:
    """Least time to move ``nbytes`` through device memory at the
    published bandwidth."""
    return nbytes / chip_peaks(device_kind)["hbm_bytes_per_s"]


def summarize(cfg, device_kind: str) -> Dict[str, float]:
    """One-stop numbers for the bench: per-embed and per-update model
    FLOPs plus the card's name."""
    return {
        "flops_per_sheet_embed": embed_flops(cfg, 1),
        "flops_per_spec_embed": embed_flops(cfg, 2),
        "flops_per_update": train_update_flops(cfg),
        "chip": chip_peaks(device_kind)["name"],
    }
