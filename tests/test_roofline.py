"""Roofline accounting (utils/roofline.py): the analytic FLOP counts that
make the bench's ceiling claims auditable must themselves be auditable —
pinned here against XLA's own HLO cost analysis of the real encoder."""

import jax
import jax.numpy as jnp
import pytest

from audio_sheet_retrieval_tpu.models import encoder
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.utils import roofline


@pytest.fixture(scope="module")
def rsz_cfg():
    return get_model_config("mutopia_ccal_cont_rsz")


def test_conv_stack_geometry(rsz_cfg):
    b1 = roofline.conv_stack(rsz_cfg, 1)
    b2 = roofline.conv_stack(rsz_cfg, 2)
    assert len(b1) == len(b2) == encoder.N_CONV_BLOCKS
    # rsz sheet view: 80x100 -> 4 pools -> final 1x1 conv at 5x6
    assert (b1[0].h, b1[0].w, b1[0].c_in, b1[0].c_out) == (80, 100, 1, 24)
    assert (b1[-1].h, b1[-1].w, b1[-1].k) == (5, 6, 1)
    assert b1[-1].c_out == rsz_cfg.dim_latent
    # spec view: 92x42 -> floor-div pools -> 5x2
    assert (b2[0].h, b2[0].w) == (92, 42)
    assert (b2[-1].h, b2[-1].w) == (5, 2)


@pytest.mark.parametrize("view", [1, 2])
def test_analytic_flops_match_xla_cost_analysis(rsz_cfg, view):
    """The module's conv MAC count must agree with XLA's HLO cost model
    on the real forward program (XLA excludes SAME-padding edge MACs, so
    analytic is a few % higher — the dense-model convention)."""
    cfg = rsz_cfg
    shape = cfg.encoder_input_shape_1 if view == 1 else cfg.input_shape_2
    c, h, w = shape
    params = encoder.init_encoder(jax.random.PRNGKey(0), c,
                                  cfg.num_filters, cfg.dim_latent)
    x = jnp.zeros((1, h, w, c))
    fn = jax.jit(lambda p, xx: encoder.encoder_apply(p, xx, train=False)[0])
    ca = fn.lower(params, x).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    xla_flops = float(ca["flops"])
    analytic = sum(b.flops for b in roofline.conv_stack(cfg, view))
    assert 1.0 <= analytic / xla_flops < 1.15


def test_update_flops_is_3x_forward_times_batch(rsz_cfg):
    fwd = (roofline.embed_flops(rsz_cfg, 1)
           + roofline.embed_flops(rsz_cfg, 2))
    assert roofline.train_update_flops(rsz_cfg) == \
        3 * fwd * rsz_cfg.batch_size


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("dtype,precision,peak", [
    ("bfloat16", "default", 989e12),
    ("bfloat16", "highest", 989e12),
    ("float32", "highest", 67e12),
    ("float32", "high", 495e12),
    ("float32", "default", 495e12),
])
def test_effective_peaks_h100(dtype, precision, peak):
    assert roofline.effective_peak_flops(H100, dtype, precision) \
        == pytest.approx(peak)
    assert roofline.mfu(peak / 10, H100, dtype, precision) \
        == pytest.approx(0.1)


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.chip_peaks("FancyChip9000")
    with pytest.raises(ValueError):
        roofline.effective_peak_flops("cpu", "float32", "highest")


def test_bytes_bound_uses_published_bandwidth():
    assert roofline.bytes_bound_s(3.35e12, H100) == pytest.approx(1.0)
    assert roofline.chip_peaks(H100)["hbm_bytes"] == 80e9


def test_summarize_keys(rsz_cfg):
    s = roofline.summarize(rsz_cfg, H100)
    assert s["chip"] == "NVIDIA H100 SXM"
    assert s["flops_per_sheet_embed"] > s["flops_per_spec_embed"]
    assert s["flops_per_update"] > 1e11
