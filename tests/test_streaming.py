"""StreamingRetriever: chunked/quantized paths agree with the per-frame
baseline (reference loop: audio_sheet_server.py:83-211)."""

import jax
import numpy as np
import pytest

from audio_sheet_retrieval_tpu.models import cca_model
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import windows as win
from audio_sheet_retrieval_tpu.retrieval.streaming import StreamingRetriever


@pytest.fixture(scope="module")
def setup():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(4)
    gal = rng.standard_normal((512, cfg.dim_latent)).astype(np.float32)
    ids = rng.integers(0, 40, 512).astype(np.int32)
    frames = (rng.random((70, 92)) * 3).astype(np.float32)
    return cfg, params, gal, ids, frames


def _collect(sr, frames, chunk=None, quantized=False):
    cands = []
    if chunk is None:
        for f in frames:
            _, c = sr.push_frame(f)
            cands.append(c)
    else:
        for lo in range(0, len(frames), chunk):
            blk = frames[lo:lo + chunk]
            if quantized:
                codes, scale = win.spec_quantize(blk.T, bits=16)
                _, cs = sr.push_frames_quantized(
                    np.ascontiguousarray(codes.T), scale)
            else:
                _, cs = sr.push_frames(blk)
            cands.extend(cs)
    return cands


def test_chunked_matches_per_frame(setup):
    cfg, params, gal, ids, frames = setup
    mx = float(frames.max())
    a = _collect(StreamingRetriever(params, cfg, gal, ids, spec_max=mx),
                 frames)
    b = _collect(StreamingRetriever(params, cfg, gal, ids, spec_max=mx),
                 frames, chunk=10)
    assert len(a) == len(b) == len(frames)
    for ca, cb in zip(a, b):
        assert (ca is None) == (cb is None)
        if ca is not None:
            np.testing.assert_array_equal(ca, cb)


def test_quantized_ingest_matches_f32(setup):
    """u16 frame codes dequantize on device to candidates matching the
    f32 ingest (u16 is the rank-agreement-gated serving coding; each
    chunk gets its own scale here, like a live wire would)."""
    cfg, params, gal, ids, frames = setup
    mx = float(frames.max())
    a = _collect(StreamingRetriever(params, cfg, gal, ids, spec_max=mx),
                 frames, chunk=10)
    b = _collect(StreamingRetriever(params, cfg, gal, ids, spec_max=mx),
                 frames, chunk=10, quantized=True)
    n_match = sum(
        ca is not None and cb is not None and np.array_equal(ca, cb)
        for ca, cb in zip(a, b))
    n_live = sum(ca is not None for ca in a)
    assert n_live > 10
    # u16 rounding may flip near-ties on an untrained net; overwhelming
    # agreement is the gate (the trained-checkpoint gate is PARITY.md 15)
    assert n_match >= 0.9 * n_live
