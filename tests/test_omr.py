"""OMR subsystem: U-Net import/apply, sliding-window blending, detectors."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from audio_sheet_retrieval_tpu.models import unet
from audio_sheet_retrieval_tpu.omr import detectors, inference

from audio_sheet_retrieval_tpu import assets as _assets
from audio_sheet_retrieval_tpu.retrieval.umc import resolve_omr_weights as _resolve_omr

OMR_DIR = _assets.assets_dir()
PAGE = _assets.tutorial_sheet_path()


def _random_unet_params(key=0):
    """Small random U-Net in the exact checkpoint layout."""
    rng = np.random.default_rng(key)
    arrays = []

    def conv_bn(cin, cout, k=3):
        arrays.append(rng.standard_normal((cout, cin, k, k)).astype("f") * 0.2)
        arrays.append(np.zeros(cout, "f"))
        arrays.append(np.ones(cout, "f"))
        arrays.append(np.zeros(cout, "f"))
        arrays.append(np.ones(cout, "f"))

    def bn(c):
        arrays.append(np.zeros(c, "f"))
        arrays.append(np.ones(c, "f"))
        arrays.append(np.zeros(c, "f"))
        arrays.append(np.ones(c, "f"))

    for cin, cout in [(1, 8), (8, 8), (8, 16), (16, 16), (16, 32), (32, 32),
                      (32, 64), (64, 64)]:
        conv_bn(cin, cout)
    for cin, cout in [(64, 32), (32, 16), (16, 8)]:
        arrays.append(rng.standard_normal((cin, cout, 2, 2)).astype("f") * 0.2)
        bn(cout)
        bn(cout)
        conv_bn(cout, cout)
        conv_bn(cout, cout)
    arrays.append(rng.standard_normal((1, 8, 1, 1)).astype("f"))
    arrays.append(np.zeros(1, "f"))
    return unet.import_unet_params(arrays)


def test_unet_apply_shapes_and_range():
    params = _random_unet_params()
    x = jnp.asarray(np.random.default_rng(0).random((2, 64, 96, 1)), jnp.float32)
    y = np.asarray(unet.unet_apply(params, x))
    assert y.shape == (2, 64, 96)
    assert (y >= 0).all() and (y <= 1).all()


def test_tconv_matches_manual_expansion():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random((1, 3, 4, 2)), jnp.float32)
    w = jnp.asarray(rng.random((2, 5, 2, 2)), jnp.float32)  # (Cin,Cout,2,2)
    y = np.asarray(unet._tconv2x2(x, w))
    assert y.shape == (1, 6, 8, 5)
    xn = np.asarray(x)
    wn = np.asarray(w)
    for i in range(3):
        for j in range(4):
            for k in range(2):
                for l in range(2):
                    want = np.einsum("c,co->o", xn[0, i, j], wn[:, :, k, l])
                    np.testing.assert_allclose(y[0, 2 * i + k, 2 * j + l],
                                               want, atol=1e-5)


def test_sliding_window_matches_direct_on_training_shape():
    params = _random_unet_params(2)
    net = inference.SegmentationNetwork(params, input_shape=(64, 64))
    img = np.random.default_rng(3).random((64, 64)).astype(np.float32)
    direct = net.predict_proba(img)
    # same image through the sliding path (force by off-size pad then crop)
    slid = net._sliding(img, overlap=0.5)
    np.testing.assert_allclose(slid, direct, atol=1e-4)


def test_sliding_window_larger_image_blends_smoothly():
    params = _random_unet_params(4)
    net = inference.SegmentationNetwork(params, input_shape=(64, 64))
    img = np.random.default_rng(5).random((150, 200)).astype(np.float32)
    out = net.predict_proba(img)
    assert out.shape == (150, 200)
    assert np.isfinite(out).all()
    assert (out >= 0).all() and (out <= 1.0 + 1e-6).all()


def test_coded_page_wire_roundtrip():
    """The rANS-coded page upload decodes to the exact u16 quantized page:
    u8-origin pages take the single-plane fast path (codes = orig*257 so
    lo == hi), float pages ship both planes; the host payload cache hits
    on identical content."""
    from audio_sheet_retrieval_tpu.ops import rans

    rng = np.random.default_rng(0)
    u8_page = (rng.integers(0, 256, (64, 48)).astype(np.uint8)
               .astype(np.float32) / 255.0)
    float_page = rng.random((64, 48)).astype(np.float32)
    # 63x47 = 2961 px: NOT divisible by _PAGE_CHUNKS — exercises the
    # encoder's pad-to-c*chunks tail and the decoder's [:, :n_px] slice
    ragged_page = rng.random((63, 47)).astype(np.float32)
    for page, want_reuse in ((u8_page, True), (float_page, False),
                             (ragged_page, False)):
        q = inference._quantize_page(page)
        freqs, states, words, n_px, reuse = inference._encode_page_wire(q)
        assert reuse is want_reuse
        # payload layout: _PAGE_CHUNKS INTERLEAVED segments per plane
        # (lo then hi; segment j carries plane bytes j::chunks)
        ch = inference._PAGE_CHUNKS
        c = -(-n_px // ch)
        segs = np.asarray(rans.rans_decode_batch_device(
            jnp.asarray(freqs), jnp.asarray(states), jnp.asarray(words),
            c))
        planes = segs.reshape(-1, ch, c).swapaxes(1, 2) \
            .reshape(-1, ch * c)[:, :n_px]
        lo = planes[0].astype(np.uint16)
        hi = (planes[0] if reuse else planes[1]).astype(np.uint16)
        np.testing.assert_array_equal(((hi << 8) | lo).reshape(q.shape), q)
    # cache: same content -> same payload object
    q = inference._quantize_page(u8_page)
    assert inference._encode_page_wire(q) is inference._encode_page_wire(
        q.copy())


def test_page_wire_raw_matches_rans():
    """page_wire='raw' (local-attached arm, no device decode) and the
    default rANS-coded wire are both lossless over the u16 page codes,
    so their probability maps must be bit-identical."""
    params = _random_unet_params()
    rng = np.random.default_rng(9)
    img = rng.random((600, 700)).astype(np.float32)
    a = inference.SegmentationNetwork(params).predict_proba(img)
    b = inference.SegmentationNetwork(params,
                                      page_wire="raw").predict_proba(img)
    np.testing.assert_array_equal(a, b)


def test_sliding_map_bits8_close_to_u16():
    """map_bits=8 halves the map download; values differ from the u16
    path by at most the quantization step (the detection-equality gate on
    the real page is the slow test in this module)."""
    params = _random_unet_params()
    rng = np.random.default_rng(5)
    img = rng.random((600, 700)).astype(np.float32)
    p16 = inference.SegmentationNetwork(params).predict_proba(img)
    p8 = inference.SegmentationNetwork(params,
                                       map_bits=8).predict_proba(img)
    assert p16.shape == p8.shape == img.shape
    assert np.abs(p16 - p8).max() <= 0.5 / 255 + 0.5 / 65535 + 1e-7


def test_otsu_bimodal():
    rng = np.random.default_rng(6)
    vals = np.concatenate([rng.normal(0.1, 0.02, 1000),
                           rng.normal(0.9, 0.02, 500)])
    t = detectors.otsu_threshold(vals)
    # any threshold inside the empty gap separates the modes (argmax of the
    # flat between-class variance lands just past the lower cluster)
    assert 0.13 < t < 0.87
    assert ((vals < t).sum(), (vals >= t).sum()) == (1000, 500)


def test_labeled_regions_geometry():
    img = np.zeros((100, 100), bool)
    img[10:90, 48:52] = True   # vertical bar
    img[5:9, 5:60] = True      # horizontal blob
    _, regions = detectors.labeled_regions(img)
    assert len(regions) == 2
    bar = max(regions, key=lambda r: r.major_axis_length)
    import math

    assert abs(90 - abs(math.degrees(bar.orientation))) < 2
    assert bar.eccentricity > 0.95
    assert bar.major_axis_length > 75


def test_detect_systems_ly_groups_staff_lines():
    """Pure-morphology LilyPond system detector (reference omr.py:510-547):
    two piano systems of 10 long staff lines each, plus short ink (note
    heads / text) that the 0.7*width horizontal opening must discard."""
    img = np.ones((400, 500), np.float32)  # white page, dark ink <= 0.5
    for sys_top in (50, 250):
        for li in range(10):
            img[sys_top + 8 * li, 40:460] = 0.0       # staff lines
    img[120:130, 200:210] = 0.0                        # short blob: dropped
    omr = detectors.OpticalMusicRecognizer()
    systems = omr.detect_systems_ly(img)
    assert systems.shape == (2, 4, 2)
    # corner order TL, TR, BR, BL in (row, col)
    (tl, tr, br, bl) = systems[0]
    assert tl[0] == tr[0] == 50 and br[0] == bl[0] >= 50 + 8 * 9
    # +-1 px: cv2 even-width opening kernels have an asymmetric anchor
    assert tl[1] == bl[1] and abs(tl[1] - 40) <= 1
    assert tr[1] == br[1] and abs(tr[1] - 460) <= 1
    assert systems[1][0][0] == 250
    # group size is parameterized; 5-line single staves -> 4 systems
    assert omr.detect_systems_ly(img, lines_per_system=5).shape == (4, 4, 2)


def test_peak_local_max_2d():
    img = np.zeros((50, 50), np.float32)
    img[10, 10] = 1.0
    img[30, 40] = 0.8
    img[30, 42] = 0.7  # suppressed by min_distance
    coords = detectors.peak_local_max_2d(img, min_distance=3,
                                         threshold_abs=0.5)
    assert [10, 10] in coords.tolist()
    assert [30, 40] in coords.tolist()
    assert [30, 42] not in coords.tolist()


@pytest.mark.skipif(not _assets.has_asset("omr_system.npz"), reason="vendored OMR assets missing")
@pytest.mark.slow
def test_real_system_detection_on_tutorial_page():
    import cv2

    img = cv2.imread(PAGE, 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    prep = inference.prepare_image(img)
    sysnet = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "system"))
    barnet = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "bar"))
    omr = detectors.OpticalMusicRecognizer(system_detector=sysnet,
                                           bar_detector=barnet)
    systems = omr.detect_systems(prep)
    assert len(systems) == 6  # the tutorial page has six staves
    heights = systems[:, 2, 0] - systems[:, 0, 0]
    widths = systems[:, 1, 1] - systems[:, 0, 1]
    assert (heights > 60).all() and (heights < 160).all()
    assert (widths > 600).all()
    # top-to-bottom order
    assert (np.diff(systems[:, 0, 0]) > 0).all()


@pytest.mark.skipif(not _assets.has_asset("omr_system.npz"),
                    reason="vendored OMR assets missing")
@pytest.mark.slow
def test_map_bits8_detection_equality_gate_on_tutorial_page():
    """The u8 map download (half the u16 wire) must leave systems and
    bars detections on the real tutorial page identical to the u16
    strict path — the same gate methodology as the precision ladder."""
    import cv2

    img = cv2.imread(PAGE, 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    prep = inference.prepare_image(img)
    got = {}
    for bits in (16, 8):
        sysnet = inference.SegmentationNetwork.load(
            _resolve_omr(OMR_DIR, "system"), map_bits=bits)
        barnet = inference.SegmentationNetwork.load(
            _resolve_omr(OMR_DIR, "bar"), map_bits=bits)
        omr = detectors.OpticalMusicRecognizer(system_detector=sysnet,
                                               bar_detector=barnet)
        systems = omr.detect_systems(prep)
        bars = omr.detect_bars(prep, systems=systems)
        got[bits] = (systems, bars)
    np.testing.assert_array_equal(got[8][0], got[16][0])
    np.testing.assert_array_equal(got[8][1], got[16][1])


@pytest.mark.skipif(not _assets.has_asset("omr_system.npz"), reason="vendored OMR assets missing")
@pytest.mark.slow
def test_real_bar_detection_on_tutorial_page():
    import cv2

    img = cv2.imread(PAGE, 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    prep = inference.prepare_image(img)
    sysnet = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "system"))
    barnet = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "bar"))
    omr = detectors.OpticalMusicRecognizer(system_detector=sysnet,
                                           bar_detector=barnet)
    systems = omr.detect_systems(prep)
    bars = omr.detect_bars(prep, systems=systems)
    assert len(bars) >= 6  # at least one barline per system


@pytest.mark.skipif(not _assets.has_asset("omr_system.npz"),
                    reason="vendored OMR assets missing")
def test_unet_precision_ladder_close_on_real_checkpoint():
    """bf16 / f32-high arms stay within the trained network's noise floor
    of the f32-highest parity arm on a real 512x512 page tile (the
    detection gate itself is the slow test below). Random unnormalized
    params are NOT a valid probe here — their activations grow ~5x/layer
    and bf16 deviation explodes, which says nothing about the trained,
    BN-normalized checkpoint (measured on the true-bf16 pipeline: max
    prob deviation 0.12, flips 3.6e-3; systems/bars detections identical
    up to 1 px, see the slow gate below)."""
    import cv2

    img = cv2.imread(PAGE, 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    tile = inference.prepare_image(img)[100:612, 100:612]
    params = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "system")).params
    ref = inference.SegmentationNetwork(params).predict_proba(tile)
    for dtype, prec in (("float32", "high"), ("bfloat16", "default")):
        got = inference.SegmentationNetwork(
            params, compute_dtype=dtype,
            conv_precision=prec).predict_proba(tile)
        tol = 0.15 if dtype == "bfloat16" else 0.1
        assert np.abs(got - ref).max() < tol, (dtype, prec)
        flips = np.logical_xor(got > 0.5, ref > 0.5).mean()
        assert flips < 5e-3, (dtype, prec, flips)


@pytest.mark.skipif(not _assets.has_asset("omr_system.npz"),
                    reason="vendored OMR assets missing")
@pytest.mark.slow
def test_omr_precision_ladder_detection_equality_gate():
    """The OMR fast-recipe gate (VERDICT r3 #3), all three detectors on
    the real tutorial page vs the f32-highest parity arm:

      * f32-high (the gated fast default): systems,
        bars AND noteheads must be bit-identical;
      * bfloat16 (opt-in): NOT detection-identical — the measured
        deviation is bounded here (same system/bar sets up to 2 px corner
        shift; notehead count within 2%: +2/349 on the CPU). This is the
        documented negative result for strict equality: the true-bf16
        pipeline trades a few threshold-crossing noteheads for speed."""
    import cv2

    img = cv2.imread(PAGE, 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    prep = inference.prepare_image(img)
    sysp = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "system")).params
    barp = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "bar")).params
    notep = inference.SegmentationNetwork.load(
        _resolve_omr(OMR_DIR, "note")).params

    def detect_all(dtype, prec):
        sysnet = inference.SegmentationNetwork(
            sysp, compute_dtype=dtype, conv_precision=prec)
        barnet = inference.SegmentationNetwork(
            barp, compute_dtype=dtype, conv_precision=prec)
        notenet = inference.SegmentationNetwork(
            notep, input_shape=(256, 512), compute_dtype=dtype,
            conv_precision=prec)
        omr = detectors.OpticalMusicRecognizer(
            system_detector=sysnet, bar_detector=barnet,
            note_detector=notenet)
        systems = omr.detect_systems(prep)
        return (systems, omr.detect_bars(prep, systems=systems),
                omr.detect_notes(prep))

    ref_sys, ref_bars, ref_notes = detect_all("float32", "highest")
    assert len(ref_sys) == 6

    got_sys, got_bars, got_notes = detect_all("float32", "high")
    np.testing.assert_array_equal(got_sys, ref_sys, err_msg="f32-high")
    np.testing.assert_array_equal(np.asarray(got_bars),
                                  np.asarray(ref_bars), err_msg="f32-high")
    np.testing.assert_array_equal(np.asarray(got_notes),
                                  np.asarray(ref_notes), err_msg="f32-high")

    got_sys, got_bars, got_notes = detect_all("bfloat16", "default")
    assert got_sys.shape == ref_sys.shape
    assert np.abs(got_sys.astype(int) - ref_sys.astype(int)).max() <= 2
    assert np.shape(got_bars) == np.shape(ref_bars)
    assert np.abs(np.asarray(got_bars, float)
                  - np.asarray(ref_bars, float)).max() <= 2
    assert abs(len(got_notes) - len(ref_notes)) <= 0.02 * len(ref_notes)


# --- coded map DOWNLOAD (static-table device rANS; VERDICT r4 next #6) ---


def _inject_map_recipe(kind, counts, budget_bpx):
    """Build a synthetic static-table recipe and plant it in the cache."""
    from audio_sheet_retrieval_tpu.ops import rans

    freqs = rans.quantize_freqs(counts + 1)
    tabA, tabB = rans.encode_magic_tables(freqs)
    inference._map_wire_cache[kind] = (freqs, budget_bpx,
                                       jnp.asarray(tabA),
                                       jnp.asarray(tabB),
                                       int(np.argmax(freqs)))
    return freqs


@pytest.mark.parametrize("map_bits", [8, 16])
def test_map_wire_rans_bit_identical_to_raw(map_bits):
    """The coded map download (device rANS encode against a static table,
    host decode) must reproduce the raw download EXACTLY — it is a
    lossless transport of the same codes."""
    params = _random_unet_params(11)
    rng = np.random.default_rng(4)
    img = rng.random((150, 170)).astype(np.float32)
    raw_net = inference.SegmentationNetwork(params, input_shape=(64, 64),
                                            map_bits=map_bits,
                                            map_wire="raw")
    ref = raw_net.predict_proba(img)
    codes = np.round(np.clip(ref, 0, 1) * (2**map_bits - 1))
    plane = codes.astype(np.uint8) if map_bits == 8 \
        else (codes.astype(np.uint16) >> 8).astype(np.uint8)
    counts = np.bincount(plane.ravel(), minlength=256)
    try:
        _inject_map_recipe("_test_fit", counts, budget_bpx=2.0)
        net = inference.SegmentationNetwork(params, input_shape=(64, 64),
                                            map_bits=map_bits,
                                            map_kind="_test_fit")
        assert net.map_wire == "rans"
        np.testing.assert_array_equal(net.predict_proba(img), ref)
    finally:
        inference._map_wire_cache.pop("_test_fit", None)


def test_map_wire_overflow_falls_back_to_raw_codes():
    """A map denser than the sized budget must transparently fall back to
    fetching the raw codes (second transfer) — never corrupt output."""
    params = _random_unet_params(11)
    rng = np.random.default_rng(4)
    img = rng.random((150, 170)).astype(np.float32)
    ref = inference.SegmentationNetwork(params, input_shape=(64, 64),
                                        map_wire="raw").predict_proba(img)
    try:
        # near-uniform table + near-zero budget: guaranteed overflow
        _inject_map_recipe("_test_tiny", np.ones(256, np.int64),
                           budget_bpx=0.001)
        net = inference.SegmentationNetwork(params, input_shape=(64, 64),
                                            map_kind="_test_tiny")
        np.testing.assert_array_equal(net.predict_proba(img), ref)
    finally:
        inference._map_wire_cache.pop("_test_tiny", None)


def test_map_wire_asset_present_and_well_formed():
    """The shipped per-detector asset must load, and every kind's recipe
    must be a valid coder table (sums to PROB_SCALE, all-nonzero so any
    byte stays encodable on unseen pages)."""
    from audio_sheet_retrieval_tpu.ops import rans

    for kind in ("system", "bar", "note", None):
        rec = inference._map_wire_tables(kind)
        assert rec is not None, "omr_map_wire.npz missing"
        freqs, budget, tabA, tabB, pad_sym = rec
        assert int(freqs.sum()) == rans.PROB_SCALE
        assert (freqs >= 1).all()
        assert 0.01 <= budget <= 2.0
        assert int(freqs[pad_sym]) == int(freqs.max())
