"""Device-side windowing matches host slicing + full fused audio path."""

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.models import cca_model
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import audio, windows


def test_gather_windows_matches_host_slices():
    rng = np.random.default_rng(0)
    seq = rng.random((92, 500)).astype(np.float32)
    starts = np.asarray([0, 17, 100, 458], np.int32)
    got = np.asarray(windows.gather_windows(jnp.asarray(seq),
                                            jnp.asarray(starts), 42))
    for i, s in enumerate(starts):
        np.testing.assert_array_equal(got[i], seq[:, s:s + 42])


def test_strip_embedder_matches_wrapper_path():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    strip = (rng.random((200, 2000)) * 255).astype(np.uint8)
    starts = windows.linspace_starts(2000, 200, 10)

    embed = windows.make_strip_embedder(params, cfg, center_crop=160)
    got = np.asarray(embed(jnp.asarray(strip), jnp.asarray(starts)))

    # oracle: host slicing + standard eval path
    from audio_sheet_retrieval_tpu.train.engine import prepare_view1_device

    r0 = strip.shape[0] // 2 - 80
    snips = np.stack([strip[r0:r0 + 160, s:s + 200] for s in starts]
                     ).astype(np.float32)[:, None]
    want = np.asarray(cca_model.embed_view1(
        params, prepare_view1_device(jnp.asarray(snips), cfg), cfg))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_audio_embedder_fused_path_matches_host_chain():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(2), cfg)
    proc = audio.AudioProcessor()
    sr = proc.sample_rate
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(sr * 3) * 2000).astype(np.int16)

    # host chain: process() -> slice windows -> embed
    spec = proc.process(sig)
    starts = windows.linspace_starts(spec.shape[1], 42, 8)
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    exc = np.stack([spec[:, s:s + 42] for s in starts])[:, None]
    want = np.asarray(cca_model.embed_view2(
        params, prepare_view2_device(jnp.asarray(exc)), cfg))

    # fused device chain
    embed = windows.make_audio_embedder(params, cfg, proc)
    nf = audio.num_frames_for(len(sig), proc.hop_size)
    got = np.asarray(embed(jnp.asarray(sig), jnp.asarray(starts), nf))
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_pack4_roundtrip_and_embedding_parity():
    rng = np.random.default_rng(7)
    strip = (rng.random((200, 1000)) * 255).astype(np.uint8)
    packed = windows.pack_strip_4bit(strip)
    assert packed.shape == (200, 500)
    unpacked = np.asarray(windows.unpack_strip_4bit(jnp.asarray(packed)))
    # quantization error bounded by half a level
    assert np.abs(unpacked.astype(int) - strip.astype(int)).max() <= 9

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(11), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    starts = windows.linspace_starts(1000, 200, 6)
    full = windows.make_strip_embedder(params, cfg, center_crop=160)
    pk = windows.make_strip_embedder_packed(params, cfg, center_crop=160)
    a = np.asarray(full(jnp.asarray(strip), jnp.asarray(starts)))
    b = np.asarray(pk(jnp.asarray(packed), jnp.asarray(starts)))
    cos = np.sum(a * b, axis=1)
    assert cos.min() > 0.995  # random-weight net; real weights are >0.9999


def test_mulaw_roundtrip_snr():
    rng = np.random.default_rng(11)
    sr = 22050
    t = np.arange(sr) / sr
    sig = ((np.sin(2 * np.pi * 440 * t) * 12000
            + rng.standard_normal(sr) * 500)).astype(np.int16)
    dec = np.asarray(windows.mulaw_decode_device(
        jnp.asarray(windows.mulaw_encode(sig)))) * 32768.0
    err = dec - sig
    snr = 10 * np.log10(np.mean(sig.astype(np.float64) ** 2)
                        / np.mean(err ** 2))
    assert snr > 30  # 8-bit mu-law: ~35-38 dB on music-like signals


def test_mulaw_audio_embedder_matches_raw_path():
    """mu-law companded ingest must not move embeddings (serving default:
    ASR_BENCH_MULAW; A/B on the reference checkpoint + recording showed
    cosine >= 0.9999 and identical top-1/top-5 rankings)."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(2), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    proc = audio.AudioProcessor()
    sr = proc.sample_rate
    rng = np.random.default_rng(5)
    t = np.arange(sr * 3) / sr
    sig = ((np.sin(2 * np.pi * 330 * t) + np.sin(2 * np.pi * 523 * t))
           * 6000 + rng.standard_normal(sr * 3) * 300).astype(np.int16)
    nf = audio.num_frames_for(len(sig), proc.hop_size)
    spec_w = cfg.input_shape_2[2]
    starts = jnp.asarray(windows.linspace_starts(nf, spec_w, 8))

    raw = np.asarray(windows.make_audio_embedder(params, cfg, proc)(
        jnp.asarray(sig), starts, nf))
    mu = np.asarray(windows.make_audio_embedder_mulaw(params, cfg, proc)(
        jnp.asarray(windows.mulaw_encode(sig)), starts, nf))
    cos = np.sum(raw * mu, axis=1)  # embeddings are L2-normalized
    assert cos.min() > 0.999


def test_spec_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(21)
    spec = (rng.random((92, 300)) * 4.3).astype(np.float32)
    for bits, dt in ((8, np.uint8), (16, np.uint16)):
        codes, scale = windows.spec_quantize(spec, bits=bits)
        assert codes.dtype == dt
        dec = np.asarray(windows.spec_dequantize_device(
            jnp.asarray(codes), scale))
        # round-to-nearest: error bounded by half a quantization step
        step = scale / ((1 << bits) - 1)
        assert np.abs(dec - spec).max() <= step / 2 + 1e-6
    # degenerate all-zero spec must not divide by zero
    z, s = windows.spec_quantize(np.zeros((4, 4), np.float32))
    assert s > 0 and z.max() == 0


def test_spec_embedder_quantized_matches_f32_path():
    """Spectrogram-upload ingest (host DSP, u8/u16-quantized wire) must not
    move embeddings vs the f32 spec path (serving default: ASR_BENCH_AUDIO=
    specu8; A/B on the reference checkpoint + recording in PARITY.md)."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(2), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    proc = audio.AudioProcessor()
    sr = proc.sample_rate
    rng = np.random.default_rng(6)
    t = np.arange(sr * 3) / sr
    sig = ((np.sin(2 * np.pi * 262 * t) + np.sin(2 * np.pi * 392 * t))
           * 7000 + rng.standard_normal(sr * 3) * 250).astype(np.int16)
    spec = proc.process_host(sig)
    starts = jnp.asarray(windows.linspace_starts(spec.shape[1], 42, 8))

    f32 = np.asarray(windows.make_spec_embedder(params, cfg)(
        jnp.asarray(spec), starts))
    for bits, floor in ((8, 0.999), (16, 0.999999)):
        codes, scale = windows.spec_quantize(spec, bits=bits)
        q = np.asarray(windows.make_spec_embedder_q(params, cfg)(
            jnp.asarray(codes), scale, starts))
        cos = np.sum(f32 * q, axis=1)  # embeddings are L2-normalized
        assert cos.min() > floor, (bits, cos.min())


def test_spec_embedder_batched_matches_single():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(3), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(8)
    specs = (rng.random((3, 92, 200)) * 4).astype(np.float32)
    starts = jnp.asarray(np.arange(0, 150, 20, dtype=np.int32))

    single = windows.make_spec_embedder(params, cfg)
    batched = windows.make_spec_embedder_batched(params, cfg)
    for p in range(3):
        want = np.asarray(single(jnp.asarray(specs[p]), starts))
        got = np.asarray(batched(jnp.asarray(specs), None, p, starts))
        np.testing.assert_array_equal(want, got)

    # quantized batched path vs per-piece quantized path
    enc = [windows.spec_quantize(s) for s in specs]
    codes_all = jnp.asarray(np.stack([c for c, _ in enc]))
    scales_all = jnp.asarray(np.asarray([s for _, s in enc], np.float32))
    qb = windows.make_spec_embedder_batched(params, cfg, quantized=True)
    qs = windows.make_spec_embedder_q(params, cfg)
    for p in range(3):
        want = np.asarray(qs(jnp.asarray(enc[p][0]), enc[p][1], starts))
        got = np.asarray(qb(codes_all, scales_all, p, starts))
        np.testing.assert_array_equal(want, got)


def test_rle_roundtrip_lossless():
    """Host RLE encode -> device decode is bit-exact, including long-run
    splitting and zero-length padding runs."""
    rng = np.random.default_rng(11)
    strip = np.full((40, 500), 255, np.uint8)
    # contiguous ink blobs + antialiased edges
    for x in rng.integers(0, 480, 40):
        strip[rng.integers(0, 30):, x:x + 6][:10] = rng.integers(0, 60)
        strip[:, x + 6] = 128
    v, l = windows.rle_encode_strip(strip)
    assert v.dtype == np.uint8 and l.dtype == np.uint16
    assert len(v) % windows.RLE_PAD_RUNS == 0
    out = np.asarray(windows.rle_decode_device(
        jnp.asarray(v), jnp.asarray(l), *strip.shape))
    np.testing.assert_array_equal(out, strip)

    # constant strip: single run spanning > 65535 px exercises the split
    const = np.full((160, 600), 201, np.uint8)
    v, l = windows.rle_encode_strip(const)
    out = np.asarray(windows.rle_decode_device(
        jnp.asarray(v), jnp.asarray(l), *const.shape))
    np.testing.assert_array_equal(out, const)


def test_rle_embedder_bit_identical_to_raw():
    """The fused RLE strip embedder produces BIT-IDENTICAL embeddings to the
    raw uint8 path (lossless coding, same downstream program)."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                                   dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(3)
    strip = np.full((200, 1200), 255, np.uint8)
    for x in rng.integers(0, 1000, 80):
        strip[rng.integers(20, 170):, x:x + 5][:12] = 0
    starts = jnp.asarray(np.arange(0, 1000, 125, dtype=np.int32))
    raw = np.asarray(windows.make_strip_embedder(params, cfg,
                                                 center_crop=160)(
        jnp.asarray(strip), starts))
    v, l = windows.rle_encode_strip(strip)
    rle = np.asarray(windows.make_strip_embedder_rle(
        params, cfg, strip.shape, center_crop=160)(
        jnp.asarray(v), jnp.asarray(l), starts))
    np.testing.assert_array_equal(raw, rle)


def test_gather_half_bit_identical_for_even_starts():
    """Half-res gather (2x2-mean strip pooled once, windows gathered at
    half width) must match the standard gather+prepare path bit-for-bit
    for even starts when sheet_downscale == 2."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(1), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(9)
    strip = rng.integers(0, 256, (200, 1600), dtype=np.uint8)
    starts = jnp.asarray(np.arange(0, 1200, 50, dtype=np.int32))  # even
    std = np.asarray(windows.make_strip_embedder(
        params, cfg, center_crop=160)(jnp.asarray(strip), starts))
    fast = np.asarray(windows.make_strip_embedder(
        params, cfg, center_crop=160, gather_half=True)(
        jnp.asarray(strip), starts))
    np.testing.assert_array_equal(std, fast)


def test_batched_embedders_match_per_piece_paths():
    """Corpus-batched upload variants (stacked payloads + on-device row
    select) must produce identical embeddings to the per-piece embedders."""
    from audio_sheet_retrieval_tpu.ops.audio import AudioProcessor

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(2), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(4)

    # sheets
    strips = []
    for _ in range(3):
        s = np.full((200, 1000), 255, np.uint8)
        for x in rng.integers(0, 900, 40):
            s[rng.integers(20, 170):, x:x + 4][:10] = 0
        strips.append(s)
    enc = [windows.rle_encode_strip(s) for s in strips]
    r_max = max(v.shape[0] for v, _ in enc)
    enc = [(np.pad(v, (0, r_max - v.shape[0])),
            np.pad(l, (0, r_max - l.shape[0]))) for v, l in enc]
    starts = jnp.asarray(np.arange(0, 800, 100, dtype=np.int32))
    single = windows.make_strip_embedder_rle(params, cfg, (200, 1000),
                                             center_crop=160)
    batched = windows.make_strip_embedder_rle_batched(
        params, cfg, (200, 1000), center_crop=160)
    va = jnp.asarray(np.stack([v for v, _ in enc]))
    la = jnp.asarray(np.stack([l for _, l in enc]))
    for p in range(3):
        want = np.asarray(single(jnp.asarray(enc[p][0]),
                                 jnp.asarray(enc[p][1]), starts))
        got = np.asarray(batched(va, la, p, starts))
        np.testing.assert_array_equal(want, got)

    # audio
    proc = AudioProcessor()
    sr = proc.sample_rate
    sigs = [(np.sin(2 * np.pi * f * np.arange(sr * 2) / sr) * 8000
             ).astype(np.int16) for f in (220.0, 440.0)]
    u8 = np.stack([windows.mulaw_encode(s) for s in sigs])
    nf = __import__("audio_sheet_retrieval_tpu.ops.audio",
                    fromlist=["num_frames_for"]).num_frames_for(
        sr * 2, proc.hop_size)
    astarts = jnp.asarray(np.arange(0, nf - 42, 7, dtype=np.int32)[:4])
    single_a = windows.make_audio_embedder_mulaw(params, cfg, proc)
    batched_a = windows.make_audio_embedder_mulaw_batched(params, cfg, proc)
    for p in range(2):
        want = np.asarray(single_a(jnp.asarray(u8[p]), astarts, nf))
        got = np.asarray(batched_a(jnp.asarray(u8), p, astarts, nf))
        np.testing.assert_array_equal(want, got)


def test_corpus_scan_embedders_match_per_piece_paths():
    """ONE-dispatch corpus scan (make_corpus_sheet_embedder_rle_bitmap2 /
    make_corpus_spec_embedder) must be bit-identical to the per-piece
    batched programs it replaces — the scan only removes dispatches."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(2), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(9)

    # sheet side: rle2 wire, scan vs per-piece row select
    strips = []
    for _ in range(3):
        s = np.full((200, 1000), 255, np.uint8)
        for x in rng.integers(0, 900, 40):
            s[rng.integers(20, 170):, x:x + 4][:10] = 0
        strips.append(s)
    enc = [windows.rle_bitmap2_encode_strip(s) for s in strips]
    r2m = max(v.shape[0] for _, v, _ in enc)
    r1m = max(v.shape[0] for _, _, v in enc)
    enc = [(b, np.pad(v2, (0, r2m - v2.shape[0])),
            np.pad(v1, (0, r1m - v1.shape[0]))) for b, v2, v1 in enc]
    bm2 = jnp.asarray(np.stack([b for b, _, _ in enc]))
    v2a = jnp.asarray(np.stack([v for _, v, _ in enc]))
    v1a = jnp.asarray(np.stack([v for _, _, v in enc]))
    starts = jnp.asarray(np.arange(0, 800, 100, dtype=np.int32))
    per_piece = windows.make_strip_embedder_rle_bitmap2_batched(
        params, cfg, (200, 1000), center_crop=160)
    scan = windows.make_corpus_sheet_embedder_rle_bitmap2(
        params, cfg, (200, 1000), center_crop=160)
    got = np.asarray(scan(bm2, v2a, v1a, starts))
    assert got.shape == (3, len(starts), cfg.dim_latent)
    for p in range(3):
        want = np.asarray(per_piece(bm2, v2a, v1a, p, starts))
        np.testing.assert_array_equal(want, got[p])

    # spec side: quantized codes, scan vs per-piece row select
    specs = [rng.random((92, 80), np.float32) * (p + 1) for p in range(3)]
    qs = [windows.spec_quantize(s, bits=8) for s in specs]
    codes = jnp.asarray(np.stack([c for c, _ in qs]))
    scales = jnp.asarray(np.asarray([s for _, s in qs], np.float32))
    astarts = jnp.asarray(np.arange(0, 38, 9, dtype=np.int32))
    per_piece_a = windows.make_spec_embedder_batched(params, cfg,
                                                     quantized=True)
    scan_a = windows.make_corpus_spec_embedder(params, cfg, quantized=True)
    got_a = np.asarray(scan_a(codes, scales, astarts))
    for p in range(3):
        want = np.asarray(per_piece_a(codes, scales, p, astarts))
        np.testing.assert_array_equal(want, got_a[p])


def test_rle_bitmap_roundtrip_and_embedder_parity():
    """Bitmap run-length coding: lossless roundtrip, and the fused bitmap
    embedder (plain + corpus-batched) matches the raw uint8 path exactly."""
    rng = np.random.default_rng(13)
    strips = []
    for _ in range(2):
        s = np.full((200, 1100), 255, np.uint8)
        for x in rng.integers(0, 1000, 60):
            s[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 90)
            s[:, x + 5] = 128
        strips.append(s)
    for s in strips:
        bm, v = windows.rle_bitmap_encode_strip(s)
        out = np.asarray(windows.rle_bitmap_decode_device(
            jnp.asarray(bm), jnp.asarray(v), *s.shape))
        np.testing.assert_array_equal(out, s)

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(5), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    starts = jnp.asarray(np.arange(0, 900, 90, dtype=np.int32))
    raw_embed = windows.make_strip_embedder(params, cfg, center_crop=160)
    bm_embed = windows.make_strip_embedder_rle_bitmap(
        params, cfg, strips[0].shape, center_crop=160)
    enc = [windows.rle_bitmap_encode_strip(s) for s in strips]
    r_max = max(v.shape[0] for _, v in enc)
    enc = [(bm, np.pad(v, (0, r_max - v.shape[0]))) for bm, v in enc]
    batched = windows.make_strip_embedder_rle_bitmap_batched(
        params, cfg, strips[0].shape, center_crop=160)
    bms = jnp.asarray(np.stack([bm for bm, _ in enc]))
    vs = jnp.asarray(np.stack([v for _, v in enc]))
    for p, s in enumerate(strips):
        want = np.asarray(raw_embed(jnp.asarray(s), starts))
        got = np.asarray(bm_embed(jnp.asarray(enc[p][0]),
                                  jnp.asarray(enc[p][1]), starts))
        np.testing.assert_array_equal(want, got)
        got_b = np.asarray(batched(bms, vs, p, starts))
        np.testing.assert_array_equal(want, got_b)


def test_rle_codecs_edge_shapes():
    """Degenerate strips: single row/column, alternating pixels (worst
    case), and all-distinct values roundtrip exactly through both codings."""
    cases = [
        np.full((1, 7), 3, np.uint8),
        np.full((5, 1), 250, np.uint8),
        np.tile(np.array([[0, 255]], np.uint8), (4, 8)),   # alternating
        np.arange(256, dtype=np.uint8).reshape(16, 16),    # all distinct
    ]
    for s in cases:
        v, l = windows.rle_encode_strip(s)
        out = np.asarray(windows.rle_decode_device(
            jnp.asarray(v), jnp.asarray(l), *s.shape))
        np.testing.assert_array_equal(out, s)
        bm, vals = windows.rle_bitmap_encode_strip(s)
        out2 = np.asarray(windows.rle_bitmap_decode_device(
            jnp.asarray(bm), jnp.asarray(vals), *s.shape))
        np.testing.assert_array_equal(out2, s)


def test_fullconv_strip_embedder_close_to_standard():
    """Strip-level first-block fast path (fullconv): block-2 inputs are
    identical except the 2 border columns (window SAME-pad vs true strip
    neighbors), so embeddings must agree to high cosine; the interior
    block-2 input columns must be BIT-identical."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(4), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(19)
    strip = np.full((200, 2000), 255, np.uint8)
    for x in rng.integers(0, 1900, 120):
        strip[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 80)
    starts = jnp.asarray(np.arange(0, 1760, 50, dtype=np.int32))  # even

    std = np.asarray(windows.make_strip_embedder(
        params, cfg, center_crop=160)(jnp.asarray(strip), starts))
    fc = np.asarray(windows.make_strip_embedder(
        params, cfg, center_crop=160, fullconv=True)(
        jnp.asarray(strip), starts))
    cos = np.sum(std * fc, axis=1)
    assert cos.min() > 0.999, cos.min()

    # the RLE-bitmap serving factory honors the flag identically
    bm, vals = windows.rle_bitmap_encode_strip(strip)
    fc2 = np.asarray(windows.make_strip_embedder_rle_bitmap(
        params, cfg, strip.shape, center_crop=160, fullconv=True)(
        jnp.asarray(bm), jnp.asarray(vals), starts))
    np.testing.assert_array_equal(fc, fc2)


def test_rle_bitmap2_roundtrip_and_embedder_parity():
    """Two-level bitmap RLE: lossless roundtrip on real-ish and edge
    shapes, smaller wire than level-1 on runny content, and the fused
    embedders (plain + batched) match the raw uint8 path bit-for-bit."""
    rng = np.random.default_rng(29)
    strips = []
    for _ in range(2):
        s = np.full((200, 1400), 255, np.uint8)
        for x in rng.integers(0, 1300, 70):
            s[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 90)
        strips.append(s)
    for s in strips + [np.full((1, 9), 3, np.uint8),
                       np.tile(np.array([[0, 255]], np.uint8), (4, 8))]:
        bm2, v2, v1 = windows.rle_bitmap2_encode_strip(s)
        out = np.asarray(windows.rle_bitmap2_decode_device(
            jnp.asarray(bm2), jnp.asarray(v2), jnp.asarray(v1), *s.shape))
        np.testing.assert_array_equal(out, s)
    bm1, vals1 = windows.rle_bitmap_encode_strip(strips[0])
    bm2, v2, v1 = windows.rle_bitmap2_encode_strip(strips[0])
    assert bm2.nbytes + v2.nbytes + v1.nbytes < bm1.nbytes + vals1.nbytes

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(6), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    starts = jnp.asarray(np.arange(0, 1100, 110, dtype=np.int32))
    raw_embed = windows.make_strip_embedder(params, cfg, center_crop=160)
    embed2 = windows.make_strip_embedder_rle_bitmap2(
        params, cfg, strips[0].shape, center_crop=160)
    enc = [windows.rle_bitmap2_encode_strip(s) for s in strips]
    r2 = max(v.shape[0] for _, v, _ in enc)
    r1 = max(v.shape[0] for _, _, v in enc)
    enc = [(b, np.pad(v2_, (0, r2 - v2_.shape[0])),
            np.pad(v1_, (0, r1 - v1_.shape[0]))) for b, v2_, v1_ in enc]
    batched = windows.make_strip_embedder_rle_bitmap2_batched(
        params, cfg, strips[0].shape, center_crop=160)
    b_all = jnp.asarray(np.stack([b for b, _, _ in enc]))
    v2_all = jnp.asarray(np.stack([v for _, v, _ in enc]))
    v1_all = jnp.asarray(np.stack([v for _, _, v in enc]))
    for p, s in enumerate(strips):
        want = np.asarray(raw_embed(jnp.asarray(s), starts))
        got = np.asarray(embed2(jnp.asarray(enc[p][0]),
                                jnp.asarray(enc[p][1]),
                                jnp.asarray(enc[p][2]), starts))
        np.testing.assert_array_equal(want, got)
        got_b = np.asarray(batched(b_all, v2_all, v1_all, p, starts))
        np.testing.assert_array_equal(want, got_b)


def test_rle2_blocked_decode_bit_identical_and_planned():
    """Blocked select-accumulate decode (rle_bitmap_decode_device_blocked /
    block_k): bit-identical to the plain gather decode on runny, adversarial
    and edge strips; rle2_block_plan returns a sufficient (k1, k2) or None
    exactly when the largest bucket is too small."""
    rng = np.random.default_rng(31)
    cases = []
    s = np.full((200, 1400), 255, np.uint8)          # runny engraving-like
    for x in rng.integers(0, 1300, 70):
        s[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 90)
    cases.append(s)
    cases.append(np.full((3, 700), 7, np.uint8))     # single run
    cases.append((rng.integers(0, 4, (4, 600)) * 80).astype(np.uint8))
    cases.append(np.tile(np.array([[0, 255]], np.uint8), (2, 64)))
    for s in cases:
        n = s.size
        bm2, v2, v1 = windows.rle_bitmap2_encode_strip(s)
        plan = windows.rle2_block_plan(bm2, v2, v1, n)
        if plan is None:
            continue  # covered by the adversarial case below
        out = np.asarray(windows.rle_bitmap2_decode_device(
            jnp.asarray(bm2), jnp.asarray(v2), jnp.asarray(v1), *s.shape,
            block_k=plan))
        np.testing.assert_array_equal(out, s)
        # any larger bucket pair is also exact (next bucket up, capped at
        # the universal 512 = RLE_BLOCK bucket)
        bigger = tuple(min(2 * k, 512) for k in plan)
        out2 = np.asarray(windows.rle_bitmap2_decode_device(
            jnp.asarray(bm2), jnp.asarray(v2), jnp.asarray(v1), *s.shape,
            block_k=bigger))
        np.testing.assert_array_equal(out2, s)

    # adversarial: alternating pixels -> a 512-px tile spans 512 runs.
    # Since round 5 the bucket ladder ends at 512 = RLE_BLOCK (a tile can
    # never span more runs than its pixel count), so even this worst case
    # gets a plan and decodes exactly — no payload falls back to the
    # serial per-pixel gather anymore.
    adv = np.tile(np.array([[0, 255]], np.uint8), (2, 512))
    bm2, v2, v1 = windows.rle_bitmap2_encode_strip(adv)
    plan = windows.rle2_block_plan(bm2, v2, v1, adv.size)
    assert plan is not None and plan[0] == 512
    out = np.asarray(windows.rle_bitmap2_decode_device(
        jnp.asarray(bm2), jnp.asarray(v2), jnp.asarray(v1), *adv.shape,
        block_k=plan))
    np.testing.assert_array_equal(out, adv)

    # corpus plan = per-level max over pieces; None poisons the corpus
    encs = [windows.rle_bitmap2_encode_strip(c) for c in cases[:2]]
    n0 = cases[0].size
    # (pad to shared length like real corpus stacking would)
    plan0 = windows.rle2_block_plan(*encs[0], n0)
    assert windows.rle2_corpus_block_plan([encs[0]], n0) == plan0


def test_rle2_blocked_embedders_match_plain():
    """The three rle2 embedder factories produce bit-identical embeddings
    with block_k set (vs block_k=None)."""
    rng = np.random.default_rng(37)
    strips = []
    for _ in range(3):
        s = np.full((200, 1200), 255, np.uint8)
        for x in rng.integers(0, 1100, 50):
            s[rng.integers(20, 170):, x:x + 4][:10] = rng.integers(0, 90)
        strips.append(s)
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(8), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    starts = jnp.asarray(np.arange(0, 900, 130, dtype=np.int32))

    enc = [windows.rle_bitmap2_encode_strip(s) for s in strips]
    r2 = max(v.shape[0] for _, v, _ in enc)
    r1 = max(v.shape[0] for _, _, v in enc)
    enc = [(b, np.pad(v2_, (0, r2 - v2_.shape[0])),
            np.pad(v1_, (0, r1 - v1_.shape[0]))) for b, v2_, v1_ in enc]
    plan = windows.rle2_corpus_block_plan(enc, strips[0].size)
    assert plan is not None

    shape = strips[0].shape
    plain = windows.make_strip_embedder_rle_bitmap2(
        params, cfg, shape, center_crop=160)
    blocked = windows.make_strip_embedder_rle_bitmap2(
        params, cfg, shape, center_crop=160, block_k=plan)
    b_all = jnp.asarray(np.stack([b for b, _, _ in enc]))
    v2_all = jnp.asarray(np.stack([v for _, v, _ in enc]))
    v1_all = jnp.asarray(np.stack([v for _, _, v in enc]))
    bat = windows.make_strip_embedder_rle_bitmap2_batched(
        params, cfg, shape, center_crop=160, block_k=plan)
    scan = windows.make_corpus_sheet_embedder_rle_bitmap2(
        params, cfg, shape, center_crop=160, block_k=plan)
    all_scan = np.asarray(scan(b_all, v2_all, v1_all, starts))
    for p in range(len(strips)):
        args = tuple(jnp.asarray(x) for x in enc[p])
        want = np.asarray(plain(*args, starts))
        np.testing.assert_array_equal(
            want, np.asarray(blocked(*args, starts)))
        np.testing.assert_array_equal(
            want, np.asarray(bat(b_all, v2_all, v1_all, p, starts)))
        np.testing.assert_array_equal(want, all_scan[p])


def test_feature_window_gather_matches_numpy():
    """The fullconv feature-window gather (columns s, s+2, ... of the
    dense-pooled plane per window) must equal the numpy formula exactly,
    odd and even starts included."""
    rng = np.random.default_rng(7)
    for h4, wq, c, n_cols in [(8, 301, 24, 25), (40, 998, 24, 25),
                              (16, 130, 8, 13)]:
        q = rng.standard_normal((h4, wq, c)).astype(np.float32)
        smax = wq - 2 * n_cols
        starts = np.concatenate([[0, 1, smax], rng.integers(0, smax, 29)]
                                ).astype(np.int32)
        got = np.asarray(windows.gather_feature_windows(
            jnp.asarray(q), jnp.asarray(starts), n_cols))
        want = np.stack([q[:, s:s + 2 * n_cols:2, :] for s in starts])
        np.testing.assert_array_equal(got, want)
