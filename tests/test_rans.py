"""Interleaved-stream rANS wire coding: lossless roundtrips, batch decode,
and bit-identical embeddings through the corpus sheet pipeline.

The coder (ops/rans.py) is a device-decoded transport stage with no reference
analog (CPJKU/audio_sheet_retrieval uploads raw uint8 pixels); these tests
pin the host encoder against BOTH decoders (numpy reference + XLA scan)
and the full corpus path against the uncoded rle2 embedder.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from audio_sheet_retrieval_tpu.ops import rans, windows


def _skewed_bytes(rng, n):
    # exponential byte histogram like the RLE payloads the coder ships
    return (rng.exponential(15, n) % 256).astype(np.uint8)


def test_quantize_freqs_invariants():
    rng = np.random.default_rng(0)
    for counts in (
        np.bincount(_skewed_bytes(rng, 10000), minlength=256),
        np.bincount(np.asarray([3, 3, 3, 7], np.uint8), minlength=256),
        np.bincount(np.zeros(50, np.uint8), minlength=256),  # constant
        np.ones(256, np.int64),  # uniform: >=1 floor exactly fills 4096?
        np.concatenate([np.ones(200, np.int64), np.asarray([10**9]),
                        np.zeros(55, np.int64)]),  # overshoot-shave path
    ):
        f = rans.quantize_freqs(counts)
        assert int(f.sum()) == rans.PROB_SCALE
        assert (f[np.asarray(counts) > 0] >= 1).all()
        assert int(f.max()) <= rans.PROB_SCALE - 1
    with pytest.raises(ValueError):
        rans.quantize_freqs(np.zeros(256, np.int64))


@pytest.mark.parametrize("n,streams", [
    (50_000, 512),   # many steps
    (50_000, 2048),  # max lanes
    (777, 256),      # n not a multiple of S, tail padding
    (100, 256),      # n < S: single scan step
    (1, 256),        # single symbol
])
def test_rans_roundtrip_host_and_device(n, streams):
    rng = np.random.default_rng(n + streams)
    data = _skewed_bytes(rng, n)
    freqs, states, words = rans.rans_encode(data, streams)
    assert states.shape == (streams,)
    np.testing.assert_array_equal(
        rans.rans_decode_host(freqs, states, words, n), data)
    got = rans.rans_decode_device(jnp.asarray(freqs), jnp.asarray(states),
                                  jnp.asarray(words), n)
    np.testing.assert_array_equal(np.asarray(got), data)


def test_rans_constant_input_roundtrip():
    # one observed symbol -> phantom-neighbor table, often zero words
    c = np.full(3000, 9, np.uint8)
    freqs, states, words = rans.rans_encode(c, 256)
    np.testing.assert_array_equal(
        rans.rans_decode_host(freqs, states, words, c.size), c)
    got = rans.rans_decode_device(jnp.asarray(freqs), jnp.asarray(states),
                                  jnp.asarray(words), c.size)
    np.testing.assert_array_equal(np.asarray(got), c)


def test_rans_compression_beats_raw_on_skewed_bytes():
    rng = np.random.default_rng(7)
    data = _skewed_bytes(rng, 200_000)
    S = rans.auto_streams(data.size)
    freqs, states, words = rans.rans_encode(data, S)
    wire = words.size * 2 + states.size * 4 + 256 * 2
    # iid entropy of this distribution is ~5.3 bits/byte; the coder must
    # land well under raw and within ~5% of the entropy bound
    counts = np.bincount(data, minlength=256)
    p = counts[counts > 0] / data.size
    h_bits = float(-(p * np.log2(p)).sum())
    assert wire < data.size
    assert wire * 8 <= h_bits * data.size * 1.05 + states.size * 32


def test_rans_batch_decode_matches_per_payload():
    rng = np.random.default_rng(11)
    n = 9_000
    arrays = [_skewed_bytes(rng, n) for _ in range(5)]
    arrays.append(np.full(n, 200, np.uint8))  # a constant row in the batch
    freqs, states, words, n_words = rans.rans_encode_batch(arrays)
    assert (n_words <= words.shape[1]).all()
    got = np.asarray(rans.rans_decode_batch_device(
        jnp.asarray(freqs), jnp.asarray(states), jnp.asarray(words), n))
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(got[i], a)
        # per-row word counts are the honest wire accounting: bytes beyond
        # n_words are stack padding and must be exactly zero
        assert (words[i, int(n_words[i]):] == 0).all()


def test_native_encoder_matches_numpy():
    # the C++ batch encoder (native/rans) must be bit-identical to the
    # numpy path: same states, words, word order, counts
    lib = rans._native_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(13)
    n = 40_000
    arrays = [_skewed_bytes(rng, n) for _ in range(5)]
    arrays.append(np.full(n, 7, np.uint8))  # constant row
    freqs = np.stack([rans.quantize_freqs(np.bincount(a, minlength=256))
                      for a in arrays])
    for S in (128, 256, 1024):
        a_nat = rans._rans_encode_batch_native(lib, arrays, freqs, S)
        a_np = rans._rans_encode_batch_numpy(arrays, freqs, S)
        for x, y in zip(a_nat, a_np):
            np.testing.assert_array_equal(x, y)


def test_batch_encoder_matches_per_payload():
    rng = np.random.default_rng(17)
    n = 9_777  # not a multiple of any lane count: tail padding
    arrays = [_skewed_bytes(rng, n) for _ in range(3)]
    freqs, states, words, n_words = rans.rans_encode_batch(arrays, 256)
    for i, a in enumerate(arrays):
        f1, s1, w1 = rans.rans_encode(a, 256)
        np.testing.assert_array_equal(freqs[i], f1)
        np.testing.assert_array_equal(states[i], s1)
        assert int(n_words[i]) == w1.size
        np.testing.assert_array_equal(words[i, :w1.size], w1)


def test_rans_fuzz_roundtrip():
    """Randomized roundtrip sweep: sizes around lane/step boundaries,
    pathological distributions (constant, two-symbol, near-uniform,
    heavy-skew), native and numpy encoders, host and device decoders.
    The whole serving wire rides this coder — cheap paranoia."""
    rng = np.random.default_rng(99)
    lib = rans._native_lib()
    for trial in range(30):
        S = int(rng.choice([128, 256, 512, 2048]))
        n = int(rng.choice([1, 2, S - 1, S, S + 1, 3 * S,
                            int(rng.integers(1, 20_000))]))
        kind = trial % 4
        if kind == 0:
            data = np.full(n, int(rng.integers(0, 256)), np.uint8)
        elif kind == 1:
            data = rng.choice([7, 201], n).astype(np.uint8)
        elif kind == 2:
            data = rng.integers(0, 256, n).astype(np.uint8)
        else:
            data = (rng.exponential(3, n) % 256).astype(np.uint8)
        freqs = np.stack([rans.quantize_freqs(
            np.bincount(data, minlength=256))])
        encs = [rans._rans_encode_batch_numpy([data], freqs, S)]
        if lib is not None:
            encs.append(rans._rans_encode_batch_native(lib, [data], freqs,
                                                       S))
        for f, s, w, nw in encs:
            np.testing.assert_array_equal(
                rans.rans_decode_host(f[0], s[0], w[0], n), data,
                err_msg=f"trial={trial} n={n} S={S} kind={kind}")
            got = np.asarray(rans.rans_decode_batch_device(
                jnp.asarray(f), jnp.asarray(s), jnp.asarray(w), n))[0]
            np.testing.assert_array_equal(
                got, data, err_msg=f"trial={trial} n={n} S={S} kind={kind}")


def _engraving_like_strips(rng, n_pieces, h, w):
    # bilevel-ish staff-line content: long white runs + short black runs,
    # different per piece (the corpus coder must not share tables)
    strips = []
    for _ in range(n_pieces):
        s = np.full((h, w), 255, np.uint8)
        for y in range(10, h, 17):
            s[y, :] = 0
        n_blobs = int(rng.integers(40, 80))
        xs = rng.integers(0, w - 6, n_blobs)
        ys = rng.integers(0, h - 6, n_blobs)
        for x, y in zip(xs, ys):
            s[y:y + 5, x:x + 4] = 0
        strips.append(s)
    return strips


def test_rans_corpus_strips_bit_identical_embeddings():
    import jax

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config

    rng = np.random.default_rng(21)
    h, w, n_pieces = 200, 1000, 3
    strips = _engraving_like_strips(rng, n_pieces, h, w)

    payload, lens, piece_bytes = windows.rans_encode_corpus_strips(strips)
    decode = windows.make_corpus_rans_decoder(lens)
    bm2_all, v2_all, v1_all = decode(payload)

    # decoded component stacks must equal the direct rle2 encodings
    encs = [windows.rle_bitmap2_encode_strip(s) for s in strips]
    for i, (bm2, v2, v1) in enumerate(encs):
        np.testing.assert_array_equal(np.asarray(bm2_all[i]), bm2)
        np.testing.assert_array_equal(
            np.asarray(v2_all[i])[:v2.size], v2)
        np.testing.assert_array_equal(
            np.asarray(v1_all[i])[:v1.size], v1)

    # and the embeddings through the batched rle2 embedder are bit-identical
    # to the raw-pixel path
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    starts = jnp.asarray(windows.linspace_starts(w, 200, 6))
    batched = windows.make_strip_embedder_rle_bitmap2_batched(
        params, cfg, (h, w), center_crop=160)
    raw_embed = windows.make_strip_embedder(params, cfg, center_crop=160)
    for i, s in enumerate(strips):
        got = np.asarray(batched(bm2_all, v2_all, v1_all, i, starts))
        want = np.asarray(raw_embed(jnp.asarray(s), starts))
        np.testing.assert_array_equal(got, want)

    # honest wire accounting: per-piece bytes beat the rle2 bytes on this
    # content and the mixed-shape guard trips
    rle2_bytes = [sum(int(a.size) for a in e) for e in encs]
    assert all(rb < r2 for rb, r2 in zip(piece_bytes, rle2_bytes))
    with pytest.raises(ValueError):
        windows.rans_encode_corpus_strips(
            [strips[0], strips[1][:, : w // 2]])


def _spec_like(rng, bins, T, smooth):
    if smooth:
        # time-smooth log-magnitudes like real music: slow envelopes ->
        # the delta arm must measure the lower entropy and be chosen
        t = np.linspace(0, 1, T)
        env = 1.0 + 0.5 * np.sin(2 * np.pi * 3 * t)
        return env[None, :] * np.linspace(0.5, 2.0, bins)[:, None]
    return np.abs(rng.standard_normal((bins, T))).astype(np.float32)


def test_spec_rans_corpus_roundtrip_and_arm_choice():
    rng = np.random.default_rng(31)
    bins, T = 92, 300
    specs = [_spec_like(rng, bins, T, smooth=False) for _ in range(3)]
    specs.append(_spec_like(rng, bins, T, smooth=True))

    payload, flags, scales, shape, piece_bytes = \
        windows.spec_rans_encode_corpus(specs)
    assert shape == (bins, T)
    assert flags[-1] == 1  # smooth piece -> delta arm
    decode = windows.make_corpus_spec_rans_decoder(shape)
    codes = np.asarray(decode(payload, flags))
    for i, s in enumerate(specs):
        want, scale = windows.spec_quantize(s, bits=8)
        np.testing.assert_array_equal(codes[i], want)
        assert np.float32(scale) == scales[i]
    # honest wire accounting: the smooth piece compresses well below raw
    assert piece_bytes[-1] < bins * T // 2
    with pytest.raises(ValueError):
        windows.spec_rans_encode_corpus([specs[0], specs[1][:, : T // 2]])


def test_spec_rans_bit_identical_embeddings():
    import jax

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config

    rng = np.random.default_rng(37)
    bins, T = 92, 300
    specs = [_spec_like(rng, bins, T, smooth=bool(i % 2)) for i in range(4)]
    payload, flags, scales, shape, _ = \
        windows.spec_rans_encode_corpus(specs)
    codes = windows.make_corpus_spec_rans_decoder(shape)(payload, flags)

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    starts = jnp.asarray(windows.linspace_starts(T, cfg.input_shape_2[2], 5))
    batched = windows.make_spec_embedder_batched(params, cfg,
                                                 quantized=True)
    scales_j = jnp.asarray(scales)
    for i, s in enumerate(specs):
        want_codes, scale = windows.spec_quantize(s, bits=8)
        want = np.asarray(batched(jnp.asarray(
            np.stack([want_codes] * len(specs))), scales_j, i, starts))
        got = np.asarray(batched(codes, scales_j, i, starts))
        np.testing.assert_array_equal(got, want)


# --- device-side ENCODE (static tables; the OMR map-download direction) ---


def test_encode_magic_division_exact():
    """The div-free quotient (Hacker's Delight round-up magic, 16-bit-limb
    mulhi) must equal x // f for every table divisor on adversarial x."""
    rng = np.random.default_rng(7)
    for d in [3, 5, 6, 7, 100, 641, 2047, 3000, 4095]:
        s = int(np.ceil(np.log2(d)))
        m = ((1 << (32 + s)) + d - 1) // d - (1 << 32)
        xs = np.unique(np.clip(np.concatenate([
            rng.integers(0, 2**32, 256),
            (2**32 // d) * d + np.arange(-2, 3),
            np.asarray([0, 1, d - 1, d, d + 1, 2**32 - 1, 2**32 - d]),
        ]), 0, 2**32 - 1)).astype(np.uint64)
        h = (xs * m) >> 32
        q = (((xs - h) >> 1) + h) >> (s - 1)
        np.testing.assert_array_equal(q, xs // d)


@pytest.mark.parametrize("kind", ["maplike", "skewed", "uniform"])
def test_device_encoder_bit_identical_to_host(kind):
    """rans_encode_device (in-graph scan, static table) must produce the
    EXACT states and word stream of the numpy host encoder — the host
    decoder then serves both directions of the wire."""
    rng = np.random.default_rng(len(kind))
    n = 37_123
    if kind == "maplike":  # near-binary probability-map codes
        data = np.where(rng.random(n) < 0.97, 0,
                        rng.integers(0, 256, n)).astype(np.uint8)
    elif kind == "skewed":
        data = _skewed_bytes(rng, n)
    else:
        data = rng.integers(0, 256, n, dtype=np.uint8)
    freqs = rans.quantize_freqs(np.bincount(data, minlength=256) + 1)
    S = 256
    _, st_h, w_h = rans.rans_encode(data, S, freqs=freqs)
    st_d, w_d, nw = rans.rans_encode_device(jnp.asarray(data), freqs, n,
                                            w_budget=n, n_streams=S)
    assert int(nw) == w_h.size
    np.testing.assert_array_equal(np.asarray(st_d), st_h)
    np.testing.assert_array_equal(np.asarray(w_d)[:int(nw)], w_h)
    np.testing.assert_array_equal(
        rans.rans_decode_host(freqs, np.asarray(st_d),
                              np.asarray(w_d)[:int(nw)], n), data)


def test_device_encoder_overflow_reports_true_count():
    """A too-small budget truncates the buffer but n_words still reports
    the real count so callers can detect overflow and fall back."""
    rng = np.random.default_rng(3)
    n = 10_000
    data = rng.integers(0, 256, n, dtype=np.uint8)  # incompressible
    freqs = rans.quantize_freqs(np.bincount(data, minlength=256) + 1)
    _, _, w_h = rans.rans_encode(data, 256, freqs=freqs)
    _, w_d, nw = rans.rans_encode_device(jnp.asarray(data), freqs, n,
                                         w_budget=64, n_streams=256)
    assert int(nw) == w_h.size > 64
    assert np.asarray(w_d).shape == (64,)
    np.testing.assert_array_equal(np.asarray(w_d), w_h[:64])


def test_native_decoder_matches_numpy():
    """The native scalar decoder (host side of the map-download wire) must
    reproduce the numpy reference bit-for-bit, truncated payloads and
    zero-word payloads included."""
    lib = rans._native_lib()
    if lib is None or not hasattr(lib, "asr_rans_decode"):
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(17)
    for n, S in [(50_000, 512), (777, 256), (64, 64)]:
        data = _skewed_bytes(rng, n)
        freqs, states, words = rans.rans_encode(data, S)
        got = rans.rans_decode_host(freqs, states, words, n)
        ref = rans._rans_decode_host_numpy(freqs, states, words, n)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, data)
    # constant input: zero-word payload path
    const = np.full(500, 7, np.uint8)
    freqs, states, words = rans.rans_encode(const, 128)
    np.testing.assert_array_equal(
        rans.rans_decode_host(freqs, states, words, 500), const)
    # truncated payload: both decoders clamp to the last word (contained
    # garbage, no crash)
    data = _skewed_bytes(rng, 4096)
    freqs, states, words = rans.rans_encode(data, 256)
    if words.size > 4:
        cut = words[:words.size // 2]
        np.testing.assert_array_equal(
            rans.rans_decode_host(freqs, states, cut, 4096),
            rans._rans_decode_host_numpy(freqs, states, cut, 4096))
