"""Multi-chip paths on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from audio_sheet_retrieval_tpu.ops import cca as cca_ops
from audio_sheet_retrieval_tpu.parallel import gallery as pg
from audio_sheet_retrieval_tpu.parallel import mesh as pm


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return pm.make_mesh((8,), axis_names=(pm.DB_AXIS,))


def test_sharded_gallery_search_exact(mesh8):
    rng = np.random.default_rng(0)
    gallery = rng.standard_normal((1000, 32)).astype(np.float32)
    queries = rng.standard_normal((17, 32)).astype(np.float32)
    k = 25
    s, i = pg.sharded_gallery_search(mesh8, gallery, queries, k)
    # oracle: dense cosine top-k
    gn = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    scores = qn @ gn.T
    want = np.argsort(-scores, axis=1)[:, :k]
    want_s = np.take_along_axis(scores, want, axis=1)
    np.testing.assert_allclose(s, want_s, atol=1e-5)
    # indices agree where scores are distinct
    for q in range(len(queries)):
        assert set(i[q]) == set(want[q])


def test_sharded_gallery_padding(mesh8):
    rng = np.random.default_rng(1)
    gallery = rng.standard_normal((37, 8)).astype(np.float32)  # not /8
    queries = rng.standard_normal((3, 8)).astype(np.float32)
    s, i = pg.sharded_gallery_search(mesh8, gallery, queries, k=5)
    assert (i < 37).all()
    assert np.isfinite(s).all()


def test_sharded_cca_fit_matches_monolithic(mesh8):
    rng = np.random.default_rng(2)
    z = rng.standard_normal((512, 6))
    H1 = (z @ rng.standard_normal((6, 6)) + 0.3 * rng.standard_normal((512, 6))
          ).astype(np.float32)
    H2 = (z @ rng.standard_normal((6, 6)) + 0.3 * rng.standard_normal((512, 6))
          ).astype(np.float32)
    full = cca_ops.cca_fit(H1, H2)
    sharded = pg.sharded_cca_fit(mesh8, H1, H2, axis=pm.DB_AXIS)
    np.testing.assert_allclose(np.asarray(full.coeffs),
                               np.asarray(sharded.coeffs), atol=1e-3)
    np.testing.assert_allclose(np.asarray(full.m1), np.asarray(sharded.m1),
                               atol=1e-5)


@pytest.mark.slow
def test_dp_train_step_under_mesh(mesh8):
    """Train step with batch sharded over the mesh: XLA inserts the
    cross-device reductions for batch stats + grads automatically."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.train import engine, state as ts

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8, batch_size=16)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    optimizer = ts.make_optimizer(1e-3)
    st = ts.init_train_state(params, cfg, optimizer)
    st = pm.replicate(mesh8, st)
    step = jax.jit(engine.make_train_step(cfg, optimizer))

    rng = np.random.default_rng(0)
    x1 = pm.shard_batch(mesh8, rng.random((16, 1, 160, 200)).astype(np.float32) * 255,
                        axis=pm.DB_AXIS)
    x2 = pm.shard_batch(mesh8, rng.random((16, 1, 92, 42)).astype(np.float32),
                        axis=pm.DB_AXIS)
    st2, metrics = step(st, x1, x2)
    assert np.isfinite(float(metrics["loss"]))
    w0 = np.asarray(st.trainable["view1"]["blocks"][0]["w"])
    w1 = np.asarray(st2.trainable["view1"]["blocks"][0]["w"])
    assert not np.allclose(w0, w1)


def test_sharded_gallery_negative_scores_no_padding_eviction(mesh8):
    """All-negative scores + padded gallery: padding must not displace real
    rows (zero-score pads previously won)."""
    rng = np.random.default_rng(5)
    gallery = rng.standard_normal((13, 8)).astype(np.float32)  # pads to 16
    queries = (-gallery[:2]).astype(np.float32)  # scores all negative
    s, i = pg.sharded_gallery_search(mesh8, gallery, queries, k=6)
    assert (i < 13).all()
    assert np.isfinite(s).all()
    # oracle
    gn = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    want = np.argsort(-(qn @ gn.T), axis=1)[:, :6]
    for r in range(2):
        assert set(i[r]) == set(want[r])


def test_hybrid_mesh_axes_and_training():
    """2-D ('data', 'db') mesh of 2 x 4 devices: the training step runs
    with the batch over both axes, and the gallery search over one 'db'
    row of the mesh."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.train import engine, state as tstate

    mesh = pm.make_mesh((2, 4), (pm.DATA_AXIS, pm.DB_AXIS))
    assert dict(mesh.shape) == {"data": 2, "db": 4}

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8, batch_size=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    opt = tstate.make_optimizer(cfg.ini_learning_rate)
    st = pm.replicate(mesh, tstate.init_train_state(params, cfg, opt))
    step = jax.jit(engine.make_train_step(cfg, opt))
    rng = np.random.default_rng(0)
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = NamedSharding(mesh, P(mesh.axis_names))
    x1 = jax.device_put((rng.random((8, 1, 160, 200)) * 255).astype(
        np.float32), spec)
    x2 = jax.device_put(rng.random((8, 1, 92, 42)).astype(np.float32), spec)
    st, m = step(st, x1, x2)
    assert np.isfinite(float(m["loss"]))

    sub = pm.make_mesh((4,), axis_names=(pm.DB_AXIS,),
                       devices=list(mesh.devices[0]))
    g = rng.standard_normal((64, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    s, i = pg.sharded_gallery_search(sub, g, q, k=4, axis=pm.DB_AXIS)
    assert np.isfinite(s).all() and i.shape == (3, 4)


def test_sharded_piece_query_matches_single_chip(mesh8):
    """Pod-scale fused detect_score (gallery partitioned over the db axis,
    local top-k + all_gather re-rank + vote) produces the SAME per-piece
    counts as the single-chip fused spec query."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import windows
    from audio_sheet_retrieval_tpu.retrieval.gallery import (
        DeviceGallery,
        make_fused_piece_query_spec,
    )

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(2), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(9)
    n, n_pieces = 1003, 37  # deliberately not divisible by 8 shards
    codes = rng.standard_normal((n, cfg.dim_latent)).astype(np.float32)
    ids = rng.integers(0, n_pieces, n)
    spec = (rng.random((92, 300)) * 4).astype(np.float32)
    payload, scale = windows.spec_quantize(spec, bits=16)
    starts = jnp.asarray(windows.linspace_starts(300, 42, 20))

    single = make_fused_piece_query_spec(
        params, cfg, DeviceGallery(codes, ids=ids), n_pieces,
        n_candidates=10, quantized=True)
    want = np.asarray(single(jnp.asarray(payload), scale, starts))

    sharded = pg.make_sharded_piece_query(
        mesh8, params, cfg, codes, ids, n_pieces, n_candidates=10)
    got = np.asarray(sharded(jnp.asarray(payload), scale, starts))
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 20 * 10  # every excerpt votes its top-10


def test_sharded_gallery_build_and_query_end_to_end(mesh8):
    """Pod-scale serving end-to-end: pieces partitioned across the mesh,
    gallery rows built sharded (build_sharded_sheet_gallery), consumed
    directly by the sharded fused query with tail-padding masked — codes
    match the single-chip strip embedder and counts match the single-chip
    fused query."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import windows
    from audio_sheet_retrieval_tpu.retrieval.gallery import (
        DeviceGallery,
        make_fused_piece_query_spec,
    )

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(3), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(11)
    strips = []
    for _ in range(5):  # 5 pieces pad to 8 shards
        s = np.full((200, 1200), 255, np.uint8)
        for x in rng.integers(0, 1100, 60):
            s[rng.integers(20, 170):, x:x + 5][:12] = 0
        strips.append(s)

    codes, ids, n_real = pg.build_sharded_sheet_gallery(
        mesh8, params, cfg, strips)
    assert n_real == len(ids)
    codes_np = np.asarray(codes)[:n_real]

    # oracle: single-chip embedder over the same padded geometry
    starts = jnp.asarray(windows.stride_starts(1200, 200, 50))
    embed = windows.make_strip_embedder(params, cfg, center_crop=160)
    want = np.concatenate([
        np.asarray(embed(jnp.asarray(s), starts)) for s in strips])
    np.testing.assert_allclose(codes_np, want, atol=2e-5)

    spec = (rng.random((92, 260)) * 4).astype(np.float32)
    payload, scale = windows.spec_quantize(spec, bits=16)
    qstarts = jnp.asarray(windows.linspace_starts(260, 42, 15))
    single = make_fused_piece_query_spec(
        params, cfg, DeviceGallery(want, ids=ids), 5, n_candidates=7,
        quantized=True)
    want_counts = np.asarray(single(jnp.asarray(payload), scale, qstarts))
    sharded = pg.make_sharded_piece_query(
        mesh8, params, cfg, codes, ids, 5, n_candidates=7, n_real=n_real)
    got_counts = np.asarray(sharded(jnp.asarray(payload), scale, qstarts))
    np.testing.assert_array_equal(got_counts, want_counts)


def test_sharded_gallery_build_mixed_width_matches_single_chip(mesh8):
    """MIXED-width (and -height) corpus: the sharded build's shared start
    grid covers the widest strip, so narrower pieces' white-padding
    windows must not become real gallery rows — ids map them to the
    overflow bin, codes zero out, and the fused query masks them, giving
    EXACT vote parity with the single-chip per-piece-truncated build
    (advisor round-3 medium finding)."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import windows
    from audio_sheet_retrieval_tpu.retrieval.gallery import (
        DeviceGallery,
        make_fused_piece_query_spec,
    )

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(4), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(13)
    widths = [1400, 700, 1100, 450, 900]
    # odd heights included: v_off must be h//2 - s_h//2, not
    # (h - s_h)//2, for the global center crop to land on the same rows
    # as the per-piece crop when the parities differ
    heights = [200, 161, 200, 175, 160]
    strips = []
    for w_i, h_i in zip(widths, heights):
        s = np.full((h_i, w_i), 255, np.uint8)
        for x in rng.integers(0, w_i - 10, max(10, w_i // 20)):
            s[rng.integers(10, h_i - 30):, x:x + 5][:12] = 0
        strips.append(s)

    codes, ids, n_real = pg.build_sharded_sheet_gallery(
        mesh8, params, cfg, strips)
    n_pieces = len(strips)
    # single-chip oracle: per-piece truncated start grid (the semantics of
    # retrieval.server.initialize_sheet_db_from_imges_device)
    want_codes, want_ids = [], []
    for i, s in enumerate(strips):
        st = windows.stride_starts(s.shape[1], 200, 50)
        embed = windows.make_strip_embedder(params, cfg, center_crop=160)
        want_codes.append(np.asarray(embed(jnp.asarray(s),
                                           jnp.asarray(st))))
        want_ids.append(np.full(len(st), i, np.int64))
    want_codes = np.concatenate(want_codes)
    want_ids = np.concatenate(want_ids)

    # sharded rows restricted to valid ids reproduce the oracle rows
    codes_np = np.asarray(codes)[:n_real]
    real = ids != n_pieces
    np.testing.assert_allclose(codes_np[real], want_codes, atol=2e-5)
    np.testing.assert_array_equal(ids[real], want_ids)
    # white-padding windows are zeroed => can never outscore real rows
    assert np.abs(codes_np[~real]).max() == 0.0

    # fused query: counts identical to the single-chip gallery (no white
    # window may siphon votes OR crowd candidate slots on any query,
    # including a near-blank/quiet one)
    for spec_scale in (4.0, 0.05):
        spec = (rng.random((92, 260)) * spec_scale).astype(np.float32)
        payload, scale = windows.spec_quantize(spec, bits=16)
        qstarts = jnp.asarray(windows.linspace_starts(260, 42, 15))
        single = make_fused_piece_query_spec(
            params, cfg, DeviceGallery(want_codes, ids=want_ids), n_pieces,
            n_candidates=7, quantized=True)
        want_counts = np.asarray(single(jnp.asarray(payload), scale,
                                        qstarts))
        sharded = pg.make_sharded_piece_query(
            mesh8, params, cfg, codes, ids, n_pieces, n_candidates=7,
            n_real=n_real)
        got_counts = np.asarray(sharded(jnp.asarray(payload), scale,
                                        qstarts))
        np.testing.assert_array_equal(got_counts, want_counts)


def test_sharded_gallery_build_coded_matches_raw(mesh8):
    """Wire-coded pod build (build_sharded_sheet_gallery_coded): the
    strips ship as the rANS-coded rle2 serving wire and decode on-shard —
    the decode is bit-exact, so gallery codes, ids and n_real must equal
    the raw-pixel sharded build's EXACTLY. Mixed widths/heights exercise
    the white padding and vertical centering through the coded path."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(5), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(17)
    widths = [1200, 800, 1200, 500]
    heights = [200, 171, 190, 200]
    strips = []
    for w_i, h_i in zip(widths, heights):
        s = np.full((h_i, w_i), 255, np.uint8)
        for x in rng.integers(0, w_i - 10, max(10, w_i // 25)):
            s[rng.integers(10, h_i - 30):, x:x + 5][:12] = 0
        strips.append(s)

    raw_codes, raw_ids, raw_n = pg.build_sharded_sheet_gallery(
        mesh8, params, cfg, strips)
    coded_codes, coded_ids, coded_n = pg.build_sharded_sheet_gallery_coded(
        mesh8, params, cfg, strips)
    assert coded_n == raw_n
    np.testing.assert_array_equal(coded_ids, raw_ids)
    np.testing.assert_array_equal(np.asarray(coded_codes),
                                  np.asarray(raw_codes))


def test_sharded_audio_gallery_build_matches_single_chip(mesh8):
    """Pod-scale audio-DB build (build_sharded_audio_gallery): ragged
    piece lengths, codes bit-equal to the single-chip per-piece quantized
    embedder, grid-tail windows zeroed + overflow ids, and the
    coded=True u8 spec-rANS wire bit-equal to the uncoded u8 build."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import windows

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(6), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(19)
    ctx = cfg.input_shape_2[2]
    lengths = [260, 140, 200, 331]
    specs = [(rng.random((92, t)) * 4).astype(np.float32) for t in lengths]

    codes, ids, n_real = pg.build_sharded_audio_gallery(
        mesh8, params, cfg, specs, quantize=16)
    n_pieces = len(specs)
    codes_np = np.asarray(codes)[:n_real]
    assert n_real == len(ids)

    # single-chip oracle: per-piece quantized embed with truncated starts
    embed = windows.make_spec_embedder_q(params, cfg)
    want_codes, want_ids = [], []
    for i, s in enumerate(specs):
        st = windows.stride_starts(s.shape[1], ctx, ctx // 4)
        payload, scale = windows.spec_quantize(s, bits=16)
        want_codes.append(np.asarray(embed(jnp.asarray(payload), scale,
                                           jnp.asarray(st))))
        want_ids.append(np.full(len(st), i, np.int64))
    want_codes = np.concatenate(want_codes)
    want_ids = np.concatenate(want_ids)

    real = ids != n_pieces
    # 1-ulp drift allowed: the shard_map/lax.map program fuses differently
    # from the standalone embedder (same tolerance as the sheet build test)
    np.testing.assert_allclose(codes_np[real], want_codes, atol=2e-5)
    np.testing.assert_array_equal(ids[real], want_ids)
    assert np.abs(codes_np[~real]).max() == 0.0

    # the u8 spec-rANS wire build decodes bit-exactly: == uncoded u8
    u8_codes, u8_ids, u8_n = pg.build_sharded_audio_gallery(
        mesh8, params, cfg, specs, quantize=8)
    c_codes, c_ids, c_n = pg.build_sharded_audio_gallery(
        mesh8, params, cfg, specs, quantize=8, coded=True)
    assert (u8_n, list(u8_ids)) == (c_n, list(c_ids))
    np.testing.assert_array_equal(np.asarray(c_codes),
                                  np.asarray(u8_codes))
    with pytest.raises(ValueError):
        pg.build_sharded_audio_gallery(mesh8, params, cfg, specs,
                                       quantize=16, coded=True)


def test_serving_matrix_on_2d_mesh():
    """The pod serving matrix on a 2-D (data=4, db=2) mesh — the dryrun's
    actual pod layout — sharding builds and queries over the db axis
    only: coded sheet build + fused piece query must reproduce the 1-D
    full-mesh results exactly (same pieces, same query)."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import windows

    mesh2d = pm.make_mesh((4, 2), axis_names=(pm.DATA_AXIS, pm.DB_AXIS))
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(8), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(29)
    strips = []
    for _ in range(3):
        s = np.full((200, 900), 255, np.uint8)
        for x in rng.integers(0, 880, 40):
            s[rng.integers(20, 170):, x:x + 5][:12] = 0
        strips.append(s)
    spec = (rng.random((92, 260)) * 4).astype(np.float32)
    payload, scale = windows.spec_quantize(spec, bits=16)
    qstarts = jnp.asarray(windows.linspace_starts(260, 42, 10))

    results = {}
    for name, mesh in (("2d", mesh2d),
                       ("1d", pm.make_mesh((8,),
                                           axis_names=(pm.DB_AXIS,)))):
        codes, ids, n_real = pg.build_sharded_sheet_gallery_coded(
            mesh, params, cfg, strips, axis=pm.DB_AXIS)
        q = pg.make_sharded_piece_query(
            mesh, params, cfg, codes, ids, 3, n_candidates=5,
            n_real=n_real, axis=pm.DB_AXIS)
        results[name] = np.asarray(q(jnp.asarray(payload), scale,
                                     qstarts))
    np.testing.assert_array_equal(results["2d"], results["1d"])
    assert int(results["2d"].sum()) == 10 * 5


def test_sharded_sheet_query_matches_single_chip(mesh8):
    """Pod-scale sheet->audio mirror query (make_sharded_sheet_query): a
    strip query over the rle2 wire against the SHARDED audio gallery must
    produce vote counts identical to the single-chip fused sheet query
    (make_fused_sheet_query) over the same gallery rows."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import windows
    from audio_sheet_retrieval_tpu.retrieval.gallery import (
        DeviceGallery,
        make_fused_sheet_query,
    )

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(7), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    rng = np.random.default_rng(23)
    lengths = [260, 140, 200, 331, 180]
    specs = [(rng.random((92, t)) * 4).astype(np.float32) for t in lengths]
    codes, ids, n_real = pg.build_sharded_audio_gallery(
        mesh8, params, cfg, specs, quantize=16)
    n_pieces = len(specs)

    # sheet query strip over the lossless rle2 wire
    H, W = 200, 900
    strip = np.full((H, W), 255, np.uint8)
    for x in rng.integers(0, W - 10, 40):
        strip[rng.integers(20, H - 40):, x:x + 5][:12] = 0
    bm2, vals2, values = windows.rle_bitmap2_encode_strip(strip)
    qstarts = jnp.asarray(
        windows.linspace_starts(W, cfg.input_shape_1[2], 12))

    sharded = pg.make_sharded_sheet_query(
        mesh8, params, cfg, codes, ids, n_pieces, n_candidates=7,
        coding="rle_bitmap2", strip_shape=(H, W), n_real=n_real)
    got = np.asarray(sharded(jnp.asarray(bm2), jnp.asarray(vals2),
                             jnp.asarray(values), qstarts))

    # single-chip oracle over the REAL gallery rows (overflow-bin rows
    # dropped — the sharded path masks them in-kernel)
    real = ids != n_pieces
    gal_np = np.asarray(codes)[:n_real]
    single = make_fused_sheet_query(
        params, cfg, DeviceGallery(gal_np[real], ids=ids[real]), n_pieces,
        n_candidates=7, coding="rle_bitmap2", strip_shape=(H, W))
    want = np.asarray(single(jnp.asarray(bm2), jnp.asarray(vals2),
                             jnp.asarray(values), qstarts))
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 12 * 7  # every query window votes k times
