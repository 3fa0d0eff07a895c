"""Gallery-sharded retrieval and psum'd CCA statistics over a device mesh.

Design (new; the reference has no distributed path — SURVEY.md §2):

  * the gallery's rows are sharded across the ``db`` mesh axis; each chip
    computes a local [Q, N/m] score matmul and a local top-k,
  * the k per-shard candidates (scores + globalized indices) ride ICI via
    ``all_gather``, and a final top-k over the m*k candidates re-ranks
    globally — exact, with communication k*m per query instead of N,
  * the large-batch CCA refinement shards the sample axis: each chip
    accumulates 32x32 sufficient statistics over its shard and a single
    ``psum`` reproduces the exact global covariances (ops/cca.py moments).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audio_sheet_retrieval_tpu.ops import cca as cca_ops
from audio_sheet_retrieval_tpu.parallel.mesh import DB_AXIS

HIGHEST = jax.lax.Precision.HIGHEST


def make_sharded_topk(mesh: Mesh, k: int, axis: str = DB_AXIS,
                      n_real: Optional[int] = None,
                      with_valid: bool = False):
    """Build a jitted sharded gallery search.

    Returned fn: (gallery_shards [N, d] (sharded on axis over dim 0),
    queries [Q, d] (replicated)) -> (scores [Q, k], global indices [Q, k]).
    ``n_real``: actual gallery row count — padding rows beyond it are masked
    to -inf BEFORE the local top-k so zero-padding can never evict real
    (possibly negative-scoring) rows.
    ``with_valid``: the fn takes a third argument, a [N] row-validity array
    sharded like the gallery; invalid rows (<=0) are masked to -inf. Used
    when padding rows are INTERLEAVED with real ones (mixed-width sharded
    sheet builds) rather than a contiguous tail.
    """
    n_shards = mesh.shape[axis]

    def _core(gal, q, valid):
        # gal: [N/m, d] local shard; q: [Q, d] replicated
        shard_size = gal.shape[0]
        base = jax.lax.axis_index(axis) * shard_size
        scores = jnp.dot(q, gal.T, precision=HIGHEST,
                         preferred_element_type=jnp.float32)
        # NaN queries (e.g. an untrained zero projection) must not leak
        # padding indices — same defensive mask as the single-chip
        # retrieval.gallery._topk_query
        scores = jnp.where(jnp.isnan(scores), -jnp.inf, scores)
        if valid is not None:
            scores = jnp.where(valid[None, :] > 0, scores, -jnp.inf)
        elif n_real is not None:
            col_global = base + jax.lax.broadcasted_iota(
                jnp.int32, scores.shape, 1)
            scores = jnp.where(col_global < n_real, scores, -jnp.inf)
        # tiny shards may hold fewer than k rows; m*k_local >= k still holds
        k_local = min(k, shard_size)
        s, i = jax.lax.top_k(scores, k_local)
        i = i + base
        # gather the candidate lists of all shards: [Q, m*k]
        s_all = jax.lax.all_gather(s, axis, axis=1, tiled=True)
        i_all = jax.lax.all_gather(i, axis, axis=1, tiled=True)
        s_top, pos = jax.lax.top_k(s_all, k)
        i_top = jnp.take_along_axis(i_all, pos, axis=1)
        return s_top, i_top

    if with_valid:
        fn = jax.shard_map(
            _core, mesh=mesh,
            in_specs=(P(axis, None), P(None, None), P(axis)),
            out_specs=(P(None, None), P(None, None)),
            check_vma=False,
        )
    else:
        fn = jax.shard_map(
            lambda gal, q: _core(gal, q, None), mesh=mesh,
            in_specs=(P(axis, None), P(None, None)),
            out_specs=(P(None, None), P(None, None)),
            check_vma=False,
        )
    return jax.jit(fn), n_shards


def _pad_normalize_gallery(gallery: np.ndarray, m: int) -> np.ndarray:
    """Pad rows to a multiple of the shard count and L2-normalize (zero
    padding rows stay zero => score 0; callers mask by n_real)."""
    n, d = gallery.shape
    n_pad = int(np.ceil(n / m) * m)
    g = np.zeros((n_pad, d), np.float32)
    g[:n] = gallery
    norms = np.linalg.norm(g, axis=1, keepdims=True)
    return g / np.where(norms == 0, 1.0, norms)


def sharded_gallery_search(mesh: Mesh, gallery: np.ndarray,
                           queries: np.ndarray, k: int,
                           axis: str = DB_AXIS
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot exact top-k of normalized ``queries`` against a gallery
    sharded row-wise over ``axis``. Pads the gallery to a multiple of the
    shard count with -inf-scoring rows."""
    n = gallery.shape[0]
    g = _pad_normalize_gallery(gallery, mesh.shape[axis])

    fn, _ = make_sharded_topk(mesh, k, axis, n_real=n)
    gal_dev = jax.device_put(g, NamedSharding(mesh, P(axis, None)))
    q = np.asarray(queries, np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    q_dev = jax.device_put(qn, NamedSharding(mesh, P(None, None)))
    s, i = fn(gal_dev, q_dev)
    s, i = np.asarray(s), np.asarray(i)
    # padding is masked in-kernel; clamp defensively for k > n
    valid = i < n
    return np.where(valid, s, -np.inf), np.where(valid, i, 0)


def _prep_sharded_gallery(mesh: Mesh, gallery, ids, n_pieces: int,
                          n_candidates: int, axis: str,
                          n_real: Optional[int]):
    """Shared gallery prep of the sharded fused queries: upload/normalize
    the rows (host arrays pad here; device arrays from the sharded
    builders stay put), map padding rows to the overflow id bin, and
    build the -inf validity mask. Rows carrying the overflow id are
    padding — the contiguous tail AND any interleaved white-window rows
    of mixed-width sharded builds (build_sharded_sheet_gallery maps those
    to n_pieces). Masking them before the local top-k gives exact count
    parity with the single-chip per-piece-truncated build even when real
    scores are negative (they can never crowd candidate slots).
    Returns (gal_dev, ids_dev, valid_dev, k)."""
    if isinstance(gallery, jax.Array) and not isinstance(gallery,
                                                         np.ndarray):
        assert gallery.shape[0] % mesh.shape[axis] == 0, (
            "device gallery rows must divide the shard count (the builder "
            "pads pieces)")
        n = int(n_real) if n_real is not None else int(gallery.shape[0])

        @jax.jit
        def _norm(g_):
            nn = jnp.linalg.norm(g_, axis=1, keepdims=True)
            return g_ / jnp.where(nn == 0, 1.0, nn)

        gal_dev = _norm(gallery.astype(jnp.float32))
        total = int(gallery.shape[0])
    else:
        n = gallery.shape[0]
        g = _pad_normalize_gallery(np.asarray(gallery, np.float32),
                                   mesh.shape[axis])
        gal_dev = jax.device_put(g, NamedSharding(mesh, P(axis, None)))
        total = g.shape[0]
    k = min(n_candidates, n)
    ids_pad = np.full(total, n_pieces, np.int32)  # pad -> overflow bin
    ids_pad[:n] = np.asarray(ids, np.int32)[:n]
    ids_dev = jax.device_put(ids_pad, NamedSharding(mesh, P(None)))
    valid_rows = (ids_pad != n_pieces).astype(np.float32)
    valid_dev = jax.device_put(valid_rows, NamedSharding(mesh, P(axis)))
    return gal_dev, ids_dev, valid_dev, k


def make_sharded_piece_query(mesh: Mesh, params, cfg, gallery,
                             ids: np.ndarray, n_pieces: int, *,
                             n_candidates: int = 25, axis: str = DB_AXIS,
                             quantized: bool = True,
                             n_real: Optional[int] = None):
    """Pod-scale fused detect_score: ONE jitted program per query with the
    snippet gallery PARTITIONED row-wise across the mesh.

    The single-chip serving path (retrieval.gallery.make_fused_piece_query
    _spec) holds the whole gallery in one device's memory; beyond ~10M
    snippets the rows must shard. Here the query spec payload is replicated, the
    excerpt embedding runs under GSPMD, and the gallery top-k runs as a
    shard_map: local [Q, N/m] matmul + local top-k, candidate exchange
    over ICI (all_gather of k*m rows/query instead of N), global re-rank,
    then the piece-id vote histogram — numerically identical counts to
    the single-chip program (tests/test_parallel.py).

    ``gallery``: host [N, d] rows (padded/normalized/uploaded here), or a
    DEVICE array already sharded over ``axis`` (the output of
    build_sharded_sheet_gallery — pass its n_real so tail padding rows
    are masked; no host round trip).

    Returns query(payload [bins, T], scale, starts) -> counts [n_pieces].
    """
    from audio_sheet_retrieval_tpu.retrieval.gallery import (
        embed_spec_excerpts,
    )

    gal_dev, ids_dev, valid_dev, k = _prep_sharded_gallery(
        mesh, gallery, ids, n_pieces, n_candidates, axis, n_real)
    topk_fn, _ = make_sharded_topk(mesh, k, axis, with_valid=True)

    @jax.jit
    def q(p, gal, idtab, valid, payload, scale, starts):
        codes = embed_spec_excerpts(p, cfg, payload, scale, starts,
                                    quantized)
        _, idx = topk_fn(gal, codes.astype(jnp.float32), valid)
        pid = idtab[idx]
        return jnp.sum(pid[..., None] == jnp.arange(n_pieces), axis=(0, 1))

    params = jax.device_put(params)

    def query(payload, scale, starts):
        return q(params, gal_dev, ids_dev, valid_dev, payload,
                 jnp.float32(scale), starts)

    return query


def make_sharded_sheet_query(mesh: Mesh, params, cfg, gallery,
                             ids: np.ndarray, n_pieces: int, *,
                             n_candidates: int = 25, axis: str = DB_AXIS,
                             coding: str = "rle_bitmap2",
                             strip_shape=None,
                             n_real: Optional[int] = None,
                             block_k=None):
    """Pod-scale fused detect_performance: the sheet->audio MIRROR of
    make_sharded_piece_query (single-chip fast path:
    retrieval.gallery.make_fused_sheet_query; reference protocol
    audio_sheet_server.py:255-300). The query strip uploads once —
    lossless two-level bitmap-RLE wire by default — embeds replicated
    under GSPMD, and the AUDIO-excerpt gallery top-k + piece-id vote
    histogram run sharded over ``axis``.

    ``gallery``: host [N, d] rows, or a DEVICE array sharded over
    ``axis`` (the output of build_sharded_audio_gallery — pass its
    n_real). ``coding``: 'rle_bitmap2' (needs ``strip_shape=(H, W)``;
    query(bm2, vals2, values, starts)) or 'raw' (query(strip, starts)).
    ``block_k``: optional (k1, k2) from ops.windows.rle2_block_plan —
    routes the strip decode through the blocked select-accumulate path
    (no per-pixel random gather; bit-identical).

    Returns query(...) -> counts [n_pieces].
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops.windows import (
        gather_windows,
        rle_bitmap2_decode_device,
    )
    from audio_sheet_retrieval_tpu.train.engine import prepare_view1_device

    if coding not in ("rle_bitmap2", "raw"):
        raise ValueError(f"unknown coding {coding!r}")
    if coding == "rle_bitmap2" and strip_shape is None:
        raise ValueError("coding='rle_bitmap2' needs strip_shape=(H, W)")
    h, window = cfg.input_shape_1[1], cfg.input_shape_1[2]
    gal_dev, ids_dev, valid_dev, k = _prep_sharded_gallery(
        mesh, gallery, ids, n_pieces, n_candidates, axis, n_real)
    topk_fn, _ = make_sharded_topk(mesh, k, axis, with_valid=True)

    def _body(p, gal, idtab, valid, strip, starts):
        r0 = strip.shape[0] // 2 - h // 2
        strip = jax.lax.dynamic_slice_in_dim(strip, r0, h, axis=0)
        wins = gather_windows(strip.astype(jnp.float32), starts, window)
        codes = cca_model.embed_view1(
            p, prepare_view1_device(wins[:, None, :, :], cfg), cfg)
        _, idx = topk_fn(gal, codes.astype(jnp.float32), valid)
        pid = idtab[idx]
        return jnp.sum(pid[..., None] == jnp.arange(n_pieces), axis=(0, 1))

    @jax.jit
    def q_rle2(p, gal, idtab, valid, bm2, vals2, values, starts):
        strip = rle_bitmap2_decode_device(bm2, vals2, values, *strip_shape,
                                          block_k=block_k)
        return _body(p, gal, idtab, valid, strip, starts)

    @jax.jit
    def q_raw(p, gal, idtab, valid, strip, starts):
        return _body(p, gal, idtab, valid, strip, starts)

    params = jax.device_put(params)

    if coding == "rle_bitmap2":
        def query(bm2, vals2, values, starts):
            """(bm2, vals2, values) from
            ops.windows.rle_bitmap2_encode_strip of the [H, W] strip."""
            return q_rle2(params, gal_dev, ids_dev, valid_dev, bm2, vals2,
                          values, starts)
        return query

    def query(strip, starts):
        return q_raw(params, gal_dev, ids_dev, valid_dev, strip, starts)

    return query


def _overflow_ids(valid: np.ndarray, n_pieces: int,
                  n_win: int) -> np.ndarray:
    """Row ids for a sharded gallery build: window rows follow piece
    order; rows whose shared-grid window is invalid for their piece
    (white/silence padding) map to the overflow bin ``n_pieces`` so
    _prep_sharded_gallery masks them out of the vote. ONE home for the
    invariant shared by all three sharded builders."""
    return np.where(valid[:n_pieces].reshape(-1) > 0,
                    np.repeat(np.arange(n_pieces, dtype=np.int64), n_win),
                    np.int64(n_pieces))


def _pad_strip_stack(m: int, cfg, strips, stride: Optional[int]):
    """Shared host prep of the sharded sheet builders: pieces padded
    (all-white) to a multiple of the shard count ``m``, widths to the
    global max, heights vertically CENTERED (see the parity note inline).
    Returns (stack [P_pad, h, w] u8, valid [P_pad, n_win] f32, starts,
    n_win, n_pieces, h, w)."""
    from audio_sheet_retrieval_tpu.ops import windows as win

    sheet_w = cfg.input_shape_1[2]
    stride = stride or sheet_w // 4
    n_pieces = len(strips)
    p_pad = int(np.ceil(n_pieces / m) * m)
    h = max(s.shape[0] for s in strips)
    w = max(s.shape[1] for s in strips)
    stack = np.full((p_pad, h, w), 255, np.uint8)
    starts = win.stride_starts(w, sheet_w, stride)
    n_win = len(starts)
    valid = np.zeros((p_pad, n_win), np.float32)
    for i, s in enumerate(strips):
        # align the GLOBAL center crop (r0 = h//2 - crop//2 inside
        # _strip_embed_core) with the piece's own center crop
        # (s_h//2 - crop//2): padded row r0 - v_off must equal the piece
        # row for ANY height parity, so v_off = h//2 - s_h//2 — the
        # naive (h - s_h)//2 is one row off when exactly one of h, s_h
        # is odd, silently breaking single-chip embedding parity
        v_off = h // 2 - s.shape[0] // 2
        stack[i, v_off:v_off + s.shape[0], :s.shape[1]] = s
        valid[i, :len(win.stride_starts(s.shape[1], sheet_w, stride))] = 1.0
    return stack, valid, starts, n_win, n_pieces, h, w


def build_sharded_sheet_gallery(mesh: Mesh, params, cfg,
                                strips, *, stride: Optional[int] = None,
                                center_crop: int = 160,
                                axis: str = DB_AXIS):
    """Pod-scale sheet-DB build: pieces partitioned across the mesh, each
    chip embeds only ITS strips' sliding windows, and the gallery rows
    come out SHARDED over ``axis`` — no chip ever holds the whole
    database (the single-chip fast path is
    retrieval.server.initialize_sheet_db_from_imges_device).

    ``strips``: per-piece [H, W] uint8 unrolled strips (host). Pieces are
    padded (all-white) to a multiple of the shard count and widths to the
    global max; padding windows land at the END of the row space, so
    consumers mask them with ``n_real`` (make_sharded_piece_query does).

    Mixed-width corpora: the shared start grid covers the WIDEST strip, so
    narrower pieces would contribute windows over their all-white width
    padding. Those rows are (a) zeroed in-kernel — a zero code scores 0
    against every query, exactly like tail-padding rows — and (b) mapped
    to the overflow id bin (``n_pieces``) so the vote histogram ignores
    them; this matches the single-chip build, which truncates the start
    grid per piece (retrieval.server.initialize_sheet_db_from_imges_device).
    Strips shorter than the tallest are vertically CENTERED in the padded
    stack so the fixed center crop hits the same rows the single-chip
    per-piece crop does.

    Returns (codes [P_pad*n_windows, d] jax.Array sharded over ``axis``,
    ids [n_real] int64 piece ids (overflow bin for white-padding windows),
    n_real).
    """
    from audio_sheet_retrieval_tpu.ops import windows as win

    stack, valid, starts, n_win, n_pieces, h, w = _pad_strip_stack(
        mesh.shape[axis], cfg, strips, stride)

    def local_build(p_, strips_local, starts_, valid_local):
        # [P/m, H, W] -> [P/m * n_win, d]; sequential per piece (lax.map)
        # keeps peak memory at one piece's window batch
        def embed_one(args):
            strip, v = args
            codes1 = win._strip_embed_core(p_, strip, starts_, cfg, False,
                                           center_crop)
            return codes1 * v[:, None]

        codes = jax.lax.map(embed_one, (strips_local, valid_local))
        return codes.reshape(-1, codes.shape[-1])

    build = jax.jit(jax.shard_map(
        local_build, mesh=mesh,
        in_specs=(P(), P(axis, None, None), P(), P(axis, None)),
        out_specs=P(axis, None),
        check_vma=False,
    ))
    stack_dev = jax.device_put(stack, NamedSharding(mesh, P(axis, None,
                                                           None)))
    valid_dev = jax.device_put(valid, NamedSharding(mesh, P(axis, None)))
    codes = build(jax.device_put(params), stack_dev, jnp.asarray(starts),
                  valid_dev)
    return codes, _overflow_ids(valid, n_pieces, n_win), n_pieces * n_win


def build_sharded_sheet_gallery_coded(mesh: Mesh, params, cfg,
                                      strips, *,
                                      stride: Optional[int] = None,
                                      center_crop: int = 160,
                                      axis: str = DB_AXIS):
    """Pod-scale sheet-DB build over the serving WIRE coding: identical
    semantics to build_sharded_sheet_gallery, but the strips ship as the
    interleaved-rANS-coded two-level bitmap-RLE payloads (~0.07 B/px,
    ops/windows.rans_encode_corpus_strips) instead of raw pixels
    (1 B/px) — on a pod that is the difference between a multi-GB and a
    multi-hundred-MB ingest riding DCN to the hosts. Each shard decodes
    only ITS pieces' payloads in-graph (one rANS scan per component +
    two cumsum/gather RLE passes per piece) before embedding; the
    decoded pixels are bit-identical, so gallery codes match the raw
    builder's exactly (tests/test_parallel.py).

    Returns (codes sharded over ``axis``, ids, n_real) — the same
    contract as build_sharded_sheet_gallery; feed to
    make_sharded_piece_query.
    """
    from audio_sheet_retrieval_tpu.ops import rans, windows as win

    stack, valid, starts, n_win, n_pieces, h, w = _pad_strip_stack(
        mesh.shape[axis], cfg, strips, stride)
    payload, lens, _ = win.rans_encode_corpus_strips(list(stack))
    n0, n1, n2 = (int(x) for x in lens)
    # blocked select-accumulate decode plan (no per-pixel random gather
    # on-shard; bit-identical, ops/windows.rle2_block_plan) — computed
    # host-side from the pre-rANS rle2 components; None keeps the plain
    # gather decode
    block_k = win.rle2_corpus_block_plan(
        [win.rle_bitmap2_encode_strip(s_) for s_ in stack], h * w)

    def local_build(p_, f0, s0, w0, f1, s1, w1, f2, s2, w2, starts_,
                    valid_local):
        bm2 = rans.rans_decode_batch_device(f0, s0, w0, n0)
        v2 = rans.rans_decode_batch_device(f1, s1, w1, n1)
        v1 = rans.rans_decode_batch_device(f2, s2, w2, n2)

        def embed_one(args):
            b_, v2_, v1_, v = args
            strip = win.rle_bitmap2_decode_device(b_, v2_, v1_, h, w,
                                                  block_k)
            codes1 = win._strip_embed_core(p_, strip, starts_, cfg, False,
                                           center_crop)
            return codes1 * v[:, None]

        codes = jax.lax.map(embed_one, (bm2, v2, v1, valid_local))
        return codes.reshape(-1, codes.shape[-1])

    build = jax.jit(jax.shard_map(
        local_build, mesh=mesh,
        in_specs=(P(),) + (P(axis, None),) * 9 + (P(), P(axis, None)),
        out_specs=P(axis, None),
        check_vma=False,
    ))
    sh = NamedSharding(mesh, P(axis, None))
    wire = [jax.device_put(np.asarray(a), sh)
            for comp in payload for a in comp]
    valid_dev = jax.device_put(valid, sh)
    codes = build(jax.device_put(params), *wire, jnp.asarray(starts),
                  valid_dev)
    return codes, _overflow_ids(valid, n_pieces, n_win), n_pieces * n_win


def build_sharded_audio_gallery(mesh: Mesh, params, cfg, specs, *,
                                stride: Optional[int] = None,
                                quantize: int = 16, coded: bool = False,
                                axis: str = DB_AXIS):
    """Pod-scale audio-DB build: the sheet->audio mirror of
    build_sharded_sheet_gallery. Pieces' spectrograms are partitioned
    across the mesh, each chip embeds only ITS pieces' sliding context
    windows (the single-chip fast path is
    retrieval.server.initialize_audio_db_from_specs_device), and the
    excerpt codes come out SHARDED over ``axis``.

    ``specs``: per-piece [bins, T_i] float32 spectrograms (host). Pieces
    pad (zeros = silence) to the global max T and to a multiple of the
    shard count; the shared start grid covers the longest piece, and a
    shorter piece's grid-tail windows are zeroed + mapped to the overflow
    id bin, exactly like the sheet build's white-padding windows — so
    per-piece codes equal the single-chip per-piece-truncated build
    bit-for-bit (tests/test_parallel.py).

    ``quantize``: 16 (the strict rank-agreement-lossless wire, single-chip
    parity recipe) or 8 (the hard-corpus-gated minimum wire).
    ``coded=True`` (u8 only) additionally ships the codes entropy-coded by
    the spec-rANS serving wire (raw-or-time-delta per piece,
    ops/windows.spec_rans_encode_corpus) and decodes on-shard — lossless
    over the codes, so embeddings are bit-identical to ``coded=False``.

    Returns (codes sharded over ``axis``, ids, n_real) — the
    make_sharded_piece_query contract.
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops import rans
    from audio_sheet_retrieval_tpu.ops import windows as win
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    if coded and quantize != 8:
        raise ValueError("coded=True is the u8 spec-rANS wire")
    m = mesh.shape[axis]
    ctx = cfg.input_shape_2[2]
    stride = stride or ctx // 4
    n_pieces = len(specs)
    p_pad = int(np.ceil(n_pieces / m) * m)
    bins = {s.shape[0] for s in specs}
    if len(bins) != 1:
        raise ValueError(f"specs must share the bin count, got {bins}")
    bins = bins.pop()
    T = max(s.shape[1] for s in specs)
    stack = np.zeros((p_pad, bins, T), np.float32)
    starts = win.stride_starts(T, ctx, stride)
    n_win = len(starts)
    valid = np.zeros((p_pad, n_win), np.float32)
    for i, s in enumerate(specs):
        stack[i, :, :s.shape[1]] = np.asarray(s, np.float32)
        valid[i, :len(win.stride_starts(s.shape[1], ctx, stride))] = 1.0
    maxcode = float((1 << quantize) - 1)

    def embed_one_fn(p_, starts_):
        def embed_one(args):
            c, sc, v = args
            spec = c.astype(jnp.float32) * (sc / maxcode)
            wins = win.gather_windows(spec, starts_, ctx)
            x = prepare_view2_device(wins[:, None, :, :])
            e = cca_model.embed_view2(p_, x, cfg)
            # grid-tail windows read the zero padding: their L2-normalized
            # embedding is NaN (0/0), so select — don't multiply — to zero
            return jnp.where(v[:, None] > 0, e, 0.0)

        return embed_one

    sh_p = NamedSharding(mesh, P(axis))
    sh_pn = NamedSharding(mesh, P(axis, None))
    if coded:
        payload, flags, scales, _, _ = win.spec_rans_encode_corpus(
            list(stack))
        n_codes = bins * T

        def local_build(p_, f_, s_, w_, flags_, scales_, starts_,
                        valid_local):
            codes = rans.rans_decode_batch_device(f_, s_, w_, n_codes)
            codes = win.spec_undelta_device(codes.reshape(-1, bins, T),
                                            flags_)
            out = jax.lax.map(embed_one_fn(p_, starts_),
                              (codes, scales_, valid_local))
            return out.reshape(-1, out.shape[-1])

        build = jax.jit(jax.shard_map(
            local_build, mesh=mesh,
            in_specs=(P(),) + (P(axis, None),) * 3 + (P(axis), P(axis),
                                                      P(), P(axis, None)),
            out_specs=P(axis, None),
            check_vma=False,
        ))
        codes = build(jax.device_put(params),
                      *(jax.device_put(np.asarray(a), sh_pn)
                        for a in payload),
                      jax.device_put(flags, sh_p),
                      jax.device_put(scales, sh_p),
                      jnp.asarray(starts), jax.device_put(valid, sh_pn))
    else:
        q = [win.spec_quantize(stack[i], bits=quantize)
             for i in range(p_pad)]
        codes_stack = np.stack([c for c, _ in q])
        scales = np.asarray([s for _, s in q], np.float32)

        def local_build(p_, codes_local, scales_, starts_, valid_local):
            out = jax.lax.map(embed_one_fn(p_, starts_),
                              (codes_local, scales_, valid_local))
            return out.reshape(-1, out.shape[-1])

        build = jax.jit(jax.shard_map(
            local_build, mesh=mesh,
            in_specs=(P(), P(axis, None, None), P(axis), P(),
                      P(axis, None)),
            out_specs=P(axis, None),
            check_vma=False,
        ))
        codes = build(jax.device_put(params),
                      jax.device_put(codes_stack,
                                     NamedSharding(mesh, P(axis, None,
                                                           None))),
                      jax.device_put(scales, sh_p), jnp.asarray(starts),
                      jax.device_put(valid, sh_pn))
    return codes, _overflow_ids(valid, n_pieces, n_win), n_pieces * n_win


def make_sharded_cca_moments(mesh: Mesh, axis: str = "data"):
    """Jitted exact CCA sufficient statistics over a sample-sharded pair of
    latent matrices: per-shard sums + one psum."""
    def local_moments(h1, h2):
        m = cca_ops.cca_moments(h1, h2)
        return jax.tree.map(lambda x: jax.lax.psum(x, axis), m)

    fn = jax.shard_map(
        local_moments, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=cca_ops.CCAMoments(n=P(), s1=P(), s2=P(), s11=P(),
                                     s22=P(), s12=P()),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_cca_fit(mesh: Mesh, H1: np.ndarray, H2: np.ndarray,
                    axis: str = "data", method: str = "svd",
                    r1: float = 1e-3, r2: float = 1e-3) -> cca_ops.CCAResult:
    """Exact multi-chip CCA fit: shard samples, psum 32x32 moments, fit.

    Trims the sample count to a multiple of the mesh axis (callers control
    n_train, reference refine_cca.py:31 uses 25000)."""
    m = mesh.shape[axis]
    n = (H1.shape[0] // m) * m
    fn = make_sharded_cca_moments(mesh, axis)
    sh = NamedSharding(mesh, P(axis, None))
    h1 = jax.device_put(np.asarray(H1[:n], np.float32), sh)
    h2 = jax.device_put(np.asarray(H2[:n], np.float32), sh)
    moments = fn(h1, h2)
    return cca_ops.cca_fit_from_moments(moments, r1=r1, r2=r2, method=method)
