"""Device-resident embedding gallery with fused matmul + top-k search.

The reference's retrieval hot path is a per-query scipy ``cdist`` against the
whole snippet-code database on the host (reference:audio_sheet_server.py:
530-551). Here the gallery lives in device memory, padded to a size bucket so
the query is one compiled XLA computation: an [Q, 32] x [32, N] score matmul
followed by ``lax.top_k`` — no host round-trips, no recompilation as
the database grows within a bucket.

Cosine distance semantics match cdist: 1 - <q, g>/(|q||g|); embeddings from
the model are already L2-normalized, but normalization is applied defensively
so raw codes behave identically to the reference.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def _normalize(x, eps=0.0):
    n = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return x / jnp.where(n == 0, 1.0, n)


@functools.partial(jax.jit, static_argnames=("k",))
def _topk_query(gallery_nt: jnp.ndarray, valid: jnp.ndarray,
                queries: jnp.ndarray, k: int):
    q = _normalize(queries.astype(jnp.float32))
    scores = jnp.dot(q, gallery_nt, precision=HIGHEST,
                     preferred_element_type=jnp.float32)
    # invalid (padding) rows get -inf score == +inf distance; NaN queries
    # (e.g. an untrained zero projection) must not leak padding indices
    scores = jnp.where(valid[None, :] & ~jnp.isnan(scores), scores, -jnp.inf)
    top_scores, top_idx = jax.lax.top_k(scores, k)
    return 1.0 - top_scores, top_idx


class DeviceGallery:
    """Padded device gallery over [N, d] codes with integer labels."""

    def __init__(self, codes: np.ndarray, ids: Optional[np.ndarray] = None,
                 bucket: int = 2048):
        n, d = codes.shape
        n_pad = max(bucket, int(np.ceil(n / bucket) * bucket))
        if isinstance(codes, jnp.ndarray):
            # device-resident codes (the fused DB builds) pad on device —
            # no download/re-upload round trip
            g = jnp.pad(codes.astype(jnp.float32), ((0, n_pad - n), (0, 0)))
        else:
            padded = np.zeros((n_pad, d), np.float32)
            padded[:n] = np.asarray(codes, np.float32)
            g = jnp.asarray(padded)
        self.n = n
        # store normalized + transposed: the query matmul is [Q,d] @ [d,N]
        self.gallery_n = _normalize(g)
        self.gallery_nt = jnp.transpose(self.gallery_n)
        self.valid = jnp.arange(n_pad) < n
        self.ids = (np.asarray(ids, np.int64) if ids is not None
                    else np.arange(n, dtype=np.int64))

    def topk(self, queries: np.ndarray, k: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (distances [Q, k], gallery indices [Q, k])."""
        k = min(k, self.n)
        q = jnp.atleast_2d(jnp.asarray(queries))
        d, i = _topk_query(self.gallery_nt, self.valid, q, k)
        return np.asarray(d), np.asarray(i)

    def topk_ids(self, queries: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels [Q, k], gallery indices [Q, k]) — the reference's
        ``_retrieve_*_ids`` contract (audio_sheet_server.py:530-563)."""
        _, idx = self.topk(queries, k)
        return self.ids[idx], idx


def make_fused_piece_query(params, cfg, processor, gallery: "DeviceGallery",
                           n_pieces: int, *, n_candidates: int = 25,
                           mulaw: bool = True):
    """Raw audio -> per-piece vote counts, ONE device dispatch.

    Fuses the reference's detect_score pipeline (audio_sheet_server.py:
    213-253: spectrogram, excerpt embedding, top-n_candidates snippet
    retrieval, piece-id histogram): DSP + encoder + CCA projection + gallery
    matmul + top-k + one-hot vote counting run as a single jitted program;
    the host downloads only an [n_pieces] count vector. With mu-law ingest
    the whole query uploads one byte per audio sample.
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops.audio import _spectrogram_core
    from audio_sheet_retrieval_tpu.ops.windows import (
        gather_windows,
        mulaw_decode_device,
    )
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]
    k = min(n_candidates, gallery.n)
    # padded piece-id table: padding rows vote into a discarded overflow bin
    ids_pad = np.full(gallery.gallery_n.shape[0], n_pieces, np.int32)
    ids_pad[:gallery.n] = gallery.ids
    ids_pad = jnp.asarray(ids_pad)

    @functools.partial(jax.jit, static_argnames=("num_frames",))
    def q(p, fb, win_arr, gal_nt, valid, idtab, sig, starts,
          num_frames: int):
        if mulaw:
            s = mulaw_decode_device(sig) * (32768.0 / 32767.0)
        else:
            s = sig.astype(jnp.float32) * (1.0 / 32767.0)
        starts_f = (jnp.arange(num_frames) * processor.hop_size
                    ).astype(jnp.int32)
        spec = _spectrogram_core(s, win_arr, fb, starts_f, num_frames,
                                 processor.frame_size).T
        wins = gather_windows(spec, starts, window)
        codes = cca_model.embed_view2(
            p, prepare_view2_device(wins[:, None, :, :]), cfg)
        scores = jnp.dot(codes.astype(jnp.float32), gal_nt,
                         precision=HIGHEST,
                         preferred_element_type=jnp.float32)
        scores = jnp.where(valid[None, :] & ~jnp.isnan(scores), scores,
                           -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        pid = idtab[idx]                                         # [Q, k]
        counts = jnp.sum(pid[..., None] == jnp.arange(n_pieces),
                         axis=(0, 1))
        return counts

    params = jax.device_put(params)
    fb = processor.filterbank
    win_arr = processor._window

    def query(audio, starts, num_frames: int):
        """audio: mu-law uint8 (mulaw=True) or int16 samples on host/device;
        starts: excerpt start frames; -> vote counts [n_pieces] (device)."""
        return q(params, fb, win_arr, gallery.gallery_nt, gallery.valid,
                 ids_pad, audio, starts, num_frames)

    return query


def embed_spec_excerpts(params, cfg, payload, scale, starts,
                        quantized: bool):
    """Traceable body shared by the fused spec queries (single-chip below,
    pod-scale parallel.gallery.make_sharded_piece_query): (quantized)
    spectrogram payload -> L2-normalized excerpt embedding codes."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops.windows import (
        gather_windows,
        spec_dequantize_device,
    )
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    spec = (spec_dequantize_device(payload, scale) if quantized
            else payload.astype(jnp.float32))
    wins = gather_windows(spec, starts, cfg.input_shape_2[2])
    return cca_model.embed_view2(
        params, prepare_view2_device(wins[:, None, :, :]), cfg)


def make_fused_piece_query_spec(params, cfg, gallery: "DeviceGallery",
                                n_pieces: int, *, n_candidates: int = 25,
                                quantized: bool = True):
    """Spectrogram -> per-piece vote counts, ONE device dispatch.

    The spectrogram-upload variant of make_fused_piece_query: the client
    runs the DSP on the host (ops.audio.AudioProcessor.process_host — the
    reference's own serving architecture, precomputed ``*_spec.npy``
    uploads at audio_sheet_server.py:632-636) and ships only the
    log-filterbank spectrogram: 7.4 kB/s f32, 1.8 kB/s u8-quantized
    (``quantized``, via ops.windows.spec_quantize) vs 22 kB/s mu-law
    waveform — the query upload drops ~12x and with it the p50 latency on
    bandwidth-limited links.

    query(spec_or_codes [bins, T], scale, starts) -> vote counts
    [n_pieces]; pass scale=1.0 for f32 specs.
    """
    k = min(n_candidates, gallery.n)
    ids_pad = np.full(gallery.gallery_n.shape[0], n_pieces, np.int32)
    ids_pad[:gallery.n] = gallery.ids
    ids_pad = jnp.asarray(ids_pad)

    @jax.jit
    def q(p, gal_nt, valid, idtab, payload, scale, starts):
        codes = embed_spec_excerpts(p, cfg, payload, scale, starts,
                                    quantized)
        scores = jnp.dot(codes.astype(jnp.float32), gal_nt,
                         precision=HIGHEST,
                         preferred_element_type=jnp.float32)
        scores = jnp.where(valid[None, :] & ~jnp.isnan(scores), scores,
                           -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        pid = idtab[idx]
        return jnp.sum(pid[..., None] == jnp.arange(n_pieces), axis=(0, 1))

    params = jax.device_put(params)

    def query(payload, scale, starts):
        return q(params, gallery.gallery_nt, gallery.valid, ids_pad,
                 payload, jnp.float32(scale), starts)

    return query


def make_fused_sheet_query(params, cfg, gallery: "DeviceGallery",
                           n_pieces: int, *, n_candidates: int = 25,
                           pack4: bool = True, coding: str = None,
                           strip_shape=None, block_k=None):
    """Unrolled sheet strip -> per-performance vote counts, ONE dispatch.

    The sheet->audio mirror of make_fused_piece_query (reference
    detect_performance, audio_sheet_server.py:255-300): compressed strip
    upload, on-device decode + window slicing + view-1 embedding + audio
    gallery top-k + vote histogram in a single jitted program.

    ``coding``: 'rle_bitmap2' (LOSSLESS two-level, ~0.11 B/px —
    query(bm2, vals2, values, starts)), 'rle_bitmap' (LOSSLESS,
    ~0.17 B/px — query(bitmap, values, starts)) — both need static
    ``strip_shape`` — 'pack4' (lossy 4-bit, 0.5 B/px) or 'raw'; the
    legacy ``pack4`` bool maps to pack4/raw when ``coding`` is None.
    ``block_k``: optional (k1, k2) from ops.windows.rle2_block_plan —
    routes the rle_bitmap2 decode through the blocked select-accumulate
    path (no per-pixel random gather; bit-identical).
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops.windows import (
        gather_windows,
        rle_bitmap2_decode_device,
        rle_bitmap_decode_device,
        unpack_strip_4bit,
    )
    from audio_sheet_retrieval_tpu.train.engine import prepare_view1_device

    if coding is None:
        coding = "pack4" if pack4 else "raw"
    assert coding in ("rle_bitmap2", "rle_bitmap", "pack4", "raw"), coding
    if coding.startswith("rle_bitmap") and strip_shape is None:
        raise ValueError(f"coding={coding!r} needs strip_shape=(H, W)")

    h, window = cfg.input_shape_1[1], cfg.input_shape_1[2]
    k = min(n_candidates, gallery.n)
    ids_pad = np.full(gallery.gallery_n.shape[0], n_pieces, np.int32)
    ids_pad[:gallery.n] = gallery.ids
    ids_pad = jnp.asarray(ids_pad)

    @jax.jit
    def q(p, gal_nt, valid, idtab, strip, starts):
        if coding == "pack4":
            strip = unpack_strip_4bit(strip)
        return _q_body(p, gal_nt, valid, idtab, strip, starts)

    @jax.jit
    def q_rle(p, gal_nt, valid, idtab, bitmap, values, starts):
        strip = rle_bitmap_decode_device(bitmap, values, *strip_shape)
        return _q_body(p, gal_nt, valid, idtab, strip, starts)

    @jax.jit
    def q_rle2(p, gal_nt, valid, idtab, bm2, vals2, values, starts):
        strip = rle_bitmap2_decode_device(bm2, vals2, values, *strip_shape,
                                          block_k=block_k)
        return _q_body(p, gal_nt, valid, idtab, strip, starts)

    def _q_body(p, gal_nt, valid, idtab, strip, starts):
        r0 = strip.shape[0] // 2 - h // 2
        strip = jax.lax.dynamic_slice_in_dim(strip, r0, h, axis=0)
        wins = gather_windows(strip.astype(jnp.float32), starts, window)
        codes = cca_model.embed_view1(
            p, prepare_view1_device(wins[:, None, :, :], cfg), cfg)
        scores = jnp.dot(codes.astype(jnp.float32), gal_nt,
                         precision=HIGHEST,
                         preferred_element_type=jnp.float32)
        scores = jnp.where(valid[None, :] & ~jnp.isnan(scores), scores,
                           -jnp.inf)
        _, idx = jax.lax.top_k(scores, k)
        pid = idtab[idx]
        return jnp.sum(pid[..., None] == jnp.arange(n_pieces), axis=(0, 1))

    params = jax.device_put(params)

    if coding == "rle_bitmap2":
        def query(bm2, vals2, values, starts):
            """(bm2, vals2, values) from
            ops.windows.rle_bitmap2_encode_strip of the [H, W] strip."""
            return q_rle2(params, gallery.gallery_nt, gallery.valid,
                          ids_pad, bm2, vals2, values, starts)
        return query

    if coding == "rle_bitmap":
        def query(bitmap, values, starts):
            """bitmap: [ceil(H*W/8)] u8, values: [R] u8
            (ops.windows.rle_bitmap_encode_strip of the [H, W] strip)."""
            return q_rle(params, gallery.gallery_nt, gallery.valid,
                         ids_pad, bitmap, values, starts)
        return query

    def query(strip, starts):
        """strip: [H, W/2] packed uint8 (pack4) or [H, W] uint8;
        starts: snippet start columns (in UNPACKED pixels)."""
        return q(params, gallery.gallery_nt, gallery.valid, ids_pad,
                 strip, starts)

    return query
