"""Piece-identification server: snippet/excerpt galleries + voting.

Parity with reference:audio_sheet_server.py (AudioSheetServer):
  * ``initialize_sheet_db`` / ``initialize_audio_db`` build galleries from
    piece data via a retrieval pool (:309-401),
  * ``initialize_sheet_db_from_imges`` / ``initialize_audio_db_from_specs``
    sliding-window (stride context//4) variants for raw inputs (:403-494),
  * pickle save/load of databases (:496-522),
  * ``detect_score``: 100 equally spaced excerpts -> embed -> per-excerpt
    top-n_candidates neighbors -> piece-id vote count -> top-k (:213-253),
  * ``detect_performance``: the sheet-query mirror (:255-300),
  * ``run``: streaming frame loop with a sliding 42-frame window and an
    energy-based music gate (:83-211, GUI optional).

Galleries are device-resident (retrieval/gallery.py) so a full
100-excerpt query is ONE matmul+top-k; the 100 windows are sliced with a
batched gather instead of a python loop.
"""

from __future__ import annotations

import pickle
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from audio_sheet_retrieval_tpu.data.pools import (
    NO_AUGMENT,
    SHEET_CONTEXT,
    SPEC_BINS,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
    AudioScoreRetrievalPool,
)
from audio_sheet_retrieval_tpu.retrieval.gallery import DeviceGallery
from audio_sheet_retrieval_tpu.utils.logging import BColors

col = BColors()


def slice_windows(arr2d: np.ndarray, window: int, starts: np.ndarray,
                  row0: int = 0, rows: Optional[int] = None) -> np.ndarray:
    """Batched horizontal window gather: [rows, window] slices at ``starts``.

    Replaces the reference's per-window python loops
    (audio_sheet_server.py:216-223, 465-477)."""
    rows = rows if rows is not None else arr2d.shape[0]
    out = np.zeros((len(starts), 1, rows, window), dtype=np.float32)
    for i, s in enumerate(starts):
        out[i, 0] = arr2d[row0:row0 + rows, s:s + window]
    return out


def linspace_starts(total: int, window: int, n_samples: int = 100) -> np.ndarray:
    return np.linspace(start=0, stop=total - window, num=n_samples).astype(int)


def vote_ranking(all_ids: np.ndarray, top_k: int):
    """Piece-id vote count -> (unique ids, counts, top-k order)
    (audio_sheet_server.py:237-240 semantics, incl. argsort tie order)."""
    unique, counts = np.unique(all_ids, return_counts=True)
    sorted_count_idxs = np.argsort(counts)[::-1][:top_k]
    return unique, counts, sorted_count_idxs


class AudioSheetServer:
    """Audio -> sheet-music piece retrieval server."""

    def __init__(self, spec_shape=(SPEC_BINS, SPEC_CONTEXT),
                 sheet_shape=(SYSTEM_HEIGHT, SHEET_CONTEXT)):
        self.spec_shape = spec_shape
        self.sheet_shape = sheet_shape

        self.sheet_snippet_codes: Optional[np.ndarray] = None
        self.sheet_snippet_ids: Optional[np.ndarray] = None
        self.id_to_piece: Dict[int, str] = {}
        self.sheet_snippets: Optional[np.ndarray] = None

        self.perform_excerpt_codes: Optional[np.ndarray] = None
        self.perform_excerpt_ids: Optional[np.ndarray] = None
        self.id_to_perform: Dict[int, str] = {}
        self.perform_excerpts: Optional[np.ndarray] = None

        self.embed_network = None
        self._sheet_gallery: Optional[DeviceGallery] = None
        self._audio_gallery: Optional[DeviceGallery] = None

    # -- model ----------------------------------------------------------------

    def initialize_embedding_network(self, wrapper) -> None:
        self.embed_network = wrapper

    # -- database construction --------------------------------------------------

    def _refresh_sheet_gallery(self):
        self._sheet_gallery = DeviceGallery(self.sheet_snippet_codes,
                                            self.sheet_snippet_ids)

    def _refresh_audio_gallery(self):
        self._audio_gallery = DeviceGallery(self.perform_excerpt_codes,
                                            self.perform_excerpt_ids)

    def initialize_sheet_db(self, pieces: Sequence[str],
                            piece_loader: Callable[[str], tuple],
                            keep_snippets: bool = False) -> None:
        """Build the sheet-snippet gallery from aligned piece data.

        ``piece_loader(name) -> (image, specs, o2c_maps)`` abstracts the data
        source (msmd / npz / synthetic); the reference hardcoded
        prepare_piece_data over DATA_ROOT_MSMD (audio_sheet_server.py:324).
        """
        print("Initializing sheet music db ...")
        codes, ids, snippets = [], [], []
        self.id_to_piece = {}
        for piece_idx, piece in enumerate(pieces):
            print(" (%03d / %03d) %s" % (piece_idx + 1, len(pieces), piece))
            self.id_to_piece[piece_idx] = piece
            image, specs, o2c = piece_loader(piece)
            pool = AudioScoreRetrievalPool(
                [image], [specs], [o2c], data_augmentation=NO_AUGMENT,
                shuffle=False,
                sheet_context=self.sheet_shape[1],
                staff_height=self.sheet_shape[0],
                spec_context=self.spec_shape[1])
            if pool.shape[0] == 0:
                continue
            sheet_batch, _ = pool[0:pool.shape[0]]
            codes.append(self.embed_network.compute_view_1(sheet_batch))
            ids.append(np.full(pool.shape[0], piece_idx, np.int64))
            if keep_snippets:
                half = sheet_batch[:, 0, ::2, ::2].astype(np.uint8)
                snippets.append(half)
        self.sheet_snippet_codes = np.concatenate(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        self.sheet_snippets = (np.concatenate(snippets) if snippets else
                               np.zeros((0,) + tuple(
                                   s // 2 for s in self.sheet_shape),
                                   np.uint8))
        print("%s sheet snippet codes of %d pieces collected"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    def initialize_audio_db(self, pieces: Sequence[str],
                            piece_loader: Callable[[str], tuple],
                            keep_snippets: bool = False) -> None:
        """Audio-excerpt gallery from aligned piece data (:356-401)."""
        print("Initializing audio db ...")
        codes, ids = [], []
        self.id_to_perform = {}
        for piece_idx, piece in enumerate(pieces):
            print(" (%03d / %03d) %s" % (piece_idx + 1, len(pieces), piece))
            self.id_to_perform[piece_idx] = piece
            image, specs, o2c = piece_loader(piece)
            pool = AudioScoreRetrievalPool(
                [image], [specs], [o2c], data_augmentation=NO_AUGMENT,
                shuffle=False,
                sheet_context=self.sheet_shape[1],
                staff_height=self.sheet_shape[0],
                spec_context=self.spec_shape[1])
            if pool.shape[0] == 0:
                continue
            _, spec_batch = pool[0:pool.shape[0]]
            codes.append(self.embed_network.compute_view_2(spec_batch))
            ids.append(np.full(pool.shape[0], piece_idx, np.int64))
        self.perform_excerpt_codes = np.concatenate(codes)
        self.perform_excerpt_ids = np.concatenate(ids)
        print("%s audio excerpts of %d pieces collected"
              % (self.perform_excerpt_codes.shape[0], len(pieces)))
        self._refresh_audio_gallery()

    def initialize_sheet_db_from_imges(self, pieces: Sequence[str],
                                       scores: Sequence[np.ndarray],
                                       keep_snippets: bool = False) -> None:
        """Sliding-window gallery from raw unrolled score images (:447-494)."""
        print("Initializing sheet music db ...")
        codes, ids = [], []
        self.id_to_piece = {}
        h, w = self.sheet_shape
        for piece_idx, piece in enumerate(pieces):
            self.id_to_piece[piece_idx] = piece
            image = scores[piece_idx]
            starts = np.arange(0, image.shape[1] - w, w // 4)
            r0 = image.shape[0] // 2 - h // 2
            snippets = slice_windows(image.astype(np.float32), w, starts,
                                     row0=r0, rows=h)
            codes.append(self.embed_network.compute_view_1(snippets))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.sheet_snippet_codes = np.concatenate(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        print("%s sheet snippet codes of %d pieces collected"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    def initialize_sheet_db_from_imges_device(
            self, pieces: Sequence[str], scores: Sequence[np.ndarray],
            *, width_bucket: int = 4096, fullconv: bool = False) -> None:
        """Fast-path sheet DB build: each unrolled strip uploads ONCE
        (lossless bitmap-RLE), sliding windows + embedding run fused on
        device, and the codes stay device-resident — no per-window upload
        and no embedding download (the serving-bench ingest path, ~4-10x
        less wire + no dispatch-degrading round trip vs the host loop in
        initialize_sheet_db_from_imges; downloads happen only in
        save_sheet_db_file). Strip widths are padded to ``width_bucket``
        multiples so the fused program compiles once per bucket."""
        import jax.numpy as jnp

        from audio_sheet_retrieval_tpu.ops import windows as win

        print("Initializing sheet music db (device-resident) ...")
        wrapper = self.embed_network
        h, w = self.sheet_shape
        codes, ids = [], []
        self.id_to_piece = {}
        # device builds never keep raw snippets (host builds' default
        # keep_snippets=False); drop any stale set from a previous host
        # build so save_sheet_db_file can't pickle mismatched snippets
        self.sheet_snippets = None
        embedders = {}
        for piece_idx, piece in enumerate(pieces):
            self.id_to_piece[piece_idx] = piece
            image = np.asarray(scores[piece_idx], np.uint8)
            starts = np.arange(0, image.shape[1] - w, w // 4,
                               dtype=np.int32)
            bm2, vals2, values, (sh, wb) = win.rle_bitmap2_encode_padded(
                image, width_bucket)
            n_max = len(win.stride_starts(wb, w, w // 4))
            starts_pad = np.zeros(n_max, np.int32)
            starts_pad[:len(starts)] = starts
            # key = the factory's actual static inputs; jit re-specializes
            # per payload shape under one shared params device_put
            key = (sh, wb)
            if key not in embedders:
                # two-level lossless RLE upload (~0.11 B/px); fullconv:
                # strip-level first conv block (75%-overlap elimination;
                # NOT equivalent to the per-window embedding for trained
                # weights — see ops.windows._strip_embed_core_fullconv)
                embedders[key] = win.make_strip_embedder_rle_bitmap2(
                    wrapper.params, wrapper.cfg, (sh, wb), center_crop=h,
                    fullconv=fullconv)
            c = embedders[key](jnp.asarray(bm2), jnp.asarray(vals2),
                               jnp.asarray(values),
                               jnp.asarray(starts_pad))
            codes.append(c[:len(starts)])
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.sheet_snippet_codes = jnp.concatenate(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        print("%s sheet snippet codes of %d pieces collected (device)"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    def initialize_audio_db_from_specs_device(
            self, pieces: Sequence[str],
            spectrograms: Sequence[np.ndarray],
            *, frames_bucket: int = 1024) -> None:
        """Device-resident audio-DB mirror of
        initialize_sheet_db_from_imges_device: each full spectrogram
        uploads once, sliding windows + embedding run fused on device,
        codes stay device-resident."""
        import jax.numpy as jnp

        from audio_sheet_retrieval_tpu.ops import windows as win

        print("Initializing audio db (device-resident) ...")
        wrapper = self.embed_network
        bins, ctx = self.spec_shape
        codes, ids = [], []
        self.id_to_perform = {}
        self.perform_excerpts = None  # see initialize_sheet_db_from_imges_device
        embedders = {}
        for piece_idx, piece in enumerate(pieces):
            self.id_to_perform[piece_idx] = piece
            spec = np.asarray(spectrograms[piece_idx], np.float32)
            starts = np.arange(0, spec.shape[1] - ctx, ctx // 4,
                               dtype=np.int32)
            tb = max(1, int(np.ceil(spec.shape[1] / frames_bucket))
                     ) * frames_bucket
            spec_pad = np.zeros((bins, tb), np.float32)
            spec_pad[:, :spec.shape[1]] = spec
            # u16-quantized upload: half the f32 wire, rank-agreement-
            # lossless on the reference checkpoint (PARITY.md 15)
            payload, scale = win.spec_quantize(spec_pad, bits=16)
            n_max = len(win.stride_starts(tb, ctx, ctx // 4))
            starts_pad = np.zeros(n_max, np.int32)
            starts_pad[:len(starts)] = starts
            if not embedders:  # one embedder; jit specializes per shape
                embedders[0] = win.make_spec_embedder_q(wrapper.params,
                                                        wrapper.cfg)
            c = embedders[0](jnp.asarray(payload), scale,
                             jnp.asarray(starts_pad))
            codes.append(c[:len(starts)])
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.perform_excerpt_codes = jnp.concatenate(codes)
        self.perform_excerpt_ids = np.concatenate(ids)
        print("%s audio excerpts of %d pieces collected (device)"
              % (self.perform_excerpt_codes.shape[0], len(pieces)))
        self._refresh_audio_gallery()

    def initialize_audio_db_from_specs(self, pieces: Sequence[str],
                                       spectrograms: Sequence[np.ndarray],
                                       keep_snippets: bool = False) -> None:
        """Sliding-window gallery from full spectrograms (:403-445)."""
        print("Initializing audio db ...")
        codes, ids = [], []
        self.id_to_perform = {}
        bins, ctx = self.spec_shape
        for piece_idx, piece in enumerate(pieces):
            self.id_to_perform[piece_idx] = piece
            spec = spectrograms[piece_idx]
            starts = np.arange(0, spec.shape[1] - ctx, ctx // 4)
            excerpts = slice_windows(spec.astype(np.float32), ctx, starts)
            codes.append(self.embed_network.compute_view_2(excerpts))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.perform_excerpt_codes = np.concatenate(codes)
        self.perform_excerpt_ids = np.concatenate(ids)
        print("%s audio excerpts of %d pieces collected"
              % (self.perform_excerpt_codes.shape[0], len(pieces)))
        self._refresh_audio_gallery()

    # -- database persistence ----------------------------------------------------

    def save_sheet_db_file(self, path: str) -> None:
        print("Dumping sheet db codes ...")
        with open(path, "wb") as fp:
            pickle.dump([np.asarray(self.sheet_snippet_codes),
                         self.sheet_snippet_ids,
                         self.id_to_piece, self.sheet_snippets], fp)

    def load_sheet_db_file(self, path: str) -> None:
        print("Loading sheet db codes ...")
        with open(path, "rb") as fp:
            (self.sheet_snippet_codes, self.sheet_snippet_ids,
             self.id_to_piece, self.sheet_snippets) = pickle.load(fp)
        self._refresh_sheet_gallery()

    def save_audio_db_file(self, path: str) -> None:
        print("Dumping audio db codes ...")
        with open(path, "wb") as fp:
            pickle.dump([np.asarray(self.perform_excerpt_codes),
                         self.perform_excerpt_ids,
                         self.id_to_perform, self.perform_excerpts], fp)

    def load_audio_db_file(self, path: str) -> None:
        print("Loading audio db codes ...")
        with open(path, "rb") as fp:
            (self.perform_excerpt_codes, self.perform_excerpt_ids,
             self.id_to_perform, self.perform_excerpts) = pickle.load(fp)
        self._refresh_audio_gallery()

    # -- retrieval ----------------------------------------------------------------

    def _retrieve_sheet_snippet_ids(self, spec_codes: np.ndarray,
                                    n_candidates: int = 1):
        ids, idx = self._sheet_gallery.topk_ids(spec_codes, n_candidates)
        return ids.ravel(), idx.ravel()

    def _retrieve_perform_excerpt_ids(self, sheet_codes: np.ndarray,
                                      n_candidates: int = 1):
        ids, idx = self._audio_gallery.topk_ids(sheet_codes, n_candidates)
        return ids.ravel(), idx.ravel()

    def detect_score(self, spectrogram: np.ndarray, top_k: int = 1,
                     n_candidates: int = 1, verbose: bool = False,
                     n_samples: int = 100):
        """Identify the piece for a full-performance spectrogram (:213-253)."""
        starts = linspace_starts(spectrogram.shape[1], self.spec_shape[1],
                                 n_samples)
        excerpts = slice_windows(spectrogram, self.spec_shape[1], starts,
                                 rows=self.spec_shape[0])
        spec_codes = self.embed_network.compute_view_2(excerpts)
        all_piece_ids, _ = self._retrieve_sheet_snippet_ids(
            spec_codes, n_candidates=n_candidates)

        unique, counts, order = vote_ranking(all_piece_ids, top_k)
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for idx in order:
                print("pid: %03d (%03d): %s" % (
                    unique[idx], counts[idx], self.id_to_piece[unique[idx]]))
        ret_result = [self.id_to_piece[unique[i]] for i in order]
        ret_votes = np.asarray([counts[i] for i in order], float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes

    def detect_score_from_audio(self, signal: np.ndarray, top_k: int = 1,
                                n_candidates: int = 1, verbose: bool = False,
                                n_samples: int = 100,
                                sample_rate: Optional[int] = None):
        """detect_score from a raw int16 waveform in ONE device dispatch.

        Equivalent to ``proc.process(signal)`` + :meth:`detect_score`, but
        the spectrogram, excerpt embedding, gallery top-k and vote histogram
        all run inside one jitted program (gallery.make_fused_piece_query);
        the upload is mu-law companded (1 byte/sample, PARITY.md item 12)
        and the download is one [n_pieces] count vector. Tie order matches
        vote_ranking's reversed-argsort over np.unique ids exactly.
        """
        import jax.numpy as jnp

        from audio_sheet_retrieval_tpu.ops.audio import (
            default_processor,
            num_frames_for,
        )
        from audio_sheet_retrieval_tpu.ops.windows import mulaw_encode
        from audio_sheet_retrieval_tpu.retrieval.gallery import (
            make_fused_piece_query,
        )

        n_pieces = max(self.id_to_piece) + 1
        key = (id(self._sheet_gallery), n_candidates, n_pieces)
        if getattr(self, "_fused_query_key", None) != key:
            proc = default_processor()
            self._fused_query = make_fused_piece_query(
                self.embed_network.params, self.embed_network.cfg, proc,
                self._sheet_gallery, n_pieces, n_candidates=n_candidates,
                mulaw=True)
            self._fused_query_proc = proc
            self._fused_query_key = key
        proc = self._fused_query_proc
        signal = np.asarray(signal)
        if signal.ndim == 2:
            signal = signal.mean(axis=1).astype(np.int16)
        if sample_rate is not None and sample_rate != proc.sample_rate:
            from audio_sheet_retrieval_tpu.ops.audio import resample

            signal = np.asarray(
                resample(signal, sample_rate, proc.sample_rate), np.int16)
        nf = num_frames_for(len(signal), proc.hop_size)
        starts = jnp.asarray(linspace_starts(nf, self.spec_shape[1],
                                             n_samples))
        counts = np.asarray(self._fused_query(
            jnp.asarray(mulaw_encode(signal)), starts, nf))
        hit = np.flatnonzero(counts > 0)  # np.unique domain (voted pieces)
        order = hit[np.argsort(counts[hit])[::-1]][:top_k]
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for pid in order:
                print("pid: %03d (%03d): %s" % (pid, counts[pid],
                                                self.id_to_piece[pid]))
        ret_result = [self.id_to_piece[int(pid)] for pid in order]
        ret_votes = counts[order].astype(float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes

    def detect_score_from_spec(self, spectrogram: np.ndarray,
                               top_k: int = 1, n_candidates: int = 1,
                               verbose: bool = False, n_samples: int = 100,
                               quantize: Optional[int] = 16):
        """detect_score with a spectrogram UPLOAD in one device dispatch.

        The minimum-wire serving mode, and the reference's own serving
        architecture (host madmom DSP, precomputed ``*_spec.npy`` uploads —
        audio_sheet_server.py:632-636): the client computes the
        log-filterbank spectrogram host-side (ops.audio.AudioProcessor.
        process_host) and ships 3.7 kB/s (``quantize=16``, the default —
        rank-agreement-lossless per PARITY.md 15), 1.8 kB/s (8, ~99% top-1,
        explicit minimum-wire opt-in) or 7.4 kB/s (None, f32) instead of
        22 kB/s mu-law audio. Embedding,
        gallery top-k and the vote histogram run fused on device; ranking
        semantics match :meth:`detect_score_from_audio`. A/B vs the f32
        path: PARITY.md item 15.
        """
        import jax.numpy as jnp

        from audio_sheet_retrieval_tpu.ops.windows import spec_quantize
        from audio_sheet_retrieval_tpu.retrieval.gallery import (
            make_fused_piece_query_spec,
        )

        assert quantize in (None, 8, 16), quantize
        n_pieces = max(self.id_to_piece) + 1
        key = (id(self._sheet_gallery), n_candidates, n_pieces,
               quantize is not None)
        if getattr(self, "_fused_spec_query_key", None) != key:
            self._fused_spec_query = make_fused_piece_query_spec(
                self.embed_network.params, self.embed_network.cfg,
                self._sheet_gallery, n_pieces, n_candidates=n_candidates,
                quantized=quantize is not None)
            self._fused_spec_query_key = key
        spec = np.asarray(spectrogram, np.float32)
        if quantize is not None:
            payload, scale = spec_quantize(spec, bits=quantize)
        else:
            payload, scale = spec, np.float32(1.0)
        starts = jnp.asarray(linspace_starts(spec.shape[1],
                                             self.spec_shape[1], n_samples))
        counts = np.asarray(self._fused_spec_query(
            jnp.asarray(payload), scale, starts))
        hit = np.flatnonzero(counts > 0)
        order = hit[np.argsort(counts[hit])[::-1]][:top_k]
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for pid in order:
                print("pid: %03d (%03d): %s" % (pid, counts[pid],
                                                self.id_to_piece[pid]))
        ret_result = [self.id_to_piece[int(pid)] for pid in order]
        ret_votes = counts[order].astype(float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes

    def detect_performance(self, sheet: np.ndarray, top_k: int = 1,
                           n_candidates: int = 1, verbose: bool = False,
                           n_samples: int = 100):
        """Identify the performance for an unrolled sheet strip (:255-300)."""
        h, w = self.sheet_shape
        starts = linspace_starts(sheet.shape[1], w, n_samples)
        r0 = sheet.shape[0] // 2 - h // 2
        snippets = slice_windows(sheet.astype(np.float32), w, starts,
                                 row0=r0, rows=h)
        sheet_codes = self.embed_network.compute_view_1(snippets)
        all_ids, _ = self._retrieve_perform_excerpt_ids(
            sheet_codes, n_candidates=n_candidates)

        unique, counts, order = vote_ranking(all_ids, top_k)
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for idx in order:
                print("pid: %03d (%03d): %s" % (
                    unique[idx], counts[idx], self.id_to_perform[unique[idx]]))
        ret_result = [self.id_to_perform[unique[i]] for i in order]
        ret_votes = np.asarray([counts[i] for i in order], float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes

    def detect_performance_from_sheet(self, sheet: np.ndarray,
                                      top_k: int = 1, n_candidates: int = 1,
                                      verbose: bool = False,
                                      n_samples: int = 100):
        """detect_performance in ONE device dispatch: the strip uploads
        losslessly two-level bitmap-RLE coded (~0.11 B/px, bit-identical
        pixels), and decode + windowing + view-1 embedding + audio-gallery
        top-k + vote histogram run as a single jitted program
        (gallery.make_fused_sheet_query); the download is one
        [n_performances] count vector. Strip widths pad to 4096-multiples
        (white) so the program compiles once per width bucket."""
        import jax.numpy as jnp

        from audio_sheet_retrieval_tpu.ops.windows import (
            rle2_block_plan,
            rle_bitmap2_encode_padded,
        )
        from audio_sheet_retrieval_tpu.retrieval.gallery import (
            make_fused_sheet_query,
        )

        strip = np.asarray(sheet, np.uint8)
        bm2, vals2, values, (sh, wb) = rle_bitmap2_encode_padded(strip)
        # blocked select-accumulate decode (bit-identical; avoids the
        # per-pixel random gather). The bucketed plan is
        # part of the program-cache key — few buckets, bounded cache.
        block_k = rle2_block_plan(bm2, vals2, values, sh * wb)

        n_perf = max(self.id_to_perform) + 1
        key = (id(self._audio_gallery), n_candidates, n_perf, sh, wb,
               block_k)
        cache = getattr(self, "_fused_sheet_queries", None)
        if cache is None:
            cache = self._fused_sheet_queries = {}
        if key not in cache:
            if len(cache) >= 8:  # bound the per-geometry program cache
                cache.pop(next(iter(cache)))
            cache[key] = make_fused_sheet_query(
                self.embed_network.params, self.embed_network.cfg,
                self._audio_gallery, n_perf, n_candidates=n_candidates,
                coding="rle_bitmap2", strip_shape=(sh, wb),
                block_k=block_k)
        starts = jnp.asarray(linspace_starts(strip.shape[1],
                                             self.sheet_shape[1], n_samples))
        counts = np.asarray(cache[key](jnp.asarray(bm2), jnp.asarray(vals2),
                                       jnp.asarray(values), starts))
        hit = np.flatnonzero(counts > 0)  # np.unique domain (voted pieces)
        order = hit[np.argsort(counts[hit])[::-1]][:top_k]
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for pid in order:
                print("pid: %03d (%03d): %s" % (pid, counts[pid],
                                                self.id_to_perform[pid]))
        ret_result = [self.id_to_perform[int(pid)] for pid in order]
        ret_votes = counts[order].astype(float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes

    # -- streaming ------------------------------------------------------------------

    @staticmethod
    def _detect_music(running_spec: np.ndarray, spec: np.ndarray) -> float:
        """Energy-based music gate (:524-528)."""
        music_prob = running_spec.sum(axis=0).mean()
        music_prob /= (spec.sum(axis=0).max() * 0.15)
        return float(np.clip(music_prob, 0.0, 1.0))

    def run_device_stream(self, spec: np.ndarray, params=None, cfg=None,
                          top_k: int = 5, n_candidates: int = 5,
                          running_frames: Optional[int] = None,
                          max_frames: Optional[int] = None,
                          on_update: Optional[Callable] = None,
                          chunk: int = 8):
        """Fast streaming mode: sliding window + embed + gallery top-k run
        on device (retrieval/streaming.py), ``chunk`` frames per dispatch
        with a per-frame remainder pass; the host keeps only the vote
        histogram. Voting semantics of run(). ``params``/``cfg`` default to
        the attached embedding network's. The retriever (jit programs +
        uploaded gallery) is cached across calls.
        """
        from audio_sheet_retrieval_tpu.retrieval.streaming import (
            StreamingRetriever,
        )

        if params is None:
            params = self.embed_network.params
        if cfg is None:
            cfg = self.embed_network.cfg
        spec_max = float(spec.sum(axis=0).max())
        cache_key = (id(params), cfg.name, cfg.dim_latent, n_candidates,
                     id(self.sheet_snippet_codes))
        cached = getattr(self, "_stream_cache", None)
        if cached is not None and cached[0] == cache_key:
            sr = cached[1]
            sr.reset(spec_max=spec_max)
        else:
            sr = StreamingRetriever(params, cfg, self.sheet_snippet_codes,
                                    self.sheet_snippet_ids,
                                    n_candidates=n_candidates,
                                    spec_max=spec_max)
            self._stream_cache = (cache_key, sr)

        all_piece_ids = np.zeros(0, np.int64)
        frame_times: list = []
        ranking, votes = [], np.zeros(0)
        n_frames = spec.shape[1] if max_frames is None else min(
            spec.shape[1], max_frames)
        fps = 0.0

        def ingest(cand_rows):
            nonlocal all_piece_ids, ranking, votes
            for ids in cand_rows:
                if ids is None:
                    continue
                all_piece_ids = np.concatenate((all_piece_ids, ids))
                if running_frames is not None:
                    first_idx = running_frames * n_candidates
                    if all_piece_ids.shape[0] > first_idx:
                        all_piece_ids = all_piece_ids[-first_idx:]
            if len(all_piece_ids):
                unique, counts, order = vote_ranking(all_piece_ids, top_k)
                ranking = [self.id_to_piece[unique[i]] for i in order]
                votes = counts[order].astype(float) / counts.sum()

        n_full = (n_frames // chunk) * chunk
        for c0 in range(0, n_full, chunk):
            start = time.time()
            _, cand_rows = sr.push_frames(spec[:, c0:c0 + chunk].T)
            ingest(cand_rows)
            frame_times.append((time.time() - start) / chunk)
            fps = 1.0 / max(np.mean(frame_times[-10:]), 1e-9)
            if on_update is not None:
                on_update(c0 + chunk - 1, ranking, votes, fps)
        for i_frame in range(n_full, n_frames):  # tail remainder
            start = time.time()
            _, ids = sr.push_frame(spec[:, i_frame])
            ingest([ids])
            frame_times.append(time.time() - start)
            fps = 1.0 / max(np.mean(frame_times[-10:]), 1e-9)
            if on_update is not None:
                on_update(i_frame, ranking, votes, fps)
        return ranking, votes, fps

    def run(self, spec: Optional[np.ndarray] = None, top_k: int = 5,
            n_candidates: int = 5, running_frames: Optional[int] = None,
            gui: bool = False, target_piece: Optional[str] = None,
            max_frames: Optional[int] = None,
            on_update: Optional[Callable] = None,
            fig_dir: str = "figs",
            frame_source=None):
        """Streaming retrieval loop over spectrogram frames (:83-211).

        Reports via ``on_update(frame_idx, ranking, votes, fps)``; with
        ``gui=True`` renders the dashboard (running spectrogram, music
        probability, vote histogram) headlessly to ``fig_dir/%05d.png``
        (the reference drew a live matplotlib window + savefig, :140-200).

        Input is either ``spec`` (precomputed [bins, T] spectrogram) or
        ``frame_source`` — an iterable (or zero-arg callable returning one)
        yielding [bins] spectrogram frames. The latter is the injection
        point for live capture: the reference reads a microphone via a
        madmom ``Stream`` (reference audio_sheet_server.py:44-50,95); a mic
        backend on a soundcard host plugs in as
        ``run(frame_source=mic_frames())`` without touching the server.
        With a live source the music gate normalizes by a running maximum
        instead of the full-signal maximum.
        """
        print("Running server ...")
        if spec is None and frame_source is None:
            raise NotImplementedError(
                "microphone capture needs an audio input device: pass "
                "frame_source=<iterable of spectrogram frames> from your "
                "capture backend, or a precomputed spec")
        if gui:
            import matplotlib

            matplotlib.use("Agg")
            import os

            os.makedirs(fig_dir, exist_ok=True)
        if frame_source is None:
            frames = iter(spec.T)
        else:
            frames = iter(frame_source() if callable(frame_source)
                          else frame_source)
        running_spec = np.zeros(self.spec_shape, np.float32)
        all_piece_ids = np.zeros(0, np.int64)
        frame_times = np.zeros(10)
        ranking, votes = [], np.zeros(0)
        norm_max = 1e-9  # running normalizer for live sources
        for i_frame, frame in enumerate(frames):
            if max_frames is not None and i_frame >= max_frames:
                break
            start = time.time()
            frame = np.asarray(frame, np.float32).reshape(-1, 1)
            running_spec = np.hstack((running_spec[:, 1:], frame))
            if spec is not None:
                m_prob = self._detect_music(running_spec, spec)
            else:
                norm_max = max(norm_max, float(frame.sum()))
                m_prob = float(np.clip(
                    running_spec.sum(axis=0).mean() / (norm_max * 0.15),
                    0.0, 1.0))
            if m_prob > 0.5 and i_frame >= running_spec.shape[1]:
                spec_code = self.embed_network.compute_view_2(
                    running_spec[None, None])
                piece_ids, _ = self._retrieve_sheet_snippet_ids(
                    spec_code, n_candidates=n_candidates)
                all_piece_ids = np.concatenate((all_piece_ids, piece_ids))
                if running_frames is not None:
                    first_idx = running_frames * n_candidates
                    if all_piece_ids.shape[0] > first_idx:
                        all_piece_ids = all_piece_ids[-first_idx:]
                unique, counts, order = vote_ranking(all_piece_ids, top_k)
                ranking = [self.id_to_piece[unique[i]] for i in order]
                votes = counts[order].astype(float) / counts.sum()

            if gui:
                self._draw_dashboard(fig_dir, i_frame, running_spec, m_prob,
                                     ranking, votes, target_piece)

            frame_times[1:] = frame_times[:-1]
            frame_times[0] = time.time() - start
            fps = 1.0 / max(frame_times.mean(), 1e-9)
            if on_update is not None:
                on_update(i_frame, ranking, votes, fps)
            else:
                print("Server is running at %.2f fps." % fps, end="\r")
                sys.stdout.flush()
        print("")
        return ranking, votes

    def _draw_dashboard(self, fig_dir, i_frame, running_spec, m_prob,
                        ranking, votes, target_piece):
        """Headless version of the reference GUI (:140-200)."""
        import matplotlib.gridspec as gridspec
        import matplotlib.pyplot as plt

        fig = plt.figure("SheetMusicRetrievalServer", figsize=(10, 7))
        fig.clf()
        gs = gridspec.GridSpec(2, 2, height_ratios=[1, 2])
        plt.subplots_adjust(left=0.1, right=0.95, bottom=0.1, top=0.92,
                            hspace=0.5)
        plt.subplot(gs[0])
        plt.title("Incoming Audio %d" % i_frame)
        plt.imshow(running_spec, cmap="viridis", origin="lower",
                   aspect="auto")
        plt.axis("off")
        plt.subplot(gs[1])
        plt.title("Music Probability")
        plt.bar([0.15], [m_prob], width=0.2)
        plt.plot([0.0, 0.5], [0.5, 0.5], "-", linewidth=3, alpha=0.5)
        plt.xlim([-0.1, 0.52])
        plt.ylim([0, 1.05])
        plt.axis("off")
        plt.subplot(gs[2:])
        plt.title("Piece Retrieval Ranking")
        plt.ylabel("Piece Probability")
        if len(ranking):
            x = np.arange(len(ranking))
            colors = ["tab:green" if r == target_piece else "tab:blue"
                      for r in ranking]
            plt.bar(x, votes[: len(ranking)], width=0.5, color=colors)
            plt.xticks(x, ranking, rotation=15, fontsize=7)
        plt.ylim([0, 1.0])
        fig.savefig("%s/%05d.png" % (fig_dir, i_frame))
        plt.close(fig)
