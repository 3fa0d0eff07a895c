"""Fused streaming retrieval: one device dispatch per audio frame.

The reference's streaming loop (reference:audio_sheet_server.py:83-211)
rebuilds the sliding 42-frame window on the host, embeds it, and runs a
host cdist per frame. Here the running spectrogram window is device-resident
state: each frame's dispatch rolls the window, applies the energy-based
music gate, embeds the excerpt (deterministic CCA path) and returns the
top-n_candidates gallery piece ids — the host only appends votes and draws.

One dispatch + one tiny download per frame (or per chunk of frames) keeps
the loop above the 20 fps of the spectrogram stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.models import cca_model
from audio_sheet_retrieval_tpu.models.configs import ModelConfig
from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

HIGHEST = jax.lax.Precision.HIGHEST


class StreamingRetriever:
    """Device-resident sliding-window retrieval over a snippet gallery."""

    def __init__(self, params, cfg: ModelConfig, gallery_codes: np.ndarray,
                 gallery_piece_ids: np.ndarray, n_candidates: int = 25,
                 spec_max: Optional[float] = None):
        self.cfg = cfg
        self.n_candidates = int(n_candidates)
        bins, ctx = cfg.input_shape_2[1], cfg.input_shape_2[2]
        self.window_len = ctx

        g = np.asarray(gallery_codes, np.float32)
        if not np.isfinite(g).all():
            # a non-finite gallery is broken upstream — reject it rather
            # than let NaN rows silently drop out of every top-k
            raise ValueError("gallery_codes contain non-finite values")
        g = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
        self._gal = jax.device_put(g)
        self._ids = jax.device_put(
            np.asarray(gallery_piece_ids, np.int32))
        self._params = jax.device_put(params)
        self._running = jnp.zeros((bins, ctx), jnp.float32)
        self._frames_seen = 0
        # energy normalizer: max column energy of the piece (reference
        # _detect_music, audio_sheet_server.py:524-528)
        self._norm = float(spec_max) if spec_max is not None else 1.0

        n_cand = self.n_candidates

        def one_frame(p, gal, ids, running, frame, norm):
            running = jnp.concatenate([running[:, 1:], frame[:, None]],
                                      axis=1)
            m_prob = jnp.clip(running.sum(axis=0).mean() / (norm * 0.15),
                              0.0, 1.0)
            x = prepare_view2_device(running[None, None])
            code = cca_model.embed_view2(p, x, cfg)          # [1, d]
            scores = jnp.dot(code, gal.T, precision=HIGHEST,
                             preferred_element_type=jnp.float32)[0]
            # NaN codes (untrained zero projections) must degrade
            # deterministically, like DeviceGallery's masked path
            scores = jnp.where(jnp.isnan(scores), -jnp.inf, scores)
            _, idx = jax.lax.top_k(scores, n_cand)
            return running, m_prob, ids[idx]

        self._step = jax.jit(one_frame)

        @jax.jit
        def step_chunk(p, gal, ids, running, frames, norm):
            """frames [T, bins]: scan T frames in ONE dispatch."""
            def body(run, frame):
                run, m_prob, cand = one_frame(p, gal, ids, run, frame, norm)
                return run, (m_prob, cand)

            running, (probs, cands) = jax.lax.scan(body, running, frames)
            return running, probs, cands

        self._step_chunk = step_chunk

        @jax.jit
        def step_chunk_q(p, gal, ids, running, codes_u16, scale, norm):
            """u16-quantized chunk ingest: frames ride the wire as codes
            (ops.windows.spec_quantize — 2 B/bin/frame, the serving-gated
            spec-u16 coding) and dequantize inside the SAME dispatch."""
            from audio_sheet_retrieval_tpu.ops.windows import (
                spec_dequantize_device,
            )

            frames = spec_dequantize_device(codes_u16, scale)  # elementwise
            return step_chunk(p, gal, ids, running, frames, norm)

        self._step_chunk_q = step_chunk_q

    def reset(self, spec_max: Optional[float] = None):
        self._running = jnp.zeros_like(self._running)
        self._frames_seen = 0
        if spec_max is not None:
            self._norm = float(spec_max)

    def push_frame(self, frame: np.ndarray
                   ) -> Tuple[float, Optional[np.ndarray]]:
        """Feed one spectrogram column -> (music probability, candidate
        piece ids or None while the window is warming up / music gate off).
        """
        self._running, m_prob, ids = self._step(
            self._params, self._gal, self._ids, self._running,
            jnp.asarray(frame, jnp.float32).ravel(),
            jnp.float32(self._norm))
        self._frames_seen += 1
        m_prob = float(m_prob)
        # host-loop parity: run() first embeds at i_frame == window_len,
        # i.e. on the (window_len+1)-th frame (audio_sheet_server.py:117)
        if m_prob > 0.5 and self._frames_seen > self.window_len:
            return m_prob, np.asarray(ids)
        return m_prob, None

    def push_frames(self, frames: np.ndarray):
        """Chunked streaming: process [T, bins] frames in ONE dispatch.

        Returns (m_probs [T], candidate ids [T, n_candidates] or None rows);
        per-frame gating applied like push_frame. Chunking amortizes the
        per-dispatch latency (one round trip per CHUNK instead of per
        frame) — use chunk sizes of ~8 for live display updates.
        """
        frames = np.asarray(frames, np.float32)
        self._running, probs, cands = self._step_chunk(
            self._params, self._gal, self._ids, self._running,
            jnp.asarray(frames), jnp.float32(self._norm))
        return self._gate_chunk(probs, cands, len(frames))

    def push_frames_quantized(self, codes: np.ndarray, scale):
        """Chunked streaming with the u16/u8 spec wire coding: ``codes``
        [T, bins] integer codes + the payload scale from
        ops.windows.spec_quantize (2 B/bin/frame at u16 instead of 4 —
        the serving-gated minimum-wire frame ingest); dequantize runs
        inside the same single dispatch."""
        self._running, probs, cands = self._step_chunk_q(
            self._params, self._gal, self._ids, self._running,
            jnp.asarray(codes), jnp.float32(scale),
            jnp.float32(self._norm))
        return self._gate_chunk(probs, cands, len(codes))

    def _gate_chunk(self, probs, cands, n: int):
        probs = np.asarray(probs)
        cands = np.asarray(cands)
        out = []
        for t in range(n):
            self._frames_seen += 1
            if probs[t] > 0.5 and self._frames_seen > self.window_len:
                out.append(cands[t])
            else:
                out.append(None)
        return probs, out
