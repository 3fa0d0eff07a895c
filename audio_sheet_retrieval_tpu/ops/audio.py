"""On-device audio front-end: framing + STFT + log filterbank, fused in XLA.

Replaces the reference's madmom CPU processor chain
(reference:tutorials/Embedding Tutorial.ipynb: SignalProcessor 22050 Hz mono
-> FramedSignalProcessor frame 2048 / 20 fps / origin='future'
-> FilteredSpectrogramProcessor(LogarithmicFilterbank, 16 bands, 30-6000 Hz)
-> LogarithmicSpectrogramProcessor) with a single jitted computation:

  frames  : gather at start = int(k * hop), hop = sr/fps = 1102.5 (float hop,
            truncated per-frame exactly like madmom signal_frame with
            origin='future'); signal zero-padded right (end='normal',
            num_frames = ceil(n / hop))
  window  : np.hanning(2048); int16 signals scale the window by 1/32767
            (madmom normalizes int ranges into the window)
  STFT    : rfft, keep bins [0, 1024) (DC included, Nyquist dropped)
  filter  : |STFT| @ [1024, 92] triangular log filterbank (one matmul)
  log     : log10(1 + x)

Output is [92, num_frames] float32 — the reference's
``processor.process(audio).T`` orientation (audio_sheet_server.py:632).

Because XLA requires static shapes, the jitted core is specialized on
``num_frames``; `AudioProcessor.process` buckets frame counts to limit
recompilation when streaming many different lengths.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.ops import filterbank as fb

INT16_MAX = 32767.0


def num_frames_for(num_samples: int, hop_size: float) -> int:
    """madmom FramedSignal end='normal': ceil(n / hop)."""
    return int(np.ceil(num_samples / float(hop_size)))


@functools.partial(jax.jit, static_argnames=("num_frames", "frame_size"))
def _spectrogram_core(signal_f32, window, filt, starts, num_frames: int,
                      frame_size: int):
    # gather frames: [num_frames, frame_size]
    idx = starts[:, None] + jnp.arange(frame_size)[None, :]
    frames = signal_f32[idx] * window[None, :]
    spec = jnp.abs(jnp.fft.rfft(frames, axis=1))[:, : frame_size // 2]
    filtered = jnp.dot(spec, filt, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.log10(1.0 + filtered)


class AudioProcessor:
    """Signal -> log-filterbank spectrogram, on device.

    Mirrors the reference processor's constants by default; the filterbank is
    precomputed host-side once and lives on device.
    """

    def __init__(
        self,
        sample_rate: int = fb.SAMPLE_RATE,
        frame_size: int = fb.FRAME_SIZE,
        fps: int = fb.FPS,
        num_bands: int = fb.NUM_BANDS,
        fmin: float = fb.FMIN,
        fmax: float = fb.FMAX,
        frame_bucket: int = 128,
    ):
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.fps = fps
        self.hop_size = sample_rate / float(fps)
        self.frame_bucket = frame_bucket
        fb_host = np.asarray(
            fb.logarithmic_filterbank(sample_rate, frame_size, num_bands,
                                      fmin, fmax), np.float32)
        # host copy for process_host: np.asarray(jnp array) would download
        # from the device EVERY call
        self._filterbank_host = fb_host
        self.filterbank = jnp.asarray(fb_host, jnp.float32)
        self.num_bins = int(self.filterbank.shape[1])
        win_host = np.hanning(frame_size).astype(np.float32)
        self._window_host = win_host
        self._window = jnp.asarray(win_host, jnp.float32)
        # smallest m with m*hop integral -> phase-strided host frame gather
        self._gather_phases = next(
            (m for m in range(1, 9)
             if float(self.hop_size * m).is_integer()), None)

    def process(self, signal: np.ndarray,
                sample_rate: Optional[int] = None) -> np.ndarray:
        """Compute the [num_bins, num_frames] spectrogram of a 1-D signal.

        ``signal`` may be int16 (native audio range, madmom-scaled) or float
        (assumed already in [-1, 1]). Multi-channel input is downmixed by
        averaging (madmom remix semantics).
        """
        signal = np.asarray(signal)
        if signal.ndim == 2:
            signal = signal.mean(axis=1).astype(signal.dtype)
        if sample_rate is not None and sample_rate != self.sample_rate:
            signal = resample(signal, sample_rate, self.sample_rate)

        if np.issubdtype(signal.dtype, np.integer):
            scale = float(np.iinfo(signal.dtype).max)
        else:
            scale = 1.0
        window = self._window / scale

        n = len(signal)
        nf = num_frames_for(n, self.hop_size)
        # bucket the frame count to bound jit specializations
        nf_pad = int(np.ceil(nf / self.frame_bucket) * self.frame_bucket)
        starts = (np.arange(nf_pad) * self.hop_size).astype(np.int64)
        pad_to = int(starts[-1]) + self.frame_size
        sig = np.zeros(pad_to, np.float32)
        sig[:n] = signal.astype(np.float32)

        out = _spectrogram_core(
            jnp.asarray(sig), window, self.filterbank,
            jnp.asarray(starts, jnp.int32), nf_pad, self.frame_size,
        )
        return np.asarray(out[:nf]).T  # [bins, frames]

    def process_host(self, signal: np.ndarray,
                     sample_rate: Optional[int] = None) -> np.ndarray:
        """Pure-numpy mirror of :meth:`process` — no device round trip.

        This is the serving client's DSP for the spectrogram-upload ingest
        mode: the reference's own architecture runs madmom on the host and
        uploads precomputed ``*_spec.npy`` spectrograms
        (reference:audio_sheet_server.py:632-636). Same framing / window /
        rfft / filterbank / log arithmetic as the jitted core (measured
        max abs diff ~2e-6 on 60 s of audio; tested at 2e-4 float32
        tolerance — the embedding A/B lives in tests/test_windows.py).

        The frame gather is phase-strided: with hop = sr/fps fractional
        but m*hop integral (m=2 at the reference's 22050/20), frame k's
        madmom-truncated start int(k*hop) decomposes exactly as
        (k//m)*(m*hop) + int((k%m)*hop), so the [nf, frame_size] gather is
        m zero-copy strided views + one windowed multiply instead of a
        materialized index matrix (host numpy: 15 -> 2.6 ms on 60 s of
        audio; a scalar-C++ fused encoder was evaluated and LOSES to
        scipy's SIMD pocketfft here).

        Returns [num_bins, num_frames] float32.
        """
        signal = np.asarray(signal)
        if signal.ndim == 2:
            signal = signal.mean(axis=1).astype(signal.dtype)
        if sample_rate is not None and sample_rate != self.sample_rate:
            signal = resample(signal, sample_rate, self.sample_rate)
        if np.issubdtype(signal.dtype, np.integer):
            scale = float(np.iinfo(signal.dtype).max)
        else:
            scale = 1.0
        window = self._window_host / np.float32(scale)

        n = len(signal)
        nf = num_frames_for(n, self.hop_size)
        starts = (np.arange(nf) * self.hop_size).astype(np.int64)
        pad_to = int(starts[-1]) + self.frame_size
        sig = np.zeros(pad_to, np.float32)
        sig[:n] = signal.astype(np.float32)

        m = self._gather_phases
        if m is not None and nf > 0:
            fs = self.frame_size
            frames = np.empty((nf, fs), np.float32)
            stride_b = int(self.hop_size * m) * sig.itemsize
            for p in range(m):
                rows = len(range(p, nf, m))
                view = np.lib.stride_tricks.as_strided(
                    sig[int(p * self.hop_size):], (rows, fs),
                    (stride_b, sig.itemsize))
                np.multiply(view, window[None, :], out=frames[p::m])
        else:  # pragma: no cover - non-integral m*hop for all m <= 8
            idx = starts[:, None] + np.arange(self.frame_size)[None, :]
            frames = sig[idx] * window[None, :]
        try:
            # scipy computes the rfft natively in float32 (numpy upcasts
            # to float64 — measured ~4x slower on 60 s of audio)
            from scipy.fft import rfft as _rfft

            spec = np.abs(_rfft(frames, axis=1))[:, : self.frame_size // 2]
        except ImportError:  # pragma: no cover
            spec = np.abs(np.fft.rfft(frames, axis=1)
                          )[:, : self.frame_size // 2]
        filtered = spec.astype(np.float32) @ self._filterbank_host
        return np.log10(1.0 + filtered).astype(np.float32).T

    def process_on_device(self, signal_f32: jnp.ndarray,
                          num_frames: int) -> jnp.ndarray:
        """Jit-friendly variant for fused pipelines: float32 signal already on
        device (int-range normalization applied by caller), static frame
        count. Returns [num_frames, num_bins]."""
        starts = (jnp.arange(num_frames) * self.hop_size).astype(jnp.int32)
        return _spectrogram_core(signal_f32, self._window, self.filterbank,
                                 starts, num_frames, self.frame_size)


def resample(signal: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (the reference shells out to ffmpeg; documented
    deviation — identical band-limited semantics, different filter)."""
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    dtype = signal.dtype
    out = resample_poly(signal.astype(np.float64), frac.numerator,
                        frac.denominator)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(dtype)


# module-level default processor mirroring msmd.midi_parser.processor
_default: Optional[AudioProcessor] = None


def default_processor() -> AudioProcessor:
    global _default
    if _default is None:
        _default = AudioProcessor()
    return _default
