"""Native mp3 decode path: lame-encoded fixtures round-trip through
utils.audio_io.read_audio / flac_native.decode_bytes(codec="mp3").

The encoder side uses the system libmp3lame purely as a test-fixture
generator (the framework itself only decodes); both tests skip cleanly on
systems without the codec libraries.
"""

import ctypes
import os
import tempfile

import numpy as np
import pytest

from audio_sheet_retrieval_tpu.utils import audio_io, flac_native


def _have(lib):
    try:
        ctypes.CDLL(lib)
        return True
    except OSError:
        return False


pytestmark = pytest.mark.skipif(
    not (_have("libmp3lame.so.0") and _have("libmpg123.so.0")),
    reason="system mp3 codec libraries not present")


def lame_encode(sig: np.ndarray, sr: int) -> bytes:
    """int16 [n] or [n, 2] -> mp3 bytes via libmp3lame (test fixture only)."""
    lame = ctypes.CDLL("libmp3lame.so.0")
    lame.lame_init.restype = ctypes.c_void_p
    for name in ("lame_set_in_samplerate", "lame_set_num_channels",
                 "lame_set_brate", "lame_set_mode", "lame_init_params",
                 "lame_close"):
        getattr(lame, name).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if name.startswith("lame_set") else [])
    lame.lame_encode_buffer.restype = ctypes.c_int
    lame.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lame.lame_encode_flush.restype = ctypes.c_int
    lame.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]

    stereo = sig.ndim == 2
    n = sig.shape[0]
    gfp = lame.lame_init()
    lame.lame_set_in_samplerate(gfp, sr)
    lame.lame_set_num_channels(gfp, 2 if stereo else 1)
    lame.lame_set_brate(gfp, 192)
    lame.lame_set_mode(gfp, 0 if stereo else 3)  # 0=stereo, 3=mono
    assert lame.lame_init_params(gfp) >= 0

    left = np.ascontiguousarray(sig[:, 0] if stereo else sig, np.int16)
    right = np.ascontiguousarray(sig[:, 1], np.int16) if stereo else left
    buf = ctypes.create_string_buffer(int(1.25 * n) + 7200)
    m = lame.lame_encode_buffer(
        gfp, left.ctypes.data_as(ctypes.c_void_p),
        right.ctypes.data_as(ctypes.c_void_p), n, buf, len(buf))
    assert m >= 0
    tail = ctypes.create_string_buffer(7200)
    t = lame.lame_encode_flush(gfp, tail, len(tail))
    lame.lame_close(gfp)
    return buf.raw[:m] + tail.raw[:t]


def _aligned_corr(ref: np.ndarray, dec: np.ndarray) -> float:
    """Correlation after compensating the codec delay via cross-correlation."""
    ref = ref.astype(np.float64)
    dec = dec.astype(np.float64)
    xc = np.correlate(dec[:4 * 1152 + len(ref) // 2], ref[:len(ref) // 2],
                      mode="valid")
    lag = int(np.argmax(xc))
    m = min(len(ref), len(dec) - lag)
    a, b = ref[:m], dec[lag:lag + m]
    return float(np.dot(a, b) / np.sqrt(np.dot(a, a) * np.dot(b, b)))


def test_mono_roundtrip_waveform():
    sr = 22050
    t = np.arange(sr * 2) / sr
    sig = (10000 * np.sin(2 * np.pi * (300 + 150 * t) * t)).astype(np.int16)
    data = lame_encode(sig, sr)
    dec, got_sr = flac_native.decode_bytes(data, codec="mp3")
    assert got_sr == sr
    assert dec.ndim == 1
    assert abs(len(dec) - len(sig)) < 5000  # encoder/decoder padding
    assert _aligned_corr(sig, dec) > 0.97


def test_stereo_channels_not_swapped(tmp_path):
    """L=440Hz / R=1320Hz: decoded channel spectra must stay on their side
    (catches interleave bugs that mono downmix would hide); also exercises
    read_audio's .mp3 dispatch from a file path."""
    sr = 44100
    t = np.arange(sr) / sr
    sig = np.stack([(9000 * np.sin(2 * np.pi * 440 * t)),
                    (9000 * np.sin(2 * np.pi * 1320 * t))],
                   axis=1).astype(np.int16)
    p = os.path.join(tmp_path, "x.mp3")
    with open(p, "wb") as f:
        f.write(lame_encode(sig, sr))
    dec, got_sr = audio_io.read_audio(p)
    assert got_sr == sr and dec.ndim == 2 and dec.shape[1] == 2
    spec = np.abs(np.fft.rfft(dec[2000:2000 + 8192].astype(np.float64),
                              axis=0))
    freqs = np.fft.rfftfreq(8192, 1.0 / sr)
    peak_l = freqs[np.argmax(spec[:, 0])]
    peak_r = freqs[np.argmax(spec[:, 1])]
    assert abs(peak_l - 440) < 20 and abs(peak_r - 1320) < 20


def test_garbage_bytes_rejected():
    with pytest.raises(ValueError):
        flac_native.decode_bytes(b"\x00" * 4096, codec="mp3")
