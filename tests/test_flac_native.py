"""Native C++ FLAC decoder: roundtrips against the test-fixture encoder."""

import os
import shutil

import numpy as np
import pytest

from tests.flac_test_encoder import encode_flac


@pytest.fixture(scope="module", autouse=True)
def build_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    from audio_sheet_retrieval_tpu.utils import native

    assert os.path.exists(native.build("asraudio"))


def _decode(data: bytes):
    from audio_sheet_retrieval_tpu.utils import flac_native

    return flac_native.decode_bytes(data)


def _noise(n, seed=0, scale=20000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale / 3).clip(
        -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("mode", ["verbatim", "constant", "fixed0", "fixed1",
                                  "fixed2", "lpc"])
def test_mono_roundtrip(mode):
    n = 10000
    if mode == "constant":
        sig = np.full(n, -1234, np.int16)
    elif mode in ("fixed1", "fixed2", "lpc"):
        t = np.arange(n)
        sig = (12000 * np.sin(2 * np.pi * 220 * t / 22050)).astype(np.int16)
    else:
        sig = _noise(n)
    data = encode_flac(sig, 22050, mode=mode)
    out, sr = _decode(data)
    assert sr == 22050
    np.testing.assert_array_equal(out, sig)


def test_stereo_independent_roundtrip():
    n = 9000
    sig = np.stack([_noise(n, 1), _noise(n, 2)], axis=1)
    out, sr = _decode(encode_flac(sig, 44100, mode="verbatim"))
    assert out.shape == (n, 2)
    np.testing.assert_array_equal(out, sig)


def test_stereo_mid_side_roundtrip():
    n = 8192
    t = np.arange(n)
    left = (9000 * np.sin(2 * np.pi * 440 * t / 22050)).astype(np.int16)
    right = (9000 * np.sin(2 * np.pi * 330 * t / 22050)).astype(np.int16)
    sig = np.stack([left, right], axis=1)
    out, sr = _decode(encode_flac(sig, 22050, mode="fixed2",
                                  stereo="mid_side"))
    np.testing.assert_array_equal(out, sig)


def test_multiblock_stream():
    sig = _noise(4096 * 3 + 777, 3)
    out, _ = _decode(encode_flac(sig, 22050, mode="fixed1"))
    np.testing.assert_array_equal(out, sig)


def test_rejects_garbage():
    with pytest.raises(ValueError):
        _decode(b"not a flac file at all........")
    with pytest.raises(ValueError):
        _decode(b"fLaC" + b"\x00" * 100)


def test_read_audio_dispatch(tmp_path):
    from audio_sheet_retrieval_tpu.utils import audio_io

    sig = _noise(5000, 4)
    p = tmp_path / "x.flac"
    p.write_bytes(encode_flac(sig, 22050, mode="verbatim"))
    out, sr = audio_io.read_audio(str(p))
    assert sr == 22050
    np.testing.assert_array_equal(out, sig)
