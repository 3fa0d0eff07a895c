"""UMC real-scan pipeline end-to-end (SURVEY section 2 row 15) without
commercial data: a synthetic UMC-style dataset directory built from the
real vendored tutorial page, processed by the real OMR U-Nets, the real
checkpoint, and the full cli/umc_a2s_server eval loop (sheet DB build ->
audio query -> vote -> yaml dump — reference umc_a2s_server.py:176-278)."""

import os
import struct
import wave

import numpy as np
import pytest

from audio_sheet_retrieval_tpu import assets

pytestmark = pytest.mark.skipif(
    not (assets.has_asset("omr_system.npz")
         and assets.has_asset("tutorial_checkpoint.npz")),
    reason="vendored assets missing")


def _write_wav(path, signal_i16, sr=22050):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(struct.pack("<%dh" % len(signal_i16), *signal_i16))


@pytest.fixture(scope="module")
def umc_dataset(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("umc_data")
    page = cv2.imread(assets.tutorial_sheet_path(), 0)

    # piece A: the full page; piece B: the lower systems only (top erased)
    page_b = page.copy()
    page_b[: page.shape[0] // 2] = 255
    sr = 22050
    t = np.arange(sr * 8) / sr
    for name, img, freqs in (
            ("PieceA", page, (262.0, 330.0, 392.0)),
            ("PieceB", page_b, (220.0, 277.0, 440.0))):
        d = root / name / "sheet"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "01.png"), img)
        sig = sum(0.2 * np.sin(2 * np.pi * f * t) for f in freqs)
        _write_wav(str(root / name / "score_ppq.wav"),
                   (sig * 20000).astype(np.int16), sr)
        # real-performance marker/recording (the s2a server gates pieces on
        # a *performance* file existing — reference umc_s2a_server)
        _write_wav(str(root / name / "01_performance.wav"),
                   (sig * 18000).astype(np.int16), sr)
    return str(root)


@pytest.mark.slow
def test_load_umc_sheets_unrolls_real_pages(umc_dataset):
    from audio_sheet_retrieval_tpu.retrieval import umc

    names, paths, strips = umc.load_umc_sheets(umc_dataset)
    assert names == ["PieceA", "PieceB"]
    for s in strips:
        assert s.ndim == 2 and s.shape[0] == 160 and s.shape[1] > 1000
    # piece B has fewer systems -> a shorter unrolled strip
    assert strips[1].shape[1] < strips[0].shape[1]
    # audio path resolution (reference get_performance_audio_path)
    assert umc.get_performance_audio_path(paths[0], "score_ppq") is not None
    assert umc.get_performance_audio_path(paths[0], "nonexistent") is None


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["host", "device"])
def test_umc_a2s_server_full_eval(umc_dataset, tmp_path, mode):
    from audio_sheet_retrieval_tpu.cli import umc_a2s_server

    db_file = os.path.join(tmp_path, "umc_db.pkl")
    param_file = assets.tutorial_checkpoint_path()
    ranks = umc_a2s_server.main([
        "--data_dir", umc_dataset,
        "--param_file", param_file,
        "--db_file", db_file,
        "--init_sheet_db", "--full_eval", "--dump_results",
    ] + (["--device_db"] if mode == "device" else []))
    assert ranks is not None and len(ranks) == 2
    assert all(1 <= r <= 2 for r in ranks)
    assert os.path.exists(db_file)
    # yaml rank dump written under the reference naming convention, safely
    # derived for a non-.pkl checkpoint; vendored-asset checkpoints dump to
    # the cwd instead of the package dir (config.derive_result_path)
    from audio_sheet_retrieval_tpu import assets as _a
    from audio_sheet_retrieval_tpu import config as cfg_mod
    import yaml

    dset = os.path.basename(umc_dataset.rstrip("/"))
    res_file = cfg_mod.derive_result_path(
        param_file, "umc_retrieval_", "%s_A2S.yaml" % dset)
    assert res_file != param_file
    assert not os.path.dirname(res_file).startswith(_a.assets_dir())
    assert os.path.exists(res_file)
    with open(res_file) as fp:
        assert yaml.safe_load(fp) == list(ranks)
    os.remove(res_file)


@pytest.mark.slow
def test_umc_s2a_server_full_eval(umc_dataset, tmp_path):
    """Sheet->audio direction through the real CLI: OMR-unrolled scans as
    queries against the rendered-audio gallery (reference
    umc_s2a_server.py:77-123), device-resident DB build."""
    from audio_sheet_retrieval_tpu.cli import umc_s2a_server

    db_file = os.path.join(tmp_path, "umc_audio_db.pkl")
    ranks = umc_s2a_server.main([
        "--data_dir", umc_dataset,
        "--param_file", assets.tutorial_checkpoint_path(),
        "--db_file", db_file,
        "--init_audio_db", "--full_eval", "--device_db",
    ])
    assert ranks is not None and len(ranks) == 2
    assert all(1 <= r <= 2 for r in ranks)
    assert os.path.exists(db_file)


@pytest.mark.slow
def test_eval_piece_retrieval_umc_sweep_script(umc_dataset, tmp_path):
    """The one-command UMC sweep wrapper (scripts/eval_piece_retrieval_umc
    .sh; reference eval_piece_retrieval_umc.sh) runs both directions x
    both performance sources and aggregates the rank table."""
    import subprocess
    import sys

    # the sweep scripts run from the repo root (module-path convention of
    # train_models.sh etc.); vendored-checkpoint result dumps land in cwd
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               ASR_UMC_PARAM_FILE=assets.tutorial_checkpoint_path(),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        ["bash", os.path.join(repo, "scripts", "eval_piece_retrieval_umc.sh"),
         umc_dataset],
        cwd=repo, env=env, text=True, timeout=1500,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    sys.stdout.write(proc.stdout[-2000:])
    dset = os.path.basename(umc_dataset.rstrip("/"))
    dumped = [f"umc_retrieval_tutorial_checkpoint_{dset}_{d}.yaml"
              for d in ("A2S", "A2S_real", "S2A", "S2A_real")]
    try:
        assert proc.returncode == 0
        for f in dumped:
            assert os.path.exists(os.path.join(repo, f)), f
        # the aggregator printed one LaTeX row per direction
        assert proc.stdout.count(f"{dset} ") >= 4
    finally:
        for f in dumped:
            p = os.path.join(repo, f)
            if os.path.exists(p):
                os.remove(p)
