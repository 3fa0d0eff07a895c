"""chip_smoke.py: it refuses to run without a GPU, and its phase functions
run end to end at tiny sizes on the CPU (the card runs them at full width:
``python chip_smoke.py``)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A narrow model (registry name kept, so the CLIs accept it) and a
    checkpoint of its random weights (identity CCA projection: the
    untrained zero projection gives NaN codes)."""
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.utils import io as uio

    cfg = get_model_config(chip_smoke.MODEL, num_filters=4, dim_latent=8,
                           batch_size=25, k_samples=500)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "params.pkl")
    params = cca_model.init_model(jax.random.PRNGKey(3), cfg)
    eye = jnp.eye(cfg.dim_latent)
    uio.save_pytree(ckpt, params._replace(cca=params.cca._replace(U=eye,
                                                                  V=eye)))
    return cfg, ckpt


def _use_config(monkeypatch, cfg, *modules):
    for m in modules:
        monkeypatch.setattr(m, "get_model_config",
                            lambda name, **kw: dataclasses.replace(cfg, **kw))


def test_refuses_a_cpu_only_process(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert proc.stdout.strip() == ""


def test_parity_phase_on_cpu(cpu):
    out = chip_smoke.phase_parity(cpu, n=3)
    assert out["f32-highest"]["view1_max_abs_err_vs_oracle"] <= 1e-4
    assert out["bf16"]["view1_max_abs_err_vs_oracle"] > 0
    # the CPU backend runs no cuDNN convs
    assert out["f32-highest"]["view1_conv_lowering"]["conv_custom_calls"] == {}


def test_serve_phase_on_cpu(cpu, tiny, tmp_path, monkeypatch):
    from audio_sheet_retrieval_tpu.cli import audio_sheet_server

    cfg, ckpt = tiny
    _use_config(monkeypatch, cfg, audio_sheet_server)
    out = chip_smoke.phase_serve(
        cpu, cpu, cfg=cfg, ckpt=ckpt, workdir=str(tmp_path), n_pieces=3,
        n_ref=2, n_onsets=20, n_perf=2, stream_frames=60, cli_pieces=2)
    assert out["subset_ranks_gpu"] == out["subset_ranks_cpu"]
    assert out["subset_votes_identical"]
    assert out["fullconv_codes_max_abs_diff_gpu_vs_cpu"] == 0.0
    assert -1.0 <= out["fullconv_min_cosine_vs_exact"] <= 1.0
    assert out["cli_rank1"].endswith("/2")


def test_train_phase_on_cpu(cpu, tiny, tmp_path, monkeypatch):
    from audio_sheet_retrieval_tpu.cli import run_train

    cfg, _ = tiny
    _use_config(monkeypatch, cfg, run_train)
    out = chip_smoke.phase_train(cpu, cpu, cfg=cfg, workdir=str(tmp_path),
                                 epochs=2)
    for dtype in ("float32", "bfloat16"):
        losses = out[dtype]["subepoch_mean_losses"]
        assert len(losses) == 2 and losses[-1] < losses[0]
    assert out["step_vs_cpu"]["loss_rel_err"] == 0.0
    assert out["step_vs_cpu"]["grad_rel_err"] == 0.0


def test_trace_interval_union():
    # overlapping, nested and disjoint kernel intervals
    assert chip_smoke._union_ns([(0, 10), (5, 15), (6, 7), (20, 25)]) == 20
    assert chip_smoke._union_ns([]) == 0


def test_conv_lowering_reads_cudnn_calls():
    hlo = ('%c = custom-call(%a, %b), custom_call_target="__cudnn$convForward"'
           ', backend_config={"algorithm":{"math_type":"TENSOR_OP_MATH"}}\n'
           '%d = f32[2]{0} convolution(%a, %b), operand_precision={highest,'
           'highest}\n')
    got = chip_smoke.conv_lowering(hlo)
    assert got == {"conv_custom_calls": {"__cudnn$convForward": 1},
                   "math_type": {"TENSOR_OP_MATH": 1},
                   "operand_precision": {"highest,highest": 1},
                   "hlo_convolution_ops": 1}
    json.dumps(got)


@pytest.mark.gpu
def test_parity_phase_on_the_card(gpu):
    """The f32-highest arm against the oracle on the card itself."""
    out = chip_smoke.phase_parity(gpu)
    assert out["f32-highest"]["view2_max_abs_err_vs_oracle"] <= 1e-4


@pytest.fixture
def gpu():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devs[0]
