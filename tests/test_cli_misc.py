"""Config system, checkpoint format detection, reports, misc CLI plumbing."""

import os
import pickle

import numpy as np
import pytest
import yaml

from audio_sheet_retrieval_tpu import config as cfg_mod
from audio_sheet_retrieval_tpu.models.configs import get_model_config


def test_experiment_config_loading():
    exp = cfg_mod.load_experiment_config("exp_configs/mutopia_full_aug.yaml")
    assert exp.sheet_context == 200 and exp.spec_bins == 92
    assert exp.augment["system_translation"] == 5
    assert exp.test_synth == "grand-piano-YDP-20160804"
    # bare-name resolution against the shipped dir
    exp2 = cfg_mod.load_experiment_config("mutopia_no_aug")
    assert exp2.augment["sheet_scaling"] == [1.0, 1.0]
    # None -> NO_AUGMENT defaults
    exp3 = cfg_mod.load_experiment_config(None)
    assert exp3.augment["synths"] == ["ElectricPiano"]


def test_compile_tag():
    assert cfg_mod.compile_tag("/a/all_split.yaml", "/b/mutopia_full_aug.yaml") \
        == "all_split_mutopia_full_aug"
    assert cfg_mod.compile_tag(None, None) is None


def test_model_registry():
    cfg = get_model_config("models/mutopia_ccal_cont.py")  # reference-style path
    assert cfg.num_filters == 12 and cfg.sheet_downscale == 1
    rsz = get_model_config("mutopia_ccal_cont_rsz")
    assert rsz.num_filters == 24 and rsz.sheet_downscale == 2
    assert rsz.patience == 30 and rsz.refinement_steps == 5
    with pytest.raises(KeyError):
        get_model_config("nope")


@pytest.mark.slow
def test_wrapper_loads_both_checkpoint_formats(tmp_path):
    import jax

    from audio_sheet_retrieval_tpu.models import cca_model, lasagne_import
    from audio_sheet_retrieval_tpu.retrieval.wrapper import (
        RetrievalWrapper,
        load_any_checkpoint,
    )
    from audio_sheet_retrieval_tpu.utils import io as uio

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)

    native = str(tmp_path / "native.pkl")
    uio.save_pytree(native, params)
    p1 = load_any_checkpoint(native, cfg)

    legacy = str(tmp_path / "legacy.pkl")
    arrays = lasagne_import.export_lasagne_arrays(params)
    with open(legacy, "wb") as fp:
        pickle.dump(arrays, fp)
    p2 = load_any_checkpoint(legacy, cfg)

    for a, b in zip(np.asarray(p1.cca.U), np.asarray(p2.cca.U)):
        np.testing.assert_allclose(a, b, atol=1e-6)

    x = np.random.default_rng(0).random((3, 1, 160, 200)).astype(np.float32)
    w1 = RetrievalWrapper(cfg, param_file=native)
    w2 = RetrievalWrapper(cfg, param_file=legacy)
    np.testing.assert_allclose(w1.compute_view_1(x), w2.compute_view_1(x),
                               atol=1e-5)

    with pytest.raises(ValueError):
        bad = str(tmp_path / "bad.pkl")
        with open(bad, "wb") as fp:
            pickle.dump({"what": 1}, fp)
        load_any_checkpoint(bad, cfg)


def test_reports_retrieval_and_piece(tmp_path):
    from audio_sheet_retrieval_tpu.cli import reports

    out = str(tmp_path)
    with open(os.path.join(out, "eval_all_split_mutopia_full_aug_A2S.yaml"),
              "w") as fp:
        yaml.safe_dump({"map": 0.51, "med_rank": 3.0,
                        "recall_at_k": {"1": 31.2, "25": 88.8}}, fp)
    rows = reports.report_retrieval(out, splits=["all_split"],
                                    augs=["mutopia_full_aug"])
    assert any("0.31" in r and "0.89" in r and "0.51" in r for r in rows)

    with open(os.path.join(out,
                           "retrieval_all_split_mutopia_full_aug_A2S.yaml"),
              "w") as fp:
        yaml.safe_dump([1, 1, 2, 7, 12], fp)
    rows = reports.report_piece_retrieval(out, splits=["all_split"],
                                          augs=["mutopia_full_aug"])
    assert any("2 (0.40)" in r for r in rows)  # rank<=1 count

    # alignment report
    errs = {"p1": np.asarray([3.0, -10.0, 50.0])}
    res_file = os.path.join(out, "alignment_res_x_pydtw.pkl")
    with open(res_file, "wb") as fp:
        pickle.dump(errs, fp)
    rows = reports.report_alignment([res_file])
    assert "median 10.0" in rows[0]


@pytest.mark.slow
def test_streaming_gui_renders_frames(tmp_path):
    """server.run(gui=True) writes dashboard pngs headlessly."""
    import jax

    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.retrieval.server import AudioSheetServer
    from audio_sheet_retrieval_tpu.retrieval.wrapper import RetrievalWrapper

    import jax.numpy as jnp

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    params = params._replace(cca=params.cca._replace(
        U=jnp.eye(cfg.dim_latent), V=jnp.eye(cfg.dim_latent)))
    wrapper = RetrievalWrapper(cfg, params=params, batch_size=10)
    names = ["p0", "p1"]
    images, specs, o2cs = synthetic.make_piece_list(3, 2, n_onsets=30)
    srv = AudioSheetServer()
    srv.initialize_embedding_network(wrapper)
    srv.initialize_sheet_db(names,
                            lambda n: (images[int(n[1])], specs[int(n[1])],
                                       o2cs[int(n[1])]))
    fig_dir = str(tmp_path / "figs")
    srv.run(spec=specs[0][0][:, :50], gui=True, fig_dir=fig_dir,
            max_frames=47, n_candidates=3, top_k=2)
    assert len(os.listdir(fig_dir)) == 47


def test_orbax_checkpoint_roundtrip(tmp_path):
    import jax

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.utils import io as uio

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(3), cfg)
    path = str(tmp_path / "orbax_ckpt")
    uio.save_pytree_orbax(path, params)
    back = uio.load_pytree_orbax(path, params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profiler_trace_smoke(tmp_path):
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.utils import profiling

    timer = profiling.StepTimer(window=3)
    with profiling.trace(str(tmp_path / "trace")):
        for _ in range(4):
            (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
            timer.tick()
    assert timer.steps_per_sec > 0
    assert os.path.exists(str(tmp_path / "trace"))
    assert profiling.device_memory_stats()


def test_checkpoint_schema_negotiation(tmp_path):
    """Pre-'version' v1 dumps load; newer-schema dumps fail actionably."""
    import pickle

    import jax
    import numpy as np

    from audio_sheet_retrieval_tpu.utils import io as uio

    tree = {"w": np.arange(4, dtype=np.float32)}
    legacy = str(tmp_path / "legacy.pkl")
    with open(legacy, "wb") as fp:  # exactly what round-1 builds wrote
        pickle.dump({"format": uio.FORMAT_TAG, "tree": tree, "meta": {}}, fp)
    back = uio.load_pytree(legacy)
    np.testing.assert_array_equal(back["w"], tree["w"])

    future = str(tmp_path / "future.pkl")
    with open(future, "wb") as fp:
        pickle.dump({"format": uio.FORMAT_TAG,
                     "version": uio.SCHEMA_VERSION + 1,
                     "tree": tree, "meta": {}}, fp)
    with pytest.raises(ValueError, match="upgrade"):
        uio.load_pytree(future)

    current = str(tmp_path / "now.pkl")
    uio.save_pytree(current, tree)
    with open(current, "rb") as fp:
        payload = pickle.load(fp)
    assert payload["version"] == uio.SCHEMA_VERSION


def test_orbax_async_save_roundtrip(tmp_path):
    import jax
    import numpy as np

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.utils import io as uio

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "async_ckpt")
    uio.save_pytree_orbax(path, params, wait=False)
    uio.orbax_wait()
    back = uio.load_pytree_orbax(path, params)
    a, b = jax.tree.leaves(params), jax.tree.leaves(back)
    assert all(np.allclose(x, y) for x, y in zip(a, b))


def test_wrapper_loader_enforces_schema_gate(tmp_path):
    """load_any_checkpoint must route native payloads through load_pytree
    (regression: it used to unpickle directly, skipping the version gate)."""
    import pickle

    import jax

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.retrieval.wrapper import load_any_checkpoint
    from audio_sheet_retrieval_tpu.utils import io as uio

    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    params = cca_model.init_model(jax.random.PRNGKey(0), cfg)
    p = str(tmp_path / "p.pkl")
    uio.save_pytree(p, params)
    import pickle as pk
    d = pk.load(open(p, "rb"))
    d["version"] = uio.SCHEMA_VERSION + 1
    pk.dump(d, open(p, "wb"))
    with pytest.raises(ValueError, match="upgrade"):
        load_any_checkpoint(p, cfg)


@pytest.mark.slow
def test_audio_sheet_server_cli_full_eval_fused(tmp_path):
    """The audio_sheet_server CLI's --full_eval with --fused routes
    queries through the one-dispatch spec path and produces the same
    ranks as the host-chained detect_score loop."""
    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.cli import audio_sheet_server

    common = ["--data", "synthetic", "--n_test_pieces", "3",
              "--param_file", assets.tutorial_checkpoint_path(),
              "--db_file", str(tmp_path / "db.pkl"),
              "--init_sheet_db", "--full_eval", "--n_candidates", "5"]
    ranks_host = audio_sheet_server.main(common)
    ranks_fused = audio_sheet_server.main(common + ["--fused"])
    assert len(ranks_host) == 3 and len(ranks_fused) == 3
    assert ranks_fused == ranks_host


@pytest.mark.slow
def test_sheet_audio_server_cli_full_eval_fused(tmp_path):
    """sheet_audio_server CLI --full_eval --fused (one-dispatch strip
    query, two-level RLE wire) matches the host-chained ranks."""
    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.cli import sheet_audio_server

    common = ["--data", "synthetic", "--n_test_pieces", "3",
              "--param_file", assets.tutorial_checkpoint_path(),
              "--db_file", str(tmp_path / "adb.pkl"),
              "--init_audio_db", "--full_eval", "--n_candidates", "5"]
    ranks_host = sheet_audio_server.main(common)
    ranks_fused = sheet_audio_server.main(common + ["--fused"])
    assert len(ranks_host) == 3 and ranks_fused == ranks_host


@pytest.mark.parametrize("name", ["mutopia_audio_aug", "mutopia_full_aug",
                                  "mutopia_no_aug", "mutopia_sheet_aug"])
def test_yaml_reader_matches_pyyaml_on_exp_configs(name):
    path = os.path.join(cfg_mod.EXP_CONFIG_DIR, name + ".yaml")
    with open(path) as fp:
        want = yaml.safe_load(fp)
    assert cfg_mod.read_yaml(path) == want
    # and what it writes reads back the same through both readers
    text = cfg_mod.dump_yaml(want)
    assert yaml.safe_load(text) == want
    assert cfg_mod.parse_yaml(text) == want


def test_result_dump_roundtrip(tmp_path):
    """Result dumps (eval dicts with quoted numeric keys, rank lists,
    split files with awkward names) round-trip through write/read_yaml
    and stay readable by PyYAML."""
    objs = [{"map": 0.51, "med_rank": 3.0,
             "recall_at_k": {"1": 31.2, "25": 88.8}},
            [1, 1, 2, 7, 12],
            {"train": ["P1", "yes", "1.0", "a: b", "it's", "#x"],
             "valid": [], "test": ["P3"]},
            {"tiny": 1e-05, "huge": 1.5e20, "none": None, "flag": True,
             "neg": -3, "empty": {}}]
    for i, obj in enumerate(objs):
        p = str(tmp_path / f"r{i}.yaml")
        cfg_mod.write_yaml(p, obj)
        assert cfg_mod.read_yaml(p) == obj
        with open(p) as fp:
            assert yaml.safe_load(fp) == obj


def test_clis_import_without_pyyaml():
    import subprocess
    import sys

    code = ("import sys; sys.modules['yaml'] = None\n"
            "import audio_sheet_retrieval_tpu.cli.run_eval, "
            "audio_sheet_retrieval_tpu.cli.audio_sheet_server, "
            "audio_sheet_retrieval_tpu.cli.sheet_audio_server, "
            "audio_sheet_retrieval_tpu.cli.umc_a2s_server, "
            "audio_sheet_retrieval_tpu.cli.umc_s2a_server, "
            "audio_sheet_retrieval_tpu.cli.reports, "
            "audio_sheet_retrieval_tpu.cli.run_train\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True,
                   timeout=300)


def test_compile_cache_dir_honours_jax_env():
    from audio_sheet_retrieval_tpu.utils import profiling

    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert profiling.compile_cache_dir(env, "gpu") == "/some/cache"


def test_compile_cache_dir_defaults_to_checkout():
    from audio_sheet_retrieval_tpu.utils import profiling

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = profiling.compile_cache_dir({}, "gpu")
    assert got == os.path.join(repo, ".jax_cache", "gpu")
    assert profiling.compile_cache_dir({"OTHER": "x"}, "gpu") == got


def test_native_library_path_tracks_sources():
    from audio_sheet_retrieval_tpu.utils import native

    a = native.lib_path("asrrans")
    assert a == native.lib_path("asrrans")
    assert os.path.dirname(a) == native.BUILD_DIR
    assert os.path.basename(a).startswith("libasrrans-")
    assert a != native.lib_path("asraudio")
