#!/usr/bin/env python
"""Bring-up smoke test of the serving and training path on NVIDIA GPUs.

    python chip_smoke.py              # one card: parity, serve, train, timing
    python chip_smoke.py --multichip  # four cards: the sharded paths only

One process drives the card(s). It refuses to run unless JAX's first
device is a GPU (no CPU fallback), and every phase failure ends the run
with a nonzero exit code. Each phase checks its results against the repo's
plain references: the pure-numpy oracle (tests/oracle_numpy_forward.py),
the golden file (tests/golden/reference_embeddings.npz), and the same
computation on the CPU backend of the same process (or, with --multichip,
on one card). The model is mutopia_ccal_cont_rsz at full width.

Earlier lines report each phase; the last line of stdout is one JSON
object, ``{"ok": true, "device": {"platform", "kind", "count"}}``. A
record of every number goes to chiprun_out/chip_smoke[_multichip].json.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
MODEL = "mutopia_ccal_cont_rsz"


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def require_gpus(n: int):
    """The GPU devices, or exit nonzero before anything is printed."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's first device is "
                         f"{devs[0].platform}); refusing to run")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, found {len(devs)}")
    return devs


# ---------------------------------------------------------------------------
# parity: the f32-highest arm against the numpy oracle and the golden file
# ---------------------------------------------------------------------------


def synthetic_snippets(n: int) -> np.ndarray:
    """[n, 1, 80, 100] prepared sheet inputs (x/255, 2x2-mean half resize)
    cut from a synthetic strip — no image decoder needed."""
    from audio_sheet_retrieval_tpu.data import synthetic

    img, _, _ = synthetic.make_piece(np.random.default_rng(5), n_onsets=40)
    r0 = img.shape[0] // 2 - 80
    snips = np.stack([img[r0:r0 + 160, 200 + 60 * i:400 + 60 * i]
                      for i in range(n)]).astype(np.float32)[:, None] / 255.0
    b, c, h, w = snips.shape
    return snips.reshape(b, c, h // 2, 2, w // 2, 2).mean(axis=(3, 5))


def golden_chirp() -> np.ndarray:
    """The 5 s int16 chirp the golden file was made from."""
    sr = 22050
    t = np.arange(sr * 5) / sr
    return (0.4 * np.sin(2 * np.pi * (220 + 80 * t) * t) * 32767
            ).astype(np.int16)


def conv_lowering(hlo: str) -> dict:
    """What XLA made of the convs: custom-call targets, cuDNN math types
    (TENSOR_OP_MATH on f32 operands means TF32) and operand precisions."""
    targets = re.findall(r'custom_call_target="([^"]+)"', hlo)
    return {
        "conv_custom_calls": dict(Counter(t for t in targets
                                          if "conv" in t.lower())),
        "math_type": dict(Counter(re.findall(r'"math_type":"(\w+)"', hlo))),
        "operand_precision": dict(Counter(
            re.findall(r"operand_precision=\{([^}]*)\}", hlo))),
        "hlo_convolution_ops": len(re.findall(r"\sconvolution\(", hlo)),
    }


def phase_parity(dev, n: int = 8, hlo_dir: str | None = None) -> dict:
    """f32-highest embeddings vs the numpy oracle (atol 1e-4) and the
    golden file (DSP chain atol 2e-5, spectrogram codes atol 2e-4); the
    other arms' deviation and conv lowering are reported."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle_numpy_forward as oracle

    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.models import cca_model, lasagne_import
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops.audio import AudioProcessor

    out = {}
    arrays = oracle.load_checkpoint_arrays(assets.tutorial_checkpoint_path())
    golden = np.load(os.path.join(REPO, "tests", "golden",
                                  "reference_embeddings.npz"))
    x1 = synthetic_snippets(n)
    with jax.default_device(dev):
        spec = np.asarray(AudioProcessor().process(golden_chirp()))
    dsp_err = float(np.abs(spec[:, :300] - golden["spec"]).max())
    x2 = np.stack([spec[:, i * 6:i * 6 + 42] for i in range(8)]
                  ).astype(np.float32)[:, None]
    want1, want2 = oracle.embed(arrays, x1=x1, x2=x2)
    out["dsp_max_abs_err_vs_golden"] = dsp_err
    check(dsp_err <= 2e-5, f"DSP chain vs golden {dsp_err} > 2e-5")

    base = get_model_config(MODEL)
    arms = {"f32-highest": dict(compute_dtype="float32",
                                conv_precision="highest"),
            "f32-high": dict(compute_dtype="float32", conv_precision="high"),
            "f32-default": dict(compute_dtype="float32",
                                conv_precision="default"),
            "bf16": dict(compute_dtype="bfloat16",
                         conv_precision="default")}
    for arm, over in arms.items():
        cfg = dataclasses.replace(base, **over)
        params = lasagne_import.load_retrieval_checkpoint(
            assets.tutorial_checkpoint_path(), cfg)
        with jax.default_device(dev):
            params = jax.device_put(params)
            v1 = jax.jit(lambda p, x: cca_model.embed_view1(p, x, cfg))
            v2 = jax.jit(lambda p, x: cca_model.embed_view2(p, x, cfg))
            a1 = jnp.asarray(np.transpose(x1, (0, 2, 3, 1)))
            a2 = jnp.asarray(np.transpose(x2, (0, 2, 3, 1)))
            lv1 = np.asarray(v1(params, a1))
            lv2 = np.asarray(v2(params, a2))
            hlo = v1.lower(params, a1).compile().as_text()
        if hlo_dir:
            with open(os.path.join(hlo_dir, f"hlo_view1_{arm}.txt"), "w") as f:
                f.write(hlo)
        r = {"view1_max_abs_err_vs_oracle": float(np.abs(lv1 - want1).max()),
             "view2_max_abs_err_vs_oracle": float(np.abs(lv2 - want2).max()),
             "view1_conv_lowering": conv_lowering(hlo)}
        if arm == "f32-highest":
            r["spec_codes_max_abs_err_vs_golden"] = float(
                np.abs(lv2 - golden["spec_codes"]).max())
        out[arm] = r
        say("parity", arm=arm, **{k: v for k, v in r.items()})
    hi = out["f32-highest"]
    check(hi["view1_max_abs_err_vs_oracle"] <= 1e-4,
          f"f32-highest view1 vs oracle {hi['view1_max_abs_err_vs_oracle']}")
    check(hi["view2_max_abs_err_vs_oracle"] <= 1e-4,
          f"f32-highest view2 vs oracle {hi['view2_max_abs_err_vs_oracle']}")
    check(hi["spec_codes_max_abs_err_vs_golden"] <= 2e-4,
          f"spec codes vs golden {hi['spec_codes_max_abs_err_vs_golden']}")

    # why the CCA / projection / gallery dots pin HIGHEST: a default-
    # precision f32 product at the projection shape, against HIGHEST
    rng = np.random.default_rng(0)
    a = rng.standard_normal((100, 32)).astype(np.float32)
    b = rng.standard_normal((32, 32)).astype(np.float32)
    with jax.default_device(dev):
        d_def = np.asarray(jax.jit(jnp.dot)(a, b))
        d_hi = np.asarray(jax.jit(lambda x, y: jnp.dot(
            x, y, precision=jax.lax.Precision.HIGHEST))(a, b))
    out["projection_dot_default_vs_highest_rel_err"] = float(
        np.abs(d_def - d_hi).max() / np.abs(d_hi).max())
    say("parity", dsp_max_abs_err_vs_golden=dsp_err,
        projection_dot_default_vs_highest_rel_err=out[
            "projection_dot_default_vs_highest_rel_err"])
    return out


# ---------------------------------------------------------------------------
# serve: the server's device DB build, fused queries, streaming and the CLI
# ---------------------------------------------------------------------------


def _true_rank(ranking, piece) -> int:
    return ranking.index(piece) + 1 if piece in ranking else len(ranking) + 1


def _spec_ranks(srv, names, specs, n_candidates=25):
    ranks, votes = [], []
    for name, spec in zip(names, specs):
        res, v = srv.detect_score_from_spec(
            spec, top_k=len(names), n_candidates=n_candidates,
            n_samples=100)
        ranks.append(_true_rank(res, name))
        votes.append((res, v))
    return ranks, votes


def phase_serve(dev, ref_dev, *, cfg, ckpt: str, workdir: str,
                n_pieces: int = 64, n_ref: int = 8, n_onsets: int = 200,
                n_perf: int = 8, stream_frames: int = 200,
                cli_pieces: int = 8) -> dict:
    """Device sheet-DB build (rle2 wire, exact per-window path), fused
    spec queries (100 excerpts, 25 candidates, top-25 vote), audio-DB
    build + sheet queries, a 200-frame device stream and the evaluation
    CLI. On the first ``n_ref`` pieces the f32-highest arm's per-query
    ranks must equal the CPU backend's, and so must the fullconv build's
    codes (within 1e-4). The fullconv codes' cosine to the exact path's is
    reported: the strip-level first block sees true neighbours where each
    window's own conv sees zero padding, so it is a different embedding."""
    import jax

    from audio_sheet_retrieval_tpu.cli import audio_sheet_server
    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.retrieval.server import AudioSheetServer
    from audio_sheet_retrieval_tpu.retrieval.wrapper import RetrievalWrapper

    images, specs, _ = synthetic.make_piece_list(26, n_pieces,
                                                 n_onsets=n_onsets)
    specs = [s[0] for s in specs]
    names = ["piece_%03d" % i for i in range(n_pieces)]
    out = {"n_pieces": n_pieces, "strip_width_px": int(images[0].shape[1])}

    def server(device, k, fullconv=False):
        with jax.default_device(device):
            srv = AudioSheetServer(
                sheet_shape=(cfg.input_shape_1[1], cfg.input_shape_1[2]),
                spec_shape=(cfg.input_shape_2[1], cfg.input_shape_2[2]))
            srv.initialize_embedding_network(
                RetrievalWrapper(cfg, param_file=ckpt))
            t0 = time.perf_counter()
            srv.initialize_sheet_db_from_imges_device(names[:k], images[:k],
                                                      fullconv=fullconv)
            jax.block_until_ready(srv.sheet_snippet_codes)
            build_s = time.perf_counter() - t0
        return srv, build_s

    srv, out["sheet_db_build_s_incl_compile"] = server(dev, n_pieces)
    out["sheet_db_rows"] = int(srv.sheet_snippet_codes.shape[0])
    with jax.default_device(dev):
        ranks, _ = _spec_ranks(srv, names, specs)
    out["spec_query_rank1"] = f"{sum(r == 1 for r in ranks)}/{len(ranks)}"

    # GPU vs CPU on the same n_ref-piece subset
    sub_gpu, _ = server(dev, n_ref)
    sub_cpu, _ = server(ref_dev, n_ref)
    with jax.default_device(dev):
        r_gpu, v_gpu = _spec_ranks(sub_gpu, names[:n_ref], specs[:n_ref])
    with jax.default_device(ref_dev):
        r_cpu, v_cpu = _spec_ranks(sub_cpu, names[:n_ref], specs[:n_ref])
    out["subset_ranks_gpu"] = r_gpu
    out["subset_ranks_cpu"] = r_cpu
    out["subset_votes_identical"] = all(
        a[0] == b[0] and np.array_equal(a[1], b[1])
        for a, b in zip(v_gpu, v_cpu))
    out["subset_codes_max_abs_diff_gpu_vs_cpu"] = float(np.abs(
        np.asarray(sub_gpu.sheet_snippet_codes)
        - np.asarray(sub_cpu.sheet_snippet_codes)).max())
    check(r_gpu == r_cpu, f"per-query ranks GPU {r_gpu} != CPU {r_cpu}")

    # fullconv (strip-level first block): the card against the CPU, and
    # against the exact per-window path
    fc_dev, _ = server(dev, n_ref, fullconv=True)
    fc_ref, _ = server(ref_dev, n_ref, fullconv=True)
    fast = np.asarray(fc_dev.sheet_snippet_codes)
    out["fullconv_codes_max_abs_diff_gpu_vs_cpu"] = float(np.abs(
        fast - np.asarray(fc_ref.sheet_snippet_codes)).max())
    check(out["fullconv_codes_max_abs_diff_gpu_vs_cpu"] <= 1e-4,
          "fullconv codes GPU vs CPU")
    exact = np.asarray(sub_gpu.sheet_snippet_codes)
    cos = np.sum(exact * fast, axis=1) / (
        np.linalg.norm(exact, axis=1) * np.linalg.norm(fast, axis=1))
    out["fullconv_min_cosine_vs_exact"] = float(cos.min())
    out["fullconv_median_cosine_vs_exact"] = float(np.median(cos))

    with jax.default_device(dev):
        srv.initialize_audio_db_from_specs_device(names, specs)
        perf_ranks = []
        for i in range(min(n_perf, n_pieces)):
            res, _ = srv.detect_performance_from_sheet(
                images[i], top_k=n_pieces, n_candidates=25, n_samples=100)
            perf_ranks.append(_true_rank(res, names[i]))
        out["sheet_query_rank1"] = (
            f"{sum(r == 1 for r in perf_ranks)}/{len(perf_ranks)}")
        ranking, votes, fps = srv.run_device_stream(
            specs[0], top_k=5, n_candidates=25, running_frames=100,
            max_frames=stream_frames)
    out["stream_frames"] = stream_frames
    out["stream_top1_is_true_piece"] = bool(ranking and
                                            ranking[0] == names[0])
    out["stream_fps_host_clock"] = float(fps)

    db = os.path.join(workdir, "sheet_db.pkl")
    with jax.default_device(dev):
        cli_ranks = audio_sheet_server.main([
            "--model", cfg.name, "--data", "synthetic", "--full_eval",
            "--fused", "--param_file", ckpt, "--db_file", db,
            "--init_sheet_db", "--n_test_pieces", str(cli_pieces)])
    check(len(cli_ranks) == cli_pieces, "CLI returned no ranks")
    out["cli_rank1"] = f"{sum(r == 1 for r in cli_ranks)}/{len(cli_ranks)}"
    say("serve", **out)
    return out


# ---------------------------------------------------------------------------
# train: the training CLI in f32 and bf16, one step against the CPU
# ---------------------------------------------------------------------------


def _train_step_outputs(device, cfg, *, permute: bool = False, mesh=None,
                        seed: int = 0):
    """(loss, gradient) of one engine.make_train_step step at full batch
    on ``device`` (or data-parallel over ``mesh``). The step runs plain SGD
    at learning rate 1, so the parameter update IS the negated gradient
    (Adam's first update is ~lr*sign(grad) and would hide it).
    ``permute`` reorders the batch (pairs kept): the same loss and gradient
    in exact arithmetic, summed in another order in f32."""
    import jax
    import optax

    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.parallel import mesh as pm
    from audio_sheet_retrieval_tpu.train import engine
    from audio_sheet_retrieval_tpu.train import state as ts

    rng = np.random.default_rng(seed)
    b = cfg.batch_size
    x1 = (rng.random((b,) + cfg.input_shape_1) * 255).astype(np.float32)
    x2 = rng.random((b,) + cfg.input_shape_2).astype(np.float32)
    if permute:
        order = rng.permutation(b)
        x1, x2 = x1[order], x2[order]
    opt = optax.sgd(1.0)
    st = ts.init_train_state(
        cca_model.init_model(jax.random.PRNGKey(seed), cfg), cfg, opt)
    if mesh is None:
        st, x1, x2 = jax.device_put((st, x1, x2), device)
    else:
        st = pm.replicate(mesh, st)
        x1, x2 = pm.shard_batch(mesh, x1), pm.shard_batch(mesh, x2)
    new, m = jax.jit(engine.make_train_step(cfg, opt))(st, x1, x2)
    before, after = (np.concatenate([np.ravel(np.asarray(x))
                                     for x in jax.tree.leaves(t.trainable)])
                     for t in (st, new))
    return float(m["loss"]), before - after


def _step_agreement(name: str, got, want, reordered) -> dict:
    """Loss within 1e-4 relative; gradient within 3x the reference's own
    f32 error, measured as the relative L2 change of its gradient when the
    batch is merely reordered (BatchNorm statistics and the CCA whitening
    amplify summation order: ~2e-3 at full width and batch 100)."""
    scale = np.linalg.norm(want[1])
    r = {"loss": got[0], "loss_ref": want[0],
         "loss_rel_err": abs(got[0] - want[0]) / abs(want[0]),
         "grad_rel_err": float(np.linalg.norm(got[1] - want[1]) / scale),
         "ref_reorder_grad_rel_err": float(
             np.linalg.norm(reordered[1] - want[1]) / scale)}
    check(r["loss_rel_err"] <= 1e-4, f"{name}: loss {r}")
    check(r["grad_rel_err"] <= 3 * max(r["ref_reorder_grad_rel_err"], 1e-6),
          f"{name}: gradient beyond 3x the reference's reorder error {r}")
    return r


def phase_train(dev, ref_dev, *, cfg, workdir: str, epochs: int = 2) -> dict:
    """run_train's CLI on synthetic data in f32 and bf16 (every loss
    finite, the last sub-epoch's mean loss below the first's), and one
    engine.make_train_step step against the CPU backend within
    _step_agreement's tolerances."""
    import jax

    from audio_sheet_retrieval_tpu.cli import run_train
    from audio_sheet_retrieval_tpu.utils import io as uio

    out = {}
    for dtype in ("float32", "bfloat16"):
        root = os.path.join(workdir, "train_" + dtype)
        t0 = time.perf_counter()
        with jax.default_device(dev):
            run_train.main(["--model", cfg.name, "--data", "synthetic",
                            "--max_epochs", str(epochs), "--no_dump",
                            "--exp_root", root, "--compute_dtype", dtype])
        curves = uio.load_results(os.path.join(root, cfg.name,
                                               "results.pkl"))
        losses = [float(x) for x in curves["pred_tr_err"]]
        out[dtype] = {"subepoch_mean_losses": losses,
                      "valid_losses": [float(x)
                                       for x in curves["pred_val_err"]],
                      "wall_s_incl_compile": time.perf_counter() - t0}
        say("train", dtype=dtype, **out[dtype])
        check(len(losses) == epochs and np.isfinite(losses).all(),
              f"{dtype} losses not finite: {losses}")
        check(losses[-1] < losses[0],
              f"{dtype} loss did not fall: {losses}")

    with jax.default_device(ref_dev):
        want = _train_step_outputs(ref_dev, cfg)
        reordered = _train_step_outputs(ref_dev, cfg, permute=True)
    with jax.default_device(dev):
        got = _train_step_outputs(dev, cfg)
    out["step_vs_cpu"] = _step_agreement("train step vs CPU", got, want,
                                         reordered)
    say("train", **out["step_vs_cpu"])
    return out


# ---------------------------------------------------------------------------
# timings of the plain XLA versions that replaced the removed kernels
# ---------------------------------------------------------------------------


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_busy_ns(trace_dir: str) -> tuple[int, list]:
    """Busy time of the GPU in a profiler trace: the union of the kernel
    intervals on the device's stream lines (or, where the trace has none,
    on its "XLA Ops" line)."""
    from jax.profiler import ProfileData

    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    by_kind = {"stream": [], "ops": []}
    lines = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.append(f"{plane.name}|{line.name}")
            kind = ("stream" if line.name.startswith("Stream")
                    else "ops" if line.name == "XLA Ops" else None)
            if kind:
                by_kind[kind] += [(e.start_ns, e.start_ns + e.duration_ns)
                                  for e in line.events]
    intervals = by_kind["stream"] or by_kind["ops"]
    check(bool(intervals), f"no GPU kernel events in the trace: {lines}")
    return _union_ns(intervals), lines


def time_on_device(fn, args, n_calls: int, trace_dir: str) -> dict:
    """Warm up, then ``n_calls`` back-to-back calls: host wall time per
    call (block_until_ready on the last) and GPU busy time per call from a
    profiler trace of a second run of the same calls."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        r = fn(*args)
    jax.block_until_ready(r)
    wall = (time.perf_counter() - t0) / n_calls
    jax.profiler.start_trace(trace_dir)
    for _ in range(n_calls):
        r = fn(*args)
    jax.block_until_ready(r)
    jax.profiler.stop_trace()
    busy, lines = trace_busy_ns(trace_dir)
    return {"wall_us_per_call": wall * 1e6,
            "device_us_per_call": busy / n_calls / 1e3,
            "trace_lines": sorted(set(lines))}


def phase_timings(dev, trace_root: str) -> dict:
    """The fullconv feature gather at the bench geometry (20,000-px strip,
    stride 25 on the half-res plane, bf16) and lax.top_k over [100, 1M]
    f32 scores with k=25 (plus the whole DeviceGallery.topk program), each
    against its bytes bound, with a large copy and a bf16 matmul for
    scale."""
    import jax
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.ops import windows as win
    from audio_sheet_retrieval_tpu.retrieval import gallery as gal_mod
    from audio_sheet_retrieval_tpu.utils import roofline

    out = {}

    def record(name, fn, args, n_calls, nbytes=None, flops=None):
        r = time_on_device(jax.jit(fn), args, n_calls,
                           os.path.join(trace_root, name))
        lines = r.pop("trace_lines")
        t = r["device_us_per_call"] * 1e-6
        if nbytes is not None:
            r["min_bytes"] = nbytes
            r["achieved_GBps"] = nbytes / t / 1e9
            r["share_of_bytes_bound_published"] = roofline.bytes_bound_s(
                nbytes, dev.device_kind) / t
        if flops is not None:
            r["achieved_TFLOPps"] = flops / t / 1e12
        out[name] = r
        say("timings", name=name, **r)
        out.setdefault("trace_lines", lines)

    with jax.default_device(dev):
        rng = np.random.default_rng(0)
        # scale: a 1 GiB bf16 elementwise copy and an 8192^3 bf16 matmul
        x = jnp.ones((1 << 29,), jnp.bfloat16)
        record("copy_1GiB_bf16", lambda v: v + jnp.bfloat16(1), (x,), 20,
               nbytes=2 * x.nbytes)
        del x
        a = jnp.asarray(rng.standard_normal((8192, 8192)), jnp.bfloat16)
        record("matmul_bf16_8192", lambda p, q: p @ q, (a, a), 20,
               flops=2 * 8192 ** 3)
        del a
        copy_bw = out["copy_1GiB_bf16"]["achieved_GBps"] * 1e9

        # fullconv feature gather: [H/4=40, W/2-1, 24] bf16 plane of a
        # 20,000-px strip, windows at stride 50 px (25 on the plane)
        starts = win.stride_starts(20000, 200, 50)
        plane = jnp.asarray(rng.standard_normal((40, 9999, 24)),
                            jnp.bfloat16)
        sh = jnp.asarray(starts // 2)
        n_cols = 50
        out_bytes = len(starts) * 40 * n_cols * 24 * 2
        record("fullconv_feature_gather",
               lambda q, s: win.gather_feature_windows(q, s, n_cols),
               (plane, sh), 200, nbytes=plane.nbytes + out_bytes)

        scores = jnp.asarray(rng.standard_normal((100, 1_000_000)),
                             jnp.float32)
        record("top_k_100x1M_k25", lambda s: jax.lax.top_k(s, 25),
               (scores,), 50, nbytes=scores.nbytes)
        del scores
        gal = gal_mod.DeviceGallery(
            rng.standard_normal((1_000_000, 32)).astype(np.float32))
        q = jnp.asarray(rng.standard_normal((100, 32)), jnp.float32)
        record("device_gallery_topk_1M",
               lambda g, v, qq: gal_mod._topk_query(g, v, qq, 25),
               (gal.gallery_nt, gal.valid, q), 50,
               nbytes=gal.gallery_nt.nbytes + gal.valid.nbytes)
    for name in ("fullconv_feature_gather", "top_k_100x1M_k25",
                 "device_gallery_topk_1M"):
        r = out[name]
        r["share_of_measured_copy_rate"] = (
            r["min_bytes"] / copy_bw / (r["device_us_per_call"] * 1e-6))
    return out


# ---------------------------------------------------------------------------
# four cards: data-parallel step, sharded galleries, psum'd CCA refit
# ---------------------------------------------------------------------------


def phase_multichip(devs, *, cfg, ckpt: str, n_rows: int = 1_000_000,
                    n_cca: int = 25_000, n_pieces: int = 8,
                    n_onsets: int = 200) -> dict:
    """Each sharded path on a plain (4,) mesh against the same computation
    on one card: DP train step (_step_agreement's tolerances),
    sharded_gallery_search (identical top-k index sets away from ties),
    sharded_cca_fit (correlations within 1e-4), and the coded sharded sheet-DB build + make_sharded_piece_query
    (codes within 2e-5, identical vote counts)."""
    import jax
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.ops import cca as cca_ops
    from audio_sheet_retrieval_tpu.ops import windows as win
    from audio_sheet_retrieval_tpu.parallel import gallery as pg
    from audio_sheet_retrieval_tpu.parallel import mesh as pm
    from audio_sheet_retrieval_tpu.retrieval.gallery import (
        DeviceGallery,
        make_fused_piece_query_spec,
    )
    from audio_sheet_retrieval_tpu.retrieval.wrapper import (
        load_any_checkpoint,
    )

    n = len(devs)
    one = devs[0]
    out = {"n_devices": n}
    rng = np.random.default_rng(1)

    # data-parallel train step at batch cfg.batch_size vs one card
    mesh = pm.make_mesh((n,), (pm.DATA_AXIS,), devices=devs)
    with jax.default_device(one):
        want = _train_step_outputs(one, cfg)
        reordered = _train_step_outputs(one, cfg, permute=True)
        got = _train_step_outputs(None, cfg, mesh=mesh)
    out["dp_step"] = _step_agreement("DP step vs one card", got, want,
                                     reordered)
    say("multichip", **out["dp_step"])

    # gallery sharded over the mesh vs one card
    db_mesh = pm.make_mesh((n,), (pm.DB_AXIS,), devices=devs)
    g = rng.standard_normal((n_rows, cfg.dim_latent)).astype(np.float32)
    q = rng.standard_normal((100, cfg.dim_latent)).astype(np.float32)
    k = 25
    _, i4 = pg.sharded_gallery_search(db_mesh, g, q, k)
    with jax.default_device(one):
        d1, i1 = DeviceGallery(g).topk(q, k + 1)
    tie = (d1[:, k] - d1[:, k - 1]) < 1e-6   # 26th as close as the 25th
    same = [set(i4[r]) == set(i1[r, :k]) for r in range(len(q))]
    out["gallery_rows"] = n_rows
    out["gallery_topk_sets_identical"] = int(sum(same))
    out["gallery_queries_at_ties"] = int(tie.sum())
    check(all(s or t for s, t in zip(same, tie)),
          "sharded gallery top-k differs away from ties")

    # psum'd CCA refit over sample shards vs one card
    z = rng.standard_normal((n_cca, cfg.dim_latent))
    h1 = (z @ rng.standard_normal((cfg.dim_latent,) * 2)
          + 0.5 * rng.standard_normal(z.shape)).astype(np.float32)
    h2 = (z @ rng.standard_normal((cfg.dim_latent,) * 2)
          + 0.5 * rng.standard_normal(z.shape)).astype(np.float32)
    res4 = pg.sharded_cca_fit(mesh, h1, h2, axis=pm.DATA_AXIS)
    with jax.default_device(one):
        res1 = cca_ops.cca_fit(h1[:(n_cca // n) * n], h2[:(n_cca // n) * n])
    out["cca_coeffs_max_abs_diff"] = float(np.abs(
        np.asarray(res4.coeffs) - np.asarray(res1.coeffs)).max())
    check(out["cca_coeffs_max_abs_diff"] <= 1e-4, "sharded CCA fit")

    # coded sharded sheet-DB build + sharded fused query vs one card
    params = load_any_checkpoint(ckpt, cfg)
    images, specs, _ = synthetic.make_piece_list(26, n_pieces,
                                                 n_onsets=n_onsets)
    codes, ids, n_real = pg.build_sharded_sheet_gallery_coded(
        db_mesh, params, cfg, images)
    w = images[0].shape[1]
    with jax.default_device(one):
        embed = win.make_strip_embedder(params, cfg, center_crop=160)
        starts = jnp.asarray(win.stride_starts(w, 200, 50))
        want = np.concatenate([np.asarray(embed(jnp.asarray(s), starts))
                               for s in images])
    got = np.asarray(codes)[:n_real]
    real = ids != n_pieces
    out["sharded_codes_max_abs_diff"] = float(
        np.abs(got[real] - want).max())
    check(out["sharded_codes_max_abs_diff"] <= 2e-5, "sharded sheet codes")
    sharded_q = pg.make_sharded_piece_query(
        db_mesh, params, cfg, codes, ids, n_pieces, n_candidates=25,
        n_real=n_real)
    with jax.default_device(one):
        single_q = make_fused_piece_query_spec(
            params, cfg, DeviceGallery(want, ids=ids[real]), n_pieces,
            n_candidates=25)
    mismatched = 0
    for spec in (s[0] for s in specs):
        payload, scale = win.spec_quantize(spec, bits=16)
        qs = jnp.asarray(win.linspace_starts(spec.shape[1], 42, 100))
        c4 = np.asarray(sharded_q(jnp.asarray(payload), scale, qs))
        with jax.default_device(one):
            c1 = np.asarray(single_q(jnp.asarray(payload), scale, qs))
        mismatched += int(not np.array_equal(c4, c1))
    out["vote_count_mismatches"] = mismatched
    check(mismatched == 0, f"{mismatched} sharded vote histograms differ")
    say("multichip", **{k_: v for k_, v in out.items() if k_ != "dp_step"})
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the sharded paths, on 4 GPUs")
    args = ap.parse_args(argv)
    n_dev = 4 if args.multichip else 1
    devs = require_gpus(n_dev)

    import jax

    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.utils.profiling import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    say("env", jax=jax.__version__, xla_flags=repr(os.environ.get(
        "XLA_FLAGS", "")), devices=len(devs), kind=repr(devs[0].device_kind),
        compile_cache=enable_compile_cache())
    compile_s = [0.0]
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, secs, **kw: compile_s.__setitem__(
            0, compile_s[0] + secs)
        if event == "/jax/core/compile/backend_compile_duration" else None)

    os.makedirs(OUT_DIR, exist_ok=True)
    cfg = get_model_config(MODEL)
    ckpt = assets.asset_path("synth_serving_ckpt.pkl")
    report = {"nvidia_smi": smi, "jax": jax.__version__,
              "device_kind": devs[0].device_kind}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        if args.multichip:
            report["multichip"] = phase_multichip(devs[:4], cfg=cfg,
                                                  ckpt=ckpt)
        else:
            cpu = jax.devices("cpu")[0]
            report["parity"] = phase_parity(devs[0], hlo_dir=OUT_DIR)
            report["serve"] = phase_serve(devs[0], cpu, cfg=cfg, ckpt=ckpt,
                                          workdir=work)
            report["train"] = phase_train(devs[0], cpu, cfg=cfg,
                                          workdir=work)
            report["timings"] = phase_timings(devs[0], os.path.join(
                work, "traces"))
    report["peak_bytes_in_use"] = [d.memory_stats()["peak_bytes_in_use"]
                                   for d in devs[:n_dev]]
    report["backend_compile_s"] = compile_s[0]
    report["wall_s"] = time.perf_counter() - t_start
    say("summary", peak_bytes_in_use=report["peak_bytes_in_use"],
        backend_compile_s=round(compile_s[0], 1),
        wall_s=round(report["wall_s"], 1))
    name = "chip_smoke_multichip.json" if args.multichip else "chip_smoke.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
