"""Audio -> sheet-music piece-identification service / full evaluation.

CLI parity with reference:audio_sheet_server.py:566-687 — build or load the
sheet-snippet DB over the test split, then either identify a single query
performance (+ streaming mode) or run the full per-piece evaluation with
rank bookkeeping and a retrieval_<tag>_A2S.yaml dump.

Audio queries: with MSMD available, spectrograms come from the piece's
performance audio via the on-device DSP chain; for npz/synthetic sources the
stored spectrograms act as the performance recordings (the reference falls
back to precomputed *_spec.npy the same way, :634-636).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from audio_sheet_retrieval_tpu import config as cfg_mod
from audio_sheet_retrieval_tpu.models import get_model_config
from audio_sheet_retrieval_tpu.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu.retrieval.wrapper import RetrievalWrapper
from audio_sheet_retrieval_tpu.utils.logging import BColors

col = BColors()


def make_piece_source(data: str, split: dict, config_file):
    """-> (test piece names, loader(name) -> (image, specs, o2c_maps),
    query_spec(name) -> full spectrogram)."""
    if data == "synthetic":
        from audio_sheet_retrieval_tpu.data import synthetic

        names = ["synthetic_%03d" % i for i in range(len(split["test"]))]
        images, specs, o2cs = synthetic.make_piece_list(
            25, len(names), n_onsets=60)
        table = {n: (images[i], specs[i], o2cs[i])
                 for i, n in enumerate(names)}
        return (names, lambda n: table[n], lambda n: table[n][1][0])
    if data.startswith("npz:"):
        from audio_sheet_retrieval_tpu.data.msmd import load_piece_npz

        npz_dir = data[4:]
        names = split["test"]

        def loader(n):
            return load_piece_npz(os.path.join(npz_dir, n + ".npz"))

        return names, loader, lambda n: loader(n)[1][0]
    if data == "mutopia":
        from audio_sheet_retrieval_tpu.data.msmd import (
            prepare_piece_data_msmd,
        )
        from audio_sheet_retrieval_tpu.ops.audio import default_processor
        from audio_sheet_retrieval_tpu.utils.audio_io import read_audio

        exp = cfg_mod.load_experiment_config(config_file)
        names = split["test"]

        def loader(n):
            return prepare_piece_data_msmd(cfg_mod.DATA_ROOT_MSMD, n)

        def query_spec(n):
            audio_file = os.path.join(
                cfg_mod.DATA_ROOT_MSMD,
                "%s/performances/%s_tempo-1000_%s/%s_tempo-1000_%s.flac"
                % (n, n, exp.test_synth, n, exp.test_synth))
            if os.path.exists(audio_file):
                signal, sr = read_audio(audio_file)
                return default_processor().process(signal, sample_rate=sr)
            spec_file = os.path.join(
                cfg_mod.DATA_ROOT_MSMD,
                "%s/performances/%s_tempo-1000_%s/features/"
                "%s_tempo-1000_%s.flac_spec.npy"
                % (n, n, exp.test_synth, n, exp.test_synth))
            return np.load(spec_file)

        return names, loader, query_spec
    raise ValueError(f"unknown data source {data}")


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Run audio 2 sheet music retrieval service.")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--init_sheet_db", action="store_true")
    parser.add_argument("--full_eval", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="full_eval queries through the one-dispatch "
                             "fused spec path (detect_score_from_spec, "
                             "u16 wire) instead of the host-chained "
                             "detect_score — same rankings "
                             "(tests/test_server.py), ~3x lower latency")
    parser.add_argument("--running_frames", type=int, default=100)
    parser.add_argument("--n_candidates", type=int, default=25)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--conv_precision", default=None,
                        choices=["highest", "high", "default"],
                        help="f32 conv precision (highest: strict "
                             "checkpoint parity; high: 1.56x serving "
                             "recipe, rank-agreement-lossless — "
                             "PARITY.md 16)")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--db_file", type=str, default="sheet_db_file.pkl")
    parser.add_argument("--n_test_pieces", type=int, default=None,
                        help="synthetic source: number of test pieces")
    parser.add_argument("--host_stream", action="store_true",
                        help="use the reference-style host streaming loop "
                             "instead of the fused device stream")
    return parser


def main(argv=None):
    from audio_sheet_retrieval_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    if args.conv_precision is not None:
        import dataclasses

        model_cfg = dataclasses.replace(model_cfg,
                                        conv_precision=args.conv_precision)
    tag = cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    if args.train_split:
        split = cfg_mod.load_split(args.train_split)
    else:
        split = {"test": ["x"] * (args.n_test_pieces or 8)}

    exp_name = model_cfg.name + ("_est_UV" if args.estimate_UV else "")
    dump_file = args.param_file
    if dump_file is None:
        exp_root = args.exp_root or cfg_mod.EXP_ROOT
        name = "params.pkl" if tag is None else "params_%s.pkl" % tag
        dump_file = os.path.join(exp_root, exp_name, name)

    srv = AudioSheetServer(
        sheet_shape=(model_cfg.input_shape_1[1], model_cfg.input_shape_1[2]),
        spec_shape=(model_cfg.input_shape_2[1], model_cfg.input_shape_2[2]))
    srv.initialize_embedding_network(
        RetrievalWrapper(model_cfg, param_file=dump_file))

    te_pieces, loader, query_spec = make_piece_source(
        args.data, split, args.config)

    if args.init_sheet_db or not os.path.exists(args.db_file):
        srv.initialize_sheet_db(te_pieces, loader)
        srv.save_sheet_db_file(args.db_file)
    else:
        srv.load_sheet_db_file(args.db_file)

    if args.full_eval:
        print(col.print_colored("\nRunning full evaluation:", col.UNDERLINE))
        ranks = []
        for tp in te_pieces:
            spec = query_spec(tp)
            if args.fused:  # u16 wire: rank-agreement-lossless (PARITY 15)
                ret_result, ret_votes = srv.detect_score_from_spec(
                    spec, top_k=len(te_pieces),
                    n_candidates=args.n_candidates, quantize=16)
            else:
                ret_result, ret_votes = srv.detect_score(
                    spec, top_k=len(te_pieces),
                    n_candidates=args.n_candidates)
            if tp in ret_result:
                rank = ret_result.index(tp) + 1
                ratio = ret_votes[ret_result.index(tp)]
            else:
                rank = len(ret_result)
                ratio = 0.0
            ranks.append(rank)
            color = col.OKBLUE if rank == 1 else col.WARNING
            print(col.print_colored("rank: %02d (%.2f) " % (rank, ratio),
                                    color) + tp)

        ranks = np.asarray(ranks)
        for r in range(1, len(ranks) + 1):
            n_correct = int(np.sum(ranks == r))
            if n_correct > 0:
                print(col.print_colored(
                    "%d of %d retrieved scores ranked at position %d."
                    % (n_correct, len(ranks), r), col.WARNING))

        if args.dump_results:
            res_file = cfg_mod.derive_result_path(
                dump_file, "retrieval_", "A2S.yaml")
            os.makedirs(os.path.dirname(os.path.abspath(res_file)),
                        exist_ok=True)
            cfg_mod.write_yaml(res_file, [int(r) for r in ranks])
            print("dumped results to", res_file)
        return list(ranks)

    # single-piece demo + streaming mode
    tp = te_pieces[0]
    spec = query_spec(tp)
    print(col.print_colored("\nQuery piece: %s" % tp, color=col.OKBLUE))
    srv.detect_score(spec, top_k=min(7, len(te_pieces)),
                     n_candidates=args.n_candidates, verbose=True)
    if args.host_stream:
        srv.run(spec, top_k=min(7, len(te_pieces)),
                n_candidates=args.n_candidates,
                running_frames=args.running_frames, target_piece=tp,
                max_frames=200)
    else:
        # fused device streaming (see retrieval/streaming.py)
        ranking, votes, fps = srv.run_device_stream(
            spec, top_k=min(7, len(te_pieces)),
            n_candidates=args.n_candidates,
            running_frames=args.running_frames, max_frames=200)
        print("device streaming at %.1f frames/s; top: %s"
              % (fps, ranking[:3]))
    return None


if __name__ == "__main__":
    main()
