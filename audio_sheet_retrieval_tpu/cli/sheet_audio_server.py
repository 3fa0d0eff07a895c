"""Sheet -> audio piece-identification: the direction-flipped evaluation.

CLI parity with reference:sheet_audio_server.py:21-111 — build the
audio-excerpt DB over the test split, query with each piece's unrolled sheet
image, dump retrieval_<tag>_S2A.yaml rank lists.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from audio_sheet_retrieval_tpu import config as cfg_mod
from audio_sheet_retrieval_tpu.cli.audio_sheet_server import make_piece_source
from audio_sheet_retrieval_tpu.models import get_model_config
from audio_sheet_retrieval_tpu.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu.retrieval.wrapper import RetrievalWrapper
from audio_sheet_retrieval_tpu.utils.logging import BColors

col = BColors()


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Run sheet 2 audio retrieval service.")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--init_audio_db", action="store_true")
    parser.add_argument("--full_eval", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="full_eval queries through the one-dispatch "
                             "fused strip path (detect_performance_from_"
                             "sheet, two-level lossless RLE wire) — same "
                             "rankings, ~3x lower latency")
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
    parser.add_argument("--db_file", type=str, default="audio_db_file.pkl")
    parser.add_argument("--n_test_pieces", type=int, default=None)
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

    te_pieces, loader, _ = make_piece_source(args.data, split, args.config)

    if args.init_audio_db or not os.path.exists(args.db_file):
        srv.initialize_audio_db(te_pieces, loader)
        srv.save_audio_db_file(args.db_file)
    else:
        srv.load_audio_db_file(args.db_file)

    if args.full_eval:
        print(col.print_colored("\nRunning full evaluation:", col.UNDERLINE))
        ranks = []
        for tp in te_pieces:
            sheet = loader(tp)[0]
            detect = (srv.detect_performance_from_sheet if args.fused
                      else srv.detect_performance)
            ret_result, ret_votes = detect(
                sheet, top_k=len(te_pieces), n_candidates=args.n_candidates)
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
                    "%d of %d retrieved performances ranked at position %d."
                    % (n_correct, len(ranks), r), col.WARNING))

        if args.dump_results:
            res_file = cfg_mod.derive_result_path(
                dump_file, "retrieval_", "S2A.yaml")
            os.makedirs(os.path.dirname(os.path.abspath(res_file)),
                        exist_ok=True)
            cfg_mod.write_yaml(res_file, [int(r) for r in ranks])
            print("dumped results to", res_file)
        return list(ranks)
    return None


if __name__ == "__main__":
    main()
