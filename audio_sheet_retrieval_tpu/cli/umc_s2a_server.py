"""Sheet -> audio retrieval on real (UMC-style) sheet music scans.

CLI parity with reference:umc_s2a_server.py:40-123: audio-excerpt DB from
performance spectrograms, queries are OMR-unrolled sheet strips;
umc_retrieval_<tag>_<dset>_S2A[_real].yaml rank dumps.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from audio_sheet_retrieval_tpu import config as cfg_mod
from audio_sheet_retrieval_tpu.models import get_model_config
from audio_sheet_retrieval_tpu.ops.audio import default_processor
from audio_sheet_retrieval_tpu.retrieval import umc
from audio_sheet_retrieval_tpu.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu.retrieval.wrapper import RetrievalWrapper
from audio_sheet_retrieval_tpu.utils.audio_io import read_audio
from audio_sheet_retrieval_tpu.utils.logging import BColors

col = BColors()


def load_specs(piece_paths, audio_file: str):
    """Spectrograms for each piece performance (umc_a2s_server.py:34-44)."""
    proc = default_processor()
    spectrograms = []
    for piece_path in piece_paths:
        path = umc.get_performance_audio_path(piece_path, audio_file)
        signal, sr = read_audio(path)
        spectrograms.append(proc.process(signal, sample_rate=sr))
    return spectrograms


def main(argv=None):
    from audio_sheet_retrieval_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        description="Sheet to audio retrieval on real sheet music.")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--init_audio_db", action="store_true")
    parser.add_argument("--full_eval", action="store_true")
    parser.add_argument("--real_perf", action="store_true")
    parser.add_argument("--n_candidates", type=int, default=25)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--omr_models", type=str, default=umc.DEFAULT_OMR_DIR)
    parser.add_argument("--omr_map_bits", type=int, default=16,
                        choices=(8, 16),
                        help="probability-map download precision: 8 "
                        "halves the OMR wire (detection-equality "
                        "gated, tests/test_omr.py); 16 = strict")
    parser.add_argument("--db_file", type=str, default="umc_audio_db_file.pkl")
    parser.add_argument("--device_db", action="store_true",
                        help="device-resident DB build (spectrograms "
                             "upload once, embedding fused on device)")
    args = parser.parse_args(argv)

    model_cfg = get_model_config(args.model)
    tag = cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    te_pieces, piece_paths, unwrapped_sheets = umc.load_umc_sheets(
        args.data_dir, require_performance=True,
        omr=umc.make_omr(args.omr_models,
                 map_bits=args.omr_map_bits))
    dset = os.path.basename(args.data_dir.rstrip("/"))

    print("Loading spectrograms ...")
    audio_file = "01_performance" if args.real_perf else "score_ppq"
    spectrograms = load_specs(piece_paths, audio_file=audio_file)

    exp_name = model_cfg.name + ("_est_UV" if args.estimate_UV else "")
    dump_file = args.param_file
    if dump_file is None:
        exp_root = args.exp_root or cfg_mod.EXP_ROOT
        name = "params.pkl" if tag is None else "params_%s.pkl" % tag
        dump_file = os.path.join(exp_root, exp_name, name)

    srv = AudioSheetServer()
    srv.initialize_embedding_network(
        RetrievalWrapper(model_cfg, param_file=dump_file))

    if args.init_audio_db or not os.path.exists(args.db_file):
        if args.device_db:
            srv.initialize_audio_db_from_specs_device(te_pieces,
                                                      spectrograms)
        else:
            srv.initialize_audio_db_from_specs(te_pieces, spectrograms)
        srv.save_audio_db_file(args.db_file)
    else:
        srv.load_audio_db_file(args.db_file)

    if not args.full_eval:
        return None

    print(col.print_colored("\nRunning full evaluation:", col.UNDERLINE))
    ranks = []
    for i, tp in enumerate(te_pieces):
        ret_result, ret_votes = srv.detect_performance(
            unwrapped_sheets[i], top_k=len(te_pieces),
            n_candidates=args.n_candidates)
        if tp in ret_result:
            rank = ret_result.index(tp) + 1
            ratio = ret_votes[ret_result.index(tp)]
        else:
            rank = len(ret_result)
            ratio = 0.0
        ranks.append(rank)
        color = (col.OKGREEN if rank == 1
                 else col.OKBLUE if rank <= 5 else col.WARNING)
        print(col.print_colored("rank: %02d (%.2f) " % (rank, ratio), color)
              + tp)

    ranks = np.asarray(ranks)
    for r in range(1, len(ranks) + 1):
        n_correct = int(np.sum(ranks == r))
        if n_correct > 0:
            print(col.print_colored(
                "%d of %d retrieved scores ranked at position %d."
                % (n_correct, len(ranks), r), col.WARNING))

    if args.dump_results:
        ret_dir = "S2A" + ("_real" if args.real_perf else "")
        res_file = cfg_mod.derive_result_path(
            dump_file, "umc_retrieval_", "%s_%s.yaml" % (dset, ret_dir))
        os.makedirs(os.path.dirname(os.path.abspath(res_file)), exist_ok=True)
        cfg_mod.write_yaml(res_file, [int(r) for r in ranks])
        print("dumped results to", res_file)
    return list(ranks)


if __name__ == "__main__":
    main()
