"""Train a cross-modality retrieval model.

CLI parity with reference:run_train.py:51-118 (flags --model --data --resume
--seed --no_dump --show_architecture --train_split --config), artifact
conventions EXP_ROOT/<model>/params_<tag>.pkl + results_<tag>.pkl.
"""

from __future__ import annotations

import argparse
import os

import jax
import numpy as np

from audio_sheet_retrieval_tpu import config as cfg_mod
from audio_sheet_retrieval_tpu.data.iterators import (
    MultiviewPoolIteratorUnsupervised,
)
from audio_sheet_retrieval_tpu.data.msmd import select_data
from audio_sheet_retrieval_tpu.models import cca_model, get_model_config
from audio_sheet_retrieval_tpu.retrieval.wrapper import load_any_checkpoint
from audio_sheet_retrieval_tpu.train import engine
from audio_sheet_retrieval_tpu.utils.logging import print_architecture


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train cross-modality retrieval model.")
    parser.add_argument("--model", help="model to train (registry name).",
                        default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", help="data source: mutopia | synthetic | npz:<dir>",
                        default="mutopia")
    parser.add_argument("--resume", help="resume on pre-trained model: "
                        "restores the FULL fit state (optimizer, early-stop "
                        "bookkeeping, data-order RNG) from fit_state_<tag>."
                        "pkl when present so the run continues epoch-for-"
                        "epoch where it was killed; falls back to params-"
                        "only reload (the reference's semantics, "
                        "run_train.py:96-101) otherwise.",
                        action="store_true")
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--no_dump", help="do not dump model file.",
                        action="store_true")
    parser.add_argument("--show_architecture", action="store_true")
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="override the model's epoch budget")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="encoder math dtype")
    parser.add_argument("--whitening", default=None,
                        choices=["polar", "eigh"],
                        help="CCA whitening (polar: matmul-only, loss-"
                             "equivalent; eigh: reference formulation)")
    parser.add_argument("--host_data", action="store_true",
                        help="disable the device-resident data path (keep "
                             "per-batch host preparation like the reference)")
    parser.add_argument("--max_train_pieces", type=int, default=None,
                        help="subset the training pieces (dataset-size "
                             "sweeps; reference train_models_dset_size.sh "
                             "uses bach_split_{10,25,50,75} yamls)")
    parser.add_argument("--tag", type=str, default=None,
                        help="override the artifact tag (default: "
                             "<split>_<config> stems)")
    return parser


def main(argv=None):
    from audio_sheet_retrieval_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    args = build_arg_parser().parse_args(argv)

    import dataclasses

    model_cfg = get_model_config(args.model)
    overrides = {}
    if args.max_epochs is not None:
        overrides["max_epochs"] = args.max_epochs
    if args.compute_dtype is not None:
        overrides["compute_dtype"] = args.compute_dtype
    if args.whitening is not None:
        overrides["whitening"] = args.whitening
    if overrides:
        model_cfg = dataclasses.replace(model_cfg, **overrides)

    print("\nLoading data...")
    data = select_data(args.data, args.train_split, args.config, args.seed,
                       max_train_pieces=args.max_train_pieces)

    tag = args.tag or cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    exp_root = args.exp_root or cfg_mod.EXP_ROOT
    out_path = os.path.join(exp_root, model_cfg.name)
    dump_file = "params.pkl" if tag is None else "params_%s.pkl" % tag
    dump_file = os.path.join(out_path, dump_file)
    log_file = "results.pkl" if tag is None else "results_%s.pkl" % tag
    log_file = os.path.join(out_path, log_file)

    print("\nBuilding network...")
    params = cca_model.init_model(jax.random.PRNGKey(args.seed), model_cfg)
    if args.show_architecture:
        print_architecture(params, model_cfg.name)

    state_file = ("fit_state.pkl" if tag is None
                  else "fit_state_%s.pkl" % tag)
    state_file = os.path.join(out_path, state_file)
    if args.resume and not os.path.exists(state_file):
        # no full snapshot: fall back to the reference's params-only resume
        print("Loading model parameters from:", dump_file)
        params = load_any_checkpoint(dump_file, model_cfg)

    if args.host_data:
        train_batch_iter = MultiviewPoolIteratorUnsupervised(
            batch_size=model_cfg.batch_size, k_samples=model_cfg.k_samples)
        valid_batch_iter = MultiviewPoolIteratorUnsupervised(
            batch_size=model_cfg.batch_size, shuffle=False)
    else:
        # device-resident data: pieces live on device, batches are jitted
        # gathers with on-device augmentation
        from audio_sheet_retrieval_tpu.data import device_pool as dpool

        data = dict(
            data,
            train=dpool.from_host_pool(
                data["train"], rng=np.random.default_rng(args.seed)),
            valid=dpool.from_host_pool(
                data["valid"], shuffle=False,
                rng=np.random.default_rng(args.seed + 1)),
        )
        train_batch_iter = dpool.DeviceBatchIterator(
            batch_size=model_cfg.batch_size, k_samples=model_cfg.k_samples)
        valid_batch_iter = dpool.DeviceBatchIterator(
            batch_size=model_cfg.batch_size, shuffle=False, train=False)

    if not args.resume and os.path.exists(state_file) \
            and jax.process_index() == 0:
        os.remove(state_file)  # fresh run: a stale snapshot must not resume

    best_params, best_map = engine.fit(
        params, data, model_cfg, train_batch_iter, valid_batch_iter,
        out_path=out_path,
        dump_file=None if args.no_dump else dump_file,
        log_file=log_file,
        exp_name=model_cfg.name,
        resume_file=state_file,
    )
    # the fit-state snapshot is IN-FLIGHT state only: a CLI run that
    # returned normally (epoch budget exhausted or early stop) must not
    # leave one behind, or a later --resume would restore the finished
    # bookkeeping and train ZERO further epochs — the reference's
    # --resume on a finished run reloads params and trains a fresh
    # schedule (reference run_train.py:96-101), which the params-only
    # fallback above then provides. A killed process never reaches this
    # line and keeps its snapshot for exact continuation (engine.fit
    # restores it bit-identically; tests/test_train.py,
    # tests/test_multiprocess.py).
    if jax.process_index() == 0 and os.path.exists(state_file):
        os.remove(state_file)
    print("Best validation MAP: %.2f" % (100 * best_map))
    return best_params, best_map


if __name__ == "__main__":
    main()
