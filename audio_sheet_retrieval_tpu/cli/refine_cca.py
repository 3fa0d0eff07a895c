"""Large-batch CCA refinement of a trained model ("the 25k pass").

Parity with reference:refine_cca.py:24-111 — embed the first n_train training
samples with the PRE-CCA encoder outputs, fit offline CCA (method 'svd'),
write U/V/mean1/mean2 back into the projection head, dump to a parallel
``<model>_est_UV`` experiment directory.

Device-side: the embed runs as jitted fixed-size batches and the CCA fit is a
single on-device computation over psum-ready sufficient statistics (the
covariances are 32x32, so sharded galleries combine exactly — see
parallel/gallery.py for the multi-chip path).
"""

from __future__ import annotations

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu import config as cfg_mod
from audio_sheet_retrieval_tpu.data.iterators import batch_compute1
from audio_sheet_retrieval_tpu.data.msmd import select_data
from audio_sheet_retrieval_tpu.models import cca_model, get_model_config
from audio_sheet_retrieval_tpu.ops import cca as cca_ops
from audio_sheet_retrieval_tpu.retrieval.wrapper import load_any_checkpoint
from audio_sheet_retrieval_tpu.train.engine import (
    prepare_view1_device,
    prepare_view2_device,
)
from audio_sheet_retrieval_tpu.utils import io as uio


def refine(params, cfg, data, n_train: int = 25000, batch_size: int = 100,
           method: str = "svd", verbose: bool = True):
    """Embed n_train pre-CCA latents, fit CCA, rewrite the projection head."""
    n_train = min(n_train, data["train"].shape[0])
    X1, X2 = data["train"][0:n_train]

    # params ride as jit arguments (closure constants bloat the program);
    # pre_cca_latent_v* honor cfg.compute_dtype so the fit sees the same
    # latent distribution the serving path produces
    @jax.jit
    def pre1_p(p, x):
        return cca_model.pre_cca_latent_v1(p, prepare_view1_device(x, cfg),
                                           cfg)

    @jax.jit
    def pre2_p(p, x):
        return cca_model.pre_cca_latent_v2(p, prepare_view2_device(x), cfg)

    p_dev = jax.device_put(params)

    def pre1(x):
        return pre1_p(p_dev, jnp.asarray(x))

    def pre2(x):
        return pre2_p(p_dev, jnp.asarray(x))

    if verbose:
        print("Computing train output (%d samples)..." % n_train)
    lv1_tr = batch_compute1(X1.astype(np.float32), pre1, batch_size)
    lv2_tr = batch_compute1(X2.astype(np.float32), pre2, batch_size)

    if verbose:
        print("Fitting CCA model...")
    res = cca_ops.cca_fit(lv1_tr, lv2_tr, method=method)
    if verbose:
        print("Correlation-Coeffs: ", np.round(np.asarray(res.coeffs), 3))
        print("Canonical-Correlation:",
              float(np.sum(np.asarray(res.coeffs))) / lv1_tr.shape[1])

    new_cca = params.cca._replace(
        U=res.U.astype(jnp.float32), V=res.V.astype(jnp.float32),
        mean1=res.m1.astype(jnp.float32), mean2=res.m2.astype(jnp.float32))
    return params._replace(cca=new_cca), res


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Refine CCA projection.")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--n_train", type=int, default=25000)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tag", type=str, default=None,
                        help="override the artifact tag (dataset-size sweeps)")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--max_train_pieces", type=int, default=None,
                        help="refine on a training-piece subset (dataset-"
                             "size sweeps)")
    return parser


def main(argv=None):
    from audio_sheet_retrieval_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    tag = args.tag or cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    exp_root = args.exp_root or cfg_mod.EXP_ROOT
    dump_name = "params.pkl" if tag is None else "params_%s.pkl" % tag
    param_file = args.param_file or os.path.join(
        exp_root, model_cfg.name, dump_name)
    print("Loading model parameters from:", param_file)
    params = load_any_checkpoint(param_file, model_cfg)

    print("\nLoading data...")
    data = select_data(args.data, args.train_split, args.config, args.seed,
                       max_train_pieces=args.max_train_pieces)

    params, _ = refine(params, model_cfg, data, n_train=args.n_train)

    out_path = os.path.join(exp_root, model_cfg.name + "_est_UV")
    dump_file = os.path.join(out_path, dump_name)
    print("Dumping refined model to", dump_file)
    uio.save_pytree(dump_file, params,
                    meta={"model": model_cfg.name, "refined": True,
                          "n_train": args.n_train})
    return dump_file


if __name__ == "__main__":
    main()
