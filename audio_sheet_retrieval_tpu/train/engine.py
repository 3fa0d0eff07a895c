"""Training engine: jitted train step + the reference's fit/refinement loop.

Control-flow parity with reference:utils/train_dcca_pool.py:
  * per-epoch train over ``k_samples`` sub-epochs through a threaded prefetch
    generator (:193-232),
  * per-epoch embedding of <=1000 train + valid samples, optional offline CCA
    refit (fit_cca), retrieval evaluation (:234-299),
  * early stopping on ``map_va >= prev_map_va`` with best-model snapshot and
    params dump on improvement (:391-401),
  * NaN-loss abort (:410-411),
  * refinement schedule: on patience exhaustion reload best weights AND best
    optimizer state, lr *= lr_multiplier, patience = refinement_patience,
    repeat ``refinement_steps`` times (:492-520),
  * per-epoch results.pkl curve log (:477-489).

Deviations: the whole update (both encoders + CCA whitening/eigh +
ranking loss + Adam) is ONE jitted XLA computation; the view-1 'prepare'
normalization/half-resize runs on device inside the step (the reference did
cv2 resizes on the host per batch, models/mutopia_ccal_cont_rsz.py:179-185);
multi-chip data parallelism comes from donating batch shards under a Mesh —
XLA inserts the psum for the global CCA batch statistics automatically.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from audio_sheet_retrieval_tpu.data.iterators import (
    threaded_generator_from_iterator,
)
from audio_sheet_retrieval_tpu.models import cca_model
from audio_sheet_retrieval_tpu.models.cca_model import ModelParams
from audio_sheet_retrieval_tpu.models.configs import ModelConfig
from audio_sheet_retrieval_tpu.ops import cca as cca_ops
from audio_sheet_retrieval_tpu.ops import losses
from audio_sheet_retrieval_tpu.ops.metrics import (
    eval_retrieval,
    retrieval_metrics_device,
    unpack_retrieval_metrics,
)
from audio_sheet_retrieval_tpu.train import state as ts
from audio_sheet_retrieval_tpu.utils import io as uio
from audio_sheet_retrieval_tpu.utils.logging import BColors

col = BColors()


# --- device-side input preparation -------------------------------------------


def prepare_view1_device(x1: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """[B,1,H,W] raw-range sheet batch -> [B,H',W',1] normalized NHWC.

    Mirrors model.prepare (x/255 + optional half bilinear resize,
    reference mutopia_ccal_cont_rsz.py:170-190) on device.
    """
    x = jnp.transpose(x1, (0, 2, 3, 1)) * (1.0 / 255.0)
    if cfg.sheet_downscale > 1:
        b, h, w, c = x.shape
        x = jax.image.resize(
            x, (b, h // cfg.sheet_downscale, w // cfg.sheet_downscale, c),
            method="bilinear", antialias=False)
    return x


def prepare_view2_device(x2: jnp.ndarray) -> jnp.ndarray:
    """[B,1,bins,frames] spectrogram batch -> NHWC (no normalization;
    the log-filterbank output is fed as-is, like the reference)."""
    return jnp.transpose(x2, (0, 2, 3, 1))


# --- jitted steps -------------------------------------------------------------


def make_train_step(cfg: ModelConfig, optimizer: optax.GradientTransformation):
    loss_weight = 1.0 - cfg.weight_tno

    @jax.jit
    def train_step(state: ts.TrainState, x1, x2):
        x1p = prepare_view1_device(x1, cfg)
        x2p = prepare_view2_device(x2)

        def loss_fn(trainable):
            params = ts.merge_params(trainable, state.non_trainable, cfg)
            lv1, lv2, new_params, corr = cca_model.forward_train(
                params, x1p, x2p, cfg)
            obj = losses.contrastive_cos_loss(
                lv1, lv2, weight=loss_weight, gamma=cfg.gamma)
            # CCALayer corr loss: -mean(sqrt(clip(E1)))*wl (lasagne cca.py:163)
            obj = obj - jnp.mean(corr) * cfg.weight_tno
            if cfg.l2:
                obj = obj + cfg.l2 * ts.l2_penalty(trainable)
            if cfg.l1:
                obj = obj + cfg.l1 * ts.l1_penalty(trainable)
            return obj, (new_params, corr)

        (loss, (new_params, corr)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.trainable)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.trainable)
        new_trainable = optax.apply_updates(state.trainable, updates)
        _, new_non_trainable = ts.split_params(new_params, cfg)
        new_state = ts.TrainState(new_trainable, new_non_trainable, opt_state,
                                  state.step + 1)
        return new_state, {"loss": loss, "corr": corr}

    return train_step


def make_eval_fns(cfg: ModelConfig):
    @jax.jit
    def embed_pair(params: ModelParams, x1, x2):
        lv1 = cca_model.embed_view1(params, prepare_view1_device(x1, cfg), cfg)
        lv2 = cca_model.embed_view2(params, prepare_view2_device(x2), cfg)
        return lv1, lv2

    @jax.jit
    def valid_loss(params: ModelParams, x1, x2):
        lv1, lv2 = embed_pair(params, x1, x2)
        return losses.contrastive_cos_loss(
            lv1, lv2, weight=1.0 - cfg.weight_tno, gamma=cfg.gamma), lv1, lv2

    @jax.jit
    def init_cca_step(state: ts.TrainState, x1, x2):
        """CCA running-stat burn-in without gradient updates (pretrain,
        reference train_dcca_pool.py:170-182)."""
        params = ts.merge_params(state.trainable, state.non_trainable, cfg)
        _, _, new_params, _ = cca_model.forward_train(
            params, prepare_view1_device(x1, cfg), prepare_view2_device(x2),
            cfg)
        _, new_non_trainable = ts.split_params(new_params, cfg)
        return state._replace(non_trainable=new_non_trainable)

    return embed_pair, valid_loss, init_cca_step


def make_fused_eval(cfg: ModelConfig):
    """One jitted computation for the whole per-epoch evaluation: offline CCA
    refit on the train subset (when cfg.fit_cca), projection of both splits,
    and the full rank/hit/MRR reduction for each — returning two 8-vectors.

    Replaces the host round-trip of the [n, d] code matrices (reference
    train_dcca_pool.py:234-299 collects embeddings on the host and loops
    scipy cdist/argsort) with a single dispatch whose download is 16 scalars.
    """
    fit_cca = bool(cfg.fit_cca)

    @jax.jit
    def fused_eval(lv1_tr, lv2_tr, lv1_va, lv2_va):
        if fit_cca:
            res = cca_ops.cca_fit(lv1_tr, lv2_tr, method="svd")
            lv1_tr = cca_ops.cca_transform_v1(res, lv1_tr)
            lv2_tr = cca_ops.cca_transform_v2(res, lv2_tr)
            lv1_va = cca_ops.cca_transform_v1(res, lv1_va)
            lv2_va = cca_ops.cca_transform_v2(res, lv2_va)
        return (retrieval_metrics_device(lv1_tr, lv2_tr),
                retrieval_metrics_device(lv1_va, lv2_va))

    return fused_eval


# --- full fit-state checkpointing (kill-and-resume) ---------------------------
#
# The reference's --resume reloads best PARAMS only (run_train.py:96-101) —
# adequate single-GPU, but on a pod the restart path must reproduce the
# interrupted trajectory exactly: optimizer state, early-stop/refinement
# bookkeeping, results curves, and the data-order RNG state all matter.
# fit(resume_file=...) snapshots all of it atomically at every epoch end
# (process 0 writes; every process restores the identical snapshot, keeping
# SPMD lockstep) so a killed run resumed on all hosts continues
# epoch-for-epoch identical to an uninterrupted one
# (tests/test_multiprocess.py).

_FIT_STATE_VERSION = 1


def _host_leaf(x):
    """Device array -> host numpy; replicated multi-process arrays (not
    fully addressable) read their local shard, which holds the full value
    under a P() sharding."""
    if isinstance(x, jax.Array) and not getattr(x, "is_fully_addressable",
                                                True):
        return np.asarray(x.addressable_shards[0].data)
    return np.asarray(x)


def _atomic_pickle(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        pickle.dump(obj, fp, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # a kill mid-write can never corrupt the snapshot


def _rng_capture(obj) -> dict:
    """Duck-typed data-order state of a pool/iterator: numpy Generator
    state, jax PRNG key, shuffle order, sub-epoch counter."""
    d = {}
    if obj is None:
        return d
    rng = getattr(obj, "rng", None)
    if isinstance(rng, np.random.Generator):
        d["rng"] = rng.bit_generator.state
    key = getattr(obj, "_key", None)
    if key is not None:
        d["key"] = np.asarray(key)
    order = getattr(obj, "_order", None)
    if order is not None:
        d["order"] = np.asarray(order)
    if hasattr(obj, "epoch_counter"):
        d["epoch_counter"] = int(obj.epoch_counter)
    return d


def _rng_restore(obj, d: Optional[dict]) -> None:
    if obj is None or not d:
        return
    rng = getattr(obj, "rng", None)
    if "rng" in d and isinstance(rng, np.random.Generator):
        rng.bit_generator.state = d["rng"]
    if "key" in d and getattr(obj, "_key", None) is not None:
        obj._key = jnp.asarray(d["key"])
    if "order" in d and getattr(obj, "_order", None) is not None:
        obj._order = np.asarray(d["order"])
    if "epoch_counter" in d and hasattr(obj, "epoch_counter"):
        obj.epoch_counter = int(d["epoch_counter"])


# --- fit ----------------------------------------------------------------------


def fit(
    params: ModelParams,
    data: Dict,
    cfg: ModelConfig,
    train_batch_iter,
    valid_batch_iter,
    *,
    out_path: str,
    dump_file: Optional[str] = None,
    log_file: Optional[str] = None,
    num_epochs: Optional[int] = None,
    exp_name: str = "ff",
    verbose: bool = True,
    on_epoch: Optional[Callable[[dict], None]] = None,
    update_learning_rate: Optional[Callable[[float, int], float]] = None,
    mesh=None,
    resume_file: Optional[str] = None,
) -> tuple[ModelParams, float]:
    """Train with early stopping + refinement restarts; returns
    (best params, best validation MRR).

    With ``mesh`` set, training is data-parallel: parameters/optimizer state
    are replicated and every batch is sharded over the mesh's first axis —
    XLA derives the gradient all-reduce and the cross-chip CCA batch
    statistics (there is no reference analog; the reference is single-GPU).

    With ``resume_file`` set, the FULL fit state (train/optimizer state,
    best snapshot, early-stop/refinement bookkeeping, curves, pool RNG
    state) is written atomically every epoch, and an existing file resumes
    the run exactly where it was killed — the continued trajectory is
    epoch-for-epoch identical to an uninterrupted run, including on
    multi-host SPMD meshes (every process restores the same snapshot).
    """
    # on multi-host meshes only process 0 writes artifacts (checkpoints,
    # results curves) — every process computes identically under SPMD, and
    # concurrent writers on a shared filesystem would race
    is_writer = jax.process_index() == 0
    if is_writer:
        os.makedirs(out_path, exist_ok=True)
    if log_file is None:
        log_file = os.path.join(out_path, "results.pkl")
    num_epochs = num_epochs or cfg.max_epochs

    optimizer = ts.make_optimizer(cfg.ini_learning_rate)
    state = ts.init_train_state(params, cfg, optimizer)
    train_step = make_train_step(cfg, optimizer)
    embed_pair, valid_loss_fn, init_cca_step = make_eval_fns(cfg)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        batch_sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
        replicated = NamedSharding(mesh, P())
        state = jax.tree.map(lambda x: jax.device_put(x, replicated), state)

        def put(x):
            return jax.device_put(jnp.asarray(x), batch_sharding)
    else:
        def put(x):
            return jnp.asarray(x)

    def say(msg, color=None):
        if verbose:
            print(col.print_colored(msg, color) if color else msg)

    say("Running Test Case: " + exp_name, BColors.UNDERLINE)

    snap = None
    do_resume = resume_file is not None and os.path.exists(resume_file)
    if jax.process_count() > 1:
        # the resume decision must be COLLECTIVE: process 0 decides and
        # broadcasts. Deciding from local file state races run_train's
        # stale-snapshot removal (process 0's os.remove vs another
        # process's exists-check) and diverges outright on per-host
        # filesystems where only the writer host has the snapshot —
        # either way processes disagree on whether pretrain runs and the
        # SPMD program desyncs (collective mismatch).
        from jax.experimental import multihost_utils

        do_resume = bool(multihost_utils.broadcast_one_to_all(
            np.int32(1 if do_resume else 0)))
        if do_resume and not os.path.exists(resume_file):
            raise RuntimeError(
                f"process {jax.process_index()} cannot see resume "
                f"snapshot {resume_file}; multi-host resume requires the "
                "snapshot on a filesystem shared by all hosts")
    if do_resume:
        with open(resume_file, "rb") as fp:
            snap = pickle.load(fp)
        assert snap.get("fit_state_version") == _FIT_STATE_VERSION, (
            f"{resume_file} has fit-state version "
            f"{snap.get('fit_state_version')}, expected {_FIT_STATE_VERSION}")
        say(f"Resuming full fit state from {resume_file} "
            f"(after epoch {snap['epoch_idx']})", BColors.WARNING)

    # CCA burn-in epochs (pretrain, reference :170-182); already done in
    # the interrupted run when resuming
    for _ in range(0 if snap is not None else cfg.pretrain_epochs):
        for x1, x2 in threaded_generator_from_iterator(
                train_batch_iter(data["train"])):
            state = init_cca_step(state, put(x1), put(x2))

    patience = cfg.patience
    refinement_steps = cfg.refinement_steps
    learn_rate = cfg.ini_learning_rate
    last_improvement = 0
    best_model = state.params(cfg)
    best_opt_state = state.opt_state
    best_epoch = 0
    prev_map_va = 0.0

    curves: Dict[str, list] = {k: [] for k in (
        "pred_tr_err", "pred_val_err", "dist_tr", "dist_val", "rank_tr",
        "rank_val", "map_tr", "map_val", "evals_tr", "lr")}

    n_valid_cca = int(min(1000, data["valid"].shape[0]))
    epoch_idx = 0
    epoch_runner = None
    fused_eval = None
    # fused evaluation runners (single-dispatch embed+score) when the pools
    # are device-resident and no mesh resharding is involved
    from audio_sheet_retrieval_tpu.data.device_pool import (
        DevicePool,
        make_embed_runner,
    )
    from audio_sheet_retrieval_tpu.parallel.sharded_pool import (
        ShardedDevicePool,
        make_sharded_embed_runner,
    )

    def _embed_builder(pool, it):
        if not hasattr(it, "epoch_entity_indices"):
            return None
        if isinstance(pool, ShardedDevicePool) and pool.mesh is mesh:
            return make_sharded_embed_runner(cfg, pool)
        if isinstance(pool, DevicePool) and pool.mesh is mesh:
            return make_embed_runner(cfg, pool)
        return None

    embed_runner_tr = _embed_builder(data["train"], train_batch_iter)
    embed_runner_va = _embed_builder(data.get("valid"), valid_batch_iter)

    if snap is not None:
        epoch_idx = int(snap["epoch_idx"])
        patience = int(snap["patience"])
        refinement_steps = int(snap["refinement_steps"])
        learn_rate = float(snap["learn_rate"])
        last_improvement = int(snap["last_improvement"])
        prev_map_va = float(snap["prev_map_va"])
        best_epoch = int(snap["best_epoch"])
        curves = snap["curves"]

        def _from_leaves(template, leaves):
            tree = jax.tree.unflatten(jax.tree.structure(template),
                                      [jnp.asarray(v) for v in leaves])
            if mesh is not None:
                tree = jax.tree.map(
                    lambda x: jax.device_put(x, replicated), tree)
            return tree

        state = _from_leaves(state, snap["state"])
        best_model = _from_leaves(best_model, snap["best_model"])
        best_opt_state = _from_leaves(best_opt_state,
                                      snap["best_opt_state"])
        for nm, obj in (("train_pool", data.get("train")),
                        ("valid_pool", data.get("valid")),
                        ("train_iter", train_batch_iter),
                        ("valid_iter", valid_batch_iter)):
            _rng_restore(obj, snap["data_state"].get(nm))

    def _write_snapshot():
        _atomic_pickle(resume_file, {
            "fit_state_version": _FIT_STATE_VERSION,
            "epoch_idx": epoch_idx, "patience": patience,
            "refinement_steps": refinement_steps,
            "learn_rate": learn_rate,
            "last_improvement": last_improvement,
            "prev_map_va": prev_map_va, "best_epoch": best_epoch,
            "curves": curves,
            "state": [_host_leaf(x) for x in jax.tree.leaves(state)],
            "best_model": [_host_leaf(x)
                           for x in jax.tree.leaves(best_model)],
            "best_opt_state": [_host_leaf(x)
                               for x in jax.tree.leaves(best_opt_state)],
            "data_state": {
                "train_pool": _rng_capture(data.get("train")),
                "valid_pool": _rng_capture(data.get("valid")),
                "train_iter": _rng_capture(train_batch_iter),
                "valid_iter": _rng_capture(valid_batch_iter),
            },
        })

    now = time.time()
    try:
        while epoch_idx < num_epochs:
            epoch_idx += 1

            # ---- train one epoch --------------------------------------------
            iterator = train_batch_iter(data["train"])
            t0 = time.time()
            if (hasattr(iterator, "epoch_entity_indices")
                    and getattr(iterator.pool, "mesh", None) is mesh):
                # fused path: the whole sub-epoch is ONE device dispatch
                # (lax.scan over batches; see device_pool.make_epoch_runner)
                if epoch_runner is None:
                    from audio_sheet_retrieval_tpu.data.device_pool import (
                        make_epoch_runner,
                    )
                    from audio_sheet_retrieval_tpu.parallel.sharded_pool import (
                        ShardedDevicePool,
                        make_sharded_epoch_runner,
                    )

                    build = (make_sharded_epoch_runner
                             if isinstance(iterator.pool, ShardedDevicePool)
                             else make_epoch_runner)
                    epoch_runner = build(cfg, optimizer, iterator.pool)
                entity_idx = iterator.epoch_entity_indices()
                state, losses_dev, corrs_dev = epoch_runner(state, entity_idx)
                batch_losses = list(np.asarray(losses_dev))
                batch_corrs = [corrs_dev.mean(axis=0)]
                n_batches = len(batch_losses)
            else:
                batch_losses, batch_corrs = [], []
                n_batches = 0
                for x1, x2 in threaded_generator_from_iterator(iterator):
                    state, m = train_step(state, put(x1), put(x2))
                    batch_losses.append(m["loss"])
                    batch_corrs.append(m["corr"])
                    n_batches += 1
                # one host sync at epoch end, not per batch
                batch_losses = [float(l) for l in batch_losses]
            tr_loss = float(np.mean(batch_losses))
            ups = n_batches / max(time.time() - t0, 1e-9)
            params_now = state.params(cfg)

            # ---- evaluation --------------------------------------------------
            if embed_runner_tr is not None and embed_runner_va is not None:
                # fully on-device: embed, CCA refit and rank/hit/MRR reduction
                # stay on the chip; the only downloads this epoch are the
                # per-batch losses and 2x8 metric scalars (make_fused_eval)
                if fused_eval is None:
                    fused_eval = make_fused_eval(cfg)
                bs = train_batch_iter.batch_size
                nb = int(np.ceil(n_valid_cca / bs))
                pool_tr = data["train"]
                if hasattr(pool_tr, "epoch_indices"):  # piece-sharded pool
                    entity_idx = pool_tr.epoch_indices(nb, bs)
                else:
                    idx = np.arange(nb * bs) % pool_tr.shape[0]
                    entity_idx = pool_tr._order[idx.reshape(nb, bs)]
                lv1_tr_d, lv2_tr_d, _ = embed_runner_tr(params_now,
                                                        entity_idx)
                va_it = valid_batch_iter(data["valid"])
                lv1_va_d, lv2_va_d, losses_va = embed_runner_va(
                    params_now, va_it.epoch_entity_indices())
                n_keep = max(n_valid_cca, va_it.batch_size)
                vec_tr, vec_va = fused_eval(lv1_tr_d, lv2_tr_d,
                                            lv1_va_d[:n_keep],
                                            lv2_va_d[:n_keep])
                va_loss = float(np.asarray(losses_va).mean())
                _, med_rank_tr, dist_tr, hit_tr, map_tr = \
                    unpack_retrieval_metrics(vec_tr)
                _, med_rank_va, dist_va, hit_va, map_va = \
                    unpack_retrieval_metrics(vec_va)
                mean_rank_tr = 1.0 - float(hit_tr[10]) / (nb * bs)
                mean_rank_va = 1.0 - float(hit_va[10]) / 1000.0
            else:
                # ---- embed train subset (fresh iterator copy, :234-246) -----
                if embed_runner_tr is not None:
                    bs = train_batch_iter.batch_size
                    nb = int(np.ceil(n_valid_cca / bs))
                    pool_tr = data["train"]
                    idx = np.arange(nb * bs) % pool_tr.shape[0]
                    entity_idx = pool_tr._order[idx.reshape(nb, bs)]
                    lv1d, lv2d, _ = embed_runner_tr(params_now, entity_idx)
                    V1_tr = np.asarray(lv1d)
                    V2_tr = np.asarray(lv2d)
                else:
                    it_copy = copy.copy(train_batch_iter)
                    it_copy.epoch_counter = 0
                    V1_tr, V2_tr = [], []
                    n_collected = 0
                    # drain the generator fully (like the reference,
                    # train_dcca_pool.py:239-246): breaking out would leave
                    # the prefetch producer thread blocked on its queue
                    for x1, x2 in threaded_generator_from_iterator(
                            it_copy(data["train"])):
                        if n_collected >= n_valid_cca:
                            continue
                        lv1, lv2 = embed_pair(params_now, put(x1), put(x2))
                        V1_tr.append(np.asarray(lv1))
                        V2_tr.append(np.asarray(lv2))
                        n_collected += lv1.shape[0]
                    V1_tr = np.vstack(V1_tr)
                    V2_tr = np.vstack(V2_tr)

                if cfg.fit_cca:
                    res = cca_ops.cca_fit(V1_tr, V2_tr, method="svd")
                    lv1_tr = np.asarray(cca_ops.cca_transform_v1(res, V1_tr))
                    lv2_tr = np.asarray(cca_ops.cca_transform_v2(res, V2_tr))
                else:
                    lv1_tr, lv2_tr = V1_tr, V2_tr
                _, med_rank_tr, dist_tr, hit_tr, map_tr = eval_retrieval(
                    lv1_tr, lv2_tr)
                mean_rank_tr = 1.0 - float(hit_tr[10]) / len(lv1_tr)

                # ---- validation (:272-299) ----------------------------------
                if embed_runner_va is not None:
                    va_it = valid_batch_iter(data["valid"])
                    entity_idx = va_it.epoch_entity_indices()
                    lv1d, lv2d, losses_va = embed_runner_va(params_now,
                                                            entity_idx)
                    va_loss = float(np.asarray(losses_va).mean())
                    V1_va = np.asarray(lv1d)[:max(n_valid_cca,
                                                  va_it.batch_size)]
                    V2_va = np.asarray(lv2d)[:max(n_valid_cca,
                                                  va_it.batch_size)]
                else:
                    V1_va, V2_va, va_losses = [], [], []
                    n_collected = 0
                    for x1, x2 in threaded_generator_from_iterator(
                            valid_batch_iter(data["valid"])):
                        vloss, lv1, lv2 = valid_loss_fn(params_now, put(x1),
                                                        put(x2))
                        va_losses.append(float(vloss))
                        if n_collected < n_valid_cca:
                            V1_va.append(np.asarray(lv1))
                            V2_va.append(np.asarray(lv2))
                            n_collected += lv1.shape[0]
                    va_loss = float(np.mean(va_losses))
                    V1_va = np.vstack(V1_va)
                    V2_va = np.vstack(V2_va)
                if cfg.fit_cca:
                    lv1_va = np.asarray(cca_ops.cca_transform_v1(res, V1_va))
                    lv2_va = np.asarray(cca_ops.cca_transform_v2(res, V2_va))
                else:
                    lv1_va, lv2_va = V1_va, V2_va
                _, med_rank_va, dist_va, hit_va, map_va = eval_retrieval(
                    lv1_va, lv2_va)
                mean_rank_va = 1.0 - float(hit_va[10]) / 1000.0

            # ---- improvement / snapshot (:387-401) --------------------------
            improvement = map_va >= prev_map_va
            if improvement:
                last_improvement = 0
                best_epoch = epoch_idx
                best_model = jax.tree.map(lambda x: x, params_now)
                best_opt_state = jax.tree.map(lambda x: x, state.opt_state)
                if dump_file is not None and is_writer:
                    uio.save_pytree(dump_file, best_model,
                                    meta={"model": cfg.name,
                                          "epoch": epoch_idx})
            last_improvement += 1

            if np.isnan(tr_loss):
                last_improvement = patience + 1

            say("Epoch %d of %d took %.3fs (patience: %d, %.2f ups)" % (
                epoch_idx, num_epochs, time.time() - now,
                patience - last_improvement + 1, ups))
            now = time.time()
            txt = "  costs_tr %.5f costs_va %.5f " % (tr_loss, va_loss)
            txt += "| map_tr %.2f map_va %.2f " % (100 * map_tr, 100 * map_va)
            txt += "| medr_tr %.2f medr_va %.2f lr %.6g" % (
                med_rank_tr, med_rank_va, learn_rate)
            say(txt, BColors.OKGREEN if map_va > prev_map_va else None)
            if map_va > prev_map_va:
                prev_map_va = map_va

            # ---- curves (:465-489) ------------------------------------------
            corr_mean = (np.asarray(jnp.stack(batch_corrs)).mean(axis=0)
                         if batch_corrs else None)
            for k, v in (("pred_tr_err", tr_loss), ("pred_val_err", va_loss),
                         ("dist_tr", dist_tr), ("dist_val", dist_va),
                         ("rank_tr", mean_rank_tr), ("rank_val", mean_rank_va),
                         ("map_tr", map_tr), ("map_val", map_va),
                         ("evals_tr", corr_mean), ("lr", learn_rate)):
                curves[k].append(v)
            if is_writer:
                uio.save_results(log_file, curves)

            if on_epoch is not None:
                on_epoch(dict(number=epoch_idx, train_loss=tr_loss,
                              valid_loss=va_loss, map_tr=map_tr,
                              map_va=map_va, med_rank_va=med_rank_va))

            # ---- early stopping / refinement (:491-520) ---------------------
            if last_improvement > patience:
                say("Early Stopping!", BColors.WARNING)
                say("Best Epoch: %d, Map: %.2f" % (best_epoch,
                                                   100 * prev_map_va),
                    BColors.WARNING)
                if refinement_steps <= 0:
                    break
                say("Loading best parameters so far and refining (%d) "
                    "with decreased learn rate ..." % refinement_steps,
                    BColors.WARNING)
                last_improvement = 0
                patience = cfg.refinement_patience
                refinement_steps -= 1
                trainable, non_trainable = ts.split_params(best_model, cfg)
                learn_rate = learn_rate * cfg.lr_multiplier
                state = ts.TrainState(
                    trainable, non_trainable,
                    ts.set_lr(jax.tree.map(lambda x: x, best_opt_state),
                              learn_rate),
                    state.step)
            else:
                # per-epoch lr hook (model.update_learning_rate — identity in
                # all shipped models, reference run_train.py:113/:522-525)
                if update_learning_rate is not None:
                    new_lr = update_learning_rate(learn_rate, epoch_idx)
                    if new_lr is not None:
                        learn_rate = float(new_lr)
                state = state._replace(
                    opt_state=ts.set_lr(state.opt_state, learn_rate))

            # full kill-and-resume snapshot: written AFTER the early-stop /
            # refinement branch so the file always holds exactly the state
            # the next loop iteration would start from
            if resume_file is not None and is_writer:
                _write_snapshot()

    except KeyboardInterrupt:
        say("\ntraining interrupted", BColors.WARNING)

    return best_model, prev_map_va
