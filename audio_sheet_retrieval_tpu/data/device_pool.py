"""Device-resident training data: pieces on device, batches gathered on device.

The reference prepares every training batch on the host (cv2 resize/crop per
sample, utils/data_pools.py:127-228) and ships ~14 MB per 100-sample batch
to the device. Here the complete dataset lives in device memory once:

  * all unrolled strips concatenated into one [H, W_total] uint8 array with
    2*context white margins between pieces (windows never cross pieces),
  * all spectrograms concatenated into one [bins, T_total] float32 array
    with context margins (edge-padded),
  * entities reduced to two int32 vectors (absolute sheet x / spec t),
    with the reference's edge behavior folded in at build time: windows of
    entities near a piece boundary center on the clipped crop center, not
    the note coordinate (data_pools.py:137-156 arithmetic).

A batch is assembled fully inside jit: contiguous dynamic-slice crops
(contiguous copies), then the random scale / vertical translation
resampling and the spec_padding frequency shift expressed as one-hot
selection matmuls — exact nearest-neighbor semantics without per-pixel
gathers (see _make_assemble).

Host->device traffic per batch: 2 x [B] int32 index vectors + a PRNG key.
MSMD-scale datasets fit comfortably (strips ~1-2 GB uint8, specs <1 GB).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.data.pools import (
    NO_AUGMENT,
    SHEET_CONTEXT,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
)


def _make_assemble(aug: Dict, ctx: int, sh: int, spec_ctx: int,
                   strip_h: int, bins: int, train: bool):
    """Build the jitted batch-assembly fn(strip, spec, coords, onsets, key).

    Windows here are CONTIGUOUS dynamic-slice crops, and the
    scale/translate resampling is expressed as two one-hot selection
    matmuls per sample — exact nearest-neighbor semantics without an
    arbitrary per-pixel gather.
    """
    sc = aug.get("sheet_scaling") if train else None
    use_scale = bool(sc) and list(sc) != [1.0, 1.0]
    t_amp = int(aug.get("system_translation", 0)) if train else 0
    o_amp = int(aug.get("onset_translation", 0)) if train else 0
    p_roll = int(aug.get("spec_padding", 0)) if train else 0
    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST

    # crop wide enough for the strongest zoom-out (scale_min) + rounding
    if use_scale:
        crop_w = int(np.ceil(ctx / sc[0])) + 4
    else:
        crop_w = ctx

    @jax.jit
    def assemble(strip, spec, coords, onsets, key):
        B = coords.shape[0]
        k_scale, k_trans, k_onset, k_roll = jax.random.split(key, 4)

        # --- sheet ----------------------------------------------------------
        starts = jnp.clip(coords - crop_w // 2, 0, strip.shape[1] - crop_w)
        crops = jax.vmap(
            lambda s: jax.lax.dynamic_slice(strip, (0, s), (strip_h, crop_w))
        )(starts).astype(f32)                       # [B, strip_h, crop_w]

        if use_scale or t_amp:
            if use_scale:
                scale = jax.random.uniform(k_scale, (B,), minval=sc[0],
                                           maxval=sc[1])
            else:
                scale = jnp.ones((B,))
            if t_amp:
                trans = jax.random.randint(k_trans, (B,), -t_amp,
                                           t_amp + 1).astype(f32)
            else:
                trans = jnp.zeros((B,), f32)
            inv_s = (1.0 / scale)[:, None]
            # one-hot row selection P: [B, sh, strip_h]
            ii = jnp.arange(sh, dtype=f32)[None, :]
            r_idx = jnp.round(strip_h / 2.0
                              + (ii - sh / 2.0 + trans[:, None]) * inv_s)
            r_idx = jnp.clip(r_idx.astype(jnp.int32), 0, strip_h - 1)
            P = (r_idx[:, :, None]
                 == jnp.arange(strip_h)[None, None, :]).astype(f32)
            # one-hot column selection Q: [B, crop_w, ctx]
            jj = jnp.arange(ctx, dtype=f32)[None, :]
            c_center = (coords - starts).astype(f32)[:, None]
            c_idx = jnp.round(c_center + (jj - ctx / 2.0) * inv_s)
            c_idx = jnp.clip(c_idx.astype(jnp.int32), 0, crop_w - 1)
            Q = (jnp.arange(crop_w)[None, :, None]
                 == c_idx[:, None, :]).astype(f32)
            sheet_batch = jnp.einsum("bis,bsw,bwj->bij", P, crops, Q,
                                     precision=hi)
        else:
            r0 = strip_h // 2 - sh // 2
            sheet_batch = crops[:, r0:r0 + sh, :]

        # --- spec: contiguous window + frequency-shift matmul ----------------
        if o_amp:
            onsets_j = onsets + jax.random.randint(k_onset, (B,), -o_amp,
                                                   o_amp + 1)
        else:
            onsets_j = onsets
        t0 = jnp.clip(onsets_j - spec_ctx // 2, 0, spec.shape[1] - spec_ctx)
        wins = jax.vmap(
            lambda t: jax.lax.dynamic_slice(spec, (0, t), (bins, spec_ctx))
        )(t0)                                        # [B, bins, spec_ctx]
        if p_roll:
            shift = jax.random.randint(k_roll, (B,), 0, p_roll) - p_roll
            ff = jnp.clip(jnp.arange(bins)[None, :] + shift[:, None], 0,
                          bins - 1)                  # [B, bins]
            Pf = (ff[:, :, None]
                  == jnp.arange(bins)[None, None, :]).astype(f32)
            spec_batch = jnp.einsum("bfs,bst->bft", Pf, wins, precision=hi)
        else:
            spec_batch = wins

        return sheet_batch[:, None, :, :], spec_batch[:, None, :, :]

    return assemble


class DevicePool:
    """Device-resident (strips, specs, entities) with jitted batch assembly."""

    def __init__(
        self,
        images: Sequence[np.ndarray],
        specs: Sequence[Sequence[np.ndarray]],
        o2c_maps: Sequence[Sequence[np.ndarray]],
        spec_context: int = SPEC_CONTEXT,
        sheet_context: int = SHEET_CONTEXT,
        staff_height: int = SYSTEM_HEIGHT,
        data_augmentation: Optional[Dict] = None,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        mesh=None,
        data_axis: str = "data",
        host_only: bool = False,
    ):
        """``mesh``: shard assembled batches (and everything downstream)
        over the mesh's ``data_axis`` — the dataset arrays are replicated
        across chips and each chip assembles its share of every batch
        (batch_size must divide by the axis size).

        ``host_only``: keep strip/spec as host numpy arrays (no device
        transfer) — for callers that only use the entity arithmetic and
        place the data themselves (parallel.sharded_pool.from_piece_loader).
        """
        self.spec_context = spec_context
        self.sheet_context = sheet_context
        self.staff_height = staff_height
        self.data_augmentation = dict(data_augmentation or NO_AUGMENT)
        self.rng = rng if rng is not None else np.random.default_rng()
        self.shuffle = shuffle
        self.mesh = mesh
        self.data_axis = data_axis

        margin_x = 2 * sheet_context
        margin_t = spec_context

        # ---- concatenate strips with white margins ---------------------------
        strip_h = max(im.shape[0] for im in images)
        parts: List[np.ndarray] = []
        sheet_offsets = []
        x = 0
        for im in images:
            pad_rows = strip_h - im.shape[0]
            im = np.pad(im, ((0, pad_rows), (0, 0)), mode="edge")
            parts.append(np.full((strip_h, margin_x), 255, np.uint8))
            x += margin_x
            sheet_offsets.append(x)
            parts.append(im.astype(np.uint8))
            x += im.shape[1]
        parts.append(np.full((strip_h, margin_x), 255, np.uint8))
        big_strip = np.concatenate(parts, axis=1)

        # ---- concatenate spectrograms with edge margins ----------------------
        bins = specs[0][0].shape[0]
        sparts: List[np.ndarray] = []
        spec_offsets: List[List[int]] = []
        t = 0
        for piece_specs in specs:
            offs = []
            for sp in piece_specs:
                sparts.append(np.repeat(sp[:, :1], margin_t, axis=1))
                t += margin_t
                offs.append(t)
                sparts.append(np.asarray(sp, np.float32))
                t += sp.shape[1]
            spec_offsets.append(offs)
        sparts.append(np.zeros((bins, margin_t), np.float32))
        big_spec = np.concatenate(sparts, axis=1)

        # ---- entity index (reference bound filtering + edge centering) -------
        coords_abs, onsets_abs = [], []
        half_c, half_o = sheet_context // 2, spec_context // 2
        for i_sheet, sheet in enumerate(images):
            W = sheet.shape[1]
            for i_spec, spec in enumerate(specs[i_sheet]):
                T = spec.shape[1]
                m = np.asarray(o2c_maps[i_sheet][i_spec])
                for onset, coord in m:
                    onset, coord = int(onset), int(coord)
                    o_start = onset - half_o
                    c_start = coord - half_c
                    c_stop = o_start + sheet_context  # reference quirk
                    if not (o_start >= 0 and o_start + spec_context < T
                            and c_start >= 0 and c_stop < W):
                        continue
                    # reference edge behavior: the window centers on the
                    # clipped 4*context crop center (data_pools.py:137-156)
                    c_eff = int(np.clip(coord, 2 * sheet_context,
                                        max(2 * sheet_context,
                                            W - 2 * sheet_context)))
                    # spec window clamp (data_pools.py:186-189)
                    o_eff = int(np.clip(onset, half_o, T - 1 - spec_context
                                        + half_o))
                    coords_abs.append(sheet_offsets[i_sheet] + c_eff)
                    onsets_abs.append(spec_offsets[i_sheet][i_spec] + o_eff)
        self.entity_coords = np.asarray(coords_abs, np.int32)
        self.entity_onsets = np.asarray(onsets_abs, np.int32)
        self.shape = [len(self.entity_coords)]
        self._order = np.arange(self.shape[0])
        if shuffle:
            self.reset_batch_generator()

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            replicated = NamedSharding(mesh, P())
            self.strip = jax.device_put(big_strip, replicated)
            self.spec = jax.device_put(big_spec, replicated)
            self._idx_sharding = NamedSharding(mesh, P(data_axis))
            self._mat_sharding = NamedSharding(mesh, P(None, data_axis))
        elif host_only:
            self.strip = big_strip
            self.spec = big_spec
            self._idx_sharding = self._mat_sharding = None
        else:
            self.strip = jax.device_put(big_strip)
            self.spec = jax.device_put(big_spec)
            self._idx_sharding = self._mat_sharding = None
        self.strip_h = strip_h
        self.bins = bins
        self._key = jax.random.PRNGKey(int(self.rng.integers(2 ** 31)))
        self._assemble = {
            True: _make_assemble(self.data_augmentation, sheet_context,
                                 staff_height, spec_context, strip_h, bins,
                                 train=True),
            False: _make_assemble(self.data_augmentation, sheet_context,
                                  staff_height, spec_context, strip_h, bins,
                                  train=False),
        }

    def reset_batch_generator(self):
        self._order = self.rng.permutation(self.shape[0])

    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _put(self, arr: np.ndarray, matrix: bool = False):
        """Upload an index array, sharded over the mesh when configured."""
        if self.mesh is None:
            return jnp.asarray(arr)
        sh = self._mat_sharding if matrix else self._idx_sharding
        return jax.device_put(np.asarray(arr), sh)

    def batch(self, idx: np.ndarray, train: bool = True):
        """Assemble a batch for entity positions ``idx`` (in the current
        shuffled order) -> device arrays ([B,1,sh,ctx] raw-range sheets,
        [B,1,bins,spec_ctx] spectrogram excerpts)."""
        sel = self._order[np.asarray(idx)]
        coords = self._put(self.entity_coords[sel])
        onsets = self._put(self.entity_onsets[sel])
        return self._assemble[train](self.strip, self.spec, coords, onsets,
                                     self.next_key())

    def __getitem__(self, key):
        """Pool-compatible slicing."""
        if isinstance(key, int):
            key = slice(key, key + 1)
        if isinstance(key, slice):
            idx = np.arange(*key.indices(self.shape[0]))
        else:
            idx = np.asarray(key)
        x1, x2 = self.batch(idx, train=True)
        return [x1, x2]


def make_epoch_runner(cfg, optimizer, pool: "DevicePool"):
    """Fused sub-epoch trainer: ONE device dispatch runs all k_samples
    batches via lax.scan (assemble + forward + CCA + loss + Adam per step).

    Amortizes per-call dispatch latency (a scanned epoch costs one
    dispatch for ~100 steps). Returns run_epoch(state, coords_mat [n, B],
    onsets_mat [n, B], key) -> (state, losses [n], corrs [n, d]).
    """
    from audio_sheet_retrieval_tpu.train.engine import make_train_step

    train_step = make_train_step(cfg, optimizer)
    assemble = pool._assemble[True]

    @jax.jit
    def run_epoch(state, strip, spec, coords_mat, onsets_mat, key):
        def body(carry, inputs):
            st, k = carry
            coords, onsets = inputs
            k, sub = jax.random.split(k)
            x1, x2 = assemble(strip, spec, coords, onsets, sub)
            st, m = train_step(st, x1, x2)
            return (st, k), (m["loss"], m["corr"])

        (state, _), (losses, corrs) = jax.lax.scan(
            body, (state, key), (coords_mat, onsets_mat))
        return state, losses, corrs

    def runner(state, entity_idx: np.ndarray, key=None):
        """entity_idx: [n_batches, B] entity indices (see
        DeviceBatchIterator.epoch_entity_indices)."""
        coords = pool._put(pool.entity_coords[entity_idx], matrix=True)
        onsets = pool._put(pool.entity_onsets[entity_idx], matrix=True)
        if key is None:
            key = pool.next_key()
        return run_epoch(state, pool.strip, pool.spec, coords, onsets, key)

    return runner


def make_embed_runner(cfg, pool: "DevicePool"):
    """Fused evaluation: ONE dispatch embeds + scores many batches.

    Returns run(params, entity_idx [n, B]) -> (lv1 [n*B, d], lv2 [n*B, d],
    per-batch losses [n]) using deterministic (eval-mode) assembly and the
    deterministic forward path — the engine's per-epoch train/valid
    embedding loops collapse from ~30 dispatches to one each.
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops import losses as loss_ops
    from audio_sheet_retrieval_tpu.train.engine import (
        prepare_view1_device,
        prepare_view2_device,
    )

    assemble = pool._assemble[False]
    loss_weight = 1.0 - cfg.weight_tno

    @jax.jit
    def run(params, strip, spec, coords_mat, onsets_mat, key):
        def body(k, inputs):
            coords, onsets = inputs
            k, sub = jax.random.split(k)
            x1, x2 = assemble(strip, spec, coords, onsets, sub)
            lv1 = cca_model.embed_view1(
                params, prepare_view1_device(x1, cfg), cfg)
            lv2 = cca_model.embed_view2(params, prepare_view2_device(x2), cfg)
            loss = loss_ops.contrastive_cos_loss(
                lv1, lv2, weight=loss_weight, gamma=cfg.gamma)
            return k, (lv1, lv2, loss)

        _, (lv1s, lv2s, losses) = jax.lax.scan(
            body, key, (coords_mat, onsets_mat))
        d = lv1s.shape[-1]
        return lv1s.reshape(-1, d), lv2s.reshape(-1, d), losses

    def runner(params, entity_idx: np.ndarray):
        coords = pool._put(pool.entity_coords[entity_idx], matrix=True)
        onsets = pool._put(pool.entity_onsets[entity_idx], matrix=True)
        return run(params, pool.strip, pool.spec, coords, onsets,
                   pool.next_key())

    return runner


def from_host_pool(pool, data_augmentation: Optional[Dict] = None,
                   rng: Optional[np.random.Generator] = None,
                   shuffle: bool = True) -> "DevicePool":
    """Lift a host AudioScoreRetrievalPool's piece data onto the device."""
    return DevicePool(
        pool.images, pool.specs, pool.o2c_maps,
        spec_context=pool.spec_context, sheet_context=pool.sheet_context,
        staff_height=pool.staff_height,
        data_augmentation=(data_augmentation
                           if data_augmentation is not None
                           else pool.data_augmentation),
        rng=rng, shuffle=shuffle)


class DeviceBatchIterator:
    """Drop-in replacement for MultiviewPoolIteratorUnsupervised over a
    DevicePool: same k_samples sub-epoch / wrap-around / reshuffle semantics,
    but yields device-resident batches (host sends only index vectors)."""

    def __init__(self, batch_size: int, k_samples: Optional[int] = None,
                 shuffle: bool = True, train: bool = True):
        self.batch_size = batch_size
        self.k_samples = k_samples
        self.shuffle = shuffle
        self.train = train
        self.epoch_counter = 0
        self.n_epochs = None

    def __call__(self, pool: DevicePool):
        self.pool = pool
        if self.k_samples is None or self.k_samples > pool.shape[0]:
            self.k_samples = pool.shape[0]
        self.n_batches = self.k_samples // self.batch_size
        self.n_epochs = max(1, pool.shape[0] // self.k_samples)
        return self

    def epoch_entity_indices(self) -> np.ndarray:
        """[n_batches, B] ENTITY indices of the NEXT sub-epoch, resolved
        through the current shuffle order BEFORE advancing the sub-epoch
        counter / reshuffling (matches what iteration would have yielded)."""
        bs = self.batch_size
        n = self.pool.shape[0]
        idx_epoch = self.epoch_counter % self.n_epochs
        base = idx_epoch * self.k_samples
        rows = []
        for i in range((self.k_samples + bs - 1) // bs):
            idx = np.arange(base + i * bs, base + (i + 1) * bs)
            rows.append(np.where(idx < n, idx, idx - n))
        entity_idx = self.pool._order[np.stack(rows)]
        self.epoch_counter += 1
        if self.shuffle and (idx_epoch + 1) == self.n_epochs:
            self.pool.reset_batch_generator()
        return entity_idx

    def __iter__(self):
        bs = self.batch_size
        n = self.pool.shape[0]
        idx_epoch = self.epoch_counter % self.n_epochs
        base = idx_epoch * self.k_samples
        for i in range((self.k_samples + bs - 1) // bs):
            idx = np.arange(base + i * bs, base + (i + 1) * bs)
            # wrap-around fill (batch_iterators.py:204-211)
            idx = np.where(idx < n, idx, idx - n)
            yield self.pool.batch(idx, train=self.train)
        self.epoch_counter += 1
        if self.shuffle and (idx_epoch + 1) == self.n_epochs:
            self.pool.reset_batch_generator()
