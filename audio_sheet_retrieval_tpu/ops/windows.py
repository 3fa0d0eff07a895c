"""Device-side window extraction over long sequences (strips, spectrograms).

The reference windows long inputs host-side with python loops
(reference:audio_sheet_server.py:216-223,465-477; audio2sheet_align.py:
112-135). Here the full unrolled strip / spectrogram stays resident in
device memory and all windows are produced by one batched gather —
uploading a piece once costs 4-16x less host->device traffic than
uploading its overlapping windows (the serving DB build uses stride
context//4).

All functions are jit-specialized on (num_windows, window); callers bucket
start counts (pad with repeated starts, drop tails host-side).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("window",))
def gather_windows(seq: jnp.ndarray, starts: jnp.ndarray, window: int):
    """[H, W] sequence + [N] starts -> [N, H, window] windows (gather)."""
    cols = starts[:, None] + jnp.arange(window)[None, :]      # [N, window]
    return jnp.transpose(seq[:, cols], (1, 0, 2))             # [N, H, window]


def gather_feature_windows(q: jnp.ndarray, starts_half: jnp.ndarray,
                           n_cols: int) -> jnp.ndarray:
    """[H4, Wq, C] dense-pooled feature plane + [N] half-res window starts
    -> [N, H4, n_cols, C] block-2 input tiles: columns s, s+2, ...,
    s+2*(n_cols-1) of the plane for each start s (one XLA gather)."""
    cols = starts_half[:, None] + 2 * jnp.arange(n_cols)[None, :]
    return jnp.transpose(q[:, cols], (1, 0, 2, 3))


def linspace_starts(total: int, window: int, n: int) -> np.ndarray:
    return np.linspace(0, total - window, num=n).astype(np.int32)


def stride_starts(total: int, window: int, stride: int) -> np.ndarray:
    return np.arange(0, total - window, stride, dtype=np.int32)


def make_strip_embedder(params, cfg, *, center_crop: int | None = None,
                        gather_half: bool = False, fullconv: bool = False):
    """Sheet-strip -> window embeddings, fully fused on device.

    Returns fn(strip_u8 [H, W], starts [N]) -> [N, dim] where the strip is
    raw uint8; the vertical center crop (server semantics,
    audio_sheet_server.py:265-271), /255 normalization, optional half
    resize ('prepare') and the encoder+CCA+L2 all run in one computation.

    Parameters are threaded as a jit ARGUMENT (never a closure): closed-over
    weight arrays would be inlined as HLO constants, bloating the program
    and its compile time.
    """
    crop_h = center_crop or cfg.input_shape_1[1]

    @jax.jit
    def embed_p(p, strip_u8: jnp.ndarray, starts: jnp.ndarray):
        return _strip_embed_core(p, strip_u8, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(strip_u8, starts):
        return embed_p(params, strip_u8, starts)

    return embed


def _strip_embed_core(p, strip, starts, cfg, packed: bool, crop_h: int,
                      gather_half: bool = False, fullconv: bool = False):
    """Traceable strip-embedding core (optionally 4-bit packed input):
    vertical center crop, window gather, 'prepare', encoder+CCA+L2.
    Compose inside larger jits (the embedders below, bench ceiling scans).

    ``gather_half`` (valid when cfg.sheet_downscale == 2): 2x2-mean-pool
    the strip ONCE and gather windows directly at half resolution — 4x
    less gather traffic, no per-window resize. Numerically identical to
    the standard path for EVEN window starts and crop offsets (the half-
    scale bilinear 'prepare' IS a 2x2 mean; serving strides context//4
    are even); odd starts are rounded down one pixel.

    ``fullconv`` (serving fast mode, implies the half-res plane): the
    first conv block (conv-BN-ELU x2 + pool) runs ONCE over the whole
    strip instead of per 75%-overlapping window — see
    _strip_embed_core_fullconv.
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.train.engine import prepare_view1_device

    if packed:
        strip = unpack_strip_4bit(strip)
    if fullconv and cfg.sheet_downscale == 2:
        return _strip_embed_core_fullconv(p, strip, starts, cfg, crop_h)
    window = cfg.input_shape_1[2]
    r0 = strip.shape[0] // 2 - crop_h // 2
    if gather_half and cfg.sheet_downscale == 2:
        # build the half plane with the SAME resize op 'prepare' uses so
        # the arithmetic (two-stage pair averaging) matches bit-for-bit
        h2, w2 = strip.shape[0] // 2, strip.shape[1] // 2
        half = jax.image.resize(
            strip.astype(jnp.float32) * (1.0 / 255.0), (h2, w2),
            method="bilinear", antialias=False)
        half = jax.lax.dynamic_slice_in_dim(half, r0 // 2, crop_h // 2,
                                            axis=0)
        wins = gather_windows(half, starts // 2, window // 2)
        return cca_model.embed_view1(p, wins[..., None], cfg)
    strip = jax.lax.dynamic_slice_in_dim(strip, r0, crop_h, axis=0)
    wins = gather_windows(strip.astype(jnp.float32), starts, window)
    x = prepare_view1_device(wins[:, None, :, :], cfg)
    return cca_model.embed_view1(p, x, cfg)


def _strip_embed_core_fullconv(p, strip, starts, cfg, crop_h: int):
    """Strip-level first-block serving fast path.

    Serving DB builds embed windows at stride context//4 — 75% overlap —
    so the per-window encoder recomputes the first conv block 4x on the
    same pixels. The convs are translation-invariant: here conv-BN-ELU x2
    run ONCE over the whole half-res strip plane; a horizontally-dense
    maxpool (window 2x2, stride (2,1)) yields a plane whose column
    j holds the pool over strip columns (j, j+1), so window start s
    (half-res, any even full-res start) gathers its block-2 input as
    columns s + 2k — exact pool-grid alignment for every stride with NO
    parity duplication. Blocks 2-9 + CCA head run per window as usual.

    Deviation vs the per-window path: a window's own conv SAME-pads its
    1-px borders with zeros (black, on a white page) while the strip conv
    sees the true neighboring pixels, so the 2 border columns of the
    50-column block-2 input differ. That is NOT a small change for trained
    weights: on synthetic strips the minimum embedding cosine to the
    per-window path is 0.995 with the tutorial checkpoint and -0.03 with
    the synthetic serving checkpoint (>= 0.999 only for random weights,
    tests/test_windows.py). Treat it as a different embedding, not an
    exact fast path.

    The eliminated block-1 overlap is the whole gain; the price is the
    feature gather (gather_feature_windows), which moves C(=24)x the bytes
    of the pixel gather. Extending the strip computation past block 2 is
    blocked by pool-grid alignment (serving stride 25 at half-res is not
    divisible by the stride-4 feature grid).
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models import encoder as enc

    dt = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    window = cfg.input_shape_1[2]
    r0 = strip.shape[0] // 2 - crop_h // 2
    h2_, w2_ = strip.shape[0] // 2, strip.shape[1] // 2
    half = jax.image.resize(
        strip.astype(jnp.float32) * (1.0 / 255.0), (h2_, w2_),
        method="bilinear", antialias=False)
    half = jax.lax.dynamic_slice_in_dim(half, r0 // 2, crop_h // 2, axis=0)

    blocks = p.view1["blocks"]
    h = half[None, :, :, None]
    for i in (0, 1):
        h = enc._conv(h, blocks[i]["w"], dt, cfg.conv_precision)
        h = (h - blocks[i]["mean"]) * (blocks[i]["inv_std"]
                                       * blocks[i]["gamma"]) + blocks[i]["beta"]
        h = jax.nn.elu(h)
    # horizontally-dense pool: [1, H/2, W2, C] -> [H/4, W2-1, C]; the
    # window gather moves C(=24)x the bytes of the pixel gather, so the
    # plane is gathered at the compute dtype (bf16 halves the traffic;
    # the next conv casts to it anyway)
    q = jax.lax.reduce_window(
        h, -jnp.inf, jax.lax.max,
        window_dimensions=(1, 2, 2, 1), window_strides=(1, 2, 1, 1),
        padding="VALID")[0].astype(dt)
    n_cols = window // 2 // 2  # block-2 window width
    h = gather_feature_windows(q, starts // 2, n_cols)
    for i in range(2, enc.N_CONV_BLOCKS):
        h = enc._conv(h, blocks[i]["w"], dt, cfg.conv_precision)
        h = (h - blocks[i]["mean"]) * (blocks[i]["inv_std"]
                                       * blocks[i]["gamma"]) + blocks[i]["beta"]
        if i < enc.N_CONV_BLOCKS - 1:
            h = jax.nn.elu(h)
            if i % 2 == 1:
                h = enc._maxpool2(h)
    h1 = jnp.mean(h, axis=(1, 2)).astype(jnp.float32)
    lv1 = (h1 - p.cca.mean1).dot(p.cca.U,
                                     precision=jax.lax.Precision.HIGHEST)
    return cca_model.length_norm(lv1)


def pack_strip_4bit(strip_u8: np.ndarray) -> np.ndarray:
    """Pack a [H, W] uint8 sheet strip to 4 bits/pixel ([H, W/2] uint8).

    Sheet images are near-binary; 16 gray levels change embeddings less than
    bfloat16 compute does (measured with the reference checkpoint: pairwise
    cosine >= 0.99996 vs full precision) while halving the dominant
    host->device stream. Odd widths drop the last column.
    """
    s = np.asarray(strip_u8, np.uint8)
    w2 = (s.shape[1] // 2) * 2
    codes = (s[:, :w2].astype(np.uint16) + 8) // 17  # round(v/17)
    codes = np.minimum(codes, 15).astype(np.uint8)
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def unpack_strip_4bit(packed: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of pack_strip_4bit -> [H, 2*Wp] uint8 values."""
    hi = (packed >> 4) * jnp.uint8(17)
    lo = (packed & jnp.uint8(0xF)) * jnp.uint8(17)
    h, wp = packed.shape
    return jnp.stack([hi, lo], axis=2).reshape(h, 2 * wp)


def make_strip_embedder_packed(params, cfg, *, center_crop: int | None = None,
                               gather_half: bool = False,
                               fullconv: bool = False):
    """4-bit-packed variant of make_strip_embedder: the host uploads the
    packed strip (half the bytes); unpacking fuses into the same program."""
    crop_h = center_crop or cfg.input_shape_1[1]

    @jax.jit
    def embed_p(p, packed: jnp.ndarray, starts: jnp.ndarray):
        return _strip_embed_core(p, packed, starts, cfg, True, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(packed, starts):
        return embed_p(params, packed, starts)

    return embed


RLE_PAD_RUNS = 4096  # bucket run counts to limit jit respecialization


def rle_encode_strip(strip_u8: np.ndarray, pad_to: int = RLE_PAD_RUNS):
    """LOSSLESS run-length encoding of a [H, W] uint8 sheet strip for the
    host->device wire: row-major runs as (value uint8, length uint16) pairs,
    runs longer than 65535 split, run count padded to a multiple of
    ``pad_to`` with zero-length runs (dropped by the device decoder).

    Sheet strips are ink-on-white: measured 0.17 B/px on the real tutorial
    page and 0.03 B/px on rendered score strips, vs 0.5 B/px for the lossy
    4-bit packing — a 3-20x wire reduction with bit-identical pixels.

    Trade-off: this is the most compact coding but its device decode runs
    a per-pixel binary search (log2(R) full-size gather passes). The default
    serving coding is rle_bitmap_encode_strip — ~20% more wire bytes,
    >10x faster decode. Use the pair coding only on bandwidth-starved
    links where wire dominates decode.

    Returns (values [R] uint8, lengths [R] uint16).
    """
    flat = np.asarray(strip_u8, np.uint8).reshape(-1)
    if flat.size == 0:
        raise ValueError("empty strip")
    boundaries = np.nonzero(np.diff(flat))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [flat.size]])
    values = flat[starts]
    lengths = ends - starts
    if lengths.max() > 0xFFFF:  # split over-long runs (vectorized: white
        # margins make >65535-px runs near-universal on real strips)
        n_parts = (lengths + 0xFFFE) // 0xFFFF
        values = np.repeat(values, n_parts)
        split_lens = np.full(int(n_parts.sum()), 0xFFFF, np.int64)
        last = np.cumsum(n_parts) - 1  # each run's final chunk gets the rest
        split_lens[last] = lengths - 0xFFFF * (n_parts - 1)
        lengths = split_lens
    r = len(values)
    r_pad = ((r + pad_to - 1) // pad_to) * pad_to
    values = np.pad(values, (0, r_pad - r)).astype(np.uint8)
    lengths = np.pad(lengths, (0, r_pad - r)).astype(np.uint16)
    return values, lengths


def rle_decode_device(values: jnp.ndarray, lengths: jnp.ndarray,
                      h: int, w: int) -> jnp.ndarray:
    """Device-side inverse of rle_encode_strip -> [h, w] uint8.

    Gather-only: a cumsum over the run lengths gives each
    run's exclusive end; the run index of every output pixel is an unrolled
    binary search (log2(R) vectorized gathers) over those ends; one final
    gather reads the values. No scatter and no full-length scan. Zero-length
    padding runs sort to the end and are never selected.
    """
    n = h * w
    ends = jnp.cumsum(lengths.astype(jnp.int32))
    run_of = jnp.searchsorted(ends, jnp.arange(n, dtype=jnp.int32),
                              side="right", method="scan_unrolled")
    return values[run_of].reshape(h, w)


def rle_bitmap_encode_strip(strip_u8: np.ndarray, pad_to: int = RLE_PAD_RUNS):
    """LOSSLESS sheet coding tuned for DECODE SPEED: a 1-bit-per-pixel
    run-start bitmap plus the per-run values.

    Wire cost = 0.125 B/px + runs/px bytes (~0.17 B/px on real engraving —
    slightly above the (values, lengths) pair coding's 0.14, still 3x under
    4-bit packing) but the device decode is one bit-unpack, one native
    cumsum and one value gather — no scatter and no per-pixel binary
    search (the pair coding's searchsorted decode does log2(R) full-size
    gather passes).

    Returns (bitmap uint8 [ceil(N/8)], values uint8 [R_pad]).
    """
    flat = np.asarray(strip_u8, np.uint8).reshape(-1)
    if flat.size == 0:
        raise ValueError("empty strip")
    is_start = np.empty(flat.size, np.uint8)
    is_start[0] = 1
    np.not_equal(flat[1:], flat[:-1], out=is_start[1:].view(bool))
    values = flat[is_start.astype(bool)]
    r = len(values)
    r_pad = ((r + pad_to - 1) // pad_to) * pad_to
    values = np.pad(values, (0, r_pad - r))
    bitmap = np.packbits(is_start)  # big-endian bit order
    return bitmap, values


def rle_bitmap_decode_device(bitmap: jnp.ndarray, values: jnp.ndarray,
                             h: int, w: int) -> jnp.ndarray:
    """Device-side inverse of rle_bitmap_encode_strip -> [h, w] uint8."""
    n = h * w
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # packbits bit order
    bits = (bitmap[:, None] >> shifts[None, :]) & jnp.uint8(1)
    run_of = jnp.cumsum(bits.reshape(-1)[:n].astype(jnp.int32)) - 1
    return values[run_of].reshape(h, w)


RLE_BLOCK = 512  # pixels per blocked-decode tile (one row-major span)
# static local-run buckets (jit keys). A RLE_BLOCK-px tile can span at
# most RLE_BLOCK runs, so the 512 bucket makes the blocked decode
# universal — no payload ever falls back to the serial per-pixel gather.
# 384 exists because real dense engraving lands there at the LEVEL-2
# bitmap (bench corpus: k2 = 379 while the pixel level fits 256; without
# it the whole plan fell back to the gather decode).
RLE_BLOCK_KS = (32, 64, 128, 256, 384, 512)


def rle_bitmap_decode_device_blocked(bitmap: jnp.ndarray,
                                     values: jnp.ndarray, h: int, w: int,
                                     k: int) -> jnp.ndarray:
    """Blocked inverse of rle_bitmap_encode_strip -> [h, w] uint8.

    The plain decode's per-pixel ``values[run_of]`` is a million-index
    random gather. This variant exploits that ``run_of`` is
    NON-DECREASING: a tile of RLE_BLOCK consecutive pixels spans at most a
    few runs, so each tile gathers one small contiguous slice
    ``values[base : base+k]`` (a window gather — the fast primitive this
    module is built on) and resolves pixels with a k-step select-accumulate
    over dense [tiles, RLE_BLOCK] planes — no random gather at all.

    ``k`` must bound the number of runs any tile spans; compute it host-
    side with rle2_block_plan. Bit-identical to rle_bitmap_decode_device
    for any sufficient k (tests/test_windows.py).

    The per-tile run table is NOT gathered: the values are laid out as a
    DENSE strided grid (rows of ``s`` values, window k+s built from
    k/s+1 static shifted slices — no gather) and each tile selects its
    grid row by a one-hot bf16 MATMUL. Whether this beats the plain
    gather decode on the GPU is not measured.
    Exact: one nonzero per one-hot row, u8 values are exact in bf16,
    accumulation forced f32.
    """
    n = h * w
    blk = RLE_BLOCK
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # packbits bit order
    bits = (bitmap[:, None] >> shifts[None, :]) & jnp.uint8(1)
    run_of = jnp.cumsum(bits.reshape(-1)[:n].astype(jnp.int32)) - 1
    n_tiles = -(-n // blk)
    run_p = jnp.pad(run_of, (0, n_tiles * blk - n))
    r2d = run_p.reshape(n_tiles, blk)
    base = r2d[:, 0]
    s = min(128, k)                          # grid row stride
    width = k + s                            # covers local offsets < k+s-1
    g_of = base // s
    local = r2d - (g_of * s)[:, None]        # in [0, width) for real px
    r_pad = values.shape[0]
    n_rows = -(-r_pad // s)                  # ceil: every g_of < n_rows
    r_rows = width // s
    vp = jnp.pad(values, (0, (n_rows + r_rows) * s - r_pad))
    w2 = vp.reshape(n_rows + r_rows, s)
    grid = jnp.concatenate([w2[i:i + n_rows] for i in range(r_rows)],
                           axis=1)           # [n_rows, width], no gather
    oh = (g_of[:, None] == jnp.arange(n_rows)[None, :]).astype(jnp.bfloat16)
    tab = jnp.dot(oh, grid.astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32).astype(jnp.uint8)

    def body(acc, kk):
        acc = acc + jnp.where(local == kk, tab[:, kk][:, None],
                              jnp.uint8(0))
        return acc, None

    acc, _ = jax.lax.scan(body, jnp.zeros_like(local, dtype=jnp.uint8),
                          jnp.arange(width, dtype=jnp.int32))
    return acc.reshape(-1)[:n].reshape(h, w)


def _max_tile_span(bits_u8: np.ndarray, n: int, blk: int = RLE_BLOCK):
    """Host: max number of runs any blk-px tile of the decode touches."""
    run_of = np.cumsum(bits_u8[:n].astype(np.int64)) - 1
    n_tiles = -(-n // blk)
    run_p = np.pad(run_of, (0, n_tiles * blk - n), mode="edge")
    r2d = run_p.reshape(n_tiles, blk)
    return int((r2d[:, -1] - r2d[:, 0]).max()) + 1


def rle2_block_plan(bm2: np.ndarray, vals2: np.ndarray, values: np.ndarray,
                    n: int, buckets=RLE_BLOCK_KS):
    """Host-side decode plan for a two-level payload: the smallest
    (k1, k2) buckets that make the blocked decode exact for this strip —
    or None when some tile spans more runs than the largest bucket (the
    caller then uses the plain gather decode; lossless either way).
    With the default buckets None cannot happen: the ladder ends at
    512 = RLE_BLOCK and a tile can never span more runs than its pixel
    count, so every payload gets a blocked plan.

    Works from the WIRE alone so sharded ingest (parallel/gallery.py) can
    plan without the original pixels. Cost: one numpy expand of the
    level-1 bitmap (~n/8 bytes).
    """
    nb = (n + 7) // 8
    bits2 = np.unpackbits(np.asarray(bm2))[:nb]
    k2 = _max_tile_span(bits2, nb)
    bitmap = np.asarray(vals2)[np.cumsum(bits2.astype(np.int64)) - 1]
    bits1 = np.unpackbits(bitmap)[:n]
    k1 = _max_tile_span(bits1, n)
    plan = []
    for need in (k1, k2):
        fit = [b for b in buckets if b >= need]
        if not fit:
            return None
        plan.append(fit[0])
    return tuple(plan)


def rle2_corpus_block_plan(encs, n: int, buckets=RLE_BLOCK_KS):
    """Decode plan covering a whole corpus of (bm2, vals2, values)
    payloads sharing one strip pixel count ``n``: the per-level max of the
    per-piece plans (one jit specialization serves every piece), or None
    if any piece needs the plain decode."""
    k1 = k2 = 0
    for bm2, vals2, values in encs:
        plan = rle2_block_plan(bm2, vals2, values, n, buckets)
        if plan is None:
            return None
        k1, k2 = max(k1, plan[0]), max(k2, plan[1])
    return (k1, k2)


def rle_bitmap2_encode_strip(strip_u8: np.ndarray,
                             pad_to: int = RLE_PAD_RUNS):
    """Two-level LOSSLESS sheet coding: the level-1 run-start bitmap
    (rle_bitmap_encode_strip) has a hard 1-bit/px floor even over white
    margins, but its BYTES are highly runny (long all-zero stretches), so
    the bitmap itself is bitmap-RLE'd recursively with the same codec.

    Measured on the real-engraving bench strip: 0.109 B/px vs 0.184 for
    level-1 (level-2 bitmap 1/64 bit/px + byte-run values + the level-1
    run colors) — 41% less sheet wire; the device decode adds ONE extra
    cumsum+gather pass at N/8 elements (~0.5% of the pixel-level work).

    Returns (bm2 uint8 [ceil(N/64)], vals2 uint8 [R2_pad],
    values uint8 [R1_pad]).
    """
    bitmap, values = rle_bitmap_encode_strip(strip_u8, pad_to)
    bm2, vals2 = rle_bitmap_encode_strip(bitmap.reshape(1, -1), pad_to)
    return bm2, vals2, values


def rle_bitmap2_decode_device(bm2: jnp.ndarray, vals2: jnp.ndarray,
                              values: jnp.ndarray, h: int, w: int,
                              block_k=None) -> jnp.ndarray:
    """Device-side inverse of rle_bitmap2_encode_strip -> [h, w] uint8.

    ``block_k``: optional (k1, k2) from rle2_block_plan — routes both
    levels through the blocked select-accumulate decode (no per-pixel
    random gather; bit-identical). None keeps
    the plain gather decode (always exact, any payload).
    """
    nb = (h * w + 7) // 8
    if block_k is None:
        bitmap = rle_bitmap_decode_device(bm2, vals2, 1, nb).reshape(-1)
        return rle_bitmap_decode_device(bitmap, values, h, w)
    k1, k2 = block_k
    bitmap = rle_bitmap_decode_device_blocked(bm2, vals2, 1, nb,
                                              k2).reshape(-1)
    return rle_bitmap_decode_device_blocked(bitmap, values, h, w, k1)


def make_strip_embedder_rle_bitmap2(params, cfg, strip_shape,
                                    *, center_crop: int | None = None,
                                    gather_half: bool = False,
                                    fullconv: bool = False,
                                    block_k=None):
    """Two-level bitmap-RLE strip embedder (see rle_bitmap2_encode_strip):
    both decode levels fuse with crop/gather/prepare/encoder."""
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_p(p, bm2, vals2, values, starts):
        strip = rle_bitmap2_decode_device(bm2, vals2, values, h, w,
                                          block_k)
        return _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(bm2, vals2, values, starts):
        return embed_p(params, bm2, vals2, values, starts)

    return embed


def make_strip_embedder_rle_bitmap2_batched(params, cfg, strip_shape,
                                            *, center_crop: int
                                            | None = None,
                                            gather_half: bool = False,
                                            fullconv: bool = False,
                                            block_k=None):
    """Corpus-batched two-level variant: stacked [P, ...] payloads upload
    in one transfer each; per-piece embeds select their row on device."""
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_p(p, bm2_all, vals2_all, values_all, idx, starts):
        bm2 = jax.lax.dynamic_index_in_dim(bm2_all, idx, keepdims=False)
        v2 = jax.lax.dynamic_index_in_dim(vals2_all, idx, keepdims=False)
        v1 = jax.lax.dynamic_index_in_dim(values_all, idx, keepdims=False)
        strip = rle_bitmap2_decode_device(bm2, v2, v1, h, w, block_k)
        return _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(bm2_all, vals2_all, values_all, idx, starts):
        return embed_p(params, bm2_all, vals2_all, values_all,
                       jnp.int32(idx), starts)

    return embed


def make_corpus_sheet_embedder_rle_bitmap2(params, cfg, strip_shape,
                                           *, center_crop: int
                                           | None = None,
                                           gather_half: bool = False,
                                           fullconv: bool = False,
                                           block_k=None):
    """ONE-dispatch corpus sheet embed: `lax.scan` over the stacked
    [P, ...] rle2 wire components decodes + embeds EVERY piece inside a
    single device program -> [P, n_windows, dim].

    Why this exists: a DB build of per-piece dispatches
    (make_strip_embedder_rle_bitmap2_batched) pays the per-dispatch
    latency once per piece. The scan collapses the build to one
    dispatch; outputs are bit-identical to the per-piece program
    (tests/test_windows.py). Memory: one decoded strip
    + one piece's gathered windows live at a time (scan carries nothing).
    """
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_all(p, bm2_all, vals2_all, values_all, starts):
        def body(_, wire):
            bm2, v2, v1 = wire
            strip = rle_bitmap2_decode_device(bm2, v2, v1, h, w, block_k)
            out = _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                    gather_half, fullconv)
            return 0, out
        _, codes = jax.lax.scan(body, 0,
                                (bm2_all, vals2_all, values_all))
        return codes  # [P, n_windows, dim]

    params = jax.device_put(params)

    def embed(bm2_all, vals2_all, values_all, starts):
        return embed_all(params, bm2_all, vals2_all, values_all, starts)

    return embed


def make_corpus_spec_embedder(params, cfg, *, quantized: bool = False):
    """ONE-dispatch corpus audio embed (the spec mirror of
    make_corpus_sheet_embedder_rle_bitmap2): scan over stacked
    [P, bins, T] spectrograms (f32, or u8/u16 codes + [P] scales) ->
    [P, n_windows, dim]."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]

    @jax.jit
    def embed_all(p, specs_all, scales_all, starts):
        def body(_, xs):
            spec, scale = xs
            spec = (spec_dequantize_device(spec, scale) if quantized
                    else spec.astype(jnp.float32))
            wins = gather_windows(spec, starts, window)
            x = prepare_view2_device(wins[:, None, :, :])
            return 0, cca_model.embed_view2(p, x, cfg)
        _, codes = jax.lax.scan(body, 0, (specs_all, scales_all))
        return codes

    params = jax.device_put(params)

    def embed(specs_all, scales_all, starts):
        if quantized:
            assert scales_all is not None, \
                "quantized=True requires the per-piece scales array"
        return embed_all(params, specs_all,
                         jnp.zeros(specs_all.shape[0], jnp.float32)
                         if scales_all is None else scales_all, starts)

    return embed


def make_strip_embedder_rle(params, cfg, strip_shape,
                            *, center_crop: int | None = None,
                            gather_half: bool = False,
                            fullconv: bool = False):
    """Lossless-RLE variant of make_strip_embedder: the host uploads
    (values, lengths) from rle_encode_strip; decode fuses into the same
    program as crop/gather/prepare/encoder. ``strip_shape`` (H, W) is static
    (one compile per strip geometry, like the other embedders)."""
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_p(p, values: jnp.ndarray, lengths: jnp.ndarray,
                starts: jnp.ndarray):
        strip = rle_decode_device(values, lengths, h, w)
        return _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(values, lengths, starts):
        return embed_p(params, values, lengths, starts)

    return embed


def make_strip_embedder_rle_batched(params, cfg, strip_shape,
                                    *, center_crop: int | None = None,
                                    gather_half: bool = False,
                                    fullconv: bool = False):
    """Corpus-batched RLE variant: ALL pieces' (values, lengths) payloads
    are stacked to [P, R] and uploaded in ONE transfer each; per-piece
    embedding selects its row on device. On high-latency links this
    amortizes the per-transfer cost that dominates when compressed
    payloads are small — same per-piece compute as
    make_strip_embedder_rle."""
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_p(p, vals_all, lens_all, idx, starts):
        v = jax.lax.dynamic_index_in_dim(vals_all, idx, keepdims=False)
        l = jax.lax.dynamic_index_in_dim(lens_all, idx, keepdims=False)
        strip = rle_decode_device(v, l, h, w)
        return _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(vals_all, lens_all, idx, starts):
        return embed_p(params, vals_all, lens_all, jnp.int32(idx), starts)

    return embed


def make_audio_embedder_mulaw_batched(params, cfg, processor):
    """Corpus-batched mu-law variant: all pieces' companded signals stack
    to [P, S] u8, uploaded once; per-piece embedding indexes its row on
    device (see make_strip_embedder_rle_batched)."""

    @functools.partial(jax.jit, static_argnames=("num_frames",))
    def embed_p(p, fb, win_fn, signals_all, idx, starts, num_frames: int):
        signal_u8 = jax.lax.dynamic_index_in_dim(signals_all, idx,
                                                 keepdims=False)
        return _mulaw_audio_embed_core(p, fb, win_fn, signal_u8, starts,
                                       num_frames, cfg, processor)

    params = jax.device_put(params)
    fb = processor.filterbank
    win_arr = processor._window

    def embed(signals_all, idx, starts, num_frames):
        return embed_p(params, fb, win_arr, signals_all, jnp.int32(idx),
                       starts, num_frames)

    return embed


def rans_encode_corpus_strips(strips, pad_to: int = RLE_PAD_RUNS):
    """Entropy-coded corpus sheet wire: two-level bitmap-RLE components
    (rle_bitmap2_encode_strip) compressed by interleaved-stream rANS
    (ops/rans.py) — ~0.070 B/px on the bench engraving vs rle2's 0.109,
    still bit-exactly lossless.

    All strips must share one [H, W] shape (pad first; the bench and the
    device DB build already bucket). The three component stacks (level-2
    bitmap, level-2 values, run colors) are padded to corpus-max lengths
    and rANS-coded per piece with per-component adaptive tables.

    Returns (payload, lens, piece_bytes):
      payload: 3 per-component (freqs [P,256] u16, states [P,S] u32,
               words [P,Wmax] u16) triples,
      lens: the 3 component lengths (static decode shapes),
      piece_bytes: honest per-piece wire bytes (actual words, not the
               stack padding).

    Decode = make_corpus_rans_decoder(lens) -> the component stacks, fed
    unchanged into make_strip_embedder_rle_bitmap2_batched. The decode
    runs ONE scan per component over [P, S] lanes — a bandwidth-starved-
    link recipe: it wins end-to-end only when the link is slower than the
    decode (bench.py reports both arms).
    """
    from audio_sheet_retrieval_tpu.ops import rans

    shapes = {s.shape for s in strips}
    if len(shapes) != 1:
        raise ValueError(f"strips must share one shape, got {shapes}")
    encs = [rle_bitmap2_encode_strip(s, pad_to) for s in strips]
    lens = (encs[0][0].size,
            max(e[1].size for e in encs),
            max(e[2].size for e in encs))
    stacks = (
        [e[0] for e in encs],
        [np.pad(e[1], (0, lens[1] - e[1].size)) for e in encs],
        [np.pad(e[2], (0, lens[2] - e[2].size)) for e in encs],
    )
    enc = [rans.rans_encode_batch(c) for c in stacks]
    payload = tuple(e[:3] for e in enc)
    piece_bytes = [
        int(sum(enc[k][0].shape[1] * 2 + enc[k][1].shape[1] * 4
                + enc[k][3][p] * 2 for k in range(3)))
        for p in range(len(strips))]
    return payload, lens, piece_bytes


def make_corpus_rans_decoder(lens):
    """One-dispatch device decode of rans_encode_corpus_strips payloads ->
    (bm2_all, vals2_all, values_all) uint8 [P, n] stacks (the exact inputs
    of make_strip_embedder_rle_bitmap2_batched)."""
    from audio_sheet_retrieval_tpu.ops import rans

    n0, n1, n2 = (int(x) for x in lens)

    @jax.jit
    def decode(f0, s0, w0, f1, s1, w1, f2, s2, w2):
        return (rans.rans_decode_batch_device(f0, s0, w0, n0),
                rans.rans_decode_batch_device(f1, s1, w1, n1),
                rans.rans_decode_batch_device(f2, s2, w2, n2))

    def run(payload):
        (f0, s0, w0), (f1, s1, w1), (f2, s2, w2) = payload
        return decode(jnp.asarray(f0), jnp.asarray(s0), jnp.asarray(w0),
                      jnp.asarray(f1), jnp.asarray(s1), jnp.asarray(w1),
                      jnp.asarray(f2), jnp.asarray(s2), jnp.asarray(w2))

    return run


def rle_bitmap_encode_padded(strip_u8: np.ndarray, width_bucket: int = 4096):
    """Pad a strip (white) to a width-bucket multiple and bitmap-RLE encode
    it: -> (bitmap, values, (h, w_padded)). One compile per (h, bucketed
    width) for the consumers' jitted programs; shared by the device DB
    build and the fused sheet query."""
    s = np.asarray(strip_u8, np.uint8)
    wb = max(1, int(np.ceil(s.shape[1] / width_bucket))) * width_bucket
    padded = np.full((s.shape[0], wb), 255, np.uint8)
    padded[:, :s.shape[1]] = s
    bm, vals = rle_bitmap_encode_strip(padded)
    return bm, vals, (s.shape[0], wb)


def rle_bitmap2_encode_padded(strip_u8: np.ndarray,
                              width_bucket: int = 4096):
    """Width-bucketed two-level coding (see rle_bitmap_encode_padded):
    -> (bm2, vals2, values, (h, w_padded))."""
    s = np.asarray(strip_u8, np.uint8)
    wb = max(1, int(np.ceil(s.shape[1] / width_bucket))) * width_bucket
    padded = np.full((s.shape[0], wb), 255, np.uint8)
    padded[:, :s.shape[1]] = s
    bm2, vals2, values = rle_bitmap2_encode_strip(padded)
    return bm2, vals2, values, (s.shape[0], wb)


def make_strip_embedder_rle_bitmap(params, cfg, strip_shape,
                                   *, center_crop: int | None = None,
                                   gather_half: bool = False,
                                   fullconv: bool = False):
    """Bitmap-RLE strip embedder (see rle_bitmap_encode_strip): fast
    on-device decode fused with crop/gather/prepare/encoder."""
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_p(p, bitmap, values, starts):
        strip = rle_bitmap_decode_device(bitmap, values, h, w)
        return _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(bitmap, values, starts):
        return embed_p(params, bitmap, values, starts)

    return embed


def make_strip_embedder_rle_bitmap_batched(params, cfg, strip_shape,
                                           *, center_crop: int | None = None,
                                           gather_half: bool = False,
                                           fullconv: bool = False):
    """Corpus-batched bitmap-RLE embedder: stacked [P, N/8] bitmaps +
    [P, R] values upload in one transfer each; per-piece embeds select
    their row on device (amortizes per-transfer RPC latency)."""
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])

    @jax.jit
    def embed_p(p, bitmaps_all, values_all, idx, starts):
        bm = jax.lax.dynamic_index_in_dim(bitmaps_all, idx, keepdims=False)
        v = jax.lax.dynamic_index_in_dim(values_all, idx, keepdims=False)
        strip = rle_bitmap_decode_device(bm, v, h, w)
        return _strip_embed_core(p, strip, starts, cfg, False, crop_h,
                                 gather_half, fullconv)

    params = jax.device_put(params)

    def embed(bitmaps_all, values_all, idx, starts):
        return embed_p(params, bitmaps_all, values_all, jnp.int32(idx),
                       starts)

    return embed


def make_spec_embedder(params, cfg):
    """Spectrogram [bins, T] -> window embeddings, fused on device."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]

    @jax.jit
    def embed_p(p, spec: jnp.ndarray, starts: jnp.ndarray):
        wins = gather_windows(spec, starts, window)
        x = prepare_view2_device(wins[:, None, :, :])
        return cca_model.embed_view2(p, x, cfg)

    params = jax.device_put(params)

    def embed(spec, starts):
        return embed_p(params, spec, starts)

    return embed


def spec_quantize(spec: np.ndarray, bits: int = 8):
    """Quantize a log-filterbank spectrogram for the host->device wire.

    The spectrogram-upload serving mode (the reference's own architecture:
    host madmom DSP, precomputed ``*_spec.npy`` uploads —
    reference:audio_sheet_server.py:632-636) cuts the audio wire term from
    22 kB/s (mu-law waveform) to 7.4 kB/s (f32 spec) and further to
    1.8/3.7 kB/s with this u8/u16 log-magnitude quantization: values are
    ``log10(1+filtered) >= 0``, scaled by the per-payload max into the
    integer range. A/B on the reference checkpoint + recording:
    tests/test_windows.py + PARITY.md.

    Returns (codes uint8|uint16 [bins, T], scale float32).
    """
    assert bits in (8, 16), bits
    s = np.asarray(spec, np.float32)
    scale = float(s.max()) if s.size else 0.0
    if scale <= 0.0:
        scale = 1.0
    maxcode = (1 << bits) - 1
    codes = np.round(s * (maxcode / scale))
    codes = np.clip(codes, 0, maxcode)
    return codes.astype(np.uint8 if bits == 8 else np.uint16), \
        np.float32(scale)


def spec_dequantize_device(codes: jnp.ndarray, scale) -> jnp.ndarray:
    """Device-side inverse of spec_quantize -> float32 [bins, T]."""
    maxcode = float(jnp.iinfo(codes.dtype).max)
    return codes.astype(jnp.float32) * (scale / maxcode)


def spec_rans_encode_corpus(specs):
    """Entropy-coded corpus audio wire: the spec-u8 codes (spec_quantize)
    compressed by interleaved-stream rANS (ops/rans.py), per piece coding
    either the raw codes or their time-delta (mod 256) — whichever
    measures the lower order-0 byte entropy. Music spectrograms are
    time-smooth, so delta usually wins on real content (the vendored
    tutorial recording: 0.56 B/B delta vs 0.71 raw); on noise-like content
    delta loses and raw order-0 still saves ~13% (bench content).
    Lossless over the u8 codes, so embeddings are bit-identical to the
    plain specu8 upload.

    All specs must share one [bins, T] shape (equal-length audio; the
    bench and device DB builds already bucket). Returns
    (payload, flags, scales, shape, piece_bytes):
      payload: (freqs u16[P,256], states u32[P,S], words u16[P,Wmax]),
      flags:   uint8[P], 1 = delta-coded (decode applies a mod-256
               time cumsum),
      scales:  float32[P] dequantization scales,
      shape:   (bins, T) static decode shape,
      piece_bytes: honest per-piece wire bytes (real words + table +
               states + scale + flag, not the stack padding).

    Decode = make_corpus_spec_rans_decoder(shape) -> uint8 codes
    [P, bins, T] on device, fed with ``scales`` straight into
    make_spec_embedder_batched(quantized=True). u8 only: rANS codes a
    byte alphabet, and the hard-corpus sweep (scripts/accuracy_sweep.py)
    gated u8 == u16 in every cell.
    """
    from audio_sheet_retrieval_tpu.ops import rans

    shapes = {np.asarray(s).shape for s in specs}
    if len(shapes) != 1:
        raise ValueError(f"specs must share one shape, got {shapes}")
    bins, T = shapes.pop()

    def entropy_bits(arr):
        c = np.bincount(arr.ravel(), minlength=256).astype(np.float64)
        p = c[c > 0] / arr.size
        return float(-(p * np.log2(p)).sum()) * arr.size

    chosen, flags, scales = [], [], []
    for s in specs:
        codes, scale = spec_quantize(s, bits=8)
        c16 = codes.astype(np.int16)
        delta = (np.diff(c16, axis=1,
                         prepend=np.zeros((bins, 1), np.int16))
                 & 0xFF).astype(np.uint8)
        use_delta = entropy_bits(delta) < entropy_bits(codes)
        chosen.append(delta if use_delta else codes)
        flags.append(1 if use_delta else 0)
        scales.append(scale)
    freqs, states, words, n_words = rans.rans_encode_batch(chosen)
    piece_bytes = [int(freqs.shape[1] * 2 + states.shape[1] * 4
                       + nw * 2 + 4 + 1) for nw in n_words]
    return ((freqs, states, words), np.asarray(flags, np.uint8),
            np.asarray(scales, np.float32), (bins, T), piece_bytes)


def spec_undelta_device(codes: jnp.ndarray,
                        flags: jnp.ndarray) -> jnp.ndarray:
    """Invert the spec-rANS wire's per-piece mod-256 time delta:
    ``codes`` [P, bins, T] u8, ``flags`` [P] (1 = delta-coded). The
    uint32 cumsum + truncating cast is exact because the deltas were
    taken mod 256. Shared by the corpus decoder below and the sharded
    audio-DB build (parallel/gallery.py) — ONE home for the invariant."""
    undelta = jnp.cumsum(codes.astype(jnp.uint32), axis=2).astype(jnp.uint8)
    return jnp.where(flags[:, None, None] != 0, undelta, codes)


def make_corpus_spec_rans_decoder(shape):
    """One-dispatch device decode of spec_rans_encode_corpus payloads ->
    uint8 codes [P, bins, T] (the exact quantized input of
    make_spec_embedder_batched). Delta-coded pieces are inverted by
    spec_undelta_device."""
    from audio_sheet_retrieval_tpu.ops import rans

    bins, T = (int(x) for x in shape)
    n = bins * T

    @jax.jit
    def decode(freqs, states, words, flags):
        codes = rans.rans_decode_batch_device(freqs, states, words, n)
        return spec_undelta_device(codes.reshape(-1, bins, T), flags)

    def run(payload, flags):
        f, s, w = payload
        return decode(jnp.asarray(f), jnp.asarray(s), jnp.asarray(w),
                      jnp.asarray(flags))

    return run


def make_spec_embedder_q(params, cfg):
    """Quantized-spectrogram embedder: fn(codes u8|u16, scale, starts) ->
    [N, dim]. Dequantize + window gather + encoder+CCA+L2 fuse into one
    program (one compile per codes dtype/shape)."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]

    @jax.jit
    def embed_p(p, codes, scale, starts):
        spec = spec_dequantize_device(codes, scale)
        wins = gather_windows(spec, starts, window)
        x = prepare_view2_device(wins[:, None, :, :])
        return cca_model.embed_view2(p, x, cfg)

    params = jax.device_put(params)

    def embed(codes, scale, starts):
        return embed_p(params, codes, scale, starts)

    return embed


def make_spec_embedder_batched(params, cfg, *, quantized: bool = False):
    """Corpus-batched spectrogram embedder: all pieces' specs stack to
    [P, bins, T] (f32, or u8/u16 codes + [P] scales when ``quantized``)
    and upload in one transfer; per-piece embeds select their row on
    device (see make_strip_embedder_rle_batched on why batching matters
    on high-RPC-latency links)."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]

    @jax.jit
    def embed_p(p, specs_all, scales_all, idx, starts):
        spec = jax.lax.dynamic_index_in_dim(specs_all, idx, keepdims=False)
        if quantized:
            scale = jax.lax.dynamic_index_in_dim(scales_all, idx,
                                                 keepdims=False)
            spec = spec_dequantize_device(spec, scale)
        else:
            spec = spec.astype(jnp.float32)
        wins = gather_windows(spec, starts, window)
        x = prepare_view2_device(wins[:, None, :, :])
        return cca_model.embed_view2(p, x, cfg)

    params = jax.device_put(params)

    def embed(specs_all, scales_all, idx, starts):
        if quantized:
            # a zeros fallback would silently dequantize every spectrogram
            # to all-zeros; only the unquantized path may omit scales
            assert scales_all is not None, \
                "quantized=True requires the per-piece scales array"
        return embed_p(params, specs_all,
                       jnp.zeros(specs_all.shape[0], jnp.float32)
                       if scales_all is None else scales_all,
                       jnp.int32(idx), starts)

    return embed


def make_audio_embedder(params, cfg, processor):
    """Raw int16-range waveform -> spectrogram -> window embeddings.

    The complete audio serving path as ONE jitted computation: framing +
    STFT + log filterbank (ops/audio.py) + window gather + encoder. The
    host uploads int16 samples only. Params and the filterbank ride as jit
    arguments (see make_strip_embedder on why closures are harmful).
    """
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]

    @functools.partial(jax.jit, static_argnames=("num_frames",))
    def embed_p(p, fb, win_fn, signal_i16, starts, num_frames: int):
        # madmom folds the int16 range into the window (1/32767)
        sig = signal_i16.astype(jnp.float32) * (1.0 / 32767.0)
        from audio_sheet_retrieval_tpu.ops.audio import _spectrogram_core

        starts_f = (jnp.arange(num_frames) * processor.hop_size
                    ).astype(jnp.int32)
        spec = _spectrogram_core(sig, win_fn, fb, starts_f, num_frames,
                                 processor.frame_size).T
        wins = gather_windows(spec, starts, window)
        x = prepare_view2_device(wins[:, None, :, :])
        return cca_model.embed_view2(p, x, cfg)

    params = jax.device_put(params)
    fb = processor.filterbank
    win_arr = processor._window

    def embed(signal_i16, starts, num_frames):
        return embed_p(params, fb, win_arr, signal_i16, starts, num_frames)

    return embed


def mulaw_encode(signal_i16: np.ndarray, mu: int = 255) -> np.ndarray:
    """int16 waveform -> 8-bit mu-law companded bytes (host side).

    Halves the audio host->device stream, which dominates serving ingest
    once sheet strips are 4-bit packed. Decoding fuses into the embedding
    program (make_audio_embedder_mulaw). Quality A/B with the reference
    checkpoint + the reference tutorial recording: excerpt-embedding cosine
    and cross-modal rankings in tests/test_windows.py; see PARITY.md.
    """
    x = np.asarray(signal_i16, np.float32) * (1.0 / 32768.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) * (1.0 / np.log1p(mu))
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def mulaw_decode_device(u8: jnp.ndarray, mu: float = 255.0) -> jnp.ndarray:
    """Device-side inverse of mulaw_encode -> float32 in [-1, 1]."""
    y = u8.astype(jnp.float32) * (1.0 / 127.5) - 1.0
    return jnp.sign(y) * jnp.expm1(jnp.abs(y) * jnp.log1p(mu)) * (1.0 / mu)


def _mulaw_audio_embed_core(p, fb, win_fn, signal_u8, starts,
                            num_frames: int, cfg, processor):
    """Traceable mu-law audio embedding body shared by the per-piece and
    corpus-batched factories: expand (the decode is /32768-scaled; the raw
    path divides int16 by 32767) -> spectrogram -> window gather ->
    encoder+CCA+L2."""
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.ops.audio import _spectrogram_core
    from audio_sheet_retrieval_tpu.train.engine import prepare_view2_device

    window = cfg.input_shape_2[2]
    sig = mulaw_decode_device(signal_u8) * (32768.0 / 32767.0)
    starts_f = (jnp.arange(num_frames) * processor.hop_size
                ).astype(jnp.int32)
    spec = _spectrogram_core(sig, win_fn, fb, starts_f, num_frames,
                             processor.frame_size).T
    wins = gather_windows(spec, starts, window)
    x = prepare_view2_device(wins[:, None, :, :])
    return cca_model.embed_view2(p, x, cfg)


def make_audio_embedder_mulaw(params, cfg, processor):
    """mu-law variant of make_audio_embedder: the host uploads 8-bit
    companded samples (half the bytes); expansion + DSP + encoder stay one
    jitted program."""

    @functools.partial(jax.jit, static_argnames=("num_frames",))
    def embed_p(p, fb, win_fn, signal_u8, starts, num_frames: int):
        return _mulaw_audio_embed_core(p, fb, win_fn, signal_u8, starts,
                                       num_frames, cfg, processor)

    params = jax.device_put(params)
    fb = processor.filterbank
    win_arr = processor._window

    def embed(signal_u8, starts, num_frames):
        return embed_p(params, fb, win_arr, signal_u8, starts, num_frames)

    return embed
