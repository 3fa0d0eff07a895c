"""Interleaved-stream rANS entropy coding with an XLA-parallel device decode.

The two-level bitmap-RLE sheet coding measures 0.109 B/px against a
0.069 B/px byte-entropy bound of its own payload. Arithmetic/deflate-class
decoders have no parallel XLA decode, with ONE exception: range ANS with S
interleaved streams. Each stream is a self-contained rANS
decoder, but S of them decode in lockstep — one symbol per stream per
step — so the decode is a `lax.scan` of ceil(n/S) steps over [S]-lane
vectors. No sequential bottleneck crosses lanes; the per-lane serial chain
is the scan itself.

The layout is the single-bitstream interleaving of Giesen's ryg_rans
(https://github.com/rygorous/ryg_rans, public domain): lanes share ONE
word stream, and because a step consumes at most one 16-bit word per lane
(L = 2^16 state lower bound, 16-bit renormalization, 12-bit frequency
precision), the decoder can compute each lane's word index as
base + exclusive-cumsum(consume-flags) — the encoder emits words in
exactly that (step-ascending, lane-ascending) order by processing symbols
in reverse. No per-stream buffers, offsets or padding; the only per-stream
overhead is the S final states (4 B each) shipped as the stream header.

Cost model: every gathered element and every op inside a scan body costs
time, so the decoder is built to minimize BOTH gathered elements per symbol
and scan steps:

  * the three per-slot lookups (symbol, frequency, cumulative base) are
    packed into ONE uint32 table entry (sym<<24 | freq<<12 | cum, all
    fields <= 12 bits by construction) -> one gather per symbol instead
    of three;
  * decodes batch across the corpus: `rans_decode_batch_device` decodes P
    payloads in one scan over [P, S] lanes (per-piece word cumsum is an
    axis-1 cumsum), so the per-step dispatch overhead is paid once per
    corpus, not once per piece.

Used as a second wire stage over the bitmap-RLE sheet payloads
(ops/windows): the byte-level order-0 entropy of those payloads is
~0.069 B/px on the bench engraving, and this coder lands within ~2% of it
(plus 0.5 kB tables + 4 B/lane states per strip), cutting sheet wire ~32%
below the previously declared floor — with the decoded bytes feeding the
existing (unchanged, bit-exact) rle2 pixel decode. The decode cost makes
it a bandwidth-starved-link recipe: it wins when link MB/s is below the
crossover the bench measures (see bench.py ASR_BENCH_SHEET=rans).

No reference analog (CPJKU/audio_sheet_retrieval ships raw uint8 pixels);
this is a transport optimization for links slower than the decode.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 12                 # frequency precision: tables sum to 4096
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16               # state lower bound; 16-bit renormalization
N_STREAMS = 2048               # default (and maximum) interleaved lanes


def quantize_freqs(counts: np.ndarray, total: int = PROB_SCALE
                   ) -> np.ndarray:
    """[256] symbol counts -> [256] uint16 quantized frequencies summing to
    ``total``, every observed symbol >= 1 and every frequency <= total-1
    (so it fits the packed table's 12-bit field). Unobserved symbols get 0
    and can never be encoded — the encoder only codes bytes it counted.
    A constant input (one observed symbol) donates one slot to a phantom
    neighbor symbol the encoder never emits."""
    counts = np.asarray(counts, np.int64)
    obs = np.nonzero(counts)[0]
    if obs.size == 0:
        raise ValueError("empty symbol distribution")
    out = np.zeros(256, np.uint16)
    if obs.size == 1:
        out[obs[0]] = total - 1
        out[(obs[0] + 1) % 256] = 1
        return out
    c = counts[obs].astype(np.float64)
    ideal = c / c.sum() * total
    f = np.maximum(1, np.floor(ideal)).astype(np.int64)
    diff = int(total - f.sum())
    if diff > 0:
        # floor loses < 1 per symbol -> diff < n_obs; give the spare slots
        # to the largest fractional remainders
        order = np.argsort(-(ideal - f))
        f[order[:diff]] += 1
    else:
        # the >=1 floor can overshoot by at most n_obs; shave the largest
        # entries (cheapest in code length)
        for _ in range(-diff):
            i = int(np.argmax(np.where(f > 1, f, -1)))
            f[i] -= 1
    out[obs] = f.astype(np.uint16)
    return out


def auto_streams(n: int) -> int:
    """Lane count for an n-byte payload. The 4 B/lane state header is the
    coder's only fixed wire overhead, and the scan's per-step cost is
    mostly fixed (the [P, S] lane math is tiny at any S), so the rule
    targets ~800 payload bytes per lane — state header <= ~0.5% of the
    payload — instead of minimizing steps. On the bench content, vs an
    ~100-step rule, this cuts the sheet wire 0.074 -> 0.070 B/px and the
    spec-u8 wire 0.92 -> 0.87 B/B; power of two in [128, 2048]."""
    s = 1 << int(np.ceil(np.log2(max(1, n / 800))))
    return int(max(128, min(s, N_STREAMS)))


def rans_encode(data: np.ndarray, n_streams: int = N_STREAMS,
                freqs: Optional[np.ndarray] = None):
    """Encode a uint8 array with S-lane interleaved rANS.

    Returns (freqs uint16[256], states uint32[S], words uint16[W]) — the
    complete wire payload; the symbol count n = data.size is carried by the
    caller (it is a static shape in every consumer).

    ``freqs``: optional STATIC frequency table (every symbol that occurs in
    ``data`` must have a nonzero entry) — used by consumers that pin the
    table offline so decoders need no per-payload histogram (the OMR map
    download); default builds the per-payload adaptive table.

    Vectorized over lanes: the Python loop runs ceil(n/S) steps (~100 for a
    20k-px strip's largest component), each a handful of numpy ops on [S]
    vectors — ~5 ms/strip host encode, counted in the bench's client-encode
    figure.
    """
    data = np.asarray(data, np.uint8).ravel()
    n = data.size
    if n == 0:
        raise ValueError("empty input")
    S = int(n_streams)
    if freqs is None:
        freqs = quantize_freqs(np.bincount(data, minlength=256))
    else:
        freqs = np.asarray(freqs, np.uint16)
    cum = np.zeros(256, np.uint64)
    cum[1:] = np.cumsum(freqs.astype(np.uint64))[:-1]
    f_of = freqs.astype(np.uint64)
    pad_sym = int(np.argmax(freqs))

    K = (n + S - 1) // S
    lanes = np.full(K * S, pad_sym, np.uint8)
    lanes[:n] = data
    lanes = lanes.reshape(K, S)

    x = np.full(S, RANS_L, np.uint64)
    blocks = []  # word blocks, collected in reverse step order
    for t in range(K - 1, -1, -1):
        sym = lanes[t].astype(np.int64)
        f = f_of[sym]
        need = x >= (f << 20)  # emit at most one u16 per lane per step
        if need.any():
            blocks.append((x[need] & np.uint64(0xFFFF)).astype(np.uint16))
            x = np.where(need, x >> np.uint64(16), x)
        x = ((x // f) << np.uint64(PROB_BITS)) + cum[sym] + (x % f)
    blocks.reverse()  # decoder reads step-ascending, lane-ascending
    words = (np.concatenate(blocks) if blocks
             else np.zeros(0, np.uint16))
    return freqs, x.astype(np.uint32), words


def rans_encode_batch(arrays, n_streams: int | None = None):
    """Encode P equal-length uint8 arrays (a corpus component stack) ->
    (freqs uint16[P, 256], states uint32[P, S], words uint16[P, Wmax],
    n_words int64[P]) for `rans_decode_batch_device`. Word rows are
    zero-padded to the max (``n_words`` carries each row's real count for
    wire accounting); padding is never read (consumption is driven by the
    states).

    Runs the native scalar encoder (native/rans, built on first use,
    ~5 ns/symbol: the whole 24-piece bench corpus in ~15 ms) when the
    toolchain is available, else the vectorized numpy path — both
    bit-identical to per-payload `rans_encode` (tests/test_rans.py)."""
    arrays = [np.asarray(a, np.uint8).ravel() for a in arrays]
    n = arrays[0].size
    if n == 0:
        raise ValueError("empty input")
    if any(a.size != n for a in arrays):
        raise ValueError("batch components must share one length")
    S = auto_streams(n) if n_streams is None else int(n_streams)
    freqs = np.stack([quantize_freqs(np.bincount(a, minlength=256))
                      for a in arrays])
    lib = _native_lib()
    if lib is not None:
        return _rans_encode_batch_native(lib, arrays, freqs, S)
    return _rans_encode_batch_numpy(arrays, freqs, S)


_native: Optional[ctypes.CDLL] = None
_native_failed = False


def _native_lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use, utils/native.py) the native batch
    encoder; None when no C++ toolchain can build it — callers fall back
    to numpy. Disable explicitly with ASR_NO_NATIVE_RANS=1 (tests use it
    to pin the numpy path)."""
    global _native, _native_failed
    if os.environ.get("ASR_NO_NATIVE_RANS") == "1":
        return None
    if _native is not None or _native_failed:
        return _native
    from audio_sheet_retrieval_tpu.utils import native

    try:
        lib = ctypes.CDLL(native.build("asrrans"))
    except (OSError, subprocess.CalledProcessError):
        _native_failed = True
        return None
    fn = lib.asr_rans_encode_batch
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    _native = lib
    return _native


def _rans_encode_batch_native(lib, arrays, freqs: np.ndarray, S: int):
    P, n = len(arrays), arrays[0].size
    data = np.ascontiguousarray(np.stack(arrays))
    freqs = np.ascontiguousarray(freqs, np.uint16)
    states = np.empty((P, S), np.uint32)
    wcap = n + S  # each of the K*S < n + S lane-steps emits <= 1 word
    words = np.empty((P, wcap), np.uint16)
    n_words = np.empty(P, np.int64)
    rc = lib.asr_rans_encode_batch(
        data.ctypes.data, freqs.ctypes.data, P, n, S,
        states.ctypes.data, words.ctypes.data, wcap, n_words.ctypes.data)
    if rc != 0:  # cannot happen with wcap = n + S; guard regardless
        raise RuntimeError("native rANS encode overflow")
    wmax = int(n_words.max())
    return freqs, states, np.ascontiguousarray(words[:, :wmax]), n_words


def _rans_encode_batch_numpy(arrays, freqs: np.ndarray, S: int):
    """Vectorized numpy encoder: each of the ceil(n/S) steps runs its ops
    once on [P, S] lanes instead of P times on [S] (at the wire-optimal
    small lane counts the per-op fixed cost dominates)."""
    n = arrays[0].size
    P = len(arrays)
    cum = np.zeros((P, 256), np.uint64)
    cum[:, 1:] = np.cumsum(freqs.astype(np.uint64), axis=1)[:, :-1]
    f_of = freqs.astype(np.uint64)
    pad_sym = np.argmax(freqs, axis=1).astype(np.uint8)

    K = (n + S - 1) // S
    lanes = np.repeat(pad_sym[:, None], K * S, axis=1)
    lanes[:, :n] = np.stack(arrays)
    lanes = lanes.reshape(P, K, S)

    rows = np.arange(P)[:, None]
    x = np.full((P, S), RANS_L, np.uint64)
    cand = np.empty((K, P, S), np.uint16)
    needs = np.empty((K, P, S), bool)
    for t in range(K - 1, -1, -1):
        sym = lanes[:, t, :].astype(np.int64)
        f = f_of[rows, sym]
        need = x >= (f << 20)  # emit at most one u16 per lane per step
        cand[t] = (x & np.uint64(0xFFFF)).astype(np.uint16)
        needs[t] = need
        x = np.where(need, x >> np.uint64(16), x)
        x = ((x // f) << np.uint64(PROB_BITS)) + cum[rows, sym] + (x % f)
    states = x.astype(np.uint32)

    # per piece, emitted words in the decoder's (step-ascending,
    # lane-ascending) order = row-major boolean select over [K, S]
    n_words = needs.sum(axis=(0, 2)).astype(np.int64)
    wmax = int(n_words.max()) if P else 0
    words = np.zeros((P, wmax), np.uint16)
    for p in range(P):
        w = cand[:, p, :][needs[:, p, :]]
        words[p, :w.size] = w
    return freqs, states, words, n_words


def rans_decode_host(freqs: np.ndarray, states: np.ndarray,
                     words: np.ndarray, n: int) -> np.ndarray:
    """Host decoder: native scalar loop when the toolchain/library is
    available (~3 ms for a 1 Mpx map-download payload vs ~49 ms numpy),
    else the numpy reference below — bit-identical
    (tests/test_rans.py::test_native_decoder_matches_numpy)."""
    lib = _native_lib()
    if lib is not None:
        try:
            fn = lib.asr_rans_decode
        except AttributeError:
            fn = None  # stale vendored binary without the decoder
        if fn is not None:
            import ctypes as ct

            fn.restype = ct.c_int64
            freqs_c = np.ascontiguousarray(freqs, np.uint16)
            states_c = np.ascontiguousarray(states, np.uint32)
            words_c = np.ascontiguousarray(words, np.uint16)
            out = np.empty(int(n), np.uint8)
            fn(freqs_c.ctypes.data_as(ct.c_void_p),
               states_c.ctypes.data_as(ct.c_void_p),
               words_c.ctypes.data_as(ct.c_void_p),
               ct.c_int64(words_c.size), ct.c_int64(states_c.size),
               ct.c_int64(int(n)), out.ctypes.data_as(ct.c_void_p))
            return out
    return _rans_decode_host_numpy(freqs, states, words, n)


def _rans_decode_host_numpy(freqs: np.ndarray, states: np.ndarray,
                            words: np.ndarray, n: int) -> np.ndarray:
    """Pure-numpy reference decoder (mirrors the device scan; for tests)."""
    freqs = np.asarray(freqs, np.uint32)
    cum = np.zeros(256, np.uint32)
    cum[1:] = np.cumsum(freqs)[:-1]
    ends = np.cumsum(freqs)
    sym_of_slot = np.searchsorted(ends, np.arange(PROB_SCALE),
                                  side="right").astype(np.int64)
    S = states.size
    K = (n + S - 1) // S
    if words.size == 0:  # fully in-state payload (e.g. constant input)
        words = np.zeros(1, np.uint16)
    x = states.astype(np.uint64)
    base = 0
    out = np.empty((K, S), np.uint8)
    for t in range(K):
        slot = (x & np.uint64(PROB_SCALE - 1)).astype(np.int64)
        sym = sym_of_slot[slot]
        out[t] = sym
        x = freqs[sym] * (x >> np.uint64(PROB_BITS)) \
            + slot.astype(np.uint64) - cum[sym]
        consume = x < RANS_L
        idx = np.clip(base + np.cumsum(consume) - 1, 0, len(words) - 1)
        w = words[idx].astype(np.uint64)
        x = np.where(consume, (x << np.uint64(16)) | w, x)
        base += int(consume.sum())
    return out.reshape(-1)[:n]


def _packed_slot_tables(freqs: jnp.ndarray) -> jnp.ndarray:
    """[P, 256] wire frequency tables -> [P, 4096] packed per-slot uint32
    entries (sym<<24 | freq<<12 | cum_base), built on device once per
    decode (a [4096]-query searchsorted over 256 entries — negligible next
    to the scan). One packed entry = ONE gather per decoded symbol."""
    f32u = freqs.astype(jnp.uint32)
    ends = jnp.cumsum(f32u, axis=1)
    cum = ends - f32u
    slots = jnp.arange(PROB_SCALE, dtype=jnp.uint32)
    sym_slot = jax.vmap(
        lambda e: jnp.searchsorted(e, slots, side="right"))(ends)
    sym_slot = sym_slot.astype(jnp.int32)
    f_slot = jnp.take_along_axis(f32u, sym_slot, axis=1)
    c_slot = jnp.take_along_axis(cum, sym_slot, axis=1)
    return ((sym_slot.astype(jnp.uint32) << 24)
            | (f_slot << PROB_BITS) | c_slot)


@functools.partial(jax.jit, static_argnames=("n", "k"))
def _decode_batch_jit(freqs: jnp.ndarray, states: jnp.ndarray,
                      words: jnp.ndarray, n: int, k: int) -> jnp.ndarray:
    P, S = states.shape
    packed = _packed_slot_tables(freqs).reshape(-1)      # [P*4096]
    row = (jnp.arange(P, dtype=jnp.uint32) * PROB_SCALE)[:, None]
    wmax = words.shape[1]
    wf = words.reshape(-1)                                # [P*Wmax]
    base0 = jnp.arange(P, dtype=jnp.int32) * wmax

    def step(carry, _):
        x, base = carry                                   # [P,S], [P]
        slot = x & jnp.uint32(PROB_SCALE - 1)
        e = packed[(row + slot).astype(jnp.int32)]        # ONE gather
        f = (e >> PROB_BITS) & jnp.uint32(PROB_SCALE - 1)
        c = e & jnp.uint32(PROB_SCALE - 1)
        # f*(x>>12) < 2^12 * 2^20 = 2^32: exact in uint32
        x = f * (x >> PROB_BITS) + slot - c
        consume = x < jnp.uint32(RANS_L)
        offs = jnp.cumsum(consume.astype(jnp.int32), axis=1) - 1
        # clip PER ROW [base0[p], base0[p]+wmax-1]: a leading
        # non-consuming lane indexes base-1 (gathered word discarded by
        # the where), and a truncated/malformed payload row can only
        # re-read its own row's padding — never the next row's words —
        # so corruption stays contained to the bad payload. Payloads are
        # still assumed trusted/in-process: a bad row decodes garbage
        # for itself rather than raising.
        idx = jnp.clip(base[:, None] + offs, base0[:, None],
                       base0[:, None] + (wmax - 1))
        w = wf[idx].astype(jnp.uint32)
        x = jnp.where(consume, (x << 16) | w, x)
        base = base + offs[:, -1] + 1
        return (x, base), (e >> 24).astype(jnp.uint8)

    (_, _), out = jax.lax.scan(step, (states, base0), None, length=k)
    # out [K, P, S]: symbol i of payload p lived in lane i % S at step i//S
    return jnp.transpose(out, (1, 0, 2)).reshape(P, k * S)[:, :n]


def rans_decode_batch_device(freqs: jnp.ndarray, states: jnp.ndarray,
                             words: jnp.ndarray, n: int) -> jnp.ndarray:
    """Decode P payloads -> uint8[P, n] in ONE `lax.scan` of ceil(n/S)
    steps over [P, S] lanes. ``n`` is static (component lengths are fixed
    shapes in every consumer); word rows may carry arbitrary padding."""
    S = states.shape[1]
    k = (n + S - 1) // S
    if words.shape[1] == 0:  # fully in-state payloads (constant inputs)
        words = jnp.zeros((states.shape[0], 1), jnp.uint16)
    return _decode_batch_jit(freqs, states, words, n, k)


def rans_decode_device(freqs: jnp.ndarray, states: jnp.ndarray,
                       words: jnp.ndarray, n: int) -> jnp.ndarray:
    """Single-payload decode -> uint8[n] (P=1 batch; prefer the batched
    form — the scan's per-step dispatch overhead amortizes over P)."""
    return rans_decode_batch_device(freqs[None], states[None], words[None],
                                    n)[0]


# ---------------------------------------------------------------------------
# Device-side ENCODE (static frequency table).
#
# The wire above runs host->device: host encodes, the device decodes
# in-graph. The OMR probability-map DOWNLOAD needs the mirror: the map lives
# on device and the HOST wants it — so the encoder must run in-graph and the
# (cheap, sequential-friendly) decode runs on host. A device-built table
# would cost two extra host round trips (histogram download for table
# construction + word-count download before the sized payload). Both
# disappear with a STATIC table trained offline on map content
# (assets/omr_map_freqs.npy): the table is a compile-time
# constant on both ends, and the payload downloads as ONE fixed-capacity
# buffer carrying its own word count (overflow -> the caller falls back to
# the raw map, kept on device; see omr/inference.py).
#
# The encode scan mirrors the numpy encoder exactly (same layout, states,
# and word order — tests assert bit-identity), with two device adaptations:
#   * the u32 state division x // f has no fast vector lowering, so each
#     symbol's reciprocal magic rides in the static table and the quotient
#     is a mulhi + shift (Hacker's Delight round-up magic: for non-pow2 d
#     with s = ceil(log2 d), m = ceil(2^(32+s)/d) is 33 bits; with
#     m' = m - 2^32, q = (((x - mulhi(x, m')) >> 1) + mulhi(x, m'))
#     >> (s-1), exact for ALL x < 2^32 since x*e < 2^(32+s));
#   * words are emitted sparsely (one per lane-step where the state
#     renormalizes), and scatters/per-element gathers are slow to lower —
#     so compaction is ONE lax.sort_key_val over the [K*S] candidates
#     keyed by emission rank (non-emitting slots key to +inf), which keeps
#     the (step-ascending, lane-ascending) stream order.
# ---------------------------------------------------------------------------


def encode_magic_tables(freqs: np.ndarray):
    """[256] static frequency table -> two packed uint32[256] device tables
    for the div-free encode scan.

    tabA = pow2_flag<<31 | shift<<24 | freq<<12 | cum_base
    tabB = magic multiplier m' (m - 2^32) for non-pow2 freqs, else 0.
    """
    f = np.asarray(freqs, np.uint64)
    assert f.shape == (256,) and int(f.sum()) == PROB_SCALE, "bad table"
    cum = np.zeros(256, np.uint64)
    cum[1:] = np.cumsum(f)[:-1]
    tabA = np.zeros(256, np.uint32)
    tabB = np.zeros(256, np.uint32)
    for sym in range(256):
        d = int(f[sym])
        if d == 0:
            # unencodable symbol (never occurs in valid input): encode as
            # divisor 1 so the lane math stays defined even on garbage
            d_eff, pow2, sh, magic = 1, 1, 0, 0
        elif d & (d - 1) == 0:
            d_eff, pow2, sh, magic = d, 1, int(d).bit_length() - 1, 0
        else:
            s = int(np.ceil(np.log2(d)))
            m = (1 << (32 + s)) + d - 1
            m //= d                      # ceil(2^(32+s)/d), 33 bits
            assert (1 << 32) < m < (1 << 33)
            d_eff, pow2, sh, magic = d, 0, s, m - (1 << 32)
        tabA[sym] = ((pow2 << 31) | (sh << 24) | (min(d, PROB_SCALE - 1)
                     if d else 0) << 12 | int(cum[sym]))
        tabB[sym] = magic
    return tabA, tabB


def _mulhi32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact high 32 bits of a 32x32 unsigned multiply via 16-bit limbs
    (no 64-bit integers: JAX runs with x64 off)."""
    al = a & jnp.uint32(0xFFFF)
    ah = a >> 16
    bl = b & jnp.uint32(0xFFFF)
    bh = b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    mid = (ll >> 16) + (lh & jnp.uint32(0xFFFF)) + (hl & jnp.uint32(0xFFFF))
    return ah * bh + (lh >> 16) + (hl >> 16) + (mid >> 16)


@functools.partial(jax.jit, static_argnames=("n", "S", "w_budget",
                                             "pad_sym"))
def _encode_device_jit(tabA: jnp.ndarray, tabB: jnp.ndarray,
                       data: jnp.ndarray, n: int, S: int, w_budget: int,
                       pad_sym: int):
    K = (n + S - 1) // S
    lanes = jnp.full(K * S, pad_sym, jnp.uint8).at[:n].set(data)
    lanes = lanes.reshape(K, S)

    def step(x, row):                                     # x: [S] uint32
        sym = row.astype(jnp.int32)
        a = tabA[sym]                                     # one gather
        m = tabB[sym]                                     # one gather
        f = (a >> 12) & jnp.uint32(PROB_SCALE - 1)
        c = a & jnp.uint32(PROB_SCALE - 1)
        sh = (a >> 24) & jnp.uint32(0xF)
        pow2 = a >> 31
        need = x >= (f << 20)          # emit <= one u16 per lane per step
        cand = (x & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        x = jnp.where(need, x >> 16, x)
        h = _mulhi32(x, m)
        q_magic = (((x - h) >> 1) + h) >> (jnp.maximum(sh, 1) - 1)
        q = jnp.where(pow2 == 1, x >> sh, q_magic)        # q = x // f
        x = x + c + q * (jnp.uint32(PROB_SCALE) - f)
        return x, (cand, need)

    x0 = jnp.full((S,), RANS_L, jnp.uint32)
    # reverse=True: symbols encode back-to-front, outputs stack in
    # step-ascending order (ys[t] <-> xs[t]) — the decoder's word order
    states, (cand, need) = jax.lax.scan(step, x0, lanes, reverse=True)
    need_flat = need.reshape(-1)                          # (t asc, lane asc)
    n_words = jnp.sum(need_flat.astype(jnp.int32))
    rank = jnp.cumsum(need_flat.astype(jnp.int32)) - 1
    keys = jnp.where(need_flat, rank, jnp.int32(2**31 - 1))
    _, words = jax.lax.sort_key_val(keys, cand.reshape(-1))
    return states, words[:w_budget], n_words


def rans_encode_device(data: jnp.ndarray, static_freqs: np.ndarray,
                       n: int, w_budget: int,
                       n_streams: Optional[int] = None):
    """In-graph encode of uint8[n] ``data`` against a STATIC table.

    Returns (states uint32[S], words uint16[w_budget], n_words int32):
    bit-identical to ``rans_encode(data, S, freqs=static_freqs)`` whenever
    n_words <= w_budget; on overflow the first w_budget words are still
    exact but the payload is unusable — callers check n_words and fall
    back (the budget is sized from the training content, see
    omr/inference.py). Traceable; compose inside larger jits."""
    S = auto_streams(n) if n_streams is None else int(n_streams)
    tabA, tabB = encode_magic_tables(static_freqs)
    return rans_encode_device_tables(
        jnp.asarray(tabA), jnp.asarray(tabB), data, n, S, int(w_budget),
        int(np.argmax(static_freqs)))


def rans_encode_device_tables(tabA: jnp.ndarray, tabB: jnp.ndarray,
                              data: jnp.ndarray, n: int, S: int,
                              w_budget: int, pad_sym: int):
    """Table-level entry for composition inside other jitted programs:
    the magic tables (encode_magic_tables) ride as traced device arrays so
    the caller controls caching/placement; pad_sym/w_budget are static."""
    return _encode_device_jit(tabA, tabB, data.reshape(-1), n, S,
                              int(w_budget), int(pad_sym))
