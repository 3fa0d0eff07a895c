"""Dynamic time warping over a precomputed distance matrix.

Parity with reference:utils/dtw_by_dist.py:6-83 — same cost recurrence
(D[i,j] += min(up, left, diag) over the inf-bordered matrix), same
transpose-to-tall convention, same return signature (min_dist, C, D1, path)
and the same traceback tie-breaking (argmin over (diag, up, left)).

On device: the reference's O(N*M) python double loop becomes an
anti-diagonal wavefront ``lax.scan`` — each diagonal updates min(N, M)
cells in parallel; only the (cheap, sequential) traceback stays
on the host. A numpy fallback is kept for tiny problems.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

INF = np.float32(np.inf)


@jax.jit
def _skew_to_diagonals(dist: jnp.ndarray) -> jnp.ndarray:
    """[R, C] -> [R+C-1, C] shear where row d holds anti-diagonal d:
    out[d, j] = dist[d-j, j] (INF outside the matrix).

    Pure pad/reshape/transpose — the naive per-diagonal
    ``dist[d - j, j]`` is an arbitrary gather in every scan step;
    shearing once makes every scan step a contiguous row read.
    The reshape trick: pad each row of dist.T to width W=R+C with INF,
    flatten, and re-read as width W-1 rows — each row's start drifts one
    element per row, which IS the shear.
    """
    R, C = dist.shape
    W = R + C
    b = jnp.pad(dist.T, ((0, 0), (0, C)), constant_values=INF)   # [C, W]
    sheared = b.reshape(-1)[: C * (W - 1)].reshape(C, W - 1)     # [C, R+C-1]
    return sheared.T


@jax.jit
def _dtw_accumulate_diagonals(dist: jnp.ndarray) -> jnp.ndarray:
    """Accumulate DTW costs over anti-diagonals.

    dist: [R, C]; returns diagonals [R+C-1, C] where diagonal d holds the
    accumulated cost of cells (i=d-j, j) (inf outside the matrix).
    """
    R, C = dist.shape
    j_idx = jnp.arange(C)
    skewed = _skew_to_diagonals(dist)

    def step(carry, inputs):
        prev, prev2 = carry  # diagonals d-1 and d-2, each [C]
        dist_d, d = inputs
        up = prev                                    # (i-1, j)
        left = jnp.concatenate([jnp.full((1,), INF), prev[:-1]])   # (i, j-1)
        diag = jnp.concatenate([jnp.full((1,), INF), prev2[:-1]])  # (i-1, j-1)
        best = jnp.minimum(jnp.minimum(up, left), diag)
        # base case: cell (0, 0) accumulates nothing
        best = jnp.where((d == 0) & (j_idx == 0), 0.0, best)
        acc = dist_d + best          # INF rides through out-of-matrix cells
        return (acc, prev), acc

    init = (jnp.full((C,), INF), jnp.full((C,), INF))
    _, diagonals = jax.lax.scan(step, init,
                                (skewed, jnp.arange(R + C - 1)))
    return diagonals


def _diagonals_to_matrix(diagonals: np.ndarray, R: int, C: int) -> np.ndarray:
    i = np.arange(R)[:, None]
    j = np.arange(C)[None, :]
    return diagonals[i + j, j].astype(np.float64)


def _accumulate_numpy(dist: np.ndarray) -> np.ndarray:
    r, c = dist.shape
    D0 = np.zeros((r + 1, c + 1))
    D0[0, 1:] = np.inf
    D0[1:, 0] = np.inf
    D0[1:, 1:] = dist
    D1 = D0[1:, 1:]
    for i in range(r):
        for j in range(c):
            D1[i, j] += min(D0[i, j], D0[i, j + 1], D0[i + 1, j])
    return D1.copy()


@jax.jit
def _traceback_device(diagonals: jnp.ndarray):
    """Traceback over the diagonal-layout accumulated matrix, on device.

    Same tie-break as the reference (np.argmin over (diag, up, left)).
    Emits up to R+C-2 moves as (i, j) coordinate vectors plus a padding
    mask for steps after (0, 0) was reached; the host reverses and appends
    the start cell. Each step reads 3 scalars via dynamic indexing — all
    inside ONE dispatch, so the download shrinks from the full accumulated
    matrix to two short index vectors.
    """
    T, Cw = diagonals.shape
    R = T + 1 - Cw
    flat = diagonals.reshape(-1)

    def read(a, b):
        # D1[a, b] with D0's inf border; D0[0, 0] == 0 maps to (-1, -1)
        idx = jnp.clip((a + b) * Cw + b, 0, T * Cw - 1)
        v = jax.lax.dynamic_index_in_dim(flat, idx, keepdims=False)
        v = jnp.where((a >= 0) & (b >= 0), v, INF)
        return jnp.where((a == -1) & (b == -1), jnp.float32(0.0), v)

    def step(carry, _):
        i, j, done = carry
        tb = jnp.argmin(jnp.stack([read(i - 1, j - 1), read(i - 1, j),
                                   read(i, j - 1)]))
        ni = jnp.where(done, i, jnp.where(tb != 2, i - 1, i))
        nj = jnp.where(done, j, jnp.where(tb != 1, j - 1, j))
        ndone = done | ((ni == 0) & (nj == 0))
        return (ni, nj, ndone), (ni, nj, done)

    init = (jnp.asarray(R - 1), jnp.asarray(Cw - 1), jnp.asarray(False))
    _, (pi, pj, pad) = jax.lax.scan(step, init, None,
                                    length=max(R + Cw - 2, 0))
    return pi, pj, pad


def _traceback(D0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference traceback (dtw_by_dist.py:69-83), inf-bordered D0."""
    i, j = np.asarray(D0.shape) - 2
    p, q = [i], [j]
    while (i > 0) or (j > 0):
        tb = np.argmin((D0[i, j], D0[i, j + 1], D0[i + 1, j]))
        if tb == 0:
            i -= 1
            j -= 1
        elif tb == 1:
            i -= 1
        else:
            j -= 1
        p.insert(0, i)
        q.insert(0, j)
    return np.asarray(p), np.asarray(q)


def fastdtw(x: np.ndarray, y: np.ndarray, dist: str = "cosine",
            use_device: bool = True):
    """DTW of two feature sequences: distance matrix + dtw_by_dist
    (reference dtw_by_dist.py:37-66). ``dist`` is any scipy cdist metric;
    'cosine' runs as a device matmul."""
    if dist == "cosine":
        from audio_sheet_retrieval_tpu.ops.metrics import (
            cosine_distance_matrix,
        )

        D = np.asarray(cosine_distance_matrix(
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)))
    else:
        from scipy.spatial.distance import cdist

        D = cdist(x, y, dist)
    return dtw_by_dist(D, use_device=use_device)


def dtw_by_dist(dist: np.ndarray, use_device: bool = True,
                return_acc: bool = True):
    """-> (normalized min distance, cost matrix, accumulated matrix, path).

    ``path`` is (rows_of_input, cols_of_input) index arrays — the reference
    returns them swapped when no transpose happened (dtw_by_dist.py:31-32),
    which is mirrored exactly. ``return_acc=False`` skips materializing the
    accumulated matrix on the host (returned as None) — alignment callers
    only need the path, and the download is the dominant cost on device.
    """
    dist = np.asarray(dist, np.float64)
    transposed = False
    if dist.shape[1] > dist.shape[0]:
        dist = dist.T
        transposed = True

    C = dist.copy()
    R_, C_ = dist.shape
    if use_device and dist.size >= 4096:
        diagonals_dev = _dtw_accumulate_diagonals(
            jnp.asarray(dist, jnp.float32))
        # device traceback: the only downloads are the path index vectors
        # and the final cost — NOT the [R+C-1, C] accumulated matrix
        # (~96 MB at 6000x4000)
        pi, pj, pad = (np.asarray(v)
                       for v in _traceback_device(diagonals_dev))
        keep = ~pad
        path = (np.append(pi[keep][::-1], R_ - 1),
                np.append(pj[keep][::-1], C_ - 1))
        final_cost = float(np.asarray(diagonals_dev[-1, -1]))
        if return_acc:
            D1 = _diagonals_to_matrix(np.asarray(diagonals_dev), R_, C_)
        else:
            D1 = None
    else:
        D1 = _accumulate_numpy(dist)
        D0 = np.full((R_ + 1, C_ + 1), np.inf)
        D0[0, 0] = 0.0
        D0[1:, 1:] = D1
        path = _traceback(D0)
        final_cost = D1[-1, -1]

    if not transposed:
        path = (path[1], path[0])

    return final_cost / (R_ + C_), C, D1, path
