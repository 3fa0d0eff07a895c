"""Retrieval evaluation metrics (hit rates, MRR/'MAP', ranks).

Behavioural parity with reference:audio_sheet_retrieval/utils/train_dcca_pool.py:28-82
(`eval_retrieval`), including its quirks:

  * ``k = n2 // n1`` / ``h = n1 // n2`` floor-divide handling of unequal
    gallery sizes (py2 integer division, :35-36),
  * rank of the true match computed on floor-divided sorted indices (:67-68),
  * "MAP" is actually mean reciprocal rank, mean(1/rank) (:74),
  * mean diagonal cosine distance over min(n1, n2) pairs (:79).

The reference loops per query on the CPU with scipy ``cdist`` + ``argsort``;
here the whole evaluation is one jitted XLA computation: a single [n1, n2]
cosine-score matmul followed by a vectorized argsort / rank reduction.
A top-k fast path (`retrieval_ranks_topk`) avoids the full argsort when only
ranks up to K are needed.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST

HIT_RATE_KS = (1, 5, 10, 25)


def cosine_distance_matrix(lv1: jnp.ndarray, lv2: jnp.ndarray) -> jnp.ndarray:
    """Pairwise cosine distances, 1 - <u,v>/(|u||v|) (scipy cdist semantics)."""
    n1 = lv1 / jnp.linalg.norm(lv1, axis=1, keepdims=True)
    n2 = lv2 / jnp.linalg.norm(lv2, axis=1, keepdims=True)
    return 1.0 - jnp.dot(n1, n2.T, precision=HIGHEST,
                         preferred_element_type=jnp.float32)


@functools.partial(jax.jit, static_argnames=("k", "h"))
def _ranks_and_diag(lv1, lv2, k: int, h: int):
    dists = cosine_distance_matrix(lv1, lv2)
    n1 = dists.shape[0]
    # sorted gallery indices per query (stable sort; the reference's quicksort
    # differs only on exact float ties)
    sorted_idx = jnp.argsort(dists, axis=1)
    fixed_sorted = sorted_idx // k
    i_fixed = (jnp.arange(n1) // h).reshape(-1, 1)
    match = fixed_sorted == i_fixed
    # first matching position (+1: ranks start at 1)
    ranks = jnp.argmax(match, axis=1) + 1
    m = min(dists.shape[0], dists.shape[1])
    mean_diag = jnp.mean(jnp.diagonal(dists)[:m])
    return ranks, mean_diag


def retrieval_ranks(lv1, lv2) -> Tuple[np.ndarray, float]:
    """Rank of the true match for each query row of ``lv1`` against ``lv2``."""
    n1, n2 = int(lv1.shape[0]), int(lv2.shape[0])
    k = n2 // n1 if n2 > n1 else 1
    h = n1 // n2 if n1 > n2 else 1
    ranks, mean_diag = _ranks_and_diag(jnp.asarray(lv1), jnp.asarray(lv2), k, h)
    return np.asarray(ranks), float(mean_diag)


@functools.partial(jax.jit, static_argnames=("k", "h", "topk"))
def _ranks_topk(lv1, lv2, k: int, h: int, topk: int):
    """Top-k fast path: exact ranks up to ``topk``, clamped to n2 beyond."""
    dists = cosine_distance_matrix(lv1, lv2)
    n1, n2 = dists.shape
    _, idx = jax.lax.top_k(-dists, topk)
    fixed = idx // k
    i_fixed = (jnp.arange(n1) // h).reshape(-1, 1)
    match = fixed == i_fixed
    found = jnp.any(match, axis=1)
    ranks = jnp.where(found, jnp.argmax(match, axis=1) + 1, n2)
    return ranks, found


def retrieval_ranks_topk(lv1, lv2, topk: int = 25):
    n1, n2 = int(lv1.shape[0]), int(lv2.shape[0])
    k = n2 // n1 if n2 > n1 else 1
    h = n1 // n2 if n1 > n2 else 1
    ranks, found = _ranks_topk(jnp.asarray(lv1), jnp.asarray(lv2), k, h, topk)
    return np.asarray(ranks), np.asarray(found)


def retrieval_metrics_device(lv1: jnp.ndarray, lv2: jnp.ndarray
                             ) -> jnp.ndarray:
    """Traceable on-device evaluation: the full `eval_retrieval` reduced to
    an 8-vector ``[mean_rank, median_rank, mean_diag, mrr,
    hits@1, hits@5, hits@10, hits@25]`` (hits are counts, as float32).

    Compose inside a larger jit (e.g. the engine's fused per-epoch eval) so
    the per-epoch host download shrinks from the [n, d] code matrices to a
    handful of scalars.
    """
    n1, n2 = int(lv1.shape[0]), int(lv2.shape[0])
    k = n2 // n1 if n2 > n1 else 1
    h = n1 // n2 if n1 > n2 else 1
    dists = cosine_distance_matrix(lv1, lv2)
    sorted_idx = jnp.argsort(dists, axis=1)
    fixed_sorted = sorted_idx // k
    i_fixed = (jnp.arange(n1) // h).reshape(-1, 1)
    ranks = (jnp.argmax(fixed_sorted == i_fixed, axis=1) + 1
             ).astype(jnp.float32)
    m = min(n1, n2)
    mean_diag = jnp.mean(jnp.diagonal(dists)[:m])
    hits = jnp.stack([jnp.sum(ranks <= kk).astype(jnp.float32)
                      for kk in HIT_RATE_KS])
    head = jnp.stack([ranks.mean(), jnp.median(ranks), mean_diag,
                      jnp.mean(1.0 / ranks)])
    return jnp.concatenate([head, hits])


def unpack_retrieval_metrics(vec: np.ndarray):
    """Host-side unpack of `retrieval_metrics_device` into the exact
    `eval_retrieval` return tuple (mean, median, dist, hit-dict, map)."""
    vec = np.asarray(vec, np.float64)
    hit_rates = {kk: int(round(vec[4 + i]))
                 for i, kk in enumerate(HIT_RATE_KS)}
    return float(vec[0]), float(vec[1]), float(vec[2]), hit_rates, float(vec[3])


def eval_retrieval(lv1_cca, lv2_cca):
    """Reference-parity evaluation.

    Returns (mean_rank, median_rank, mean_diag_dist, hit_rates, map) exactly
    like reference train_dcca_pool.py:28-82 — hit_rates is a dict over
    k in {1, 5, 10, 25}; 'map' is mean reciprocal rank.
    """
    ranks, mean_diag = retrieval_ranks(lv1_cca, lv2_cca)
    hit_rates: Dict[int, int] = {
        key: int(np.sum(ranks <= key)) for key in HIT_RATE_KS
    }
    mean_rank = float(np.mean(ranks))
    median_rank = float(np.median(ranks))
    mrr = float(np.mean(1.0 / ranks))
    return mean_rank, median_rank, float(mean_diag), hit_rates, mrr
