#!/usr/bin/env python
"""Discriminative serving-accuracy sweep with paired significance
(VERDICT r3 #1; error bars added for VERDICT r4 weak #2).

The round-3 accuracy gate saturated (60/60 on every arm), proving nothing
about how far each fast serving recipe sits from the accuracy cliff. This
sweep makes the evidence discriminative AND statistically supported:

  * HARD corpus: >=300 confusable pieces (shared motif bank, transposed
    copies, near-duplicates — data/synthetic.make_confusable_piece_list):
    local windows recur across pieces, so snippet votes must integrate
    piece-level structure;
  * difficulty axis: excerpts_per_query 100 -> 25 -> 5 (the reference
    protocol uses 100, audio_sheet_server.py:216) and BOTH gallery
    constructions (onset-aligned like initialize_sheet_db, and stride
    context//4 windows like initialize_sheet_db_from_imges);
  * arms: f32-highest (strict parity), f32-high (shipped default), bf16
    (fast serving), each at the rank-agreement-gated u16 spec upload,
    plus the u8 minimum-wire opt-in on the fast arms;
  * per cell: rank<=1, rank<=5, the SIGNED VOTE-MARGIN distribution
    (true-piece votes minus best impostor; <=0 = lost/tied);
  * PAIRED TESTS: every arm answers the same queries in the same order,
    so recipe deltas are tested with exact McNemar over the per-query
    rank<=1 outcomes (discordant pairs only) — pooled across `--seeds`
    corpus draws — with a 95% CI on the paired accuracy delta. This
    replaces single-draw point-estimate comparisons whose deltas were of
    the same order as binomial noise.
  * STRIDE cells are marked diagnostic-only: at this corpus difficulty
    the stride-gallery floor is 12-16 successes/cell, far below any
    gating power (VERDICT r4 weak #5); the onset cells (the reference's
    own initialize_sheet_db construction) carry the gates.

Usage: python scripts/accuracy_sweep.py [--n_pieces 300]
           [--seeds 31,47,63] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# (compute_dtype, conv_precision, wire arms (spec quantize bits),
#  gallery-build kwargs)
LADDER = [
    ("f32-highest", "float32", "highest", (16,), {}),
    ("f32-high", "float32", "high", (16, 8), {}),
    ("bf16", "bfloat16", "default", (16, 8), {}),
]
# (excerpts_per_query, queries_per_piece)
DIFFICULTY = [(100, 1), (25, 2), (5, 3)]
MODES = ("onset", "stride")

# headline paired comparisons (arm_a vs arm_b), run per (mode, epq) cell
# pair and pooled across seeds
COMPARISONS = [
    ("f32-high+u16", "f32-highest+u16", "conv-precision high vs highest"),
    ("bf16+u16", "f32-highest+u16", "bfloat16 vs f32 strict parity"),
    ("f32-high+u8", "f32-high+u16", "spec u8 vs u16 wire (f32-high)"),
    ("bf16+u8", "bf16+u16", "spec u8 vs u16 wire (bf16)"),
]


def mcnemar_exact(b: int, c: int) -> float:
    """Two-sided exact McNemar p-value over discordant pair counts
    (b = only arm A correct, c = only arm B correct): binomial test of
    b successes in b+c trials at p=1/2."""
    n = b + c
    if n == 0:
        return 1.0
    k = min(b, c)
    # 2 * P(X <= k), X ~ Binom(n, 1/2), capped at 1
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n
    return min(1.0, 2.0 * tail)


def paired_delta_ci(hits_a: np.ndarray, hits_b: np.ndarray):
    """Paired accuracy delta (A - B) with a 95% normal-approximation CI
    from the per-query paired differences (exactly the discordant-pair
    variance: var = (b + c - (b-c)^2/n) / n)."""
    d = hits_a.astype(np.int64) - hits_b.astype(np.int64)
    n = d.size
    delta = float(d.mean())
    se = float(d.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
    return delta, (delta - 1.96 * se, delta + 1.96 * se)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_pieces", type=int, default=300)
    p.add_argument("--n_onsets", type=int, default=120)
    p.add_argument("--seeds", default="31",
                   help="comma-separated corpus seeds; deltas/McNemar "
                        "pool across all of them")
    p.add_argument("--only", default=None,
                   help="comma-separated arm bases (e.g. 'bf16,bf16-fcp') "
                        "to run a targeted paired comparison without "
                        "re-sweeping the whole ladder")
    p.add_argument("--modes", default=",".join(MODES),
                   help="gallery constructions to run (onset and/or "
                        "stride; stride cells are diagnostic-only)")
    p.add_argument("--out", default=None, help="JSON dump path")
    args = p.parse_args(argv)
    seeds = [int(s) for s in str(args.seeds).split(",") if s != ""]
    only = (set(args.only.split(",")) if args.only else None)
    modes = [m for m in str(args.modes).split(",") if m in MODES]

    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.models import cca_model
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.retrieval.accuracy import (
        build_piece_gallery,
        piece_id_accuracy,
    )
    from audio_sheet_retrieval_tpu.utils import io as uio
    from audio_sheet_retrieval_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    import jax

    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    cfg0 = get_model_config("mutopia_ccal_cont_rsz")
    ckpt = os.path.join(os.path.dirname(assets.tutorial_checkpoint_path()),
                        "synth_serving_ckpt.pkl")
    params = uio.load_pytree(ckpt, like=cca_model.init_model(
        jax.random.PRNGKey(0), cfg0))

    results = {}      # "<label>|<mode>|e<epq>" -> aggregated cell
    hits = {}         # (seed, label, mode, epq) -> np.ndarray[bool]
    from collections import Counter

    for seed in seeds:
        images, specs, o2cs, kinds = synthetic.make_confusable_piece_list(
            seed, args.n_pieces, n_onsets=args.n_onsets)
        te_specs = [sp[0] for sp in specs]
        coords = [oc[0][:, 1] for oc in o2cs]
        print(f"seed {seed}: corpus {args.n_pieces} pieces "
              f"({dict(Counter(kinds))}), {args.n_onsets} onsets each",
              file=sys.stderr)

        for base, dtype, prec, qbits_arms, gal_kw in LADDER:
            if only is not None and base not in only:
                continue
            cfg = dataclasses.replace(cfg0, compute_dtype=dtype,
                                      conv_precision=prec)
            for mode in modes:
                t0 = time.time()
                gallery = build_piece_gallery(
                    params, cfg, images,
                    coords=coords if mode == "onset" else None, **gal_kw)
                print(f"  {base:12s} {mode:6s}: gallery "
                      f"{gallery.n} rows ({time.time() - t0:.0f}s)",
                      file=sys.stderr)
                for qbits in qbits_arms:
                    label = f"{base}+u{qbits}"
                    for epq, qpp in DIFFICULTY:
                        t0 = time.time()
                        acc = piece_id_accuracy(
                            params, cfg, images, te_specs,
                            queries_per_piece=qpp, excerpts_per_query=epq,
                            quantize=qbits, gallery=gallery)
                        m = np.asarray(acc.pop("margins"))
                        ranks = np.asarray(acc.pop("ranks"))
                        hits[(seed, label, mode, epq)] = ranks <= 1
                        key = f"{label}|{mode}|e{epq}"
                        cell = results.setdefault(key, {
                            "rank1": 0, "rank5": 0, "n": 0, "errors": 0,
                            "margin_min": 10 ** 9, "per_seed_rank1": [],
                            "diagnostic_only": mode == "stride",
                        })
                        cell["rank1"] += acc["rank1"]
                        cell["rank5"] += acc["rank5"]
                        cell["n"] += acc["n"]
                        cell["errors"] += int((m <= 0).sum())
                        cell["margin_min"] = min(cell["margin_min"],
                                                 acc["margin_min"])
                        cell["per_seed_rank1"].append(acc["rank1"])
                        cell["margin_p10"] = acc["margin_p10"]
                        cell["margin_p50"] = acc["margin_p50"]
                        print(f"  {label:16s} {mode:6s} e={epq:3d}: "
                              f"rank<=1 {acc['rank1']}/{acc['n']} "
                              f"rank<=5 {acc['rank5']}/{acc['n']} "
                              f"margin min/p10/p50 {acc['margin_min']}/"
                              f"{acc['margin_p10']:.0f}/"
                              f"{acc['margin_p50']:.0f} "
                              f"({time.time() - t0:.0f}s)",
                              file=sys.stderr)

    # --- paired significance over pooled per-query outcomes ---
    comparisons = {}
    for arm_a, arm_b, desc in COMPARISONS:
        for mode in MODES:
            for epq, _ in DIFFICULTY:
                ha, hb = [], []
                for seed in seeds:
                    ka = (seed, arm_a, mode, epq)
                    kb = (seed, arm_b, mode, epq)
                    if ka in hits and kb in hits:
                        ha.append(hits[ka])
                        hb.append(hits[kb])
                if not ha:
                    continue
                ha = np.concatenate(ha)
                hb = np.concatenate(hb)
                b = int((ha & ~hb).sum())   # only A correct
                c = int((~ha & hb).sum())   # only B correct
                delta, ci = paired_delta_ci(ha, hb)
                pval = mcnemar_exact(b, c)
                comparisons[f"{arm_a} vs {arm_b}|{mode}|e{epq}"] = {
                    "desc": desc, "n": int(ha.size),
                    "rank1_a": int(ha.sum()), "rank1_b": int(hb.sum()),
                    "discordant_a_only": b, "discordant_b_only": c,
                    "delta": round(delta, 5),
                    "delta_ci95": [round(ci[0], 5), round(ci[1], 5)],
                    "mcnemar_p": round(pval, 5),
                    "significant_5pct": bool(pval < 0.05),
                    "diagnostic_only": mode == "stride",
                }
                flag = ("**" if pval < 0.05 else "  ")
                print(f"PAIRED {arm_a:16s} vs {arm_b:16s} {mode:6s} "
                      f"e={epq:3d}: delta {delta * 100:+.2f}% "
                      f"[{ci[0] * 100:+.2f}, {ci[1] * 100:+.2f}] "
                      f"b/c={b}/{c} p={pval:.4f}{flag}"
                      + (" (diagnostic-only cell)" if mode == "stride"
                         else ""), file=sys.stderr)

    out = {"n_pieces": args.n_pieces, "n_onsets": args.n_onsets,
           "seeds": seeds, "cells": results, "comparisons": comparisons,
           "notes": {
               "pairing": "per-query rank<=1 outcomes paired across arms "
                          "(identical corpus/queries), pooled over seeds; "
                          "exact two-sided McNemar over discordant pairs; "
                          "CI = normal approx over paired differences",
               "stride": "stride-gallery cells are diagnostic-only: "
                         "12-16 successes/cell at this corpus difficulty "
                         "is below any gating power (VERDICT r4 weak #5)",
           }}
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(out, fp, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
