#!/usr/bin/env python
"""Train the STATIC rANS frequency table for the OMR map download.

A device-built rANS table for the probability-map DOWNLOAD needs a
histogram download (table construction) plus a word-count download (sized
payload) — 3 host round trips. A STATIC table trained offline on map
content removes both extra trips. This script builds that table:

  * runs the three detector U-Nets (system/bar/note) over the vendored
    tutorial page and its contrast/scale variants (synthetic staff-line
    pages detect no systems: the detectors were trained on real engraving),
  * histograms the u8 map codes AND the u16 hi-byte plane (both download
    encodings), add-1 smoothed so every byte stays encodable,
  * quantizes to the coder's 12-bit precision and writes
    audio_sheet_retrieval_tpu/assets/omr_map_wire.npz with PER-DETECTOR
    tables and download budgets plus a shared fallback (~2 kB total, a
    compile-time constant on both ends of the wire). Per-kind matters:
    system maps measure ~0.55 B/px vs ~0.04 for note maps — a shared
    budget would waste the sparse maps' entire win,
  * reports per-map coded sizes under the static vs adaptive table (the
    static-table regret); each kind's budget = BUDGET_HEADROOM x its
    densest observed map, floor 0.06 B/px (overflow falls back to the
    raw fetch at runtime, omr/inference.py).

Usage: python scripts/train_map_freqs.py [--variants N] [--dry]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def page_variants(img: np.ndarray):
    """The real page + rescale/contrast/brightness variants."""
    import cv2

    h, w = img.shape
    out = [img]
    for scale in (0.9, 1.1):
        out.append(cv2.resize(img, (int(w * scale), int(h * scale))))
    out.append(np.clip(img.astype(np.float32) * 0.85 + 20, 0,
                       255).astype(img.dtype))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--variants", type=int, default=3,
                   help="gate-page variants per net (<=5)")
    p.add_argument("--dry", action="store_true",
                   help="report only; do not write the asset")
    args = p.parse_args(argv)

    import cv2

    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.omr import inference
    from audio_sheet_retrieval_tpu.ops import rans

    img = cv2.imread(assets.tutorial_sheet_path(), 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    pages = [inference.prepare_image(v)
             for v in page_variants(img)[:args.variants]]

    kind_counts = {}
    maps = []
    for kind, shape in (("system", (512, 512)), ("bar", (512, 512)),
                        ("note", (256, 512))):
        net = inference.SegmentationNetwork.load(
            assets.omr_weights_path(kind), input_shape=shape,
            page_wire="raw", map_wire="raw")
        kind_counts[kind] = np.zeros(256, np.int64)
        for i, page in enumerate(pages):
            proba = net.predict_proba(page)
            u8 = np.round(np.clip(proba, 0, 1) * 255).astype(np.uint8)
            u16 = np.round(np.clip(proba, 0, 1) * 65535).astype(np.uint16)
            hi = (u16 >> 8).astype(np.uint8)
            lo = (u16 & 0xFF).astype(np.uint8)
            kind_counts[kind] += np.bincount(u8.ravel(), minlength=256)
            kind_counts[kind] += np.bincount(hi.ravel(), minlength=256)
            maps.append((kind, f"{kind}/p{i}", u8, hi, lo))
            print(f"  {kind} page{i}: {u8.shape}", file=sys.stderr)

    # add-1: every byte stays encodable on unseen pages
    tables = {k: rans.quantize_freqs(c + 1) for k, c in kind_counts.items()}
    tables["shared"] = rans.quantize_freqs(
        sum(kind_counts.values()) + 1)

    def coded_bpp(plane_u8, table):
        n = plane_u8.size
        _, st, w = rans.rans_encode(plane_u8.ravel(),
                                    rans.auto_streams(n), freqs=table)
        return (2 * w.size + 4 * st.size) / n

    BUDGET_HEADROOM = 1.45
    rows, worst = [], {k: 0.0 for k in tables}
    for kind, name, u8, hi, lo in maps:
        adaptive = rans.quantize_freqs(np.bincount(u8.ravel(),
                                                   minlength=256))
        b_static = coded_bpp(u8, tables[kind])
        b_adapt = coded_bpp(u8, adaptive)
        b_hi = coded_bpp(hi, tables[kind])
        b_shared = coded_bpp(u8, tables["shared"])
        ent_lo = _entropy_bpp(lo)
        worst[kind] = max(worst[kind], b_static, b_hi)
        worst["shared"] = max(worst["shared"], b_shared,
                              coded_bpp(hi, tables["shared"]))
        rows.append({"map": name, "u8_static_Bpx": round(b_static, 4),
                     "u8_adaptive_Bpx": round(b_adapt, 4),
                     "u8_shared_Bpx": round(b_shared, 4),
                     "u16_hi_static_Bpx": round(b_hi, 4),
                     "u16_lo_entropy_Bpx": round(ent_lo, 4)})
        print(f"  {name}: u8 static {b_static:.3f} B/px (adaptive "
              f"{b_adapt:.3f}, shared {b_shared:.3f}), u16-hi "
              f"{b_hi:.3f}, u16-lo entropy {ent_lo:.2f}",
              file=sys.stderr)

    budgets = {k: max(0.06, round(BUDGET_HEADROOM * worst[k], 3))
               for k in tables}
    out_path = assets.asset_path(inference._MAP_WIRE_ASSET)
    if not args.dry:
        np.savez(out_path,
                 **{f"freqs_{k}": t for k, t in tables.items()},
                 **{f"budget_{k}": np.float64(b)
                    for k, b in budgets.items()})
    out = {"asset": out_path, "written": not args.dry,
           "budgets_Bpx": budgets, "maps": rows}
    print(json.dumps(out))
    return out


def _entropy_bpp(plane_u8: np.ndarray) -> float:
    c = np.bincount(plane_u8.ravel(), minlength=256).astype(np.float64)
    p = c[c > 0] / c.sum()
    return float(-(p * np.log2(p)).sum() / 8.0)


if __name__ == "__main__":
    main()
