#!/usr/bin/env python
"""Persist the fastest measured megakernel knobs into tuned.json.

Reads a sweep log of JSON lines as written by scripts/sweep_knobs.py
(``{"scene": ..., "env": {...}, "kw": {...}, "mrays": N}``), compares the
baseline config (empty env, no kw) of the anchor scene against its kw-only
variants, and — when a variant wins by more than ``--margin`` (default 2%) —
writes the winning knobs into ray_tracer_2_tpu/tuned.json for the active
backend (``--backend``, default the active JAX backend). Knob changes are
image-invariant by construction (pixel values derive from pixel ids;
tests/test_persistent.py gates every knob), so the update is safe to apply
unattended.

Usage: python scripts/apply_tuning.py SWEEP_LOG [--scene sponza]
       [--margin 0.02] [--backend gpu] [--dry-run]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ray_tracer_2_tpu import tuning


def best_config(lines, scene):
    """(baseline_mrays, best_kw, best_mrays) from sweep-log JSON lines.
    Later duplicates win (a re-run supersedes). Env-var variants are
    excluded: they flip physics/path knobs, not scheduling."""
    baseline = None
    variants = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if rec.get("scene") != scene or "mrays" not in rec:
            continue
        if rec.get("env"):
            continue
        kw = rec.get("kw") or {}
        if not kw:
            baseline = rec["mrays"]
        else:
            variants[json.dumps(kw, sort_keys=True)] = rec["mrays"]
    if not variants:
        return baseline, None, None
    key, val = max(variants.items(), key=lambda kv: kv[1])
    return baseline, json.loads(key), val


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--scene", default="sponza",
                    help="anchor scene (the headline bench config)")
    ap.add_argument("--margin", type=float, default=0.02,
                    help="required relative win over the baseline config")
    ap.add_argument("--backend", default=None,
                    help="tuned.json entry to write (default: the active "
                         "JAX backend)")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args()
    if args.backend is None:
        import jax
        args.backend = jax.default_backend()

    lines = Path(args.log).read_text().splitlines()
    baseline, kw, mrays = best_config(lines, args.scene)
    if baseline is None:
        print(f"apply_tuning: no baseline row for {args.scene!r} in "
              f"{args.log}; nothing applied")
        return 0
    if kw is None:
        print(f"apply_tuning: no kw variants for {args.scene!r}; "
              f"baseline {baseline} stands")
        return 0
    rel = (mrays - baseline) / baseline
    print(f"apply_tuning: {args.scene} baseline {baseline} Mrays/s; "
          f"best variant {kw} -> {mrays} ({rel:+.1%})")
    if rel <= args.margin:
        print(f"apply_tuning: win <= {args.margin:.0%} margin; keeping "
              "current defaults")
        return 0

    valid = tuning._validated(kw)
    if valid != kw:
        print(f"apply_tuning: variant {kw} failed validation -> {valid}; "
              "not applied")
        return 1
    try:
        current = json.loads(tuning.TUNED_PATH.read_text())
    except (OSError, json.JSONDecodeError):
        current = {}
    merged = dict(current)
    merged[args.backend] = {**current.get(args.backend, {}), **valid}
    if args.dry_run:
        print(f"apply_tuning (dry run): would write {merged}")
        return 0
    tuning.TUNED_PATH.write_text(json.dumps(merged, indent=2) + "\n")
    print(f"apply_tuning: wrote {tuning.TUNED_PATH}: {merged}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
