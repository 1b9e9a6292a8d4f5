"""Kernel tuning defaults measured on the card.

The persistent-lanes megakernel's ``lanes``/``unroll`` are pure scheduling
knobs: per-pixel values derive from pixel ids, so every setting produces the
bit-identical image (tests/test_persistent.py gates this).  The *fast*
setting, however, is hardware-dependent.  ``scripts/sweep_knobs.py``
measures the candidates on the card and ``scripts/apply_tuning.py`` persists
the winner into ``tuned.json`` next to this file, so the defaults every
caller gets (including ``bench.py``) are the measured optimum rather than
whatever constant was last hand-edited into the kernel.

The reference has no analog — all its tuning lives in compile-time consts
(ray_tracer.rs:15-19, bvh.rs:140-142).  This is an autotuning cache
(persisted, validated, checked in).

Rules:
  * explicit kwargs always win (``Renderer(lanes=...)``, ``bench --lanes``);
  * tuned values apply only on the backend they were measured on (the
    ``tuned.json`` top-level key) — CPU tests and the virtual-device mesh
    never pick up chip-sized lane counts;
  * a malformed or out-of-range file is ignored with a warning, never fatal.
"""
from __future__ import annotations

import json
import logging
from functools import lru_cache
from pathlib import Path

log = logging.getLogger(__name__)

TUNED_PATH = Path(__file__).with_name("tuned.json")

# knob -> (type, min, max). Bounds are sanity rails, not sweep ranges.
_SCHEMA = {
    "lanes": (int, 128, 262144),
    "unroll": (int, 1, 16),
    "boundaries": (int, 1, 8),
    "log_cap": (int, 128, 262144),
    "packet": (int, 1, 16),
}

# knob -> extra predicate beyond the (type, lo, hi) rails. Keeps a malformed
# tuned.json warn-and-ignore (never fatal): values that pass the range check
# but would trip a trace-time layout assert inside a kernel are rejected
# here instead (e.g. the deleted trav_lanes knob required 128-multiples).
_EXTRA_CHECKS: dict = {
    # the claim-rank cumsum runs as (lanes / 128, 128) blocks
    # (kernels/megakernel.py _cumsum_i32)
    "lanes": (lambda v: v % 128 == 0, "must be a multiple of 128"),
}


def _validated(raw: dict) -> dict:
    out = {}
    for key, val in raw.items():
        spec = _SCHEMA.get(key)
        if spec is None:
            log.warning("tuned.json: unknown knob %r ignored", key)
            continue
        typ, lo, hi = spec
        if not isinstance(val, typ) or isinstance(val, bool) \
                or not (lo <= val <= hi):
            log.warning("tuned.json: knob %r=%r out of range [%s, %s]; "
                        "ignored", key, val, lo, hi)
            continue
        extra = _EXTRA_CHECKS.get(key)
        if extra is not None and not extra[0](val):
            log.warning("tuned.json: knob %r=%r invalid (%s); ignored",
                        key, val, extra[1])
            continue
        out[key] = val
    return out


@lru_cache(maxsize=None)
def tuned_defaults(backend: str | None = None) -> dict:
    """Validated tuned knobs for ``backend`` (default: the active JAX
    backend).  Cached per process: the jit cache keys on the resolved
    static values, so they must not change under a live process."""
    if backend is None:
        import jax
        backend = jax.default_backend()
    try:
        raw = json.loads(TUNED_PATH.read_text())
    except FileNotFoundError:
        return {}
    except (OSError, json.JSONDecodeError) as e:
        log.warning("tuned.json unreadable (%s); using built-in defaults", e)
        return {}
    if not isinstance(raw, dict):
        log.warning("tuned.json: top level must be a backend->knobs object")
        return {}
    per_backend = raw.get(backend, {})
    if not isinstance(per_backend, dict):
        log.warning("tuned.json: entry for backend %r is not an object",
                    backend)
        return {}
    return _validated(per_backend)


def resolve(name: str, explicit, fallback, profile: str | None = None):
    """Explicit kwarg > tuned.json scene-class profile > tuned.json backend
    defaults > built-in fallback.

    ``profile`` is a STATIC scene-class key (e.g. "bigtex"): some optima
    shift with scene structure, not only hardware (a big texel atlas
    competes with the traversal tables for cache). Profiles live under
    "<backend>:<profile>" in tuned.json and override the plain backend
    entry knob-by-knob."""
    if explicit is not None:
        return explicit
    if profile is not None:
        import jax
        prof = tuned_defaults(f"{jax.default_backend()}:{profile}")
        if name in prof:
            return prof[name]
    return tuned_defaults().get(name, fallback)
