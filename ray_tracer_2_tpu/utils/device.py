"""What the process runs on, for every number the program reports.

A time is only meaningful beside the device that produced it, so the
benchmark and the smoke check name the JAX platform, the device kind and
count, and the card's name and power limit (a card set below its maximum
power runs slower under load). Measurement entry points refuse to fall back
to the CPU silently.
"""
from __future__ import annotations

import os
import subprocess


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each, or a note saying why it is unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    if out.returncode != 0:
        return f"nvidia-smi failed ({out.stderr.strip()[:200]})"
    return out.stdout.strip()


def require_gpu(tool: str, allow_explicit_cpu: bool = False) -> dict:
    """The device summary, or SystemExit naming the platform JAX found.

    ``allow_explicit_cpu`` lets a tool run on the CPU when the caller asked
    for it with ``JAX_PLATFORMS=cpu`` (tests and tiny rehearsals)."""
    info = device_summary()
    if info["platform"] == "gpu":
        return info
    if allow_explicit_cpu and os.environ.get("JAX_PLATFORMS") == "cpu" \
            and info["platform"] == "cpu":
        return info
    hint = (" (set JAX_PLATFORMS=cpu to run on the CPU on purpose)"
            if allow_explicit_cpu else "")
    raise SystemExit(f"{tool}: JAX found platform {info['platform']!r} "
                     f"({info['kind']}), not a GPU{hint}")
