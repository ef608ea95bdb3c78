"""The accelerator a measurement ran on.

Every number the benchmark and the smoke run print names its device: JAX's
platform, device kind and count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs slower
under load). A measurement path that finds no GPU fails; it never falls back
to the CPU.
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``name, power limit`` of the first card, from ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu() -> dict:
    """Platform, kind and count of JAX's devices plus the card line;
    raises if JAX found no GPU."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devices[0].platform} devices; device "
            "measurements need the card")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "card": card_line()}
