"""What a run ran on: the JAX devices, and on NVIDIA GPUs the card's name
and power limit (a card set below its maximum power runs slower under
load, so every recorded time carries it)."""

from __future__ import annotations

import subprocess


def device_summary(devices=None) -> dict:
    """{"platform", "kind", "count"} of the JAX devices (first device's
    platform and kind, as results report them)."""
    if devices is None:
        import jax

        devices = jax.devices()
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def require_platform(platform: str, count: int = 1, devices=None) -> dict:
    """device_summary(), after checking that at least `count` devices are
    visible and every one of them is on `platform`. Raises RuntimeError
    otherwise: a measurement or check that finds another backend must fail,
    never fall back."""
    if devices is None:
        import jax

        devices = jax.devices()
    found = sorted({d.platform for d in devices})
    if not devices or found != [platform]:
        raise RuntimeError(f"needs {platform} devices; JAX found "
                           f"{len(devices)} on {found or 'none'}")
    if len(devices) < count:
        raise RuntimeError(f"needs {count} {platform} device(s); JAX found "
                           f"{len(devices)}")
    return device_summary(devices)


def gpu_card_info() -> list[str]:
    """One "name, power.limit" line per card, exactly as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. Runs nvidia-smi as a child, so the caller's device state is not
    touched. Raises OSError / CalledProcessError where it cannot run."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
