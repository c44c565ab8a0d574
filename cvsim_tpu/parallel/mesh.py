"""Device-mesh sharding for field batches.

The reference is single-threaded (SURVEY.md section 2.3) so every parallel
strategy here is an original design:

- **dp** axis: fields in a batch are almost independent (inter-field state is
  just fieldno/parity metadata, carried on the host), so the field-batch axis
  shards embarrassingly over devices.
- **sp** axis: scanlines within a field are independent for every per-line
  stage (filters reset per line), so the line axis shards too ("sequence
  parallel" over the raster). The only cross-line ops — VHS vertical chroma
  blend (2-tap line FIR) and the head-switching shift schedule — compile to
  halo exchanges / small collectives emitted by XLA from the sharding
  annotations.

The W (sample) axis stays unsharded: it carries the IIR scans.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor_2d(n: int) -> tuple[int, int]:
    """Split n devices into (dp, sp) as square as possible, dp >= sp."""
    best = (n, 1)
    for sp in range(1, int(math.isqrt(n)) + 1):
        if n % sp == 0:
            best = (n // sp, sp)
    return best


def make_mesh(n_devices: int | None = None, devices=None,
              dp: int | None = None) -> Mesh:
    """2-D ('dp', 'sp') mesh over the first n devices.

    dp: explicit field-parallel extent (sp = n/dp). Line sharding of a small
    batch wants dp == B (e.g. one frame's 2 fields on 4 devices -> dp=2,
    sp=2); the default square-ish factoring suits large batches.

    Raises if fewer than `n_devices` devices are visible — silently shrinking
    the mesh would let an "8-way sharding" check pass on a 1x1 mesh."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) but only {len(devices)} "
                f"device(s) visible on backend "
                f"'{devices[0].platform if devices else '?'}'; for a virtual "
                "CPU mesh set XLA_FLAGS=--xla_force_host_platform_device_count"
                f"={n_devices} and force the cpu platform before backend init")
        devices = devices[:n_devices]
    if dp is not None:
        if len(devices) % dp:
            raise ValueError(f"dp={dp} must divide {len(devices)} devices")
        sp = len(devices) // dp
    else:
        dp, sp = _factor_2d(len(devices))
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))


def field_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Sharding for [B, L, W] (or [B, L, W, C]) field batches:
    fields over dp, scanlines over sp, samples replicated."""
    spec = ("dp", "sp") + (None,) * (ndim - 2)
    return NamedSharding(mesh, P(*spec))


def meta_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-field metadata vectors [B]."""
    return NamedSharding(mesh, P("dp"))


def shard_fields(mesh: Mesh, *arrays):
    """Device-put [B, L, W(, C)] arrays with the field sharding."""
    out = tuple(
        jax.device_put(a, field_sharding(mesh, a.ndim)) for a in arrays
    )
    return out if len(out) > 1 else out[0]


def run_field_sharded_chain(mesh: Mesh, cfg, rgb, fieldno, field_parity,
                            key, dtype=None):
    """Field-parallel gen-2 chain: the field-batch axis shards over every
    device (dp and sp flattened) and each device runs the whole chain on
    its local block via shard_map. Fields are mutually independent and
    noise is content-addressed per (seed, fieldno, stage), so shard outputs
    are bit-identical to the single-device batch and no collectives are
    needed. This is the layout the CLI's `-devices n` uses inside its GOP
    programs (host/pipeline.py, host/pipeline_yiq.py).

    rgb: [B, L, W, 3]; the device count must divide B.
    """
    import jax.numpy as jnp
    from cvsim_tpu.models import yiq

    if dtype is None:
        dtype = jnp.float32
    n = mesh.devices.size
    if rgb.shape[0] % n:
        raise ValueError(
            f"mesh size {n} must divide the field batch {rgb.shape[0]}")
    flat = P(("dp", "sp"))
    data_sh = NamedSharding(mesh, P(("dp", "sp"), None, None, None))
    meta_sh = NamedSharding(mesh, flat)

    def local(rgb, fieldno, field_parity):
        return yiq.composite_layer_rgb(
            rgb, fieldno, field_parity, key, cfg=cfg, dtype=dtype)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(("dp", "sp")), flat, flat),
        out_specs=P(("dp", "sp"))))
    rgb = jax.device_put(jnp.asarray(rgb, jnp.int32), data_sh)
    fieldno = jax.device_put(jnp.asarray(fieldno, jnp.int32), meta_sh)
    field_parity = jax.device_put(jnp.asarray(field_parity, jnp.int32),
                                  meta_sh)
    return fn(rgb, fieldno, field_parity)


def run_sharded_chain(mesh: Mesh, cfg, rgb, fieldno, field_parity, key):
    """Jit + run the full gen-2 chain with explicit shardings over `mesh`:
    fields over dp, scanlines over sp (GSPMD adds the halo exchanges for
    the two cross-line stages). This is the route for one HD frame over
    several devices.

    rgb: [B, L, W, 3]; dp must divide B, sp must divide L.
    """
    import jax.numpy as jnp
    from cvsim_tpu.models import yiq

    data_sh = field_sharding(mesh, 4)
    meta_sh = meta_sharding(mesh)

    def step(rgb, fieldno, field_parity, key):
        return yiq.composite_layer_rgb(
            rgb, fieldno, field_parity, key, cfg=cfg)

    fn = jax.jit(
        step,
        in_shardings=(data_sh, meta_sh, meta_sh, None),
        out_shardings=data_sh,
    )
    rgb = jax.device_put(jnp.asarray(rgb), data_sh)
    fieldno = jax.device_put(jnp.asarray(fieldno), meta_sh)
    field_parity = jax.device_put(jnp.asarray(field_parity), meta_sh)
    return fn(rgb, fieldno, field_parity, key)
