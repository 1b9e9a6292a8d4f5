"""Row-fetch strategies.

Rows of SMALL tables are fetched by a one-hot matmul, larger ones by a
gather. The one-hot fetch is exact under ``Precision.HIGHEST`` (products
against exact 0/1 stay exact). The split was chosen before the H100 port,
where dependent gathers inside device loops were latency-bound; it is
queued for an H100 A/B against ``jnp.take`` (ROADMAP S5).

``fetch_rows`` picks the strategy statically from the table size.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

#: tables up to this many rows use the one-hot matmul path
ONEHOT_MAX_ROWS = 2048


def onehot_fetch(table: jax.Array, idx: jax.Array) -> jax.Array:
    """rows = onehot(idx) @ table, exact. table (R, C); idx (B,) int32
    (out-of-range indices return zero rows)."""
    r = table.shape[0]
    oh = (idx[:, None] == jnp.arange(r, dtype=jnp.int32)[None, :]
          ).astype(jnp.float32)
    return jnp.dot(oh, table, precision=jax.lax.Precision.HIGHEST)


def fetch_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Fetch ``table[idx]`` rows with the strategy suited to the table size
    (static shape ⇒ static choice)."""
    if table.shape[0] <= ONEHOT_MAX_ROWS:
        return onehot_fetch(table, idx)
    return jnp.take(table, idx, axis=0)


def fetch_attr(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Fetch triangle-attribute row ``idx`` from the QUAD-PACKED attribute
    table (4 triangles per 128-col row, 32 cols each — accel/packed.py
    pack_attr_quads). Returns (B, 32).

    Narrow rows gather badly, so four triangles share one packed row and
    two hierarchical halving selects pick the winner's quarter."""
    row = fetch_rows(table, jax.lax.shift_right_logical(idx, 2))
    g = idx & 3
    half = jnp.where((g >= 2)[:, None], row[:, 64:128], row[:, 0:64])
    return jnp.where((g & 1 == 1)[:, None], half[:, 32:64], half[:, 0:32])
