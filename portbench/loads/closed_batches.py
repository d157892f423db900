"""Closed loop: one client calls ``__call__`` back to back, each call on
the next request of the pool, in an order drawn from the seed, until the
window's seconds have passed.  The window ends when the last call
returns."""

from __future__ import annotations

import numpy as np


def warmup(client) -> None:
    """Every request of the pool once (each shape the window uses), then
    one more call."""
    for i in range(len(client.pool)):
        client.call(i)
    client.call(0)


def window(client, seconds: float, seed: int):
    order = np.random.default_rng(int(seed)).permutation(len(client.pool))
    t0 = client.clock()
    records = []
    while client.clock() - t0 < seconds:
        records.append(client.call(int(order[len(records) % len(order)])))
    return t0, records
