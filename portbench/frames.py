"""The cell's frames, made from the seed.

A traffic mix names the frame sizes, ``sizes``, cycled over a request's
frames; every seed gets the same sizes.  A pool of ``pool`` requests of ``batch`` frames is
drawn once, uint8 noise made on the device in one call and copied to the
host, where the program takes its frames from.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# the frames' generator is seeded apart from the weights'
FRAME_SEED_OFFSET = 0x5EED_F4A3


def request_sizes(traffic: dict) -> List[Tuple[int, int]]:
    cyc = [tuple(s) for s in traffic["sizes"]]
    return [cyc[i % len(cyc)] for i in range(int(traffic["batch"]))]


def make_pool(traffic: dict, seed: int, device) -> List[List[np.ndarray]]:
    """``pool`` requests, each a list of HWC uint8 frames."""
    shapes = [request_sizes(traffic) for _ in range(int(traffic["pool"]))]
    numel = [h * w * 3 for req in shapes for h, w in req]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + FRAME_SEED_OFFSET) % (2 ** 63))
    flat = torch.randint(0, 256, (sum(numel),), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()
    out, at = [], 0
    for req in shapes:
        frames = []
        for h, w in req:
            frames.append(flat[at:at + h * w * 3].reshape(h, w, 3))
            at += h * w * 3
        out.append(frames)
    return out
