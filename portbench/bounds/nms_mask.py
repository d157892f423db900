"""nms_mask(boxes (B, K, 4) f32, valid (B, K), iou_thresh, tile_size,
stop_after): the validity read and the keep mask written for every
candidate; the boxes a greedy pass has to read before its early exit
(the first tile boundary at or past ``stop_after``; all K without one);
12 operations an IoU pair (PERF.md section 6, row 1).

The pairs are in the data: from shapes alone none are counted, so the
bound is the bytes' (``pairs`` adds them)."""

import math


def work(launch, pairs=0):
    b, k, _ = launch["shapes"][0]
    tile, stop = int(launch["scalars"][3]), int(launch["scalars"][4])
    read = k if stop <= 0 else min(k, math.ceil(stop / tile) * tile)
    return 16 * b * read + 2 * b * k, 12.0 * pairs, "float32"
