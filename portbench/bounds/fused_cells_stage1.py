"""fused_cells_stage1(levels, num_anchors, kw): every level's head logits
read once; the cells table (the same values) and the per-anchor max obj
and max class logits written once (PERF.md section 6, row 6).  Where the
profiler recorded no shapes for the list of levels, ``launch["levels"]``
holds the cell's head-output shapes."""


def work(launch):
    levels = launch["shapes"][0]
    if not (levels and isinstance(levels[0], (list, tuple)) and len(levels[0]) == 4):
        levels = launch["levels"]  # a profiler that records no shapes of a tensor list
    a = int(launch["scalars"][1])
    es = launch["float_bytes"]
    nbytes = 0
    for b, h, w, c in levels:
        nbytes += 2 * b * h * w * c * es + 2 * b * h * w * a * es
    return nbytes, 0.0, "float32"
