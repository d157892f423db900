"""row_fetch(table (B, m, w), idx (B, k)): the indices read, each row the
slots name read once, the k rows written (PERF.md section 6, row 3).

Which rows the slots name is in the data, not the shapes: from shapes
alone each image is taken to name min(k, m) distinct rows, the most it
can (``rows`` overrides)."""

from portbench.bounds._common import elem_bytes


def work(launch, rows=None):
    b, m, w = launch["shapes"][0]
    k = launch["shapes"][1][1]
    es = elem_bytes(launch, 0)
    rows = b * min(k, m) if rows is None else rows
    return b * k * 4 + rows * w * es + b * k * w * es, 0.0, "float32"
