"""lookup_fetch(table (B, m, 128), off, k): the run offsets read, each row
the slots need read once, k rows and their 9 bytes of slot metadata
written (PERF.md section 6, row 4).  Distinct rows as in ``row_fetch``."""


def work(launch, rows=None):
    b, m, _ = launch["shapes"][0]
    k = int(launch["scalars"][2])
    rows = b * min(k, m) if rows is None else rows
    return b * 2 * m * 4 + rows * 512 + b * k * (512 + 9), 0.0, "float32"
