"""select_extract(table (B, m, 128), phys (B, k), p, is_eq, t, thr_bits):
each row the slots need read once, 9 bytes of slot metadata and a
threshold an image read, a value and an index a slot written (PERF.md
section 6, row 5).  Distinct rows as in ``row_fetch``."""


def work(launch, rows=None):
    b, m, _ = launch["shapes"][0]
    k = launch["shapes"][1][1]
    rows = b * min(k, m) if rows is None else rows
    return rows * 512 + b * k * 9 + b * 4 + b * k * 8, 0.0, "float32"
