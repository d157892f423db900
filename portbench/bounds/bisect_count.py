"""bisect_count(table (B, m, 128) f32, k, thr_bits): the table read once,
a threshold a row and two counts a row written (PERF.md section 6, row 2)."""


def work(launch):
    b, m, _ = launch["shapes"][0]
    return b * m * 128 * 4 + b * 4 + 2 * b * m * 4, 0.0, "float32"
