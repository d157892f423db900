"""Shared by the layer readers: what each reads from the traced window.
Every function returns None where the trace holds nothing to read."""


def per_batch_ms(run, span):
    """Device ns of the work launched inside ``span``, summed over the
    traced window, per batch."""
    tr = run.trace
    if tr is None or not tr.device or not run.batches:
        return None
    lo, hi = tr.window
    ns = sum(d.end - d.start for d in tr.device
             if lo <= (d.launch or -1) <= hi and tr.span_at(d.launch) == span)
    return ns / 1e6 / run.batches


def upload_ms(run):
    """Device ms a batch of host-to-device copies."""
    tr = run.trace
    if tr is None or not tr.device or not run.batches:
        return None
    lo, hi = tr.window
    ns = sum(d.end - d.start for d in tr.device
             if d.kind == "memcpy" and "HtoD" in d.name and d.end > lo and d.start < hi)
    return ns / 1e6 / run.batches


def idle_pct(run):
    """Share of the traced window with no kernel, copy or fill on the card."""
    tr = run.trace
    if tr is None or not tr.device:
        return None
    lo, hi = tr.window
    return 100.0 * (1.0 - tr.busy_ns() / (hi - lo))


def roofline_pct(run):
    """The least time of each ``torch.ops.yolort_tpu.*`` launch
    (``bounds/<op>.py`` from its shapes, at the card's peaks), summed,
    over their device time summed."""
    tr = run.trace
    if tr is None:
        return None
    cfg = run.cell.config
    es = 4 if cfg["dtype"] == "float32" else 2
    (ch, cw), b = run.canvas, int(run.cell.traffic["batch"])
    levels = [[b, ch // s, cw // s, len(a) // 2 * (5 + cfg["nc"])]
              for s, a in zip(cfg["strides"], cfg["anchors"])]
    least = spent = 0.0
    for op in tr.ops:
        mod = run.bounds.of(op.name)
        if mod is None or op.device_ns <= 0:
            continue
        nbytes, ops, kind = mod.work({"shapes": op.shapes, "dtypes": op.dtypes,
                                      "scalars": op.scalars, "float_bytes": es,
                                      "levels": levels})
        least += run.bounds.least_seconds(nbytes, ops, kind)
        spent += op.device_ns / 1e9
    return 100.0 * least / spent if spent > 0 else None


def mfu_pct(run):
    """The network's FLOPs (counted on the reference network at the cell's
    canvas) times the images done in the traced window, over the window
    and the configuration's dtype peak."""
    tr = run.trace
    if tr is None or not tr.device:
        return None
    peak = run.bounds.peaks["ops_per_s"][run.cell.config["dtype"]]
    return 100.0 * run.flops_per_image * run.images_done / run.window_s / peak
