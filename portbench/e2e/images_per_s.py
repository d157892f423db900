"""Images whose detections came back, over the whole window (its start to
the last call's return)."""


def read(run):
    return run.images_done / run.window_s
