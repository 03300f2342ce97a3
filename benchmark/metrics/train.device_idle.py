"""The share of the traced window (whole epochs: the updates, the
validation and the engine's epoch loop) in which no operation ran on
the device."""

LAYER = "device"
UNIT = "%"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(work):
    tr = work.trace
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
