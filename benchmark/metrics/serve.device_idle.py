"""The share of the traced window in which no operation ran on the
device."""

LAYER = "device"
UNIT = "%"
MOVES = "decode_audio_s_per_s"
SOURCE = "device_trace"


def read(work):
    tr = work.trace
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
