"""The whole serving step's share of the chip's peak: the least time
of the network's products over the window's input frames, each at
the peak of its stated precision (``roofline.network_least_s``), over
the traced window. The decoder's work has its own roofline."""

LAYER = "whole serving step"
UNIT = "%"
MOVES = "decode_audio_s_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import roofline
    if not work.net_frames or work.trace.window_s <= 0:
        return None
    return 100.0 * roofline.network_least_s(
        work.model, work.net_frames) / work.trace.window_s
