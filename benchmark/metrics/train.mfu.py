"""The whole training step's share of the chip's peak: the least time
of the network's products over the window's training frames
(forward and both gradients) and validation frames (forward), each
at the peak of its stated precision, over the traced window."""

LAYER = "whole training step"
UNIT = "%"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import roofline
    if not work.train_frames or work.trace.window_s <= 0:
        return None
    least = (roofline.network_least_s(work.model, work.train_frames, True)
             + roofline.network_least_s(work.model, work.net_frames))
    return 100.0 * least / work.trace.window_s
