"""Device milliseconds an update in the optimizer's step (PyTorch's
multi-tensor kernels), over the window's updates."""

LAYER = "optimizer: train/optimizers.py"
UNIT = "ms"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import layers
    t = work.trace.seconds(layers.optimizer)
    if not t or not work.updates:
        return None
    return 1e3 * t / work.updates
