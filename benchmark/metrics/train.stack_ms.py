"""Device milliseconds an update in the network stack: every device
operation of the window that is neither one of the system's own
kernels, a copy nor the optimizer's step (the products and their
gradients, the loss; the validation's products included), over the
window's updates."""

LAYER = ("training stack: models/networks.py products, output layer, the "
         "loss, their gradients")
UNIT = "ms"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import layers
    t = work.trace.seconds(layers.stack)
    if not t or not work.updates:
        return None
    return 1e3 * t / work.updates
