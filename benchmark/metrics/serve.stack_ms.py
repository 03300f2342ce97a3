"""Device milliseconds a batch in the network stack: every device
operation of the window that is neither one of the system's own
kernels nor a copy (the products, the output layer, the log-softmax,
the time-delay trim), over the window's batches."""

LAYER = ("serving stack: models/networks.py products, output layer, "
         "ops/numerics.py log_softmax")
UNIT = "ms"
MOVES = "decode_audio_s_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import layers
    t = work.trace.seconds(layers.stack)
    if not t or not work.batches:
        return None
    return 1e3 * t / work.batches
