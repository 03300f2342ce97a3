"""The training recurrence's share of its roofline: the least time of
the window's updates through the recurrent layers
(``roofline.recurrence_least_s`` with training: the products and their
gradients, activations and their gradients, the weights and their
gradient) over the device time of the training recurrence kernels
and the dW kernel. None where the trace holds none."""

LAYER = ("training recurrence: ops/rnn_cuda.py *_scan_train, "
         "csrc/*_train.cu, csrc/dw_gemm.cuh")
UNIT = "%"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import layers, roofline
    t = work.trace.seconds(layers.recurrent_train)
    if not t or not work.train_frames:
        return None
    return 100.0 * roofline.recurrence_least_s(
        work.model, work.train_frames, work.updates, train=True) / t
