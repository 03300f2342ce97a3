"""The serving recurrence's share of its roofline: the least time of
the window's recurrent layers over the network's input frames
(``roofline.recurrence_least_s``: the bf16 recurrent products, the
projection read and the hiddens written once) over the device time of
the serving recurrence kernels. None where the trace holds none."""

LAYER = ("serving recurrence: ops/rnn_cuda.py lstm_scan, gated_scan, "
         "csrc/*_scan.cu")
UNIT = "%"
MOVES = "decode_audio_s_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import layers, roofline
    t = work.trace.seconds(layers.recurrent_serve)
    if not t or not work.net_frames:
        return None
    return 100.0 * roofline.recurrence_least_s(
        work.model, work.net_frames, work.rec_calls) / t
