"""The Viterbi forward's share of its roofline: the least time of the
window's decoding work (``roofline.decoder_least_s``: the image's
triphones times the decoded frames times the operations of one HMM
update; posteriors read once) over the device time of the decoder's
forward kernels in the trace. None where the trace holds none."""

LAYER = ("decoder: decoder/viterbi.py, viterbi_collapsed.py, "
         "csrc/viterbi_collapsed.cu")
UNIT = "%"
MOVES = "decode_audio_s_per_s"
SOURCE = "device_trace"


def read(work):
    from benchmark import layers, roofline
    t = work.trace.seconds(layers.decoder_forward)
    if not t or not work.decode_frames:
        return None
    least = roofline.decoder_least_s(work.triphones, work.num_states,
                                     work.decode_frames, work.decode_calls,
                                     work.table_bytes)
    return 100.0 * least / t
