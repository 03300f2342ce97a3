from .features import (cmn, cmn_per_speaker, fbank, fbank_cuda, frame_signal,
                       mfcc)
from .numerics import log_softmax
from .rnn_cuda import (gated_scan, gated_scan_reference, gated_scan_train,
                       lstm_scan, lstm_scan_reference, lstm_scan_train,
                       peephole_scan, peephole_scan_reference,
                       peephole_scan_train)
from .splice import splice_flat, splice_utts
from .timedelay import apply_time_delay

__all__ = ["apply_time_delay", "cmn", "cmn_per_speaker", "fbank",
           "fbank_cuda", "frame_signal", "gated_scan", "gated_scan_reference",
           "gated_scan_train", "log_softmax", "lstm_scan",
           "lstm_scan_reference", "lstm_scan_train", "mfcc", "peephole_scan",
           "peephole_scan_reference", "peephole_scan_train", "splice_flat",
           "splice_utts"]
