from .ensemble import Ensemble, stack_fold_params
from .networks import (GRU, LSTM, MLP, TDNN, MGRUNet, PeepholeLSTM,
                       ZoneoutDropoutLSTM, ZoneoutLSTM, get_network,
                       is_recurrent, redraw_params)
from .precision import HalfPrecisionNet, cast_params
from .rpl import RPL0, RPL1, RPL2, RPL3, RPL4, get_rpl

__all__ = ["Ensemble", "GRU", "HalfPrecisionNet", "LSTM", "MGRUNet", "MLP",
           "PeepholeLSTM", "RPL0", "RPL1", "RPL2", "RPL3", "RPL4", "TDNN",
           "ZoneoutDropoutLSTM", "ZoneoutLSTM", "cast_params", "get_network",
           "get_rpl", "is_recurrent", "redraw_params",
           "stack_fold_params"]
