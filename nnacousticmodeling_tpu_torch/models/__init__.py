from .networks import (GRU, LSTM, MGRUNet, PeepholeLSTM, ZoneoutDropoutLSTM,
                       ZoneoutLSTM, get_network, is_recurrent)
from .precision import HalfPrecisionNet, cast_params

__all__ = ["GRU", "HalfPrecisionNet", "LSTM", "MGRUNet", "PeepholeLSTM",
           "ZoneoutDropoutLSTM", "ZoneoutLSTM", "cast_params", "get_network",
           "is_recurrent"]
