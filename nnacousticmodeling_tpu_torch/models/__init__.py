from .networks import GRU, LSTM, MGRUNet, get_network, is_recurrent
from .precision import HalfPrecisionNet, cast_params

__all__ = ["GRU", "HalfPrecisionNet", "LSTM", "MGRUNet", "cast_params",
           "get_network", "is_recurrent"]
