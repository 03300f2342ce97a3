from .networks import LSTM, get_network, is_recurrent
from .precision import HalfPrecisionNet, cast_params

__all__ = ["HalfPrecisionNet", "LSTM", "cast_params", "get_network",
           "is_recurrent"]
