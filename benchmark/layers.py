"""Which layer of the system a device operation belongs to, by its name
in the profiler's trace.

The system's own kernels are named in its CUDA sources
(``nnacousticmodeling_tpu_torch/csrc``); the network stack's products
are cuBLAS's and its element-wise work PyTorch's; the optimizer's step
runs PyTorch's multi-tensor (foreach) kernels.
"""

from __future__ import annotations

RECURRENT_SERVE = ("lstm_scan_persistent", "gated_scan_persistent",
                   "peephole_scan_persistent")
RECURRENT_TRAIN = ("lstm_train_fwd_persistent", "lstm_train_bwd_persistent",
                   "gated_train_fwd_persistent",
                   "gated_train_bwd_persistent",
                   "peephole_train_fwd_persistent",
                   "peephole_train_bwd_persistent", "dw_gemm_kernel")
DECODER = ("viterbi",)
SYSTEM = RECURRENT_SERVE + RECURRENT_TRAIN + DECODER + ("ctc_loss", "fbank")
OPTIMIZER = ("multi_tensor_apply", "fused_sgd", "fused_adam")
#: the profiler's copies and fills, and the kernels CUDA graphs run for
#: their copy nodes
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def has(name: str, parts) -> bool:
    return any(p in name for p in parts)


def recurrent_serve(name: str) -> bool:
    return has(name, RECURRENT_SERVE)


def recurrent_train(name: str) -> bool:
    return has(name, RECURRENT_TRAIN)


def decoder_forward(name: str) -> bool:
    return has(name, DECODER) and "backtrace" not in name


def copy(name: str) -> bool:
    return name.startswith(COPIES)


def optimizer(name: str) -> bool:
    return has(name, OPTIMIZER)


def stack(name: str) -> bool:
    """The network stack: every device operation that is not one of the
    system's own kernels, a copy or the optimizer's step."""
    return not (has(name, SYSTEM) or copy(name) or optimizer(name))
