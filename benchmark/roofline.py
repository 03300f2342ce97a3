"""The chip's peaks and the work a cell's inputs need: operations and
bytes counted from shapes, never from what one route of one kernel
happens to do, so a kernel that does the same work another way is held
to the same least time.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at its
700 W power limit (the run logs the card's limit beside its numbers).
The float32 rate counts a fused multiply-add as two operations; the
decoder's additions, compares and selects are one each, so its least
time, taken at that rate, is a lower bound twice over.
"""

from __future__ import annotations

F32_FLOPS = 67e12          # float32, outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12        # bf16 tensor cores, float32 accumulation
HBM_BYTES_PER_S = 3.35e12

#: operations of one HMM update, a triphone a frame: for each of three
#: states the stay and enter additions, their compare and select, the
#: observation addition; the export addition and its first-max compare
HMM_OPS = 17


def least_s(f32_flops: float = 0.0, bf16_flops: float = 0.0,
            nbytes: float = 0.0) -> float:
    """The least time of the work: its products at their precisions'
    peaks, or its bytes at the memory's, whichever is longer."""
    compute = f32_flops / F32_FLOPS + bf16_flops / BF16_FLOPS
    return max(compute, nbytes / HBM_BYTES_PER_S)


def _dims(model: dict):
    g = {"lstm": 4, "gru": 3}[model["network"]]
    return model["in_dim"], model["units"], model["layers"], g, \
        model["num_classes"]


def network_flops(model: dict, frames: int, train: bool = False):
    """(float32, bf16) FLOPs of the network over ``frames`` input
    frames: the input projections and the output layer in float32, the
    recurrent products in bf16, as the configuration states. Training
    adds each product's two gradients, except the gradient of the
    features, which nothing needs."""
    d, h, n, g, c = _dims(model)
    first = 2 * d * g * h
    deep = (n - 1) * 2 * h * g * h
    out = 2 * h * c
    rec = n * 2 * h * g * h
    if train:
        return frames * (2 * first + 3 * deep + 3 * out), frames * 3 * rec
    return frames * (first + deep + out), frames * rec


def network_least_s(model: dict, frames: int, train: bool = False) -> float:
    f32, bf16 = network_flops(model, frames, train)
    return least_s(f32, bf16)


def recurrence_least_s(model: dict, frames: int, calls: int,
                       train: bool = False) -> float:
    """The recurrent layers over ``frames`` (rows x steps) in ``calls``
    calls a layer: their products (forward; training adds the hidden
    state's and the weights' gradients), the projection read and the
    hiddens written (training adds their gradients), the recurrent
    weights read once a call (training writes their gradient)."""
    _, h, n, g, _ = _dims(model)
    passes = 3 if train else 1
    flops = passes * 2 * h * g * h * frames
    act = frames * (g * h + h) * 4 * (2 if train else 1)
    weights = calls * h * g * h * 4 * (2 if train else 1)
    return n * least_s(bf16_flops=flops, nbytes=act + weights)


def decoder_least_s(triphones: int, num_states: int, frames: int,
                    calls: int, table_bytes: int) -> float:
    """The Viterbi forward over ``frames`` frames: ``HMM_OPS`` operations
    a triphone a frame; each frame's posteriors read once, the image's
    tables once a call."""
    ops = HMM_OPS * triphones * frames
    nbytes = frames * num_states * 4 + calls * table_bytes
    return least_s(f32_flops=ops, nbytes=nbytes)


def image_table_bytes(image) -> int:
    """Bytes of an image's arrays the forward reads."""
    return sum(int(a.nbytes) for a in (
        image.biphone_in, image.state_idxs, image.tp_selfloop,
        image.tp_transition, image.out_values, image.lm, image.end_idxs))
