"""The plain reference against the system's CPU path at a tiny size: the
LSTM and GRU forwards, one training update, the Viterbi decode; and the
benchmark's inputs against the system's own functions where both make
the same thing."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import nets
from benchmark.reference.viterbi import ReferenceDecoder

CPU = torch.device("cpu")


def _model(network):
    return {"network": network, "layers": 2, "units": 32, "in_dim": 40,
            "num_classes": 40, "timedelay": 5}


def _net(model, weights):
    from nnacousticmodeling_tpu_torch.models import get_network
    net = get_network(model["network"], model["layers"], [model["units"]],
                      model["num_classes"], in_dim=model["in_dim"],
                      scan_impl="pallas", device="cpu")
    net.load_state_dict(weights)
    return net


def test_image_is_the_systems_synthetic_image():
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    for seed in (0, 7):
        ours = inputs.synthetic_image(6, 40, seed)
        theirs = make_synthetic_image(num_phones=6, num_states=40, seed=seed,
                                      pdf_tied_transitions=True)
        for key, value in vars(ours).items():
            other = getattr(theirs, key)
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(value, other, err_msg=key)
            else:
                assert value == other, key


@pytest.mark.parametrize("network", ["lstm", "gru"])
def test_param_shapes_are_the_systems(network):
    from nnacousticmodeling_tpu_torch.models import get_network
    model = _model(network)
    net = get_network(network, 2, [32], 40, in_dim=40, device="cpu")
    assert inputs.param_shapes(model) == {
        k: tuple(v.shape) for k, v in net.state_dict().items()}


@pytest.mark.parametrize("network", ["lstm", "gru"])
def test_forward_matches_the_system(network):
    from nnacousticmodeling_tpu_torch.ops.numerics import log_softmax
    model = _model(network)
    w = inputs.model_weights(model, CPU, 3)
    ap = inputs.log_priors(40, CPU, 4)
    x = torch.randn(3, 17, 40, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        y, _ = _net(model, w).apply_sequence(x)
        got = log_softmax(y - ap, dim=-1)
    want = nets.log_posteriors(network, w, x, ap)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("network", ["lstm", "gru"])
def test_training_update_matches_the_system(network):
    model = _model(network)
    w = inputs.model_weights(model, CPU, 8)
    gen = torch.Generator().manual_seed(9)
    xb = torch.randn(4, 5, 40, generator=gen)
    yb = torch.randint(0, 40, (4, 5), generator=gen)
    losses, grads, params, first_logits = nets.train_steps(
        network, w, [(xb, yb)], {"name": "momentumsgd", "lr": 1e-3})
    net = _net(model, w)
    logits, _ = net.apply_sequence(xb, train=True)
    total = F.cross_entropy(logits.reshape(20, -1), yb.reshape(-1),
                            reduction="none").reshape(4, 5).mean(0).sum()
    total.backward()
    torch.testing.assert_close(logits.detach(), first_logits, rtol=0,
                               atol=1e-4)
    assert abs(float(total.detach()) / 5 - losses[0]) <= 1e-5 * abs(
        losses[0])
    for name, p in net.named_parameters():
        scale = float(grads[name].abs().max())
        assert float((p.grad - grads[name]).abs().max()) <= 1e-2 * scale, \
            name
        torch.testing.assert_close(params[name], w[name] - 1e-3 * grads[name])


def test_viterbi_matches_the_system():
    from nnacousticmodeling_tpu_torch.decoder.image import HmmImage
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    image = inputs.synthetic_image(6, 40, 12)
    gen = torch.Generator().manual_seed(13)
    lp = torch.log_softmax(3 * torch.randn(5, 40, 40, generator=gen), -1)
    lengths = np.array([40, 33, 21, 9, 3])
    want = ReferenceDecoder(image, device="cpu").decode(lp, lengths)
    for backend in ("collapsed", "xla"):
        dec = ViterbiDecoder(HmmImage(**vars(image)), pip=20.0, lmw=1.0,
                             backend=backend, device="cpu")
        got = dec.decode_batch(lp.numpy(), lengths)
        assert [r.segments for r in got] == [
            [(b, e, image.phone_names[t]) for b, e, t in u] for u in want]
