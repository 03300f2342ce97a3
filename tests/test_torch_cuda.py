"""The port's CUDA kernels against their plain PyTorch versions, at test
sizes, on the card. Marked ``cuda``; without a card every test skips.
Run on a machine with one: ``python -m pytest tests/test_torch_cuda.py
-m cuda -q``.

Tolerances as in ``test_torch_lstm.py`` for the recurrence (bf16 ``h``
rounding after sums in another order); the Viterbi forward is bit-equal.
The training forward is bit-equal to the ``lstm_scan`` kernel (same code
and FMA order); its residuals are bf16 roundings of values within the
recurrence tolerance, so they may differ by that plus one bf16 ulp
(rtol 2**-7). The backward, given the same residuals, differs from its
plain version only by the order of its float32 sums (and the bf16
roundings of dz those may flip): 1e-3 of each tensor's largest value.
"""

import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
    collapsed_viterbi_reference,
)
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import (
    lstm_scan,
    lstm_scan_reference,
    lstm_scan_train,
    lstm_train_backward,
    lstm_train_backward_reference,
    lstm_train_forward,
    lstm_train_forward_reference,
)

pytestmark = pytest.mark.cuda

BF16_ATOL = 2e-3
RES_RTOL = 2.0 ** -7
BWD_RTOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 4, 32), (13, 3, 40), (8, 33, 64)])
def test_lstm_scan_kernel_matches_plain(cuda, t, b, h, dtype):
    g = torch.Generator().manual_seed(t * 100 + b)
    proj = (torch.randn(t, b, 4 * h, generator=g) * 0.5).to(dtype)
    wh = torch.randn(h, 4 * h, generator=g) * 0.1
    c0 = torch.randn(b, h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.1
    args = [x.to(cuda) for x in (proj, wh, c0, h0)]
    before = kernels.launches["lstm_scan"]
    (ck, hk), hsk = lstm_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_scan"] == before + 1
    (cr, hr), hsr = lstm_scan_reference(*args)
    assert hsk.dtype == dtype and hsk.shape == (t, b, h)
    torch.testing.assert_close(hsk.float(), hsr.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(hk, hr, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("num_phones", [4, 9])
def test_collapsed_viterbi_kernel_bit_equal(cuda, num_phones, beam):
    rng = np.random.default_rng(num_phones)
    img = make_synthetic_image(num_phones=num_phones,
                               num_states=3 * num_phones + 2,
                               seed=num_phones, pdf_tied_transitions=True)
    lens = np.array([23, 7, 16], np.int32)
    lp = np.log(rng.dirichlet(np.ones(img.num_states),
                              size=(3, 23))).astype(np.float32)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, device=cuda)
    ck = dec._collapsed_fwd
    lp_t = torch.from_numpy(lp).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    before = kernels.launches["collapsed_viterbi_forward"]
    packed, end = ck.forward(lp_t, lens_t)
    torch.cuda.synchronize()
    assert kernels.launches["collapsed_viterbi_forward"] == before + 1
    want_packed, want_end = collapsed_viterbi_reference(ck, lp_t, lens_t)
    for u, l in enumerate(lens):
        assert torch.equal(packed[u, :l], want_packed[u, :l])
        assert torch.equal(end[u, :l], want_end[u, :l])
    cpu = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, device="cpu")
    assert [r.segments for r in dec.decode_batch(lp, lens)] == \
        [r.segments for r in cpu.decode_batch(lp, lens)]


def _train_case(t, b, h, dtype, device):
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    proj = (torch.randn(t, b, 4 * h, generator=g) * 0.5).to(dtype)
    wh = torch.randn(h, 4 * h, generator=g) * 0.1
    c0 = torch.randn(b, h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.1
    return [x.to(device) for x in (proj, wh, c0, h0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 4, 32), (13, 33, 40), (8, 3, 64)])
def test_lstm_train_forward_kernel(cuda, t, b, h, dtype):
    args = _train_case(t, b, h, dtype, cuda)
    before = kernels.launches["lstm_train_forward"]
    hs, res, ct, ht = lstm_train_forward(*args)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_train_forward"] == before + 1
    (cs, hs_c), hs_s = lstm_scan(*args)
    assert torch.equal(hs, hs_s) and torch.equal(ct, cs)
    assert torch.equal(ht, hs_c)
    hs_r, res_r, ct_r, ht_r = lstm_train_forward_reference(*args)
    torch.testing.assert_close(hs.float(), hs_r.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(ct, ct_r, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(ht, ht_r, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(res.float(), res_r.float(), rtol=RES_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("proj_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 3, 32), (13, 33, 40), (5, 33, 40),
                                   (13, 3, 32)])
def test_lstm_train_backward_kernel(cuda, t, b, h, proj_dtype):
    args = _train_case(t, b, h, proj_dtype, cuda)
    _, res, _, _ = lstm_train_forward_reference(*args)
    g = torch.Generator().manual_seed(7)
    dhs = torch.randn(t, b, h, generator=g).to(cuda, proj_dtype)
    dct = torch.randn(b, h, generator=g).to(cuda)
    dht = torch.randn(b, h, generator=g).to(cuda)
    before = dict(kernels.launches)
    got = lstm_train_backward(res, args[1], dhs, dct, dht, proj_dtype)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_train_backward"] == \
        before.get("lstm_train_backward", 0) + 1
    assert kernels.launches["lstm_train_dw"] == \
        before.get("lstm_train_dw", 0) + 1
    want = lstm_train_backward_reference(res, args[1], dhs, dct, dht,
                                         proj_dtype)
    for k, w, name in zip(got, want, ["dproj", "dwh", "dc0", "dh0"]):
        assert k.dtype == w.dtype and k.shape == w.shape, name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(k.float(), w.float(), rtol=0,
                                   atol=BWD_RTOL * scale, msg=name)


def test_lstm_scan_train_autograd_on_card(cuda):
    args = [x.requires_grad_() for x in _train_case(6, 8, 32, torch.float32,
                                                    cuda)]
    (ct, ht), hs = lstm_scan_train(*args)
    (hs.square().sum() + ct.sum()).backward()
    got = [x.grad for x in args]
    cpu = [x.detach().cpu().requires_grad_() for x in args]
    (ct, ht), hs = lstm_scan_train(*cpu)
    (hs.square().sum() + ct.sum()).backward()
    for k, w in zip(got, cpu):
        scale = float(w.grad.abs().max())
        torch.testing.assert_close(k.cpu(), w.grad, rtol=0,
                                   atol=1e-2 * scale)


def test_lstm_scan_refuses_grad_on_card(cuda):
    proj, wh, c0, h0 = _train_case(4, 4, 32, torch.float32, cuda)
    wh.requires_grad_()
    with pytest.raises(RuntimeError, match="lstm_scan_train"):
        lstm_scan(proj, wh, c0, h0)
    with torch.no_grad():
        lstm_scan(proj, wh, c0, h0)
