"""The port's Chainer converters (``models/convert.py``) and parity CLI
(``pipeline/parity.py``) against the JAX package's.

On synthetic Chainer-layout ``.npz`` checkpoints (Chainer is not
installed; the layouts are those of ``tests/test_convert.py``): MLP,
LSTM (and the zoneout LSTMs, which share its converter), PeepholeLSTM,
GRU, MGRU with and without the reset gate, TDNN and RPL4, the converted
arrays equal JAX ``convert_checkpoint``'s exactly, key for key; loaded
into the port's networks through ``to_port_params`` they compute the JAX
networks' outputs on the JAX-converted params. ``parity.main`` writes
posteriors within 1e-4 of the JAX CLI's and gives the same verdict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.models import RPL4 as JRPL4
from nnacousticmodeling_tpu.models import TDNN as JTDNN
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.models.convert import (
    convert_checkpoint as j_convert_checkpoint,
)
from nnacousticmodeling_tpu.models.convert import convert_rpl4 as j_rpl4
from nnacousticmodeling_tpu.pipeline.parity import main as j_parity
from nnacousticmodeling_tpu_torch.models import RPL4, TDNN, get_network
from nnacousticmodeling_tpu_torch.models.convert import (
    convert_checkpoint, convert_rpl4, to_port_params,
)
from nnacousticmodeling_tpu_torch.pipeline.parity import main as parity

D, U, C, LAYERS = 4, 5, 7, 2


def _lin(rng, prefix, out, inp, src, bias=True):
    src[f"{prefix}/W"] = rng.standard_normal((out, inp)).astype(
        np.float32) * 0.3
    if bias:
        src[f"{prefix}/b"] = rng.standard_normal(out).astype(np.float32) * 0.1


def chainer_checkpoint(network, rng, in_dim=D):
    """A Chainer-layout state of ``network`` (``predictor/...`` keys)."""
    src = {}
    d = in_dim
    for l in range(LAYERS):
        p = f"predictor/layer_{l}"
        if network == "ff":
            _lin(rng, p, U, d, src)
        elif network in ("lstm", "zoneoutlstm", "peepholelstm"):
            _lin(rng, f"{p}/upward", 4 * U, d, src)
            _lin(rng, f"{p}/lateral", 4 * U, U, src, bias=False)
            if network == "peepholelstm":
                for n in ("peep_i", "peep_f", "peep_o"):
                    _lin(rng, f"{p}/{n}", U, U, src, bias=False)
        else:       # gru, mgrurelu, mgrurelur: six (or four) Linear links
            names = ["W_z", "U_z", "W", "U"]
            if network != "mgrurelu":
                names += ["W_r", "U_r"]
            for n in names:
                _lin(rng, f"{p}/{n}", U, d if n.startswith("W") else U, src)
        d = U
    _lin(rng, "predictor/out", C, U, src)
    return src


NETWORKS = ["ff", "lstm", "zoneoutlstm", "peepholelstm", "gru", "mgrurelu",
            "mgrurelur"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("network", NETWORKS)
def test_converted_arrays_equal_jax(network, tmp_path):
    rng = np.random.default_rng(NETWORKS.index(network))
    path = tmp_path / "model.npz"
    np.savez(path, **chainer_checkpoint(network, rng))
    tree = convert_checkpoint(str(path), network, LAYERS)
    j_tree = j_convert_checkpoint(str(path), network, LAYERS)
    _assert_same_tree(tree, j_tree)

    # the port's net on the converted params computes the JAX net's
    # outputs on the JAX-converted ones
    net = get_network(network, LAYERS, [U], C, in_dim=D, device="cpu")
    net.load_state_dict(to_port_params(tree, net))
    jnet = j_get_network(network, LAYERS, [U], C)
    if network == "ff":
        x = rng.standard_normal((6, D)).astype(np.float32)
        want = np.asarray(jnet.apply(j_tree, jnp.asarray(x)))
        with torch.no_grad():
            got = net.apply(torch.from_numpy(x)).numpy()
    else:
        x = rng.standard_normal((2, 7, D)).astype(np.float32)
        want = np.asarray(jnet.apply_sequence(j_tree, jnp.asarray(x))[0])
        with torch.no_grad():
            got = net.apply_sequence(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tdnn_and_rpl4_convert_as_jax(tmp_path):
    rng = np.random.default_rng(11)
    ks, units = (3, 3), (4, 5)
    src = {}
    in_c = 3
    for l, (k, u) in enumerate(zip(ks, units)):
        src[f"predictor/layer_{l}/W"] = rng.standard_normal(
            (u, in_c, 1, k)).astype(np.float32)
        src[f"predictor/layer_{l}/b"] = rng.standard_normal(u).astype(
            np.float32)
        in_c = u
    _lin(rng, "predictor/out", 6, units[-1], src)
    np.savez(tmp_path / "tdnn.npz", **src)
    tree = convert_checkpoint(str(tmp_path / "tdnn.npz"), "tdnn", 2)
    j_tree = j_convert_checkpoint(str(tmp_path / "tdnn.npz"), "tdnn", 2)
    _assert_same_tree(tree, j_tree)
    net = TDNN(units=units, num_classes=6, ksize=ks, chainer_layout=True,
               in_dim=15, device="cpu")
    net.load_state_dict(to_port_params(tree, net))
    x = rng.standard_normal((4, 15)).astype(np.float32)
    want = np.asarray(JTDNN(units=units, num_classes=6, ksize=ks,
                            chainer_layout=True).apply(j_tree,
                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    rpl_src = {"predictor/W": rng.standard_normal((1, 6)).astype(np.float32),
               "predictor/b": rng.standard_normal((1, 6)).astype(np.float32),
               "predictor/lb": np.full((1, 6), -20.0, np.float32)}
    tree, j_tree = convert_rpl4(rpl_src), j_rpl4(rpl_src)
    _assert_same_tree(tree, j_tree)
    rpl = RPL4(6, device="cpu")
    rpl.load_state_dict(to_port_params(tree, rpl))
    want = np.asarray(JRPL4(6).apply(j_tree, jnp.asarray(x[:, :6])))
    with torch.no_grad():
        got = rpl.apply(torch.from_numpy(x[:, :6])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _write_ft(path, rng, in_dim, shifts):
    """A Kaldi nnet1 feature transform in the reference's fixed-line
    format (kaldi/final.feature_transform:1-7)."""
    dim_out = in_dim * len(shifts)
    fmt = " ".join
    add = [repr(float(v)) for v in rng.standard_normal(dim_out) * 0.2]
    scale = [repr(float(v)) for v in rng.random(dim_out) * 0.5 + 0.75]
    path.write_text(
        "<Nnet> \n"
        f"<Splice> {dim_out} {in_dim} \n"
        f"[ {' '.join(str(s) for s in shifts)} ]\n"
        f"<AddShift> {dim_out} {dim_out} \n"
        f"<LearnRateCoef> 0  [ {fmt(add)} ]\n"
        f"<Rescale> {dim_out} {dim_out} \n"
        f"<LearnRateCoef> 0  [ {fmt(scale)} ]\n"
        "</Nnet> \n")


@pytest.mark.parametrize("network,extra", [
    ("ff", ["--splice", "2", "--ft", "ft.txt", "--ivector-dir", "{d}"]),
    ("lstm", ["--timedelay", "2", "--ft", "ft.txt", "--ivector-dir", "{d}"]),
    ("gru", []),
])
def test_parity_cli_matches_jax(network, extra, tmp_path, capsys):
    rng = np.random.default_rng(5)
    iv_dim = 2 if extra else 0
    shifts = list(range(-2, 3))
    _write_ft(tmp_path / "ft.txt", rng, D, shifts)
    model_in = (D * len(shifts) if network == "ff" else D) + iv_dim
    np.savez(tmp_path / "model.npz",
             **chainer_checkpoint(network, rng, in_dim=model_in))
    lengths = [17, 11]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    np.save(tmp_path / "data_test.npy", rng.standard_normal(
        (offsets[-1], D)).astype(np.float32))
    np.save(tmp_path / "ivectors_test.npy", rng.standard_normal(
        (offsets[-1], 2)).astype(np.float32))
    np.save(tmp_path / "offsets_test.npy", offsets)
    args = ["--checkpoint", tmp_path / "model.npz", "-n", network, "-l",
            str(LAYERS), "-u", str(U), "--num-classes", str(C),
            "--data-dir", tmp_path, "--offset-dir", tmp_path] + [
        a.format(d=tmp_path) for a in extra]
    assert j_parity(args + ["--out", tmp_path / "j.npy"]) is True
    capsys.readouterr()
    ok = parity(args + ["--out", tmp_path / "t.npy", "--device", "cpu",
                        "--reference-posteriors", tmp_path / "j.npy"])
    out = capsys.readouterr().out
    assert ok is True and "PARITY OK" in out
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape == (offsets[-1], C)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    # the same verdicts and lines on a reference that is off, and on one
    # of another shape
    np.save(tmp_path / "off.npy", want + 1e-2)
    np.save(tmp_path / "short.npy", want[:-1])
    for ref in ("off.npy", "short.npy"):
        verdicts = []
        for fn, extra_args in ((j_parity, []), (parity, ["--device", "cpu"])):
            verdicts.append(fn(args + ["--out", tmp_path / "x.npy",
                                       "--reference-posteriors",
                                       tmp_path / ref] + extra_args))
            lines = capsys.readouterr().out.splitlines()
            verdicts.append(lines[-1].split(":")[0 if "shape" in lines[-1]
                                                 else -1].strip())
        assert verdicts[0] is verdicts[2] is False
        assert verdicts[1] == verdicts[3], verdicts
