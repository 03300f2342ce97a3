"""The port's CTC loss (``ops/ctc_cuda.py``, ``models/ctc.py::ctc_loss``)
and CTC training step against the JAX package's, which call
``optax.ctc_loss``, on seeded numpy inputs.

Cases: repeated labels, label lengths 0 and 1, right-padded frames, an
utterance exactly at the feasibility limit (labels plus repeats equal to
its frames) and infeasible utterances (optax's loss above 1e4). The loss
within rtol 1e-5, gradients within atol 1e-5: both sides run the same
float32 recursion, so only the order of a few sums differs. Three Adam
steps on a batch with an infeasible utterance: every parameter finite and
within atol 1e-4 of the JAX steps', as ``test_torch_ctc.py``'s steps.

The kernels of ``csrc/ctc_loss.cu`` run only on a card
(``test_torch_cuda.py``); here a numpy transcription of their forward and
adjoint recursions (``_kernel_model``) is held against autograd through
the plain version, and the static-buffer training step bit for bit
against a direct call of its body.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.models.ctc import BiRNNCTC as JBiRNNCTC
from nnacousticmodeling_tpu.models.ctc import ctc_loss as j_ctc_loss
from nnacousticmodeling_tpu.models.ctc import (
    make_ctc_train_step as j_make_step,
)
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.optimizers import (
    make_optimizer as j_make_optimizer,
)
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.models.ctc import (
    BiRNNCTC, _StepProgram, ctc_loss, make_ctc_train_step,
)
from nnacousticmodeling_tpu_torch.ops import ctc_cuda
from nnacousticmodeling_tpu_torch.train import engine, load_jax_params
from nnacousticmodeling_tpu_torch.train import make_optimizer

D, H, PHONES = 6, 12, 5
C = PHONES + 1
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5

# (frames T, labels (B, S) padded with 0, logit lengths, label lengths)
CASES = {
    # repeats: [3, 3] needs 3 frames, [2, 2, 2] needs 5
    "repeats": (9, [[3, 3, 0], [2, 2, 2], [1, 2, 1]], [9, 7, 9], [2, 3, 3]),
    "label_length_0_and_1": (7, [[0, 0], [4, 0], [5, 5]], [7, 5, 1],
                             [0, 1, 1]),
    "right_padded_frames": (12, [[1, 2, 3, 4], [2, 3, 0, 0], [5, 0, 0, 0],
                                 [4, 4, 1, 0]], [12, 6, 2, 9], [4, 2, 1, 3]),
    # labels + repeats == frames: [1, 2, 3] in 3, [2, 2] in 3, [4, 4, 4] in 5
    "feasibility_limit": (8, [[1, 2, 3], [2, 2, 0], [4, 4, 4]], [3, 3, 5],
                          [3, 2, 3]),
    # one frame short of each limit, and a frame-less utterance
    "infeasible": (8, [[1, 2, 3], [2, 2, 0], [4, 4, 4], [1, 5, 1]],
                   [2, 2, 4, 0], [3, 2, 3, 3]),
    # padding equal to the last label (optax's repeat mask reads it)
    "pad_equals_last_label": (6, [[2, 3, 3], [1, 1, 1]], [6, 4], [2, 1]),
    # labels outside [0, C): log-probability 0 (optax's one-hot is zero)
    "out_of_range_label": (7, [[1, C + 2, 2], [3, -1, 4]], [7, 6], [3, 3]),
}


def _case(name, seed=0):
    t, labels, x_lens, y_lens = CASES[name]
    labels = np.array(labels, np.int32)
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((labels.shape[0], t, C))).astype(
        np.float32)
    return (logits, labels, np.array(x_lens, np.int32),
            np.array(y_lens, np.int32))


def _jax_loss_grad(logits, labels, x_lens, y_lens):
    def f(lg):
        return j_ctc_loss(lg, jnp.asarray(x_lens), jnp.asarray(labels),
                          jnp.asarray(y_lens))
    loss, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_per_sequence_matches_jax(name):
    """Each row's loss from ``ctc_loss_reference`` against the JAX loss of
    that row alone (the mean of one)."""
    logits, labels, x_lens, y_lens = _case(name)
    logp = F.log_softmax(torch.from_numpy(logits), dim=-1)
    got = ctc_cuda.ctc_loss_reference(logp, labels, x_lens, y_lens).numpy()
    want = np.array([_jax_loss_grad(logits[i:i + 1], labels[i:i + 1],
                                    x_lens[i:i + 1], y_lens[i:i + 1])[0]
                     for i in range(len(labels))])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    if name == "infeasible":
        assert (want > 1e4).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ctc_loss_and_gradient_match_jax(name):
    logits, labels, x_lens, y_lens = _case(name, seed=1)
    want, want_grad = _jax_loss_grad(logits, labels, x_lens, y_lens)
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = ctc_loss(lt, x_lens, labels, y_lens)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=LOSS_RTOL)
    assert np.isfinite(lt.grad.numpy()).all()
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, atol=GRAD_ATOL,
                               rtol=0)


def test_lengths_as_numpy_lists_or_tensors():
    logits, labels, x_lens, y_lens = _case("right_padded_frames")
    lt = torch.from_numpy(logits)
    want = ctc_loss(lt, x_lens, labels, y_lens)
    for conv in (np.ndarray.tolist, torch.from_numpy,
                 lambda a: torch.from_numpy(a.astype(np.int64))):
        got = ctc_loss(lt, conv(x_lens), conv(labels), conv(y_lens))
        assert torch.equal(got, want)


def test_twins_give_the_plain_loss_and_gradient():
    """``ctc_loss_forward_reference`` gives the plain loss and the states
    after each frame (the last valid frame's give the loss);
    ``ctc_loss_backward_reference`` autograd's gradient."""
    logits, labels, x_lens, y_lens = _case("repeats", seed=2)
    logp = F.log_softmax(torch.from_numpy(logits), dim=-1)
    loss, states = ctc_cuda.ctc_loss_forward_reference(logp, labels, x_lens,
                                                       y_lens)
    S = labels.shape[1]
    assert states.shape == (len(labels), logits.shape[1], 2 * S + 1)
    assert torch.equal(loss, ctc_cuda.ctc_loss_reference(logp, labels,
                                                         x_lens, y_lens))
    for b, (n, L) in enumerate(zip(x_lens, y_lens)):
        phi, em = states[b, n - 1, :S + 1], states[b, n - 1, S + 1:]
        last = phi[L] if L == 0 else torch.logaddexp(phi[L], em[L - 1])
        assert float(-last) == float(loss[b])
    grad = torch.tensor([0.5, -1.0, 2.0])
    lp = logp.clone().requires_grad_(True)
    (ctc_cuda.ctc_loss_reference(lp, labels, x_lens, y_lens) * grad
     ).sum().backward()
    got = ctc_cuda.ctc_loss_backward_reference(logp, labels, x_lens, y_lens,
                                               states, grad)
    assert torch.equal(got, lp.grad)


def _lae(a, b):
    m = np.maximum(a, b)
    return np.float32(m + np.log1p(np.exp(-np.abs(np.float32(a - b)))))


def _threads_for(S):
    """``csrc/ctc_loss.cu``'s block size: the least power of two >= S+1,
    at least 32, at most 256."""
    n = 32
    while n < S + 1 and n < 256:
        n *= 2
    return n


def _blank_sum(part, S, route):
    """The blank gradient of a frame from each position's ``gq + gz``
    (``part``, S+1 values), in the kernel's order: ``"block"`` a tree
    over ``nt = _threads_for(S)`` threads in shared memory (thread n
    holds 0 + part[n]); ``"warp"`` the same tree with position n in lane
    n % 32, slot n // 32: the strides of 32 and more within a lane, then
    ``__shfl_down_sync`` by 16 .. 1 (a lane past the warp reads its own
    value)."""
    f32 = np.float32
    nt = _threads_for(S)
    red = np.zeros(nt, f32)
    for n in range(S + 1):
        red[n] = f32(f32(0.0) + part[n])
    if route == "block":
        off = nt // 2
        while off > 0:
            for tid in range(off):
                red[tid] = f32(red[tid] + red[tid + off])
            off //= 2
        return red[0]
    k = nt // 32
    lanes = red.reshape(k, 32).T.copy()              # [lane, slot]
    h = k // 2
    while h >= 1:
        for j in range(h):
            lanes[:, j] = (lanes[:, j] + lanes[:, j + h]).astype(f32)
        h //= 2
    v = lanes[:, 0].copy()
    for off in (16, 8, 4, 2, 1):
        src = np.array([v[l + off] if l + off < 32 else v[l]
                        for l in range(32)], f32)
        v = (v + src).astype(f32)
    return v[0]


def _class_chains(lab, C):
    """``csrc/ctc_loss.cu``'s warp-route tables over the label positions
    ``lab`` (those before the label length): head[k], the first position
    naming class k, and nxt[n], the next one (-1: none)."""
    head, nxt = [-1] * C, [-1] * len(lab)
    for n in range(len(lab) - 1, -1, -1):
        if lab[n] >= 0:
            nxt[n] = head[lab[n]]
            head[lab[n]] = n
    return head, nxt


def _kernel_model(logp, labels, x_lens, y_lens, grad, route="block"):
    """numpy transcription of ``csrc/ctc_loss.cu``, per utterance and
    lattice position as the kernels run (float32): the forward's states
    and loss, then the backward's adjoint from the seed at the last
    frame down, its blank sum (``_blank_sum``) and its class sums in the
    route's order: ``"block"`` walks every label position for each class,
    ``"warp"`` follows the class's chain (``_class_chains``) over the
    positions before the label length (the rest have a +0 gradient), and
    takes a frame's last two logaddexps from the state after the frame
    where the block route recomputes them."""
    f32 = np.float32
    eps = f32(ctc_cuda.LOG_EPSILON)
    B, T, Cn = logp.shape
    S = labels.shape[1]
    loss = np.zeros(B, f32)
    dlp = np.zeros_like(logp)
    for b in range(B):
        y = labels[b]
        lab = [int(v) if 0 <= v < Cn else -1 for v in y]
        rep = [f32(1.0) if n + 1 < S and y[n] == y[n + 1] else f32(0.0)
               for n in range(S)]
        e_rep = [eps * r for r in rep]
        e_norep = [eps * (f32(1.0) - r) for r in rep]
        n_t = min(max(int(x_lens[b]), 0), T)
        L = min(max(int(y_lens[b]), 0), S)
        head, nxt = _class_chains(lab[:L], Cn)
        phi = [f32(0.0)] + [eps] * S
        em = [eps] * S
        states = [(phi, em)]
        for t in range(n_t):
            row = logp[b, t]
            lb = row[0]
            new_phi, new_em = [], []
            for n in range(S + 1):
                pp = phi[n]
                if n > 0:
                    pp = _lae(phi[n], f32(em[n - 1] + e_rep[n - 1]))
                if n < S:
                    le = row[lab[n]] if lab[n] >= 0 else f32(0.0)
                    new_em.append(_lae(f32(pp + le), f32(em[n] + le)))
                q = f32(pp + lb)
                if n > 0:
                    q = _lae(q, f32(f32(em[n - 1] + lb) + e_norep[n - 1]))
                new_phi.append(q)
            phi, em = new_phi, new_em
            states.append((phi, em))
        loss[b] = -(phi[0] if L == 0 else _lae(phi[L], em[L - 1]))
        # the adjoint
        gP = [f32(0.0)] * (S + 1)
        gE = [f32(0.0)] * (S + 1)
        g = f32(-grad[b])
        if L == 0:
            gP[0] = g
        else:
            o = _lae(phi[L], em[L - 1])
            gP[L] = g * np.exp(phi[L] - o)
            gE[L - 1] = g * np.exp(em[L - 1] - o)
        for t in range(n_t - 1, -1, -1):
            P, E = states[t]
            after = states[t + 1]
            row = logp[b, t]
            lb = row[0]
            gP_prev, gY, gle = [None] * (S + 1), [None] * S, [None] * S
            gZ, gA = [f32(0.0)] * (S + 2), [f32(0.0)] * (S + 2)
            part = [None] * (S + 1)
            for n in range(S + 1):
                p = P[n]
                pp, a = p, None
                if n > 0:
                    a = f32(E[n - 1] + e_rep[n - 1])
                    pp = _lae(p, a)
                q = f32(pp + lb)
                gq, gz = gP[n], f32(0.0)
                if n > 0:
                    z = f32(f32(E[n - 1] + lb) + e_norep[n - 1])
                    o = _lae(q, z) if route == "block" else after[0][n]
                    gq = f32(gP[n] * np.exp(q - o))
                    gz = f32(gP[n] * np.exp(z - o))
                gpp = gq
                if n < S:
                    le = row[lab[n]] if lab[n] >= 0 else f32(0.0)
                    x, yv = f32(pp + le), f32(E[n] + le)
                    o = _lae(x, yv) if route == "block" else after[1][n]
                    gx = f32(gE[n] * np.exp(x - o))
                    gy = f32(gE[n] * np.exp(yv - o))
                    gpp = f32(gpp + gx)
                    gle[n] = f32(gx + gy)
                    gY[n] = gy
                gp, ga = gpp, f32(0.0)
                if n > 0:
                    gp = f32(gpp * np.exp(p - pp))
                    ga = f32(gpp * np.exp(a - pp))
                gP_prev[n] = gp
                gZ[n], gA[n] = gz, ga
                part[n] = f32(gq + gz)
            glb = _blank_sum(part, S, route)
            gP = gP_prev
            gE = [f32(f32(gY[n] + gZ[n + 1]) + gA[n + 1])
                  for n in range(S)] + [f32(0.0)]
            for k in range(Cn):
                v = glb if k == 0 else f32(0.0)
                if route == "block":
                    for n in range(S):
                        if lab[n] == k:
                            v = f32(v + gle[n])
                else:
                    n = head[k]
                    while n >= 0:
                        v = f32(v + gle[n])
                        n = nxt[n]
                dlp[b, t, k] = v
    return loss, dlp


def _wide_case(seed=4):
    """Label rows of S=40 (a 64-thread block, two slots a lane) from 9
    classes, so repeats and long class chains occur, with padded frames,
    an infeasible row and an out-of-range label."""
    rng = np.random.default_rng(seed)
    b, t, s = 3, 60, 40
    logits = (2.0 * rng.standard_normal((b, t, C + 3))).astype(np.float32)
    labels = rng.integers(1, C + 3, (b, s)).astype(np.int32)
    labels[1, 5] = C + 3                         # out of range
    return (logits, labels, np.array([60, 47, 30], np.int32),
            np.array([40, 33, 38], np.int32))


MODEL_CASES = ["repeats", "right_padded_frames", "infeasible",
               "pad_equals_last_label", "out_of_range_label", "wide"]


def _model_case(name):
    if name == "wide":
        logits, labels, x_lens, y_lens = _wide_case()
    else:
        logits, labels, x_lens, y_lens = _case(name, seed=3)
    logp = F.log_softmax(torch.from_numpy(logits), dim=-1)
    grad = np.linspace(0.25, 1.5, len(labels)).astype(np.float32)
    return logp, labels, x_lens, y_lens, grad


@pytest.mark.parametrize("name", MODEL_CASES)
def test_kernel_recursions_match_autograd(name):
    """The kernels' forward and adjoint recursions, transcribed to numpy
    (the block route's orders), against the plain version's loss and
    autograd's gradient."""
    logp, labels, x_lens, y_lens, grad = _model_case(name)
    loss, dlp = _kernel_model(logp.numpy(), labels, x_lens, y_lens, grad)
    lp = logp.clone().requires_grad_(True)
    want = ctc_cuda.ctc_loss_reference(lp, labels, x_lens, y_lens)
    (want * torch.from_numpy(grad)).sum().backward()
    np.testing.assert_allclose(loss, want.detach().numpy(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(dlp, lp.grad.numpy(), atol=GRAD_ATOL, rtol=0)
    assert (dlp[np.arange(logp.shape[1])[None, :]
                >= x_lens[:, None]] == 0).all()


@pytest.mark.parametrize("name", MODEL_CASES)
def test_warp_route_recursions_equal_block_route(name):
    """The warp route's transcription (class sums along the chains, the
    blank sum in lanes and shuffles) gives the block route's bits, and so
    autograd's gradient within the same tolerance."""
    logp, labels, x_lens, y_lens, grad = _model_case(name)
    args = (logp.numpy(), labels, x_lens, y_lens, grad)
    loss, dlp = _kernel_model(*args, route="warp")
    want_loss, want_dlp = _kernel_model(*args, route="block")
    assert np.array_equal(loss, want_loss)
    assert np.array_equal(dlp, want_dlp)
    lp = logp.clone().requires_grad_(True)
    (ctc_cuda.ctc_loss_reference(lp, labels, x_lens, y_lens)
     * torch.from_numpy(grad)).sum().backward()
    np.testing.assert_allclose(dlp, lp.grad.numpy(), atol=GRAD_ATOL, rtol=0)


def test_blank_sum_orders_and_class_chains():
    """The warp route's blank sum is the block route's tree, bit for bit,
    at every block size (S+1 from 1 to 256), and not the sequential sum;
    the class chains list each class's positions in order of n."""
    rng = np.random.default_rng(6)
    seq_differs = False
    for S in (0, 1, 30, 31, 32, 33, 63, 64, 100, 127, 128, 200, 255):
        part = (rng.standard_normal(S + 1) * 10.0 ** rng.uniform(
            -3, 3, S + 1)).astype(np.float32)
        block = _blank_sum(part, S, "block")
        assert _blank_sum(part, S, "warp").tobytes() == block.tobytes(), S
        seq = np.float32(0.0)
        for v in part:
            seq = np.float32(seq + v)
        seq_differs |= seq != block
    assert seq_differs
    lab = [3, 1, 3, -1, 0, 3, 1, 0]
    head, nxt = _class_chains(lab, 5)
    for k in range(5):
        chain, n = [], head[k]
        while n >= 0:
            chain.append(n)
            n = nxt[n]
        assert chain == [n for n, v in enumerate(lab) if v == k], k


def test_route_rule():
    """One warp an utterance up to 255 labels and 4096 classes, else one
    block; ``route="block"`` forces the block route; nothing else is a
    route."""
    assert ctc_cuda.ctc_route(50, 49) == "warp"
    assert ctc_cuda.ctc_route(255, 4096) == "warp"
    assert ctc_cuda.ctc_route(256, 49) == "block"
    assert ctc_cuda.ctc_route(50, 4097) == "block"
    assert ctc_cuda.ctc_route(50, 49, "block") == "block"
    with pytest.raises(ValueError, match="route must be"):
        ctc_cuda.ctc_route(50, 49, "warp")


def test_kernel_wrappers_refuse_cpu_tensors():
    logits, labels, x_lens, y_lens = _case("repeats")
    logp = torch.from_numpy(logits)
    args = (torch.from_numpy(labels), torch.from_numpy(x_lens),
            torch.from_numpy(y_lens))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ctc_cuda.ctc_loss_forward(logp, *args)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ctc_cuda.ctc_loss_backward(logp, *args, logp, torch.ones(3))


# ---- the training step -------------------------------------------------------

def _pair(seed=0):
    jm = JBiRNNCTC(base=j_get_network("lstm", 2, [H], 1), num_phones=PHONES)
    params = jm.init(jax.random.PRNGKey(seed), D)
    pm = BiRNNCTC(get_network("lstm", 2, [H], 1, in_dim=D, device="cpu"),
                  PHONES)
    pm.load_state_dict(load_jax_params(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return jm, params, pm


def _infeasible_batch(seed=1):
    """``test_torch_ctc.py``'s batch with its third utterance cut to 3
    frames and given labels [3, 3, 2, 1] (5 frames needed)."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((3, 17, D)).astype(np.float32)
    x_lens = np.array([17, 11, 3], np.int32)
    labels = np.array([[1, 2, 3, 4, 2], [5, 1, 0, 0, 0], [3, 3, 2, 1, 0]],
                      np.int32)
    y_lens = np.array([5, 2, 4], np.int32)
    return xs, x_lens, labels, y_lens


def test_train_steps_with_infeasible_utterance_match_jax():
    jm, params, pm = _pair()
    xs, x_lens, labels, y_lens = _infeasible_batch()
    opt = j_make_optimizer("adam", 1e-3)
    opt_state = opt.init(params)
    j_step = j_make_step(jm, opt)
    step = make_ctc_train_step(pm, make_optimizer("adam", 1e-3,
                                                  pm.parameters()))
    for _ in range(3):
        params, opt_state, j_loss = j_step(
            params, opt_state, jnp.asarray(xs), jnp.asarray(x_lens),
            jnp.asarray(labels), jnp.asarray(y_lens), None)
        loss = step(torch.from_numpy(xs), x_lens, labels, y_lens)
        assert float(j_loss) > 1e4
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    got = pm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = _path_str(path).replace("/", ".")
        assert np.isfinite(got[key].numpy()).all(), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(leaf),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_static_buffer_step_equals_direct_body():
    """Three steps of ``make_ctc_train_step`` (static buffers; two input
    shapes, so two programs) bit for bit against the step body called
    directly on the inputs."""
    xs, x_lens, labels, y_lens = _infeasible_batch()
    x_lens = np.array([17, 11, 9], np.int32)       # feasible
    y_lens = np.array([5, 2, 3], np.int32)
    batches = [(xs, x_lens, labels, y_lens),
               (xs[:2, :12], np.minimum(x_lens[:2], 12), labels[:2],
                y_lens[:2]),
               (xs, x_lens, labels, y_lens)]
    _, _, got_m = _pair()
    _, _, want_m = _pair()
    step = make_ctc_train_step(got_m, make_optimizer(
        "adam", 1e-3, got_m.parameters()))
    opt = make_optimizer("adam", 1e-3, want_m.parameters())
    for x, xl, y, yl in batches:
        got = step(torch.from_numpy(x), xl, y, yl)
        logits = want_m.apply_sequence(torch.from_numpy(x), lengths=xl,
                                       train=True)
        want = ctc_loss(logits, xl, y, yl)
        opt.zero_grad(set_to_none=True)
        want.backward()
        opt.step()
        assert torch.equal(got, want.detach())
    for (name, a), b in zip(got_m.state_dict().items(),
                            want_m.state_dict().values()):
        assert torch.equal(a, b), name


def test_step_program_captures_once_and_pins_its_generator(monkeypatch):
    """The graph bookkeeping with ``_capture_update`` faked (no card): the
    first call is direct, the second captures (with the step's
    generator) and replays, the third replays; another generator
    raises."""
    _, _, pm = _pair()
    xs, x_lens, labels, y_lens = _infeasible_batch()
    captured = []

    class FakeGraph:
        def __init__(self, fn):
            self.fn, self.replays = fn, 0

        def replay(self):
            self.replays += 1
            self.fn()

    def fake_capture(fn, generator):
        captured.append(generator)
        return FakeGraph(fn), {}

    monkeypatch.setattr(engine, "_capture_update", fake_capture)
    gen = torch.Generator().manual_seed(0)
    prog = _StepProgram(pm, make_optimizer("adam", 1e-3, pm.parameters()),
                        torch.from_numpy(xs), torch.from_numpy(labels), gen,
                        graph=True)
    losses = [prog(torch.from_numpy(xs), x_lens, torch.from_numpy(labels),
                   y_lens, gen) for _ in range(3)]
    assert captured == [gen] and prog.updates.graph.replays == 2
    assert all(np.isfinite(float(v)) for v in losses)
    with pytest.raises(ValueError, match="another generator"):
        prog(torch.from_numpy(xs), x_lens, torch.from_numpy(labels), y_lens,
             torch.Generator().manual_seed(0))


def test_interleaved_shapes_match_jax_step_call_for_call():
    """``make_ctc_train_step`` through three input shapes in an
    interleaved order (A, B, A, C, B, C): each loss within the file's
    rtol of the JAX jitted step's on the same call, and the params after
    the six updates within its atol."""
    jm, params, pm = _pair()
    xs, x_lens, labels, y_lens = _infeasible_batch()
    shapes = {"A": (17, 5), "B": (13, 4), "C": (9, 3)}
    batches = {}
    for key, (t, s) in shapes.items():
        batches[key] = (xs[:, :t], np.minimum(x_lens, t), labels[:, :s],
                        np.minimum(y_lens, s))
    opt = j_make_optimizer("adam", 1e-3)
    opt_state = opt.init(params)
    j_step = j_make_step(jm, opt)
    step = make_ctc_train_step(pm, make_optimizer("adam", 1e-3,
                                                  pm.parameters()))
    for key in "ABACBC":
        x, xl, y, yl = batches[key]
        params, opt_state, j_loss = j_step(
            params, opt_state, jnp.asarray(x), jnp.asarray(xl),
            jnp.asarray(y), jnp.asarray(yl), None)
        loss = step(torch.from_numpy(np.ascontiguousarray(x)), xl, y, yl)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5,
                                   err_msg=key)
    got = pm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = _path_str(path).replace("/", ".")
        np.testing.assert_allclose(got[key].numpy(), np.asarray(leaf),
                                   atol=1e-4, rtol=0, err_msg=key)
