#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit):

1. device: a CUDA card is required; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel in ``nnacousticmodeling_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and prints the seconds;
3. ``lstm_scan`` against its plain version on the card at the main
   path's shapes (T=512, B=128, H=1024), with timings and the bound; a
   second call on the same inputs must give the same bits;
4. ``collapsed_viterbi_forward`` against its plain version on the card,
   on the synthetic 48-phone 1909-pdf image at the main path's shapes
   (128 utterances x 512 frames), with and without a beam, on both
   routes: the plan's cluster route (16 blocks an utterance, the DP
   state in shared memory) and the device-memory route (``route=
   "global"``): packed rows and end scores bit-equal within lengths, a
   second call bit-identical, no (U, 3, PS, L) scratch on the cluster
   route; each route's ms and microseconds a frame, the cluster size and
   the co-resident cluster count; on NaN rows (an 8-phone image, an
   all-NaN and a half-NaN frame) both routes without and with a beam
   equal to the plain version (packed rows; end scores, NaN where NaN);
5. the slice: a synthetic corpus of 128 test utterances of about 400
   frames, an LSTM 4x1024 -> 1909 with numpy-seeded weights carried in
   through ``load_jax_params``, prior-subtracted ``rnn_log_posteriors``,
   ``decode_corpus``, MLF, PER. The three kernels' launch counts
   (``lstm_scan``, the Viterbi, the backtrace) must be > 0 for that run,
   the Viterbi's on the cluster route and none on the device-memory
   route. The plain LSTM's posteriors must agree within the stated
   tolerance, and the plain Viterbi's decode (plain forward and plain
   backtrace) of the kernel run's posteriors must give identical
   segments and PER. Then ``viterbi_backtrace`` against its plain walk
   on the collapsed rows of phase 5's posteriors in one 512-frame batch,
   on the route its rule picks (tables in shared memory) and on the
   global route: segs (padding included) and counts bit-equal, the
   segments phase 5's; each route's ms with L2 flushed and warm, the
   plain walk's ms, the bound; the same on rows of posteriors that
   favour each frame's target pdf, whose walks have a trained model's
   length (the random net decodes an utterance to one or two segments),
   and microseconds a hop as the slope between the two row sets;
6. a profiled repeat of the slice: device busy share and top device ops;
   ``lstm_scan`` must have run as one device kernel a layer, the decode
   as ``collapsed_viterbi_cluster_kernel`` and never as the
   device-memory route's kernel;
7. ``lstm_train_forward`` against its plain version at the training
   shapes (T=20, B=128, H=1024), f32 and bf16 proj: hs, c_T, h_T
   bit-equal to the ``lstm_scan`` kernel's (one kernel body) and within
   the stated tolerance of the plain version, residuals within theirs;
   device microseconds a step;
8. ``lstm_train_backward`` and its dW kernel ``lstm_train_dw`` against
   their plain versions on the same residuals, a second backward call
   bit-identical, device microseconds a reverse step, with cuDNN
   ``nn.LSTM`` bf16 forward and backward timed beside them as the
   yardstick; the dW kernel, its plain version and a cuBLAS bf16
   ``matmul`` of the same operands also by device time (a dW call is
   shorter than the host time of a Python call);
9. the training slice: ``train_cli.main`` trains LSTM 4x1024 -> 1909
   (TBPTT, batch 128, bprop 20, momentumsgd lr 1e-2, 2 epochs) on phase
   5's corpus written as a corpus tree; the training kernels and the
   validation's ``lstm_scan`` must all be launched, every loss finite,
   epoch 2's train loss below epoch 1's, and ``model.npz`` must load
   into the serving network;
10. 3 updates through ``train_network`` with the kernels against the
    same 3 updates with the plain versions (per-update losses within the
    stated tolerance), then one ``--dtype bfloat16`` epoch;
11. a profiled repeat of 3 updates: device busy share and top ops; one
    persistent forward and one backward device kernel a layer an update;
12. the gated kernels against their plain versions, for each kind (gru,
    mgru_r, mgru): ``gated_scan`` at the serving shapes (T=512, B=128,
    H=1024; its layout and device microseconds a step),
    ``gated_train_forward`` (one persistent launch; hs and h_T bit-equal
    to ``gated_scan``'s, one kernel body; a second call bit-identical;
    its layout and device microseconds a step), ``gated_train_backward``
    (one persistent launch; a second call bit-identical; device
    microseconds a reverse step) and its dW kernel ``gated_train_dw`` at
    the training shapes (T=20), f32 and bf16 proj, with cuDNN ``nn.GRU``
    bf16 timed beside them as a yardstick of like work (it applies r
    after the product, so it is not the same function); the dW kernel
    against cuBLAS bf16 ``matmul`` of the same operands (dW1, and dW2 on
    a precomputed bf16(r * h_prev)) by device time;
13. the GRU serving slice: phase 5's corpus and decoder, a GRU 4x1024
    -> 1909 with numpy-seeded weights, ``rnn_log_posteriors``,
    ``decode_corpus``, MLF, PER; ``gated_scan`` must be launched once a
    layer (one persistent device kernel a layer in a profiled repeat of
    the posteriors) and the Viterbi kernel launched, the posteriors agree
    with the plain GRU's and the plain Viterbi gives identical segments
    and PER;
14. the GRU training slice: ``train_cli.main`` with ``-n gru -l 4 -u
    1024 --timedelay 5 -d 0.2`` (TBPTT b128 L20, momentumsgd lr 1e-2, 2
    epochs) on phase 9's corpus tree; the gated training kernels and
    the validation's ``gated_scan`` must be launched, every loss finite,
    epoch 2's train loss below epoch 1's, ``model.npz`` must load into
    the serving GRU;
15. 3 kernel updates against 3 plain ones through ``train_network`` for
    each of gru, mgrurelu and mgrurelur at 4x1024;
16. a profiled repeat of 3 GRU updates: device busy share and top ops;
    one persistent forward and one persistent backward device kernel a
    layer an update, and no other gated recurrence kernel;
17. the peephole kernels against their plain versions:
    ``peephole_scan`` at the serving shapes (T=512, B=128, H=1024), f32
    and bf16 proj, with device microseconds a step;
    ``peephole_train_forward`` at T=20 (hs, c_T and h_T bit-equal to
    ``peephole_scan``'s: one kernel body; a second call bit-identical),
    ``peephole_train_backward`` and its dW kernel
    ``peephole_train_dw`` on the same residuals (a second backward call
    bit-identical), device microseconds a step of both persistent
    kernels, with cuDNN ``nn.LSTM`` bf16 timed beside them as a yardstick
    of like work (cuDNN has no peephole LSTM); the dW kernel against four
    cuBLAS bf16 ``matmul`` calls of the same operands by device time;
18. the PeepholeLSTM serving slice: phase 5's corpus and decoder, a
    PeepholeLSTM 4x1024 -> 1909 with numpy-seeded weights carried in
    through ``load_jax_params``; ``peephole_scan`` must be launched once
    a layer (one persistent device kernel a layer in a profiled repeat of
    the posteriors) and the Viterbi kernel launched, the posteriors agree
    with the plain net's and the plain Viterbi gives identical segments
    and PER;
19. the PeepholeLSTM training slice: ``train_cli.main -n peepholelstm -l
    4 -u 1024`` with phase 9's configuration on phase 9's corpus tree;
    the three training kernels and the validation's ``peephole_scan``
    must be launched, every loss finite, epoch 2's train loss below
    epoch 1's, ``model.npz`` must load into the serving net; then 3
    kernel updates against 3 plain ones;
20. ZoneoutLSTM with the SPECOM configuration (``-n zoneoutlstm -l 4 -u
    1024 --timedelay 5 -d 0.2``): its serving posteriors go through
    ``lstm_scan`` and equal phase 5's LSTM posteriors on the same weights
    bit for bit; two ``train_cli`` epochs launch no training kernel (the
    JAX package has none for it either), the validation launches
    ``lstm_scan``, the loss is finite and falls; then 3 of its updates
    profiled (device busy share);
21. a profiled repeat of 3 PeepholeLSTM updates: device busy share and
    top ops; one persistent forward and one backward device kernel a
    layer an update;
22. ``cube_viterbi_forward`` against its plain version on phase 4's
    image and on a copy whose ends are (p, (p+1) mod P), which the
    collapsed kernel refuses, at phase 4's shapes, exact and with the
    beam, on both routes as phase 4: packed rows and end scores
    bit-equal within lengths, a second call bit-identical, each route's
    ms and microseconds a frame; on phase 4's NaN rows both routes
    without and with a beam equal to the plain version;
    ``viterbi_backtrace`` bit-equal to its plain walk on the cube rows of both images on both routes (the
    lane-map table staged as int16, and read from device memory), each
    timed on the regular image's rows;
23. the decoder's backends on phase 5's LSTM posteriors: ``pallas``
    launches the cube kernel and the backtrace, ``xla`` the
    ``viterbi_scan_forward`` kernel and the backtrace, and both give
    phase 5's segments and PER;
    ``auto`` picks ``pallas`` on the irregular-end copy and ``xla`` on an
    untied-transition 48-phone 1909-pdf image, which decodes every
    utterance through the scan kernel; decode-stage ms and audio-s/s of
    each route; the scan kernel's two routes (the plan's cluster route,
    16 blocks an utterance with the DP state in shared memory, and the
    device-memory route, ``route="global"``) on that untied image and
    phase 4's inputs each bit-equal to both plain twins (the cube twin
    and the general one) and to each other; on a copy of 16 utterances
    with an all-NaN frame, a half-NaN frame and a -inf frame, on the
    untied and on a non-cube 48-phone 1909-pdf image
    (``full_context=False``), without and with a beam, both routes
    bit-equal to the general twin; on the non-cube image at phase 4's
    inputs likewise; both routes timed in turns (CUDA events, and device
    time), exact, with the beam and on the non-cube image, beside the
    cube twin (wall and device time, once), the general twin (once), the
    co-resident clusters and the bounds: the contract's (inputs read and
    outputs written once), the device-memory route's floor (the DP
    state's 48 bytes a slot a frame in device memory) and the cluster
    route's (its load/store bytes a slot a frame at 128 B a clock);
    ``viterbi_backtrace`` bit-equal to its plain walk on the scan
    kernel's rows on both routes, each timed;
24. the ``fbank`` kernel against its plain version on one seeded
    waveform as long as the test set's audio, with both mel conventions,
    within 1e-3 in the log domain, its frames entry bit-equal to its
    waveform entry; on a wide-range waveform (a loud tone, noise 60 dB
    down, a stretch of zeros) no farther from a float64 twin than the
    plain version, plus 1e-4; both entries' device time beside their
    bounds, and cuFFT ``torch.fft.rfft(frames * win, n=512)`` as a
    yardstick of like work;
25. the raw-audio serving slice: 128 seeded waveforms whose frame counts
    are the test utterances' lengths -> ``fbank_cuda`` -> ``cmn`` -> LSTM
    4x1024 posteriors -> ``decode_corpus`` with ``backend="pallas"`` -> MLF
    -> PER. ``fbank``, ``lstm_scan`` and ``cube_viterbi_forward`` must be
    launched (the cube kernel on its cluster route); each utterance's
    ``fbank_cuda`` output must be within 1e-3 of the plain ``fbank`` before
    CMN, the plain route (plain fbank, plain LSTM) must give posteriors
    within POSTERIOR_ATOL, and the plain cube Viterbi on the kernel run's
    posteriors identical segments and PER. Then the device time of the
    batch's 128 ``fbank`` launches, summed under the profiler;
26. FF serving: an MLP 8x2048 relu -> 1909 with numpy-seeded weights
    carried in through ``load_jax_params`` on phase 5's test set spliced
    +-5 (440-dim) -> ``ff_log_posteriors`` with priors ->
    ``decode_corpus`` -> MLF -> PER; the posteriors within
    POSTERIOR_ATOL of the same net on the CPU, the collapsed Viterbi
    launched on its cluster route, the plain Viterbi's segments and PER
    identical; audio-s/s and the posterior-stage ms;
27. FF and TDNN training through ``train_cli.main`` on phase 5's corpus
    written as a tree: ``-n ff -l 8 -u 2048 -a relu --splice 5 -d 0.2 -b
    1024 -o momentumsgd``, 2 epochs, float32 and then ``--dtype
    bfloat16``; ``-n tdnn --tdnn-ksize 5 5 9 9 -u 1024 x4 -a relu -d 0.2
    -b 256``, 1 epoch. Every loss finite, the FF's epoch-2 train loss
    below epoch 1's, each ``model.npz`` loads into its serving net; ms
    per update and train frames/s beside the FLOP bound of an update at
    the f32 CUDA-core and the dense bf16 tensor peaks;
28. the six-phase master pipeline (``master.main --num-folds 5
    --gen-folds``, the default spec ``-n lstm -l 4 -u 1024 --timedelay 5
    -d 0.2``, two stages of one epoch, RPL4 2 epochs) on that corpus
    with its training utterances spread over 40 speakers, so every fold
    holds some: each phase runs (1 fold generation, the master, 5 folds,
    2 predictions, the RPL, 6 evaluations, each timed), the LSTM training
    kernels with their dW, ``lstm_scan`` and the collapsed Viterbi are
    launched, the RPL's losses are finite, six finite PERs come back;
29. ensemble serving through ``evaluate.main --rpl`` on phase 28's
    master, 5 folds and RPL over phase 5's test frames: ``lstm_scan``
    launched 6x as often as for the master alone through the same call
    (K + 1 passes, every layer on the kernel), the plain route
    (``--scan-impl xla``, the same ensemble) within POSTERIOR_ATOL, the
    plain Viterbi's segments and PER identical; audio-s/s of the 6-net
    ensemble beside the master alone and phase 5's single net;
30. fold-parallel training: ``train_cli --train-all-folds`` on phase
    28's fold tree at its spec (LSTM 4x1024 ``--timedelay 5 -d 0.2``, 5
    folds, the master's two 1-epoch stages), timed beside phase 28's five
    sequential fold trainings: the LSTM training kernels launched 5 folds
    x 4 layers x the updates, ``lstm_scan`` 5 x 4 a validation, every
    fold's loss finite and lower in stage 2, the five ``fold_k.npz``
    loading into the serving net with the returned params; then 3 updates
    of ``train_folds_parallel`` (5 folds, dropout 0) on the kernels
    against the plain versions, per fold and update within
    E2E_LOSS_RTOL, and every parameter's change in every fold within
    E2E_CHANGE_RTOL of the plain change's largest magnitude;
31. the native decoder (``native/``, built by ``build_native`` into
    ``build/native/`` during phase 30): one utterance of phase 5's
    posteriors timed on one host thread, its segments phase 5's card
    decode; then ``evaluate --decoder native`` on the first N test
    utterances (N from that time, 8 to 128), its MLF and PER identical to
    ``evaluate --decoder tpu``'s; ``--lm-from-mlf`` (a bigram from the
    train and dev transcripts) through the card decoder, its MLF
    identical to the plain decode's on the same LM image;
32. CTC: ``BiRNNCTC`` over an LSTM 4x1024 (48 phones + blank) on phase
    5's 128 training utterances as one padded batch, labels from the
    reference MLF: CTC_STEPS Adam steps of ``make_ctc_train_step`` (the
    first a direct call, the second the capture, the rest CUDA graph
    replays) on the training kernels (2 directions x 4 layers launches a
    step) and the CTC loss kernels (one forward and one backward a
    step), the loss finite and falling; the same steps by direct call
    (``cuda_graph=False``): losses, params and launch counts bit-equal;
    the first step's loss within E2E_LOSS_RTOL of the plain route's (the
    plain recurrences and CTC twins) and its gradients of every
    parameter within CTC_GRAD_RTOL of the plain gradient's largest
    magnitude. Six (T, S) shapes of the batch (CTC_SHAPES) through one
    step function in an interleaved order (CTC_ORDER), by graph and by
    direct call: losses and params bit-equal, and the memory reserved
    after the six captures within CTC_POOL_RATIO of the largest shape's
    alone (the graphs share one pool). The CTC loss kernels' two routes
    on the model's log-probabilities and on a copy whose first utterance
    cannot fit its labels: the warp route (the main path's) bit-equal to
    the block route; each against the plain twins, loss within
    CTC_LOSS_RTOL, gradient within CTC_LOSS_GRAD_RTOL of the plain one's
    largest magnitude, all finite (the cut utterance's loss optax's large
    value), two runs bit-equal; the block route against the twins at S =
    CTC_LONG_S, past the warp route. Logged: ms a step by graph and by
    direct call, the capture step's ms, one profiled replayed step's
    device ms, the reserved GB after each shape's capture, each route's
    ms and us a frame, the twins' and ``F.ctc_loss``'s forward and
    backward (the library yardstick, on the feasible batch);
33. data and tensor parallel training across RANKS gloo ranks
    time-sharing the card (the script re-invoked as ``--rank-worker R
    DIR`` for each rank; one launch runs 33-35's multi-rank parts, each
    rank's process group with a 60 s timeout, the launch with
    RANK_TIMEOUT_S, the children killed after it): ``train_cli --mesh
    data=2`` at phase 9's spec for 1 epoch (64 rows a rank on the kernel
    route), rank 0's model against the single-process run of the same
    epoch (losses within E2E_LOSS_RTOL, every leaf's change within
    E2E_CHANGE_RTOL of the single run's largest, 19 updates x 4 layers
    launches of each training kernel); one FF 8x2048 -> 1909 update
    (phase 27's spec) at ``data=1,model=2``, its hidden layers
    column-parallel, against the single update with the same gates (and
    both against a float64 twin, logged);
34. ``train_folds_parallel`` on 4 LSTM 4x1024 folds at ``fold=2``, 3
    updates on the kernels, against the single-process 4-fold run with
    phase 30's gates; ``make_sharded_ensemble_forward`` at ``fold=2`` over
    the 4 nets on ENS_UTTS test utterances: posteriors within
    POSTERIOR_ATOL of the single-process ``Ensemble``, the Viterbi
    segments identical;
35. ``PipelinedMLP`` over FF 8x2048 at ``stage=2``, 4 microbatches: the
    logits against ``net.apply`` and one backward's gradients against
    the MLP's on the same microbatches, within PIPE_RTOL; a one-rank
    NCCL world (``initialize_distributed`` must pick nccl) whose
    ``data=1`` FF update equals the plain one bit for bit;
    ``utils.profiling.trace`` around a 32-utterance serving batch, whose
    trace must name the ``lstm_scan`` kernel. The times of time-shared
    ranks say nothing of scaling;
36. the fused serving path (run right after phase 6, on phase 5's net,
    decoder and corpus): the 128 test utterances padded once into one
    (128, 512, 40) device batch with device lengths, then
    ``net.apply_sequence`` on the kernel route -> ``- ap`` ->
    ``log_softmax`` -> ``dec.decode_arrays_fn()``, with no host copy of
    the posteriors, in f32 and in bf16 (``HalfPrecisionNet``). Gates: the
    f32 posteriors within POSTERIOR_ATOL of phase 5's, its segments and
    PER identical to phase 5's, ``lstm_scan`` launched once a layer, the
    collapsed Viterbi once on its cluster route and the backtrace once;
    the callable's
    segments those of ``decode_batch`` on the same posteriors (f32 and
    bf16); FUSED_ROUNDS pipelined rounds of each program under
    ``torch.cuda.set_sync_debug_mode("error")`` (no synchronising call),
    each giving the first call's segments; a profiled repeat with no
    device-to-host or host-to-device copy, one ``lstm_scan`` kernel a
    layer, ``collapsed_viterbi_cluster_kernel`` alone and one
    ``viterbi_backtrace_kernel``; one ``decode_arrays_fn`` call launching
    the two decoder kernels once each in at most MAX_DECODE_OPS device
    operations; ``decode_fn()`` (the scan kernel) launching
    ``viterbi_scan_forward`` and ``viterbi_backtrace`` once each, in at
    most MAX_DECODE_OPS device operations (the scan kernel's cluster
    route, ``viterbi_scan_cluster_kernel``, and no device-memory one),
    and giving ``decode_batch``'s
    segments on the untied image of phase 23 and phase 5's on the tied
    one. Logged: the bf16 segment parity flag (a record, as
    ``bench.py``'s), each program's audio-s/s beside phase 5's, the
    profile's busy share and the device operations, device time and host
    queue time of one ``decode_arrays_fn`` call and of one ``decode_fn``
    call.
37. every training update as one CUDA graph (``train_network``
    captures a stage's update after its first, direct-call update and
    replays it for every later one; every one-card, mesh-less
    ``train_network`` run of the phases above trains so): LSTM 4x1024
    f32 and bf16 and the GRU, PeepholeLSTM and ZoneoutLSTM of phases 14,
    19 and 20 at TBPTT b128 L20, phase 27's FF 8x2048 (f32, bf16) and
    TDNN, GRAPH_STEPS x 3 updates by graph replays against the same
    updates by direct call (``cuda_graph=False``), one seed and init:
    params, history and kernel launch counts bit-equal (cuDNN
    deterministic for both), one ``cudaGraphLaunch`` an update in the
    profiled third epoch; each run's ms per update (epoch 2), the capture
    ms and the profiled epoch's device busy share logged, for the nets of
    phases 9, 14, 19, 20 and 27.
38. every fold-parallel update as one CUDA graph (``train_folds_parallel``
    captures the update of a (stage, fold count) after its first,
    direct-call update, replays it for every later one and captures anew
    after a stop compacts the folds; phase 30's runs train so):
    NUM_FOLDS folds of the LSTM 4x1024 at the master's spec
    (``--timedelay 5 -d 0.2``), the ZoneoutLSTM of phase 20 (``-d 0.2``)
    at TBPTT b128 L20 and phase 27's FF 8x2048 at b1024, one
    pseudo-utterance a fold, FOLD_GRAPH_STEPS x 3 updates by graph
    replays against the same updates by direct call (``cuda_graph=
    False``), one seed: every fold's logged losses, params and kernel
    launch counts bit-equal, one capture, one ``cudaGraphLaunch`` an
    update in the profiled third epoch; each run's ms per update (epoch
    2, from its log line to the next), the capture ms, the graph's node
    count and the device ms of an update logged, beside phase 30's
    ``--train-all-folds`` seconds.

Output: progress lines, then the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
A fuller JSON report (stage times, profile, timings) goes to stderr.
"""

import contextlib
import functools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# card peaks used for the bounds (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
#: torch.cuda._sleep's spin before a timed loop of short launches (~5 ms)
SLEEP_CYCLES = 10 ** 7
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# tolerances: the recurrence rounds h to bf16 each step, and the kernel
# sums the 1024 products of a gate in another order than the plain
# version, so a value can round to the neighbouring bf16 and the two
# runs then carry slightly different states (one bf16 ulp of a value
# near 1 is 2^-8 = 3.9e-3). Observed on an H100: 7.0e-4 for lstm_scan at
# T=512, 1.8e-3 for the 4-layer posteriors.
LSTM_ATOL = 5e-3
POSTERIOR_ATOL = 1e-2
# training kernels. Residuals (and bf16 hs) are bf16 roundings of values
# within LSTM_ATOL, so they may also differ by one bf16 ulp: |kernel -
# plain| <= LSTM_ATOL + RES_RTOL * |plain|. The backward, on the same
# residuals, differs from its plain version by the order of its float32
# sums, and through them by the bf16 roundings of dz that flip; those
# errors scale with the gradients and grow along the 20 reverse steps:
# each of dproj, dc0, dh0 within BWD_RTOL of its largest value (dh0, a
# sum of 4H such perturbed bf16(dz) terms, is the widest: 1.7e-3 of its
# max observed on an H100; the JAX tests allow 0.03 of max for this
# comparison, tests/test_rnn_pallas.py:365-367), dW within DW_RTOL of
# max |dW| (observed 6.4e-4). Three kernel updates against three plain
# ones: the losses within E2E_LOSS_RTOL.
RES_RTOL = 2.0 ** -7
BWD_RTOL = 1e-2
DW_RTOL = 3e-3
E2E_LOSS_RTOL = 1e-3
# Three fold-parallel updates against three plain ones: each parameter's
# change (after minus before) is lr times a sum of gradients, each built
# from dproj (within BWD_RTOL) or dW (within DW_RTOL), so it is held
# within BWD_RTOL of the plain change's largest magnitude (observed on an
# H100: 1.8e-3, a cells.*.wh; a dropped dW reads 1.0). A CTC step's
# gradients (T=470 reverse steps, both directions) within DW_RTOL of the
# plain gradient's largest magnitude (observed: 7.8e-4 and 8.0e-4 in two
# runs, fwd.cells.0.wx), and its loss within E2E_LOSS_RTOL (observed:
# 7.5e-8). Later losses are no kernel check: Adam's first step moves each
# weight by about lr times the sign of its gradient, so weights whose
# gradient is near zero step either way with the order of a sum (the
# second loss read 3.5e-4 and 5.5e-4 from plain in two runs). Two kernel
# runs of the step give the same bits: the CTC loss kernels sum in a
# fixed order, with no atomics (the loss was F.ctc_loss, whose backward
# sums with atomics, when two kernel runs' second losses differed by
# 2.1e-4), so phase 32 holds CTC_STEPS graph replays bit-equal to as
# many direct calls.
E2E_CHANGE_RTOL = BWD_RTOL
CTC_GRAD_RTOL = DW_RTOL
# The CTC loss kernels against their plain twins (optax's recursion in
# float32): the loss runs the same operations in the same order (rtol
# 1e-5, the JAX tests' bound); the gradient sums the same terms in
# another order (1e-4 of the plain gradient's largest magnitude). The
# operations a lattice position costs a frame, for the bounds: three
# logaddexps (max, sub, abs, exp, log1p, add) and five adds forward; the
# backward recomputes them and adds six exps, six products and eight
# adds.
CTC_LOSS_RTOL = 1e-5
CTC_LOSS_GRAD_RTOL = 1e-4
CTC_FWD_OPS = 23
CTC_BWD_OPS = 43
T_TRAIN = 20
# gated kernels: the LSTM's reasoning (bf16 rounding flips after sums in
# another order) with every tolerance taken relative to the largest value
# of the plain version's tensor, since the relu candidate of MGRU is
# unbounded: |kernel - plain| <= GATED_ATOL * max(1, max|plain|). The
# training kernels use RES_RTOL, BWD_RTOL and DW_RTOL as the LSTM's do.
GATED_ATOL = 5e-3
GATED = {"gru": (3, "tanh", "gru"), "mgru_r": (3, "relu", "mgrurelur"),
         "mgru": (2, "relu", "mgrurelu")}
# peephole kernels: the LSTM's reasoning, each tolerance relative to
# max(1, max|plain|) as the gated kernels' are (the cell state is not
# bounded by 1); the training kernels use RES_RTOL, BWD_RTOL and DW_RTOL.
PEEP_ATOL = 5e-3

T_MAIN, B_MAIN, H_MAIN, LAYERS, CLASSES, DIM = 512, 128, 1024, 4, 1909, 40
PHONES = 48
NUM_TEST = 128
BEAM = 8.0
# phase 5's corpus (make_synthetic_corpus's arguments)
CORPUS = dict(dim=DIM, num_train=128, num_dev=1, num_test=NUM_TEST, seed=0,
              min_phones=40, max_phones=48)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps, warm=True):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    one warm-up call first unless ``warm`` is false: the plain versions
    are timed right after the call that checked them)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_calls(torch, fn, reps):
    """Device busy ms and top device ops of ``reps`` calls of ``fn`` under
    the profiler, after one warm-up call. A session that recorded no
    device time (the profiler now and then drops a session's device
    events) is repeated, up to three times in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, busy_ms, top = device_profile(
            torch, lambda: [fn() for _ in range(reps)])
        if busy_ms > 0:
            return busy_ms, top
    fail("the profiler recorded no device time in three sessions")


def device_ms(torch, fn, reps):
    """Device milliseconds per call of ``fn``: the device time of every
    kernel it launches, summed under the profiler over ``reps`` calls
    after one warm-up call. Host time between launches does not count,
    so a call shorter than its Python overhead is timed as the card
    runs it on a busy stream."""
    return profiled_calls(torch, fn, reps)[0] / reps


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def numpy_lstm_params(seed):
    """LSTM 4x1024 -> 1909 weights as the JAX package's pytree would hold
    them (dense (in, out), forget bias 1), drawn from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cells = []
    d = DIM
    for _ in range(LAYERS):
        b = np.zeros(4 * H_MAIN, np.float32)
        b[2 * H_MAIN:3 * H_MAIN] = 1.0
        cells.append({
            "wx": (rng.standard_normal((d, 4 * H_MAIN)) / np.sqrt(d)
                   ).astype(np.float32),
            "wh": (rng.standard_normal((H_MAIN, 4 * H_MAIN))
                   / np.sqrt(H_MAIN)).astype(np.float32),
            "b": b})
        d = H_MAIN
    out = {"w": (rng.standard_normal((H_MAIN, CLASSES)) / np.sqrt(H_MAIN)
                 ).astype(np.float32),
           "b": np.zeros(CLASSES, np.float32)}
    return {"cells": cells, "out": out}


def per_of(corpus, results, out_path, ref):
    """Write the decoded MLF of the test set and score it (NIST PER)."""
    from nnacousticmodeling_tpu_torch.decoder import compute_per
    from nnacousticmodeling_tpu_torch.io import write_mlf
    from nnacousticmodeling_tpu_torch.io.mlf import MlfEntry
    test_mlf, entries = {}, []
    for i, (utt, res) in enumerate(zip(corpus.test.utt_names, results)):
        test_mlf[utt] = MlfEntry(words=res.phones, orig_id=i)
        entries.append((utt, res.segments))
    write_mlf(str(out_path), entries)
    return compute_per(test_mlf, ref, nist=True)


def numpy_gated_params(network, seed):
    """GRU / MGRU 4x1024 -> 1909 weights in the JAX package's pytree
    layout (cells.py:159-168, :213-227), drawn from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h = H_MAIN

    def w(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)
                ).astype(np.float32)

    cells = []
    d = DIM
    for _ in range(LAYERS):
        if network == "gru":
            cell = {"wx": w(d, 3 * h), "bx": np.zeros(3 * h, np.float32),
                    "wh_rz": w(h, 2 * h), "wh_c": w(h, h)}
        else:
            cell = {"w_z": w(d, h), "u_z": w(h, h), "w": w(d, h),
                    "u": w(h, h), "b_z": np.zeros(h, np.float32),
                    "b": np.zeros(h, np.float32)}
            if network == "mgrurelur":
                cell.update(w_r=w(d, h), u_r=w(h, h),
                            b_r=np.zeros(h, np.float32))
        cells.append(cell)
        d = h
    return {"cells": cells, "out": {"w": w(h, CLASSES),
                                    "b": np.zeros(CLASSES, np.float32)}}


def device_time(prof):
    """Device busy ms and the top device ops of a finished profile
    (device-side events only: a host op's device time repeats the time of
    the kernels it launched)."""
    from torch.autograd import DeviceType
    dev_us = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            dev_us[ev.key] = dev_us.get(ev.key, 0) + us
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    return sum(dev_us.values()) / 1e3, {k: v / 1e3 for k, v in top}


def device_profile(torch, fn, launches_of=None):
    """Run ``fn`` under the profiler; returns wall ms, device busy ms and
    the top device ops (device-side events only: a host op's device time
    repeats the time of the kernels it launched), and with
    ``launches_of`` (a tuple of strings) a fourth value: for each string,
    how many device kernels ran whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_time(prof)
    if launches_of is None:
        return wall_ms, busy_ms, top
    counts = {name: sum(ev.count for ev in prof.key_averages()
                        if getattr(ev, "device_type", None) == DeviceType.CUDA
                        and name in ev.key) for name in launches_of}
    return wall_ms, busy_ms, top, counts


def kernel_us_per_step(torch, fn, reps, name, steps):
    """Device microseconds a step of the kernel whose name holds ``name``:
    its device time over ``reps`` calls of ``fn`` (after one warm-up
    call), over ``reps * steps``."""
    top = profiled_calls(torch, fn, reps)[1]
    return sum(v for k, v in top.items() if name in k) * 1e3 / (reps * steps)


def log_profile(tag, wall_ms, busy_ms, top, card):
    if busy_ms > 0:
        log(f"[{tag}] {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %); top: "
            + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top.items())
            + f" [{card}]")
    else:
        log(f"[{tag}] {wall_ms:.1f} ms wall; device time not measured "
            f"(the profiler recorded none)")


def rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


def phase_timer(phase_s):
    """``done(n)``: record in ``phase_s`` and log the seconds since the
    previous call (or since this one)."""
    last = [time.perf_counter()]

    def done(n):
        now = time.perf_counter()
        phase_s[n] = now - last[0]
        log(f"[phase {n}] {phase_s[n]:.1f} s")
        last[0] = now

    return done


def serving_slice(torch, np, net, name, scan_name, plain_scan, corpus, dec,
                  card):
    """A serving slice on phase 5's corpus and decoder (phases 13, 18):
    ``net``'s prior-subtracted posteriors of the test set, their decode,
    MLF and PER. The run must launch the recurrence kernel ``scan_name``
    once a layer and the Viterbi kernel; the posteriors of the plain
    recurrence (``networks.<scan_name>`` patched to ``plain_scan``) must
    agree within POSTERIOR_ATOL, and the plain Viterbi's decode of the
    kernel run's posteriors must give identical segments and PER."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.corpus_decode import (
        decode_corpus)
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.io import load_mlf, write_mlf
    from nnacousticmodeling_tpu_torch.models import networks

    x, offsets = corpus.test.data, corpus.test.offsets
    lengths = np.diff(offsets)
    audio_s = float(lengths.sum()) / 100.0
    ap = corpus.log_priors
    label = f"{type(net).__name__} {LAYERS}x{H_MAIN} -> {CLASSES}"
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
        ref_path = Path(tmp, "test_ref.mlf")
        write_mlf(str(ref_path), corpus.ref_mlf["test"])
        ref = load_mlf(str(ref_path))
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = rnn_log_posteriors(net, x, offsets, ap=ap, batch=B_MAIN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results = decode_corpus(dec, lp, offsets, batch=B_MAIN)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per = per_of(corpus, results, Path(tmp, "kernel.mlf"), ref)
        t3 = time.perf_counter()
        launches = dict(kernels.launches)
        log(f"[{name} slice] main-path launches: {launches}")
        if launches.get(scan_name, 0) != LAYERS:
            fail(f"the {name} serving path launched {scan_name} "
                 f"{launches.get(scan_name, 0)} times, not once a layer "
                 f"({LAYERS})")
        for kernel in ("collapsed_viterbi_forward", "viterbi_backtrace"):
            if launches.get(kernel, 0) <= 0:
                fail(f"the {name} serving path did not launch {kernel}")
        if lp.shape != (lengths.sum(), CLASSES) or not np.isfinite(lp).all():
            fail(f"{name} posteriors malformed: shape {lp.shape}")
        if not all(r.segments for r in results):
            fail(f"an utterance decoded to no segments ({name} slice)")
        stages = {"posteriors_ms": (t1 - t0) * 1e3,
                  "decode_ms": (t2 - t1) * 1e3,
                  "mlf_per_ms": (t3 - t2) * 1e3}
        tput = audio_s / (t3 - t0)
        log(f"[{name} slice] {label}: PER {per:.2f} %, {tput:.1f} "
            f"audio-s/s; " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in stages.items())
            + f" [{card}]")
        with mock.patch.object(networks, scan_name, plain_scan):
            lp_plain = rnn_log_posteriors(net, x, offsets, ap=ap,
                                          batch=B_MAIN)
        post_err = float(np.abs(lp - lp_plain).max())
        if not post_err <= POSTERIOR_ATOL:
            fail(f"{name} posteriors differ from the plain net's by "
                 f"{post_err} (tolerance {POSTERIOR_ATOL})")
        with plain_viterbi():
            results_plain = decode_corpus(dec, lp, offsets, batch=B_MAIN)
        per_plain = per_of(corpus, results_plain, Path(tmp, "plain.mlf"),
                           ref)
        same = sum(a.segments == b.segments
                   for a, b in zip(results, results_plain))
        if same != len(results) or per_plain != per:
            fail(f"{name} slice: plain decode differs: "
                 f"{len(results) - same} utterances, PER {per_plain} vs "
                 f"{per}")
        log(f"[{name} slice] plain {name} posteriors within {post_err:.3e} "
            f"(tolerance {POSTERIOR_ATOL}); plain Viterbi: segments of all "
            f"{same} utterances and PER identical")
    return dict(per=per, audio_s=audio_s, audio_s_per_s=tput,
                posterior_err=post_err, launches=launches, **stages)


def scan_device_kernels(torch, net, corpus, name, kernel):
    """A profiled repeat of ``net``'s posteriors (phases 13, 18): the
    device kernel ``kernel`` must run once a layer. Returns its count."""
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    for _ in range(3):   # a session the profiler dropped is repeated
        _, busy_ms, _, counts = device_profile(
            torch, lambda: rnn_log_posteriors(
                net, corpus.test.data, corpus.test.offsets,
                ap=corpus.log_priors, batch=B_MAIN), (kernel,))
        if busy_ms > 0:
            break
    if counts[kernel] != LAYERS:
        fail(f"the {name} posteriors ran {counts} device kernels, not one "
             f"persistent scan a layer ({LAYERS})")
    log(f"[{name} slice] device kernels of the posteriors: {counts}: one "
        f"persistent scan a layer")
    return counts[kernel]


def train_slice(torch, np, dev, corpus, tree, name, extra, kernel_names,
                card):
    """A training slice through ``train_cli.main`` (phases 14, 19, 20):
    ``name`` 4x1024 -> 1909, TBPTT b128 L20, momentumsgd lr 1e-2, 2
    epochs, plus the ``extra`` arguments, on the corpus tree ``tree``. The
    run must launch each of ``kernel_names``, every loss must be finite,
    epoch 2's train loss below epoch 1's, and ``model.npz`` must load into
    the serving net."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.pipeline import train_cli
    from nnacousticmodeling_tpu_torch.train import load_jax_params

    B, T = B_MAIN, T_TRAIN
    delay = int(extra[extra.index("--timedelay") + 1]) \
        if "--timedelay" in extra else 0
    frames = int(corpus.train.data.shape[0]
                 + delay * (len(corpus.train.offsets) - 1))
    steps = frames // (B * T)
    argv = ["-n", name, "-l", str(LAYERS), "-u", str(H_MAIN),
            "--num-classes", str(CLASSES), "-b", str(B), "--bproplen",
            str(T), "-o", "momentumsgd", "--lr", "0.01", "--early-stopping",
            "false", "--noplot", "-e", "2", "--data-dir", f"{tree}/data",
            "--offset-dir", f"{tree}/data", "--target-dir", f"{tree}/data",
            "--out", f"{tree}/{name}"] + extra
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"[{name} train] main-path launches: {launches}")
    for kernel in kernel_names:
        if launches.get(kernel, 0) <= 0:
            fail(f"the {name} training path did not launch {kernel}")
    hist = result.history
    losses = [h[k] for h in hist for k in ("main/loss",
                                           "validation/main/loss")]
    if len(hist) != 2 or not np.isfinite(losses).all():
        fail(f"{name} training history malformed: {hist}")
    if not hist[1]["main/loss"] < hist[0]["main/loss"]:
        fail(f"{name} train loss did not fall: {hist[0]['main/loss']} -> "
             f"{hist[1]['main/loss']}")
    serving = get_network(name, LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                          scan_impl="pallas", device=dev)
    serving.load_state_dict(load_jax_params(f"{tree}/{name}/model.npz",
                                            device=dev))
    update_ms = hist[1]["elapsed_time"] / steps * 1e3
    frames_per_s = steps * B * T / hist[1]["elapsed_time"]
    log(f"[{name} train] {type(serving).__name__} {LAYERS}x{H_MAIN} -> "
        f"{CLASSES}, {' '.join([f'TBPTT b{B} L{T}'] + extra)}, {frames} "
        f"frames, "
        f"{steps} updates an epoch: epoch times "
        + ", ".join(f"{h['elapsed_time']:.3f} s" for h in hist)
        + f"; epoch 2: {update_ms:.2f} ms per update, {frames_per_s:.0f} "
        f"train frames/s; losses "
        + ", ".join(f"{h['main/loss']:.4f} (val "
                    f"{h['validation/main/loss']:.4f})" for h in hist)
        + f"; whole call {wall_s:.1f} s; model.npz loads into the serving "
        f"net [{card}]")
    return dict(history=hist, update_ms=update_ms,
                frames_per_s=frames_per_s, launches=launches, wall_s=wall_s)


def update_runs(torch, dev, corpus, name, init):
    """3 updates through ``train_network`` of the ``name`` 4x1024 net from
    the weights ``init`` (TBPTT b128 L20 on the first 2,560 training
    frames, no validation). Returns ``losses()``, which runs them and
    returns the per-update losses, and ``profiled()``, which profiles a
    run whose net is built beforehand."""
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, load_jax_params, train_network)

    n3 = B_MAIN * T_TRAIN
    x3, y3 = corpus.train.data[:n3], corpus.train.targets[:n3]
    cfg3 = TrainConfig(
        stages=[TrainStage(epoch=3, optimizer="momentumsgd",
                           batch_size=B_MAIN, lr=0.01, early_stopping=False)],
        bprop_len=T_TRAIN, seed=0, log=None, use_validation=False)

    def net_and_init():
        return (get_network(name, LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                            scan_impl="pallas", device=dev),
                load_jax_params(init, device=dev))

    def losses():
        net3, init3 = net_and_init()
        return [h["main/loss"] for h in train_network(
            net3, x3, y3, cfg3, init_params=init3, device=dev).history]

    def profiled(launches_of=None):
        net_p, init_p = net_and_init()
        return device_profile(torch, lambda: train_network(
            net_p, x3, y3, cfg3, init_params=init_p, device=dev), launches_of)

    return losses, profiled


def e2e_updates(torch, np, dev, corpus, name, init, plain, tag):
    """Phases 10, 15, 19: ``update_runs`` with the kernels, then with the
    plain versions (``plain``: ``rnn_cuda`` name -> plain function,
    patched in; that run must launch no kernel). The per-update losses
    must agree within E2E_LOSS_RTOL. Returns the losses and
    ``profiled``."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda

    losses, profiled = update_runs(torch, dev, corpus, name, init)
    before = dict(kernels.launches)
    k_hist = losses()
    if dict(kernels.launches) == before:
        fail(f"the {name} kernel run launched no kernel")
    before = dict(kernels.launches)
    with mock.patch.multiple(rnn_cuda, **plain):
        p_hist = losses()
    if dict(kernels.launches) != before:
        fail(f"the plain {name} run launched a kernel")
    err = max(abs(a - b) / abs(b) for a, b in zip(k_hist, p_hist))
    if not (len(k_hist) == 3 and np.isfinite(k_hist).all()
            and err <= E2E_LOSS_RTOL):
        fail(f"3 kernel updates of {name} {k_hist} differ from 3 plain ones "
             f"{p_hist} (tolerance {E2E_LOSS_RTOL} relative)")
    log(f"[{tag}] 3 updates, kernel losses {k_hist}, plain {p_hist}: max "
        f"relative difference {err:.3e} (tolerance {E2E_LOSS_RTOL})")
    return dict(kernel=k_hist, plain=p_hist, err=err), profiled


def train_phases(torch, np, dev, card, corpus, report):
    """Phases 7-11: the training kernels against their plain versions,
    the training slice through ``train_cli``, kernel against plain end
    to end, and a profile. Returns the kernels' entries of the
    ``{"kernels": [...]}`` line."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.pipeline import train_cli
    from nnacousticmodeling_tpu_torch.train import load_jax_params
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        write_corpus_tree)

    T, B, H = T_TRAIN, B_MAIN, H_MAIN
    G = 4 * H
    TBH = T * B * H

    # ---- 7. lstm_train_forward against its plain version ---------------
    g = torch.Generator().manual_seed(2)
    proj = torch.randn(T, B, G, generator=g).to(dev)
    wh = (torch.randn(H, G, generator=g) / H ** 0.5).to(dev)
    c0 = (torch.randn(B, H, generator=g) * 0.1).to(dev)
    h0 = (torch.randn(B, H, generator=g) * 0.1).to(dev)
    fwd = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        p = proj.to(dt)
        hs_k, res_k, ct_k, ht_k = rnn_cuda.lstm_train_forward(p, wh, c0, h0)
        (c_s, h_s), hs_s = rnn_cuda.lstm_scan(p, wh, c0, h0)
        hs_r, res_r, ct_r, ht_r = rnn_cuda.lstm_train_forward_reference(
            p, wh, c0, h0)
        torch.cuda.synchronize()
        # lstm_scan's kernel code plus the residual stores: the same bits
        scan_err = max(float((hs_k.float() - hs_s.float()).abs().max()),
                       float((ct_k - c_s).abs().max()),
                       float((ht_k - h_s).abs().max()))
        if not (torch.equal(hs_k, hs_s) and torch.equal(ct_k, c_s)
                and torch.equal(ht_k, h_s)):
            fail(f"lstm_train_forward ({tag}) is not bit-equal to lstm_scan:"
                 f" max difference {scan_err}")
        err = max(float((hs_k.float() - hs_r.float()).abs().max()),
                  float((ct_k - ct_r).abs().max()),
                  float((ht_k - ht_r).abs().max()))
        res_d = (res_k.float() - res_r.float()).abs()
        res_over = float((res_d - RES_RTOL * res_r.float().abs()).max())
        hs_over = float(((hs_k.float() - hs_r.float()).abs()
                         - RES_RTOL * hs_r.float().abs()).max())
        c_err = max(float((ct_k - ct_r).abs().max()),
                    float((ht_k - ht_r).abs().max()))
        hs_ok = (hs_over if dt == torch.bfloat16 else err) <= LSTM_ATOL
        if not (hs_ok and c_err <= LSTM_ATOL and res_over <= LSTM_ATOL):
            fail(f"lstm_train_forward ({tag}) differs from its plain version"
                 f": {err} (tolerance {LSTM_ATOL}; bf16 hs beyond one ulp "
                 f"{hs_over}), residuals beyond {RES_RTOL} relative by "
                 f"{res_over} (tolerance {LSTM_ATOL})")
        fwd[tag] = dict(err=err, res_err=float(res_d.max()),
                        res_over=res_over, scan_err=scan_err)
        log(f"[train fwd {tag}] T={T} B={B} H={H}: hs, c_T, h_T bit-equal "
            f"to lstm_scan's; max "
            f"|kernel - plain| {err:.3e} (tolerance "
            f"{LSTM_ATOL}), residuals {float(res_d.max()):.3e}, beyond "
            f"{RES_RTOL:.4f} relative {res_over:.3e} (tolerance {LSTM_ATOL})")

    def fwd_call():
        return rnn_cuda.lstm_train_forward(proj, wh, c0, h0)

    fwd_ms = cuda_ms(torch, fwd_call, 10)
    fwd_step_us = kernel_us_per_step(torch, fwd_call, 10,
                                     "lstm_train_fwd_persistent", T)
    fwd_plain_ms = cuda_ms(torch, lambda: rnn_cuda.lstm_train_forward_reference(
        proj, wh, c0, h0), 5)
    cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
    x_lib = torch.randn(T, B, H, generator=g).to(dev, torch.bfloat16)
    x_lib.requires_grad_()
    fwd_lib_ms = cuda_ms(torch, lambda: cudnn(x_lib), 10)
    out_lib, _ = cudnn(x_lib)
    gout = torch.randn_like(out_lib)
    lib_inputs = [x_lib] + list(cudnn.parameters())
    bwd_lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out_lib, lib_inputs, gout, retain_graph=True), 10)
    del out_lib, gout, lib_inputs
    fwd_bytes = (T * B * G * 4 + H * G * 4 + 2 * B * H * 4 + TBH * 4
                 + TBH * 7 * 2 + 2 * B * H * 4)
    fwd_bound, fwd_by = bound(fwd_bytes, 2 * TBH * G, BF16_TENSOR_FLOPS)
    log(f"[train fwd] kernel {fwd_ms:.3f} ms ({fwd_step_us:.2f} us a step, "
        f"device time), plain {fwd_plain_ms:.3f} ms, cuDNN nn.LSTM bf16 "
        f"forward {fwd_lib_ms:.3f} ms, bound {fwd_bound:.4f} ms ({fwd_by}) "
        f"[{card}]")

    # ---- 8. lstm_train_backward and lstm_train_dw against plain -------
    g = torch.Generator().manual_seed(3)
    dhs = torch.randn(T, B, H, generator=g).to(dev)
    dct = torch.randn(B, H, generator=g).to(dev)
    dht = torch.randn(B, H, generator=g).to(dev)
    _, res, _, _ = rnn_cuda.lstm_train_forward(proj, wh, c0, h0)
    got = rnn_cuda.lstm_train_backward(res, wh, dhs, dct, dht, torch.float32)
    again = rnn_cuda.lstm_train_backward(res, wh, dhs, dct, dht,
                                         torch.float32)
    want = rnn_cuda.lstm_train_backward_reference(res, wh, dhs, dct, dht,
                                                  torch.float32)
    torch.cuda.synchronize()
    if not all(torch.equal(a, k) for a, k in zip(again, got)):
        fail("lstm_train_backward: a second call on the same inputs gave "
             "other bits")
    del again
    names = ("dproj", "dW", "dc0", "dh0")
    scales = [float(w.abs().max()) for w in want]
    abs_errs = [float((k - w).abs().max()) for k, w in zip(got, want)]
    rel = [e / sc for e, sc in zip(abs_errs, scales)]
    bwd_err = max(abs_errs[i] for i in (0, 2, 3))
    bwd_rel = max(rel[i] for i in (0, 2, 3))
    dw_err = rel[1]
    detail = ", ".join(f"{n} {e:.3e} of max {sc:.3e} ({r:.2e})"
                       for n, e, sc, r in zip(names, abs_errs, scales, rel))
    if not (bwd_rel <= BWD_RTOL and dw_err <= DW_RTOL):
        fail(f"lstm_train_backward differs from its plain version: {detail}"
             f" (tolerances {BWD_RTOL} of max for dproj/dc0/dh0, {DW_RTOL} "
             f"of max |dW|)")
    dz = want[0].to(torch.bfloat16)       # the plain version's bf16(dz)
    dw_k = rnn_cuda.lstm_train_dw(res, dz)
    dw_r = rnn_cuda.lstm_train_dw_reference(res, dz)
    torch.cuda.synchronize()
    dw_alone_abs = float((dw_k - dw_r).abs().max())
    dw_alone_scale = float(dw_r.abs().max())
    dw_alone_err = dw_alone_abs / dw_alone_scale
    if not dw_alone_err <= DW_RTOL:
        fail(f"lstm_train_dw differs from its plain version by "
             f"{dw_alone_err} of max |dW| (tolerance {DW_RTOL})")

    def bwd_call():
        return rnn_cuda.lstm_train_backward(res, wh, dhs, dct, dht,
                                            torch.float32)

    bwd_ms = cuda_ms(torch, bwd_call, 10)
    bwd_step_us = kernel_us_per_step(torch, bwd_call, 10,
                                     "lstm_train_bwd_persistent", T)
    bwd_plain_ms = cuda_ms(
        torch, lambda: rnn_cuda.lstm_train_backward_reference(
            res, wh, dhs, dct, dht, torch.float32), 5)
    dw_ms = cuda_ms(torch, lambda: rnn_cuda.lstm_train_dw(res, dz), 10)
    dw_plain_ms = cuda_ms(
        torch, lambda: rnn_cuda.lstm_train_dw_reference(res, dz), 10)
    hp = res[..., 6 * H:].reshape(-1, H).contiguous()
    dz2 = dz.reshape(-1, G)
    dw_lib_ms = cuda_ms(torch, lambda: torch.matmul(hp.T, dz2), 10)
    dw_dev = dict(
        ms=device_ms(torch, lambda: rnn_cuda.lstm_train_dw(res, dz), 10),
        plain_ms=device_ms(
            torch, lambda: rnn_cuda.lstm_train_dw_reference(res, dz), 10),
        library_ms=device_ms(torch, lambda: torch.matmul(hp.T, dz2), 10))
    bwd_bytes = (TBH * 7 * 2 + H * G * 4 + TBH * 4 + 2 * B * H * 4
                 + T * B * G * 4 + H * G * 4 + 2 * B * H * 4)
    bwd_bound, bwd_by = bound(bwd_bytes, 2 * 2 * TBH * G, BF16_TENSOR_FLOPS)
    dw_bytes = TBH * 2 + T * B * G * 2 + H * G * 4
    dw_bound, dw_by = bound(dw_bytes, 2 * TBH * G, BF16_TENSOR_FLOPS)
    log(f"[train bwd] max |kernel - plain|: {detail} (tolerances "
        f"{BWD_RTOL} of max for dproj/dc0/dh0, {DW_RTOL} for dW); dW kernel "
        f"alone {dw_alone_err:.3e} of max |dW|; a second call bit-identical")
    log(f"[train bwd] {bwd_step_us:.2f} us a reverse step (device time; "
        f"forward {fwd_step_us:.2f} us a step); cuDNN nn.LSTM bf16 forward "
        f"{fwd_lib_ms:.3f} ms, backward {bwd_lib_ms:.3f} ms [{card}]")
    log(f"[train bwd] backward (with dW) {bwd_ms:.3f} ms, plain "
        f"{bwd_plain_ms:.3f} ms, cuDNN nn.LSTM bf16 backward "
        f"{bwd_lib_ms:.3f} ms, bound {bwd_bound:.4f} ms ({bwd_by}); dW "
        f"call {dw_ms:.4f} ms, plain {dw_plain_ms:.4f} ms, cuBLAS bf16 "
        f"{dw_lib_ms:.4f} ms; dW device time: kernel {dw_dev['ms']:.4f} ms, "
        f"plain {dw_dev['plain_ms']:.4f} ms, cuBLAS bf16 "
        f"{dw_dev['library_ms']:.4f} ms, bound {dw_bound:.4f} ms ({dw_by}) "
        f"[{card}]")
    del proj, res, got, want, dz, dw_k, dw_r, hp, dz2, cudnn, x_lib

    # ---- 9. the training slice through train_cli -----------------------
    n_train = int(corpus.train.data.shape[0])
    steps = n_train // (B * T)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        write_corpus_tree(corpus, tmp)
        common = ["-n", "lstm", "-l", str(LAYERS), "-u", str(H),
                  "--num-classes", str(CLASSES), "-b", str(B),
                  "--bproplen", str(T), "-o", "momentumsgd", "--lr", "0.01",
                  "--early-stopping", "false", "--noplot",
                  "--data-dir", f"{tmp}/data", "--offset-dir", f"{tmp}/data",
                  "--target-dir", f"{tmp}/data"]
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = train_cli.main(common + ["-e", "2", "--out", f"{tmp}/f32"])
        torch.cuda.synchronize()
        train_wall_s = time.perf_counter() - t0
        train_launches = dict(kernels.launches)
        log(f"[train] main-path launches: {train_launches}")
        for name in ("lstm_train_forward", "lstm_train_backward",
                     "lstm_train_dw", "lstm_scan"):
            if train_launches.get(name, 0) <= 0:
                fail(f"the training path did not launch {name}")
        hist = result.history
        losses = [h[k] for h in hist for k in
                  ("main/loss", "validation/main/loss")]
        if len(hist) != 2 or not np.isfinite(losses).all():
            fail(f"training history malformed: {hist}")
        if not hist[1]["main/loss"] < hist[0]["main/loss"]:
            fail(f"train loss did not fall: {hist[0]['main/loss']} -> "
                 f"{hist[1]['main/loss']}")
        serving = get_network("lstm", LAYERS, [H], CLASSES, in_dim=DIM,
                              scan_impl="pallas", device=dev)
        serving.load_state_dict(load_jax_params(f"{tmp}/f32/model.npz",
                                                device=dev))
        update_ms = hist[1]["elapsed_time"] / steps * 1e3
        frames_per_s = steps * B * T / hist[1]["elapsed_time"]
        log(f"[train] LSTM {LAYERS}x{H} -> {CLASSES}, TBPTT b{B} L{T}, "
            f"{n_train} frames, {steps} updates an epoch: epoch times "
            + ", ".join(f"{h['elapsed_time']:.3f} s" for h in hist)
            + f"; epoch 2: {update_ms:.2f} ms per update, "
            f"{frames_per_s:.0f} train frames/s; losses "
            + ", ".join(f"{h['main/loss']:.4f} (val "
                        f"{h['validation/main/loss']:.4f})" for h in hist)
            + f"; whole call {train_wall_s:.1f} s; model.npz loads into the "
            f"serving network [{card}]")

        # ---- 10. kernel against plain, end to end; the bf16 epoch ------
        e2e, profiled = e2e_updates(
            torch, np, dev, corpus, "lstm", numpy_lstm_params(1),
            dict(lstm_train_forward=rnn_cuda.lstm_train_forward_reference,
                 lstm_train_backward=rnn_cuda.lstm_train_backward_reference),
            "train e2e")

        kernels.reset_launches()
        bf = train_cli.main(common + ["-e", "1", "--dtype", "bfloat16",
                                      "--out", f"{tmp}/bf16"])
        bf_launches = dict(kernels.launches)
        bf_losses = [bf.history[0][k] for k in ("main/loss",
                                                "validation/main/loss")]
        if not np.isfinite(bf_losses).all() or min(
                bf_launches.get(k, 0) for k in (
                    "lstm_train_forward", "lstm_train_backward",
                    "lstm_train_dw", "lstm_scan")) <= 0:
            fail(f"bf16 epoch: losses {bf_losses}, launches {bf_launches}")
        bf_update_ms = bf.history[0]["elapsed_time"] / steps * 1e3
        log(f"[train bf16] 1 epoch: losses {bf_losses}, launches "
            f"{bf_launches}, {bf_update_ms:.2f} ms per update (epoch 1, "
            f"warm-up included) [{card}]")

    # ---- 11. where the time goes: 3 updates, profiled ------------------
    step_kernels = ("lstm_train_fwd_persistent", "lstm_train_bwd_persistent")
    wall_ms, busy_ms, top, train_kernels = profiled(step_kernels)
    log_profile("train profile", wall_ms, busy_ms, top, card)
    if any(n != 3 * LAYERS for n in train_kernels.values()):
        fail(f"3 profiled updates ran {train_kernels} device kernels, not one "
             f"forward and one backward a layer an update ({3 * LAYERS})")
    log(f"[train profile] device kernels in 3 updates of {LAYERS} layers: "
        f"{train_kernels}: one forward and one backward a layer an update")

    report["train"] = dict(
        fwd=fwd, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
        fwd_lib_ms=fwd_lib_ms, bwd_err=bwd_err, dw_err=dw_err,
        dw_alone_err=dw_alone_err, bwd_abs_errs=abs_errs,
        bwd_scales=scales, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
        bwd_lib_ms=bwd_lib_ms, dw_ms=dw_ms, dw_plain_ms=dw_plain_ms,
        dw_lib_ms=dw_lib_ms, dw_device=dw_dev, history=hist,
        update_ms=update_ms,
        frames_per_s=frames_per_s, launches=train_launches,
        e2e=e2e,
        bf16=dict(history=bf.history, launches=bf_launches,
                  update_ms=bf_update_ms),
        fwd_step_us=fwd_step_us, bwd_step_us=bwd_step_us,
        profile=dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     top_device_ms=top, kernels=train_kernels))
    src = "nnacousticmodeling_tpu_torch/csrc/lstm_train.cu"
    return [
        {"name": "lstm_train_forward", "route": "cuda", "source": src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:384",
         "launches": train_launches["lstm_train_forward"],
         "max_abs_err": fwd["f32"]["err"], "tolerance": LSTM_ATOL,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": fwd_lib_ms},
        {"name": "lstm_train_backward", "route": "cuda", "source": src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:485",
         "launches": train_launches["lstm_train_backward"],
         "max_abs_err": bwd_err,
         "tolerance": BWD_RTOL * max(scales[i] for i in (0, 2, 3)),
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound,
         "bound_by": bwd_by, "library_ms": bwd_lib_ms},
        {"name": "lstm_train_dw", "route": "cuda", "source": src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:575",
         "launches": train_launches["lstm_train_dw"],
         "max_abs_err": dw_alone_abs, "tolerance": DW_RTOL * dw_alone_scale,
         "ms": dw_dev["ms"], "plain_ms": dw_dev["plain_ms"],
         "bound_ms": dw_bound, "bound_by": dw_by,
         "library_ms": dw_dev["library_ms"]},
    ]

def gated_plan(rnn_cuda, dev, name, h_dim, batch):
    """The layout the gated kernel ``name`` (``gated_scan``,
    ``gated_train_forward`` or ``gated_train_backward``) takes on this
    card."""
    if name == "gated_scan":
        plan_fn = rnn_cuda.gated_scan_plan
        query = rnn_cuda._gated_scan_lib().gated_scan_capacity
    else:
        backward = name == "gated_train_backward"
        plan_fn = (rnn_cuda.gated_train_bwd_plan if backward
                   else rnn_cuda.gated_train_fwd_plan)
        query = functools.partial(
            rnn_cuda._gated_train_lib().gated_train_capacity, int(backward))
    return plan_fn(h_dim, batch, lambda r, rows: rnn_cuda._capacity(
        name, query, dev, h_dim, r, rows))


def layout_of(plan, batch):
    """A plan's layout: for the log line and for the report."""
    d = dict(resident=plan.resident, units=plan.units, rows=plan.rows,
             launches=len(plan.launches), smem_bytes=plan.smem_bytes)
    text = (f"{len(plan.launches)} cooperative launch(es) of "
            f"{plan.unit_blocks} x {-(-batch // plan.rows)} blocks "
            f"({plan.units} units x {plan.rows} rows), weight slice "
            f"{'resident' if plan.resident else 'streamed'}, "
            f"{plan.smem_bytes} bytes of shared memory a block")
    return d, text


def gated_kernel_phase(torch, np, dev, card, report):
    """Phase 12: each gated kernel against its plain version at the
    paths' shapes, for each kind. Returns per-kind measurements."""
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda

    B, H = B_MAIN, H_MAIN
    out = {}

    for kind, (gp, act, _) in GATED.items():
        g = torch.Generator().manual_seed(20 + gp)
        has_w2 = kind != "mgru"
        w1 = (torch.randn(H, 2 * H, generator=g) / H ** 0.5).to(dev)
        w2 = ((torch.randn(H, H, generator=g) / H ** 0.5).to(dev)
              if has_w2 else None)
        k = dict(kind=kind, activation=act)
        # ---- inference at the serving shapes
        T = T_MAIN
        proj = torch.randn(T, B, gp * H, generator=g).to(dev)
        h0 = torch.zeros(B, H, device=dev)
        ht_k, hs_k = rnn_cuda.gated_scan(proj, w1, w2, h0, **k)
        ht_r, hs_r = rnn_cuda.gated_scan_reference(proj, w1, w2, h0, **k)
        torch.cuda.synchronize()
        scan_err = max(rel_err(hs_k, hs_r), rel_err(ht_k, ht_r))
        if not (np.isfinite(scan_err) and scan_err <= GATED_ATOL):
            fail(f"gated_scan ({kind}) differs from its plain version by "
                 f"{scan_err} of max(1, max|plain|) (tolerance "
                 f"{GATED_ATOL})")
        scan_ms = cuda_ms(torch, lambda: rnn_cuda.gated_scan(
            proj, w1, w2, h0, **k), 3)
        scan_step_us = kernel_us_per_step(
            torch, lambda: rnn_cuda.gated_scan(proj, w1, w2, h0, **k), 3,
            "gated_scan_persistent", T)
        scan_layout, scan_layout_text = layout_of(
            gated_plan(rnn_cuda, dev, "gated_scan", H, B), B)
        scan_plain_ms = cuda_ms(torch, lambda: rnn_cuda.gated_scan_reference(
            proj, w1, w2, h0, **k), 1, warm=False)
        n_cols = 3 * H if has_w2 else 2 * H
        w_bytes = H * n_cols * 4
        scan_bytes = (proj.numel() * 4 + w_bytes + 2 * B * H * 4
                      + T * B * H * 4)
        scan_bound, scan_by = bound(scan_bytes, 2 * T * B * H * n_cols,
                                    BF16_TENSOR_FLOPS)
        # cuDNN nn.GRU bf16 at the same shapes: like work, not the same
        # function (it applies r after the product)
        cudnn = torch.nn.GRU(H, H, device=dev, dtype=torch.bfloat16)
        x_lib = torch.randn(T, B, H, generator=g).to(dev, torch.bfloat16)
        with torch.inference_mode():
            scan_lib_ms = cuda_ms(torch, lambda: cudnn(x_lib), 3)
        log(f"[gated_scan {kind}] T={T} B={B} H={H} f32 proj: max |kernel - "
            f"plain| {scan_err:.3e} of max(1, max|plain|) (tolerance "
            f"{GATED_ATOL}), max|hs| {float(hs_r.abs().max()):.3g}; kernel "
            f"{scan_ms:.3f} ms, {scan_step_us:.2f} us a step (device time), "
            f"plain {scan_plain_ms:.3f} ms, bound "
            f"{scan_bound:.3f} ms ({scan_by}); cuDNN nn.GRU bf16 yardstick "
            f"{scan_lib_ms:.3f} ms; {scan_layout_text} [{card}]")
        del proj, hs_k, hs_r, x_lib

        # ---- training kernels at the training shapes
        T = T_TRAIN
        TBH = T * B * H
        proj = torch.randn(T, B, gp * H, generator=g).to(dev)
        h0 = (torch.randn(B, H, generator=g) * 0.1).to(dev)
        fwd = {}
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            p = proj.to(dt)
            out_k = rnn_cuda.gated_train_forward(p, w1, w2, h0, **k)
            hs_k, res_k, ht_k = out_k
            again = rnn_cuda.gated_train_forward(p, w1, w2, h0, **k)
            ht_s, hs_s = rnn_cuda.gated_scan(p, w1, w2, h0, **k)
            hs_r, res_r, ht_r = rnn_cuda.gated_train_forward_reference(
                p, w1, w2, h0, **k)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(again, out_k)):
                fail(f"gated_train_forward ({kind}, {tag}): a second call on "
                     f"the same inputs gave other bits")
            del again
            scale = max(1.0, float(hs_r.float().abs().max()))

            def hs_over(hs):
                # |hs - plain| beyond one bf16 ulp, over max(1, max|plain|)
                return float(((hs.float() - hs_r.float()).abs()
                              - RES_RTOL * hs_r.float().abs()).max()) / scale

            def hs_ok(hs):
                # bf16 hs may differ from plain by one bf16 ulp
                return (hs_over(hs) if dt == torch.bfloat16
                        else rel_err(hs, hs_r)) <= GATED_ATOL
            err = max(rel_err(hs_k, hs_r), rel_err(ht_k, ht_r))
            res_d = (res_k.float() - res_r.float()).abs()
            res_over = float((res_d - RES_RTOL * res_r.float().abs()).max()
                             ) / scale
            if not (hs_ok(hs_k) and rel_err(ht_k, ht_r) <= GATED_ATOL
                    and res_over <= GATED_ATOL):
                fail(f"gated_train_forward ({kind}, {tag}) differs from its "
                     f"plain version: {err} of max(1, max|plain|) (tolerance"
                     f" {GATED_ATOL}; bf16 hs beyond one ulp "
                     f"{hs_over(hs_k)}), "
                     f"residuals beyond {RES_RTOL} relative by {res_over}")
            # the scan runs the training forward's kernel body: the same
            # bits
            if not (torch.equal(hs_k, hs_s) and torch.equal(ht_k, ht_s)):
                fail(f"gated_train_forward ({kind}, {tag}) is not bit-equal "
                     f"to gated_scan: "
                     f"{max(rel_err(hs_k, hs_s), rel_err(ht_k, ht_s))} of "
                     f"max(1, max|scan|) apart")
            fwd[tag] = dict(err=err, res_err=float(res_d.max()),
                            res_over=res_over)
        fwd_ms = cuda_ms(torch, lambda: rnn_cuda.gated_train_forward(
            proj, w1, w2, h0, **k), 10)
        fwd_step_us = kernel_us_per_step(
            torch, lambda: rnn_cuda.gated_train_forward(proj, w1, w2, h0, **k),
            10, "gated_train_fwd_persistent", T)
        fwd_layout, fwd_layout_text = layout_of(
            gated_plan(rnn_cuda, dev, "gated_train_forward", H, B), B)
        fwd_plain_ms = cuda_ms(
            torch, lambda: rnn_cuda.gated_train_forward_reference(
                proj, w1, w2, h0, **k), 3)
        fwd_bytes = (proj.numel() * 4 + w_bytes + B * H * 4 + TBH * 4
                     + TBH * 4 * 2 + B * H * 4)
        fwd_bound, fwd_by = bound(fwd_bytes, 2 * TBH * n_cols,
                                  BF16_TENSOR_FLOPS)

        g2 = torch.Generator().manual_seed(30 + gp)
        dhs = torch.randn(T, B, H, generator=g2).to(dev)
        dht = torch.randn(B, H, generator=g2).to(dev)
        _, res, _ = rnn_cuda.gated_train_forward(proj, w1, w2, h0, **k)
        got = rnn_cuda.gated_train_backward(res, w1, w2, dhs, dht,
                                            torch.float32, **k)
        again = rnn_cuda.gated_train_backward(res, w1, w2, dhs, dht,
                                              torch.float32, **k)
        want = rnn_cuda.gated_train_backward_reference(res, w1, w2, dhs, dht,
                                                       torch.float32, **k)
        torch.cuda.synchronize()
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(again, got)):
            fail(f"gated_train_backward ({kind}): a second call on the same "
                 f"inputs gave other bits")
        del again
        names = ("dproj", "dW1", "dW2", "dh0")
        errs = {}
        for n, gk, wr in zip(names, got, want):
            if wr is None:
                continue
            sc = float(wr.abs().max())
            errs[n] = (float((gk - wr).abs().max()), sc)
        rel = {n: e / sc for n, (e, sc) in errs.items()}
        bwd_rel = max(rel["dproj"], rel["dh0"])
        dw_rel = max(rel[n] for n in ("dW1", "dW2") if n in rel)
        detail = ", ".join(f"{n} {e:.3e} of max {sc:.3e} ({rel[n]:.2e})"
                           for n, (e, sc) in errs.items())
        if not (bwd_rel <= BWD_RTOL and dw_rel <= DW_RTOL):
            fail(f"gated_train_backward ({kind}) differs from its plain "
                 f"version: {detail} (tolerances {BWD_RTOL} of max for "
                 f"dproj/dh0, {DW_RTOL} of max |dW|)")
        # the dW kernel alone, on the plain version's bf16 pair and dcpre
        dproj_b = want[0].to(torch.bfloat16)
        dc_col = {"gru": 2, "mgru_r": 1, "mgru": None}[kind]
        if kind == "gru":          # pair [r | z] = dproj columns 0, 1
            pair = dproj_b[..., :2 * H].contiguous()
        elif kind == "mgru_r":     # pair [z | r] = dproj columns 0, 2
            pair = torch.cat([dproj_b[..., :H], dproj_b[..., 2 * H:]], -1)
        else:                      # pair [z | c] = dproj columns 0, 1
            pair = dproj_b.contiguous()
        dc = (None if dc_col is None else
              dproj_b[..., dc_col * H:(dc_col + 1) * H].contiguous())
        dw_k = rnn_cuda.gated_train_dw(res, pair, dc)
        dw_r = rnn_cuda.gated_train_dw_reference(res, pair, dc)
        torch.cuda.synchronize()
        dw_alone = [(float((a - b).abs().max()), float(b.abs().max()))
                    for a, b in zip(dw_k, dw_r) if b is not None]
        dw_alone_abs = max(e for e, _ in dw_alone)
        dw_alone_scale = max(sc for _, sc in dw_alone)
        dw_alone_err = max(e / sc for e, sc in dw_alone)
        if not dw_alone_err <= DW_RTOL:
            fail(f"gated_train_dw ({kind}) differs from its plain version by"
                 f" {dw_alone_err} of max |dW| (tolerance {DW_RTOL})")
        bwd_ms = cuda_ms(torch, lambda: rnn_cuda.gated_train_backward(
            res, w1, w2, dhs, dht, torch.float32, **k), 10)
        bwd_step_us = kernel_us_per_step(
            torch, lambda: rnn_cuda.gated_train_backward(
                res, w1, w2, dhs, dht, torch.float32, **k), 10,
            "gated_train_bwd_persistent", T)
        bwd_layout, bwd_layout_text = layout_of(
            gated_plan(rnn_cuda, dev, "gated_train_backward", H, B), B)
        bwd_plain_ms = cuda_ms(
            torch, lambda: rnn_cuda.gated_train_backward_reference(
                res, w1, w2, dhs, dht, torch.float32, **k), 3)
        dw_ms = cuda_ms(torch, lambda: rnn_cuda.gated_train_dw(
            res, pair, dc), 10)
        dw_plain_ms = cuda_ms(torch, lambda: rnn_cuda.gated_train_dw_reference(
            res, pair, dc), 10)
        # cuBLAS bf16 of the same operands: dW1 = h_prev^T pair and dW2 =
        # bf16(r * h_prev)^T dcpre, the product precomputed
        lib_ops = [(res[..., 3 * H:].reshape(-1, H).contiguous(),
                    pair.reshape(-1, 2 * H))]
        if has_w2:
            rh = (res[..., :H].float() * res[..., 3 * H:].float()).to(
                torch.bfloat16).reshape(-1, H).contiguous()
            lib_ops.append((rh, dc.reshape(-1, H)))
        dw_dev = dict(
            ms=device_ms(torch, lambda: rnn_cuda.gated_train_dw(
                res, pair, dc), 10),
            plain_ms=device_ms(torch, lambda: rnn_cuda.gated_train_dw_reference(
                res, pair, dc), 10),
            library_ms=device_ms(torch, lambda: [
                torch.matmul(a.T, b) for a, b in lib_ops], 10))
        del lib_ops
        # bytes: residuals, weights, dhs, dh_T in; dproj, dW, dh0 out
        bwd_bytes = (TBH * 4 * 2 + w_bytes + TBH * 4 + B * H * 4
                     + T * B * gp * H * 4 + w_bytes + B * H * 4)
        bwd_bound, bwd_by = bound(bwd_bytes, 2 * 2 * TBH * n_cols,
                                  BF16_TENSOR_FLOPS)
        # the dW kernels read r and h_prev of the residuals, pair, dcpre
        dw_bytes = (TBH * 2 * (2 if has_w2 else 1) + TBH * 2 * 2
                    + (TBH * 2 if has_w2 else 0) + w_bytes)
        dw_bound, dw_by = bound(dw_bytes, 2 * TBH * n_cols,
                                BF16_TENSOR_FLOPS)
        # cuDNN nn.GRU bf16 forward and backward at T=20: the yardstick
        x_lib = torch.randn(T, B, H, generator=g).to(dev, torch.bfloat16)
        x_lib.requires_grad_()
        fwd_lib_ms = cuda_ms(torch, lambda: cudnn(x_lib), 10)
        out_lib, _ = cudnn(x_lib)
        gout = torch.randn_like(out_lib)
        lib_inputs = [x_lib] + list(cudnn.parameters())
        bwd_lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out_lib, lib_inputs, gout, retain_graph=True), 10)
        log(f"[gated train {kind}] T={T} B={B} H={H}: forward vs plain f32 "
            f"{fwd['f32']['err']:.3e}, bf16 {fwd['bf16']['err']:.3e} of "
            f"max(1, max|plain|) (tolerance {GATED_ATOL}), residuals beyond "
            f"{RES_RTOL:.4f} relative "
            f"{max(f['res_over'] for f in fwd.values()):.3e}; hs and h_T "
            f"bit-equal to gated_scan's; a second forward and backward call "
            f"bit-identical; backward: "
            f"{detail} (tolerances {BWD_RTOL} / {DW_RTOL}); dW kernel alone "
            f"{dw_alone_err:.3e} of max |dW|")
        log(f"[gated train {kind}] forward: {fwd_layout_text}; "
            f"{fwd_step_us:.2f} us a step (device time); backward: "
            f"{bwd_layout_text}; {bwd_step_us:.2f} us a reverse step "
            f"[{card}]")
        log(f"[gated train {kind}] forward {fwd_ms:.3f} ms (plain "
            f"{fwd_plain_ms:.3f}, bound {fwd_bound:.4f} {fwd_by}), backward "
            f"with dW {bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}, bound "
            f"{bwd_bound:.4f} {bwd_by}), dW call {dw_ms:.4f} ms (plain "
            f"{dw_plain_ms:.4f}), dW device time {dw_dev['ms']:.4f} ms (plain "
            f"{dw_dev['plain_ms']:.4f}, cuBLAS bf16 "
            f"{dw_dev['library_ms']:.4f}, bound {dw_bound:.4f} {dw_by}); "
            f"cuDNN nn.GRU "
            f"bf16 yardstick forward {fwd_lib_ms:.3f} ms, backward "
            f"{bwd_lib_ms:.3f} ms [{card}]")
        out[kind] = dict(
            scan_err=scan_err, scan_ms=scan_ms, scan_plain_ms=scan_plain_ms,
            scan_bound=scan_bound, scan_by=scan_by, scan_lib_ms=scan_lib_ms,
            scan_step_us=scan_step_us, scan_layout=scan_layout,
            fwd=fwd, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
            fwd_bound=fwd_bound, fwd_by=fwd_by, fwd_lib_ms=fwd_lib_ms,
            fwd_step_us=fwd_step_us, fwd_layout=fwd_layout,
            bwd_step_us=bwd_step_us, bwd_layout=bwd_layout,
            bwd_errs=errs, bwd_rel=bwd_rel, bwd_abs=max(
                errs[n][0] for n in ("dproj", "dh0")),
            bwd_tol=BWD_RTOL * max(errs[n][1] for n in ("dproj", "dh0")),
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound=bwd_bound,
            bwd_by=bwd_by, bwd_lib_ms=bwd_lib_ms, dw_rel=dw_rel,
            dw_alone_abs=dw_alone_abs, dw_alone_err=dw_alone_err,
            dw_tol=DW_RTOL * dw_alone_scale, dw_ms=dw_ms,
            dw_plain_ms=dw_plain_ms, dw_bound=dw_bound, dw_by=dw_by,
            dw_device=dw_dev)
        del proj, res, got, want, dproj_b, pair, dc, dw_k, dw_r, cudnn
        del x_lib, out_lib, gout, lib_inputs
    report["gated_kernels"] = out
    return out


def gated_phases(torch, np, dev, card, corpus, dec, report):
    """Phases 12-16: the gated kernels against their plain versions, the
    GRU serving and training slices, kernel against plain end to end for
    the three gated nets, and a profile. Returns the gated kernels'
    entries of the ``{"kernels": [...]}`` line."""
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.train import load_jax_params
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        write_corpus_tree)

    phase_s = {}
    phase_done = phase_timer(phase_s)

    # ---- 12. the gated kernels against their plain versions ------------
    kin = gated_kernel_phase(torch, np, dev, card, report)
    phase_done(12)

    # ---- 13. the GRU serving slice -------------------------------------
    net = get_network("gru", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device=dev)
    net.load_state_dict(load_jax_params(numpy_gated_params("gru", 0),
                                        device=dev))
    serve = serving_slice(torch, np, net, "gru", "gated_scan",
                          rnn_cuda.gated_scan_reference, corpus, dec, card)
    serve["scan_device_kernels"] = scan_device_kernels(
        torch, net, corpus, "gru", "gated_scan_persistent")
    del net
    phase_done(13)

    # ---- 14. the GRU training slice through train_cli ------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gru_train_") as tmp:
        write_corpus_tree(corpus, tmp)
        train = train_slice(
            torch, np, dev, corpus, tmp, "gru",
            ["--timedelay", "5", "-d", "0.2"],
            ("gated_train_forward", "gated_train_backward", "gated_train_dw",
             "gated_scan"), card)
    phase_done(14)

    # ---- 15. kernel against plain, end to end, for each gated net ------
    plain = dict(gated_train_forward=rnn_cuda.gated_train_forward_reference,
                 gated_train_backward=rnn_cuda.gated_train_backward_reference)
    e2e, profiled = {}, {}
    for _, _, name in GATED.values():
        e2e[name], profiled[name] = e2e_updates(
            torch, np, dev, corpus, name, numpy_gated_params(name, 1), plain,
            f"gated e2e {name}")
    phase_done(15)

    # ---- 16. where the time goes: 3 GRU updates, profiled --------------
    step_kernels = ("gated_train_fwd_persistent",
                    "gated_train_bwd_persistent")
    # the per-step gated kernels that the persistent ones replaced
    gone = ("gated_bwd_gate", "gated_bwd_reset", "gated_rz_step",
            "gated_cand_step", "gated_mgru_step")
    wall_ms, busy_ms, top, gru_kernels = profiled["gru"](step_kernels + gone)
    log_profile("gru train profile", wall_ms, busy_ms, top, card)
    if any(gru_kernels[n] != 3 * LAYERS for n in step_kernels) or any(
            gru_kernels[n] for n in gone):
        fail(f"3 profiled GRU updates ran {gru_kernels} device kernels, not "
             f"one persistent forward and one persistent backward a layer an "
             f"update ({3 * LAYERS}) and no other gated recurrence kernel")
    log(f"[gru train profile] device kernels in 3 updates of {LAYERS} "
        f"layers: {gru_kernels}: one persistent forward and one persistent "
        f"backward a layer an update")
    phase_done(16)

    report["gated"] = dict(
        slice=serve, train=train, e2e=e2e,
        profile=dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     top_device_ms=top, kernels=gru_kernels),
        phase_s=phase_s)
    gru = kin["gru"]
    scan_src = "nnacousticmodeling_tpu_torch/csrc/gated_scan.cu"
    train_src = "nnacousticmodeling_tpu_torch/csrc/gated_train.cu"
    return [
        {"name": "gated_scan", "route": "cuda", "source": scan_src,
         "device_kernel": "gated_scan_persistent",
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:197",
         "launches": serve["launches"]["gated_scan"],
         "max_abs_err": gru["scan_err"], "tolerance": GATED_ATOL,
         "ms": gru["scan_ms"], "us_per_step": gru["scan_step_us"],
         "plain_ms": gru["scan_plain_ms"],
         "bound_ms": gru["scan_bound"], "bound_by": gru["scan_by"],
         "library_ms": None},
        {"name": "gated_train_forward", "route": "cuda", "source": train_src,
         "device_kernel": "gated_train_fwd_persistent",
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:684",
         "launches": train["launches"]["gated_train_forward"],
         "max_abs_err": gru["fwd"]["f32"]["err"], "tolerance": GATED_ATOL,
         "ms": gru["fwd_ms"], "us_per_step": gru["fwd_step_us"],
         "plain_ms": gru["fwd_plain_ms"],
         "bound_ms": gru["fwd_bound"], "bound_by": gru["fwd_by"],
         "library_ms": None},
        {"name": "gated_train_backward", "route": "cuda", "source": train_src,
         "device_kernel": "gated_train_bwd_persistent",
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:785",
         "launches": train["launches"]["gated_train_backward"],
         "max_abs_err": gru["bwd_abs"], "tolerance": gru["bwd_tol"],
         "ms": gru["bwd_ms"], "us_per_step": gru["bwd_step_us"],
         "plain_ms": gru["bwd_plain_ms"],
         "bound_ms": gru["bwd_bound"], "bound_by": gru["bwd_by"],
         "library_ms": None},
        {"name": "gated_train_dw", "route": "cuda", "source": train_src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:886",
         "launches": train["launches"]["gated_train_dw"],
         "max_abs_err": gru["dw_alone_abs"], "tolerance": gru["dw_tol"],
         "ms": gru["dw_device"]["ms"],
         "plain_ms": gru["dw_device"]["plain_ms"],
         "bound_ms": gru["dw_bound"], "bound_by": gru["dw_by"],
         "library_ms": gru["dw_device"]["library_ms"]},
    ]


def numpy_peephole_params(seed):
    """PeepholeLSTM 4x1024 -> 1909 weights in the JAX package's pytree
    layout (cells.py:124-136: zero bias, full (H, H) peephole matrices),
    drawn from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h = H_MAIN

    def w(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)
                ).astype(np.float32)

    cells = []
    d = DIM
    for _ in range(LAYERS):
        cells.append({"wx": w(d, 4 * h), "wh": w(h, 4 * h),
                      "b": np.zeros(4 * h, np.float32), "peep_i": w(h, h),
                      "peep_f": w(h, h), "peep_o": w(h, h)})
        d = h
    return {"cells": cells, "out": {"w": w(h, CLASSES),
                                    "b": np.zeros(CLASSES, np.float32)}}


def peephole_kernel_phase(torch, np, dev, card):
    """Phase 17: each peephole kernel against its plain version at the
    paths' shapes. Returns the measurements."""
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda

    B, H = B_MAIN, H_MAIN
    g = torch.Generator().manual_seed(40)
    wh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    peeps = [(torch.randn(H, H, generator=g) / H ** 0.5).to(dev)
             for _ in range(3)]
    w_bytes = H * 7 * H * 4
    out = {}

    # ---- inference at the serving shapes, f32 and bf16 proj
    T = T_MAIN
    proj = torch.randn(T, B, 4 * H, generator=g).to(dev)
    c0 = torch.zeros(B, H, device=dev)
    h0 = torch.zeros(B, H, device=dev)
    scan = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (proj.to(dt), wh, *peeps, c0, h0)
        (ck, hk), hs_k = rnn_cuda.peephole_scan(*args)
        (cr, hr), hs_r = rnn_cuda.peephole_scan_reference(*args)
        torch.cuda.synchronize()
        err = max(rel_err(hs_k, hs_r), rel_err(ck, cr), rel_err(hk, hr))
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in ((hs_k, hs_r), (ck, cr), (hk, hr)))
        if not (np.isfinite(err) and err <= PEEP_ATOL):
            fail(f"peephole_scan ({tag}) differs from its plain version by "
                 f"{err} of max(1, max|plain|) (tolerance {PEEP_ATOL})")
        scan[tag] = dict(err=err, abs_err=abs_err,
                         c_max=float(cr.abs().max()))
    args = (proj, wh, *peeps, c0, h0)
    scan_ms = cuda_ms(torch, lambda: rnn_cuda.peephole_scan(*args), 3)
    scan_step_us = kernel_us_per_step(
        torch, lambda: rnn_cuda.peephole_scan(*args), 3,
        "peephole_scan_persistent", T)
    scan_plain_ms = cuda_ms(
        torch, lambda: rnn_cuda.peephole_scan_reference(*args), 1,
        warm=False)
    scan_bytes = (proj.numel() * 4 + w_bytes + 2 * B * H * 4
                  + T * B * H * 4 + 2 * B * H * 4)
    scan_bound, scan_by = bound(scan_bytes, 2 * T * B * H * 7 * H,
                                BF16_TENSOR_FLOPS)
    cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
    x_lib = torch.randn(T, B, H, generator=g).to(dev, torch.bfloat16)
    with torch.inference_mode():
        scan_lib_ms = cuda_ms(torch, lambda: cudnn(x_lib), 3)
    log(f"[peephole_scan] T={T} B={B} H={H}: max |kernel - plain| f32 proj "
        f"{scan['f32']['err']:.3e}, bf16 proj {scan['bf16']['err']:.3e} of "
        f"max(1, max|plain|) (tolerance {PEEP_ATOL}; max|c_T| "
        f"{scan['f32']['c_max']:.3g}); kernel {scan_ms:.3f} ms, "
        f"{scan_step_us:.2f} us a step (device time), plain "
        f"{scan_plain_ms:.3f} ms, bound {scan_bound:.3f} ms ({scan_by}); "
        f"cuDNN nn.LSTM bf16 yardstick {scan_lib_ms:.3f} ms [{card}]")
    out.update(scan=scan, scan_ms=scan_ms, scan_step_us=scan_step_us,
               scan_plain_ms=scan_plain_ms,
               scan_bound=scan_bound, scan_by=scan_by,
               scan_lib_ms=scan_lib_ms)
    del proj, hs_k, hs_r, x_lib

    # ---- training kernels at the training shapes
    T = T_TRAIN
    TBH = T * B * H
    proj = torch.randn(T, B, 4 * H, generator=g).to(dev)
    c0 = (torch.randn(B, H, generator=g) * 0.1).to(dev)
    h0 = (torch.randn(B, H, generator=g) * 0.1).to(dev)
    fwd = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (proj.to(dt), wh, *peeps, c0, h0)
        out_k = rnn_cuda.peephole_train_forward(*args)
        hs_k, res_k, ct_k, ht_k = out_k
        again = rnn_cuda.peephole_train_forward(*args)
        (c_s, h_s), hs_s = rnn_cuda.peephole_scan(*args)
        hs_r, res_r, ct_r, ht_r = rnn_cuda.peephole_train_forward_reference(
            *args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, k) for a, k in zip(again, out_k)):
            fail(f"peephole_train_forward ({tag}): a second call on the same "
                 f"inputs gave other bits")
        del again
        # the scan runs the training forward's kernel body: the same bits
        if not (torch.equal(hs_k, hs_s) and torch.equal(ct_k, c_s)
                and torch.equal(ht_k, h_s)):
            fail(f"peephole_train_forward ({tag}) is not bit-equal to "
                 f"peephole_scan")
        scale = max(1.0, float(hs_r.float().abs().max()))
        err = max(rel_err(hs_k, hs_r), rel_err(ct_k, ct_r),
                  rel_err(ht_k, ht_r))
        hs_over = float(((hs_k.float() - hs_r.float()).abs()
                         - RES_RTOL * hs_r.float().abs()).max()) / scale
        res_d = (res_k.float() - res_r.float()).abs()
        res_scale = max(1.0, float(res_r.float().abs().max()))
        res_over = float((res_d - RES_RTOL * res_r.float().abs()).max()
                         ) / res_scale
        c_err = max(rel_err(ct_k, ct_r), rel_err(ht_k, ht_r))
        hs_ok = (hs_over if dt == torch.bfloat16 else err) <= PEEP_ATOL
        if not (hs_ok and c_err <= PEEP_ATOL and res_over <= PEEP_ATOL):
            fail(f"peephole_train_forward ({tag}) differs from its plain "
                 f"version: {err} of max(1, max|plain|) (tolerance "
                 f"{PEEP_ATOL}; bf16 hs beyond one ulp {hs_over}), residuals "
                 f"beyond {RES_RTOL} relative by {res_over}")
        fwd[tag] = dict(err=err, abs_err=float((hs_k.float()
                                                - hs_r.float()).abs().max()),
                        res_err=float(res_d.max()), res_over=res_over)
    args = (proj, wh, *peeps, c0, h0)
    fwd_ms = cuda_ms(torch, lambda: rnn_cuda.peephole_train_forward(*args),
                     10)
    fwd_step_us = kernel_us_per_step(
        torch, lambda: rnn_cuda.peephole_train_forward(*args), 10,
        "peephole_train_fwd_persistent", T)
    fwd_plain_ms = cuda_ms(
        torch, lambda: rnn_cuda.peephole_train_forward_reference(*args), 3)
    fwd_bytes = (proj.numel() * 4 + w_bytes + 2 * B * H * 4 + TBH * 4
                 + TBH * 8 * 2 + 2 * B * H * 4)
    fwd_bound, fwd_by = bound(fwd_bytes, 2 * TBH * 7 * H, BF16_TENSOR_FLOPS)

    g2 = torch.Generator().manual_seed(41)
    dhs = torch.randn(T, B, H, generator=g2).to(dev)
    dct = torch.randn(B, H, generator=g2).to(dev)
    dht = torch.randn(B, H, generator=g2).to(dev)
    _, res, _, _ = rnn_cuda.peephole_train_forward(*args)
    bargs = (res, wh, *peeps, dhs, dct, dht, torch.float32)
    got = rnn_cuda.peephole_train_backward(*bargs)
    again = rnn_cuda.peephole_train_backward(*bargs)
    want = rnn_cuda.peephole_train_backward_reference(*bargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, k) for a, k in zip(again, got)):
        fail("peephole_train_backward: a second call on the same inputs gave "
             "other bits")
    del again
    names = ("dproj", "dW_h", "dP_i", "dP_f", "dP_o", "dc0", "dh0")
    errs = {n: (float((k - w).abs().max()), float(w.abs().max()))
            for n, k, w in zip(names, got, want)}
    rel = {n: e / sc for n, (e, sc) in errs.items()}
    bwd_rel = max(rel[n] for n in ("dproj", "dc0", "dh0"))
    dw_rel = max(rel[n] for n in ("dW_h", "dP_i", "dP_f", "dP_o"))
    detail = ", ".join(f"{n} {e:.3e} of max {sc:.3e} ({rel[n]:.2e})"
                       for n, (e, sc) in errs.items())
    if not (bwd_rel <= BWD_RTOL and dw_rel <= DW_RTOL):
        fail(f"peephole_train_backward differs from its plain version: "
             f"{detail} (tolerances {BWD_RTOL} of max for dproj/dc0/dh0, "
             f"{DW_RTOL} of max |dW|)")
    dz = want[0].to(torch.bfloat16)        # the plain version's bf16(dz)
    dw_k = rnn_cuda.peephole_train_dw(res, dz)
    dw_r = rnn_cuda.peephole_train_dw_reference(res, dz)
    torch.cuda.synchronize()
    dw_alone = [(float((a - b).abs().max()), float(b.abs().max()))
                for a, b in zip(dw_k, dw_r)]
    dw_alone_abs = max(e for e, _ in dw_alone)
    dw_alone_scale = max(sc for _, sc in dw_alone)
    dw_alone_err = max(e / sc for e, sc in dw_alone)
    if not dw_alone_err <= DW_RTOL:
        fail(f"peephole_train_dw differs from its plain version by "
             f"{dw_alone_err} of max |dW| (tolerance {DW_RTOL})")
    bwd_ms = cuda_ms(torch, lambda: rnn_cuda.peephole_train_backward(*bargs),
                     10)
    bwd_step_us = kernel_us_per_step(
        torch, lambda: rnn_cuda.peephole_train_backward(*bargs), 10,
        "peephole_train_bwd_persistent", T)
    bwd_plain_ms = cuda_ms(
        torch, lambda: rnn_cuda.peephole_train_backward_reference(*bargs), 3)
    dw_ms = cuda_ms(torch, lambda: rnn_cuda.peephole_train_dw(res, dz), 10)
    dw_plain_ms = cuda_ms(
        torch, lambda: rnn_cuda.peephole_train_dw_reference(res, dz), 10)
    # cuBLAS bf16 of the same operands: four products
    r2, d2 = res.reshape(-1, 8 * H), dz.reshape(-1, 4 * H)
    c_prev = r2[:, 5 * H:6 * H].contiguous()
    lib_ops = [(r2[:, 6 * H:7 * H].contiguous(), d2),
               (c_prev, d2[:, H:2 * H]), (c_prev, d2[:, 2 * H:3 * H]),
               (r2[:, 7 * H:].contiguous(), d2[:, 3 * H:])]
    dw_dev = dict(
        ms=device_ms(torch, lambda: rnn_cuda.peephole_train_dw(res, dz), 10),
        plain_ms=device_ms(
            torch, lambda: rnn_cuda.peephole_train_dw_reference(res, dz), 10),
        library_ms=device_ms(torch, lambda: [
            torch.matmul(a.T, b) for a, b in lib_ops], 10))
    del lib_ops, c_prev
    # bytes: residuals, weights, dhs, dc_T, dh_T in; dproj, dW, dc0, dh0 out
    bwd_bytes = (TBH * 8 * 2 + w_bytes + TBH * 4 + 2 * B * H * 4
                 + T * B * 4 * H * 4 + w_bytes + 2 * B * H * 4)
    bwd_bound, bwd_by = bound(bwd_bytes, 2 * 2 * TBH * 7 * H,
                              BF16_TENSOR_FLOPS)
    # dW reads the h_{t-1}, c_{t-1} and c_t rows of res and dz
    dw_bytes = TBH * 3 * 2 + T * B * 4 * H * 2 + w_bytes
    dw_bound, dw_by = bound(dw_bytes, 2 * TBH * 7 * H, BF16_TENSOR_FLOPS)
    x_lib = torch.randn(T, B, H, generator=g).to(dev, torch.bfloat16)
    x_lib.requires_grad_()
    fwd_lib_ms = cuda_ms(torch, lambda: cudnn(x_lib), 10)
    out_lib, _ = cudnn(x_lib)
    gout = torch.randn_like(out_lib)
    lib_inputs = [x_lib] + list(cudnn.parameters())
    bwd_lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out_lib, lib_inputs, gout, retain_graph=True), 10)
    log(f"[peephole train] T={T} B={B} H={H}: forward bit-equal to "
        f"peephole_scan; vs plain f32 "
        f"{fwd['f32']['err']:.3e}, bf16 "
        f"{fwd['bf16']['err']:.3e} of max(1, max|plain|) (tolerance "
        f"{PEEP_ATOL}), residuals beyond {RES_RTOL:.4f} relative "
        f"{max(f['res_over'] for f in fwd.values()):.3e}; backward: "
        f"{detail} (tolerances {BWD_RTOL} / {DW_RTOL}); dW kernel alone "
        f"{dw_alone_err:.3e} of max |dW|; a second forward and backward "
        f"call bit-identical")
    log(f"[peephole train] {fwd_step_us:.2f} us a forward step, "
        f"{bwd_step_us:.2f} us a reverse step (device time) [{card}]")
    log(f"[peephole train] forward {fwd_ms:.3f} ms (plain {fwd_plain_ms:.3f}"
        f", bound {fwd_bound:.4f} {fwd_by}), backward with dW {bwd_ms:.3f} "
        f"ms (plain {bwd_plain_ms:.3f}, bound {bwd_bound:.4f} {bwd_by}), dW "
        f"call {dw_ms:.4f} ms (plain {dw_plain_ms:.4f}), dW device time "
        f"{dw_dev['ms']:.4f} ms (plain {dw_dev['plain_ms']:.4f}, cuBLAS bf16 "
        f"{dw_dev['library_ms']:.4f}, bound {dw_bound:.4f} {dw_by}); cuDNN "
        f"nn.LSTM bf16 yardstick forward {fwd_lib_ms:.3f} "
        f"ms, backward {bwd_lib_ms:.3f} ms [{card}]")
    out.update(
        fwd=fwd, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
        fwd_bound=fwd_bound, fwd_by=fwd_by, fwd_lib_ms=fwd_lib_ms,
        fwd_step_us=fwd_step_us, bwd_step_us=bwd_step_us, bwd_errs=errs,
        bwd_rel=bwd_rel, dw_rel=dw_rel,
        bwd_abs=max(errs[n][0] for n in ("dproj", "dc0", "dh0")),
        bwd_tol=BWD_RTOL * max(errs[n][1] for n in ("dproj", "dc0", "dh0")),
        bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound=bwd_bound,
        bwd_by=bwd_by, bwd_lib_ms=bwd_lib_ms, dw_alone_abs=dw_alone_abs,
        dw_alone_err=dw_alone_err, dw_tol=DW_RTOL * dw_alone_scale,
        dw_ms=dw_ms, dw_plain_ms=dw_plain_ms, dw_bound=dw_bound,
        dw_by=dw_by, dw_device=dw_dev)
    return out


def peephole_phases(torch, np, dev, card, corpus, dec, lp_lstm, report):
    """Phases 17-21: the peephole kernels against their plain versions,
    the PeepholeLSTM serving and training slices, the ZoneoutLSTM of the
    SPECOM grid, and a profile. ``lp_lstm`` is phase 5's LSTM posteriors.
    Returns the peephole kernels' entries of the ``{"kernels": [...]}``
    line."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.train import load_jax_params
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        write_corpus_tree)

    phase_s = {}
    phase_done = phase_timer(phase_s)

    # ---- 17. the peephole kernels against their plain versions ---------
    kin = peephole_kernel_phase(torch, np, dev, card)
    phase_done(17)

    # ---- 18. the PeepholeLSTM serving slice ----------------------------
    net = get_network("peepholelstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device=dev)
    net.load_state_dict(load_jax_params(numpy_peephole_params(0),
                                        device=dev))
    serve = serving_slice(torch, np, net, "peepholelstm", "peephole_scan",
                          rnn_cuda.peephole_scan_reference, corpus, dec,
                          card)
    serve["scan_device_kernels"] = scan_device_kernels(
        torch, net, corpus, "peepholelstm", "peephole_scan_persistent")
    del net
    phase_done(18)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_peep_train_") as tmp:
        write_corpus_tree(corpus, tmp)
        # ---- 19. the PeepholeLSTM training slice, kernel against plain -
        train = train_slice(
            torch, np, dev, corpus, tmp, "peepholelstm", [],
            ("peephole_train_forward", "peephole_train_backward",
             "peephole_train_dw", "peephole_scan"), card)
        e2e, profiled = e2e_updates(
            torch, np, dev, corpus, "peepholelstm", numpy_peephole_params(1),
            dict(peephole_train_forward=(
                rnn_cuda.peephole_train_forward_reference),
                 peephole_train_backward=(
                     rnn_cuda.peephole_train_backward_reference)),
            "peephole e2e")
        phase_done(19)

        # ---- 20. ZoneoutLSTM, the SPECOM configuration -----------------
        zo_net = get_network("zoneoutlstm", LAYERS, [H_MAIN], CLASSES,
                             dropout=[0.2], in_dim=DIM, scan_impl="pallas",
                             device=dev)
        zo_net.load_state_dict(load_jax_params(numpy_lstm_params(0),
                                               device=dev))
        kernels.reset_launches()
        lp_zo = rnn_log_posteriors(zo_net, corpus.test.data,
                                   corpus.test.offsets, ap=corpus.log_priors,
                                   batch=B_MAIN)
        zo_serve_launches = dict(kernels.launches)
        if zo_serve_launches != {"lstm_scan": LAYERS}:
            fail(f"the ZoneoutLSTM serving path launched {zo_serve_launches}"
                 f", not lstm_scan once a layer")
        if not np.array_equal(lp_zo, lp_lstm):
            fail(f"ZoneoutLSTM posteriors differ from the LSTM's on the same "
                 f"weights by {float(np.abs(lp_zo - lp_lstm).max())}")
        del zo_net, lp_zo
        zo_train = train_slice(torch, np, dev, corpus, tmp, "zoneoutlstm",
                               ["--timedelay", "5", "-d", "0.2"],
                               ("lstm_scan",), card)
        if set(zo_train["launches"]) != {"lstm_scan"}:
            fail(f"ZoneoutLSTM training launched {zo_train['launches']}: it "
                 f"has no training kernel, and only its validation runs "
                 f"lstm_scan")
        _, zo_profiled = update_runs(torch, dev, corpus, "zoneoutlstm",
                                     numpy_lstm_params(1))
    zo_prof = zo_profiled()
    log_profile("zoneout train profile", *zo_prof, card)
    log(f"[zoneout] ZoneoutLSTM {LAYERS}x{H_MAIN} (c_ratio 0.2, h_ratio 0.5)"
        f": serving launches {zo_serve_launches}, posteriors equal to the "
        f"LSTM's bit for bit; training {zo_train['update_ms']:.2f} ms per "
        f"update through its step loop, no kernel [{card}]")
    phase_done(20)

    # ---- 21. where the time goes: 3 PeepholeLSTM updates, profiled ------
    step_kernels = ("peephole_train_fwd_persistent",
                    "peephole_train_bwd_persistent")
    wall_ms, busy_ms, top, peep_kernels = profiled(step_kernels)
    log_profile("peephole train profile", wall_ms, busy_ms, top, card)
    if any(n != 3 * LAYERS for n in peep_kernels.values()):
        fail(f"3 profiled PeepholeLSTM updates ran {peep_kernels} device "
             f"kernels, not one forward and one backward a layer an update "
             f"({3 * LAYERS})")
    log(f"[peephole train profile] device kernels in 3 updates of {LAYERS} "
        f"layers: {peep_kernels}: one forward and one backward a layer an "
        f"update")
    phase_done(21)

    report["peephole"] = dict(
        kernels=kin, slice=serve, train=train, e2e=e2e,
        zoneout=dict(serve_launches=zo_serve_launches, train=zo_train,
                     profile=dict(wall_ms=zo_prof[0],
                                  device_busy_ms=zo_prof[1],
                                  top_device_ms=zo_prof[2])),
        profile=dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     top_device_ms=top, kernels=peep_kernels),
        phase_s=phase_s)
    scan_src = "nnacousticmodeling_tpu_torch/csrc/peephole_scan.cu"
    train_src = "nnacousticmodeling_tpu_torch/csrc/peephole_train.cu"
    return [
        {"name": "peephole_scan", "route": "cuda", "source": scan_src,
         "device_kernel": "peephole_scan_persistent",
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:1306",
         "launches": serve["launches"]["peephole_scan"],
         "max_abs_err": kin["scan"]["f32"]["abs_err"],
         "tolerance": PEEP_ATOL * max(1.0, kin["scan"]["f32"]["c_max"]),
         "ms": kin["scan_ms"], "us_per_step": kin["scan_step_us"],
         "plain_ms": kin["scan_plain_ms"],
         "bound_ms": kin["scan_bound"], "bound_by": kin["scan_by"],
         "library_ms": None},
        {"name": "peephole_train_forward", "route": "cuda",
         "source": train_src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:992",
         "launches": train["launches"]["peephole_train_forward"],
         "max_abs_err": kin["fwd"]["f32"]["abs_err"],
         "tolerance": PEEP_ATOL, "ms": kin["fwd_ms"],
         "plain_ms": kin["fwd_plain_ms"], "bound_ms": kin["fwd_bound"],
         "bound_by": kin["fwd_by"], "library_ms": None},
        {"name": "peephole_train_backward", "route": "cuda",
         "source": train_src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:1101",
         "launches": train["launches"]["peephole_train_backward"],
         "max_abs_err": kin["bwd_abs"], "tolerance": kin["bwd_tol"],
         "ms": kin["bwd_ms"], "plain_ms": kin["bwd_plain_ms"],
         "bound_ms": kin["bwd_bound"], "bound_by": kin["bwd_by"],
         "library_ms": None},
        {"name": "peephole_train_dw", "route": "cuda", "source": train_src,
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:1205",
         "launches": train["launches"]["peephole_train_dw"],
         "max_abs_err": kin["dw_alone_abs"], "tolerance": kin["dw_tol"],
         "ms": kin["dw_device"]["ms"],
         "plain_ms": kin["dw_device"]["plain_ms"],
         "bound_ms": kin["dw_bound"], "bound_by": kin["dw_by"],
         "library_ms": kin["dw_device"]["library_ms"]},
    ]


def random_lp(torch, np, dev):
    """Phase 4's inputs, the rows of phases 4, 22 and 23: (B_MAIN,
    T_MAIN, CLASSES) log posteriors drawn from a flat Dirichlet (seed 1)
    and lengths 320-479."""
    rng = np.random.default_rng(1)
    lens = rng.integers(int(0.8 * 400), int(1.2 * 400), B_MAIN
                        ).astype(np.int32)
    lp = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(CLASSES), size=(B_MAIN, T_MAIN))).astype(np.float32)).to(dev)
    return lp, torch.from_numpy(lens).to(dev)


def padded_lp(torch, frame_lp, offsets):
    """Frame rows (frames, CLASSES) of the utterances at ``offsets`` in one
    (utterances, T_MAIN, CLASSES) batch, zero past each length."""
    lengths = offsets[1:] - offsets[:-1]
    out = torch.zeros((len(lengths), T_MAIN, frame_lp.shape[1]),
                      device=frame_lp.device)
    for u, (o, n) in enumerate(zip(offsets, lengths)):
        out[u, :n] = frame_lp[o:o + n]
    return out


def target_lp(torch, np, dev, corpus):
    """The test set's target rows, padded as ``padded_lp``: log
    posteriors that favour each frame's target pdf (seeded noise). The
    random net decodes an utterance to one or two segments; these give
    walks of a trained model's length (40-50 segments)."""
    targets = torch.from_numpy(corpus.test.targets.astype(np.int64)).to(dev)
    logits = torch.randn((len(targets), CLASSES), device=dev,
                         generator=torch.Generator(dev).manual_seed(5))
    logits[torch.arange(len(targets), device=dev), targets] += 6.0
    return padded_lp(torch, torch.log_softmax(logits, dim=1),
                     corpus.test.offsets)


def irregular_ends(img):
    """``img`` with the end biphone of phone p at (p, (p+1) mod P): no
    common end right context, so the collapsed kernel refuses it."""
    import dataclasses
    import numpy as np
    P = img.num_phones
    ends = np.array([p * P + (p + 1) % P for p in range(P)], np.int32)
    return dataclasses.replace(img, end_idxs=ends).validate()


def viterbi_routes(torch, obj, forward, reference, capacity, lp, lens, tag,
                   card):
    """Phases 4 and 22: a Viterbi kernel's routes on the same inputs, the
    plan's cluster route, where it keeps the state in registers the same
    cluster with the state in shared memory (``route="shared"``), and the
    device-memory route (``route="global"``), each bit-equal to the plain
    version within lengths and bit-identical on a second call; a cluster
    route must allocate no (U, 3, PS, lanes) scratch. Times them in turns
    (cluster, shared, device memory, then backwards) and the plain
    version once; per frame: a cluster route's time over the frames each
    co-resident cluster walks, the device-memory route's over the longest
    utterance. Returns {"cluster": ..., ("shared": ...,) "global": ...,
    "plain_ms", "clusters"}."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    U, T, _ = lp.shape
    mask = (torch.arange(T, device=lp.device)[None, :]
            < lens[:, None].long())
    frames, longest = int(lens.sum()), int(lens.max())
    lanes = obj.tps.shape[2]
    scratch = U * 3 * obj.PS * lanes * 8
    outputs = U * T * (lanes + obj.P) * 4
    plan = obj.plan
    if plan.route != "cluster":
        fail(f"{tag}: the plan took the {plan.route} route, not a cluster")
    clusters = capacity(obj)
    routes = [(None, "cluster", clusters)]
    if plan.registers:
        shared = vc._route(tag, plan, "shared", (obj.PS, lanes, obj.S))
        routes.append(("shared", "shared", capacity(obj, shared)))
    routes.append(("global", "global", 0))
    pr, er = reference(obj, lp, lens)
    out = {"clusters": clusters, "cluster_size": plan.cluster}
    for route, key, _ in routes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pk, ek = forward(obj, lp, lens, route=route)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        pk2, ek2 = forward(obj, lp, lens, route=route)
        torch.cuda.synchronize()
        bad_packed = int((pk != pr)[mask].sum())
        bad_end = int(((ek != er).any(dim=2))[mask].sum())
        err = float((ek - er).abs()[mask].max())
        if bad_packed or bad_end:
            fail(f"{tag}, {key} route: not bit-equal to the plain version: "
                 f"{bad_packed} packed and {bad_end} end rows differ, max "
                 f"|end diff| {err}")
        if not (torch.equal(pk[mask], pk2[mask])
                and torch.equal(ek[mask], ek2[mask])):
            fail(f"{tag}, {key} route: a second call gave other bits")
        if (peak - outputs >= scratch) == (key != "global"):
            fail(f"{tag}, {key} route: allocated {peak} bytes, its outputs "
                 f"{outputs}, the (U, 3, PS, lanes) scratch {scratch}")
        out[key] = dict(err=err, peak_bytes=peak, ms=[])
        del pk, ek, pk2, ek2
    for route, key, _ in routes + routes[::-1]:
        out[key]["ms"].append(cuda_ms(torch, lambda: forward(
            obj, lp, lens, route=route), 3))
    for _, key, held in routes:
        r = out[key]
        r["ms"] = sum(r["ms"]) / len(r["ms"])
        r["us_frame"] = (r["ms"] * 1e3 * held / frames if key != "global"
                         else r["ms"] * 1e3 / longest)
    out["plain_ms"] = cuda_ms(torch, lambda: reference(obj, lp, lens), 1,
                              warm=False)
    c, g = out["cluster"], out["global"]
    sh = out.get("shared")
    log(f"[{tag}] U={U} T={T} frames={frames}: {len(routes)} routes "
        f"bit-equal within lengths, second calls bit-identical; cluster "
        f"route (c={plan.cluster}, state in "
        f"{'registers' if plan.registers else 'shared memory'}, {clusters} "
        f"co-resident clusters) {c['ms']:.3f} ms = {c['us_frame']:.2f} us a "
        f"frame, {c['peak_bytes'] / 1e6:.1f} MB allocated (outputs "
        f"{outputs / 1e6:.1f}); "
        + (f"state in shared memory {sh['ms']:.3f} ms = "
           f"{sh['us_frame']:.2f} us a frame, {sh['peak_bytes'] / 1e6:.1f} "
           f"MB allocated; " if sh else "")
        + f"device-memory route "
        f"{g['ms']:.3f} ms = {g['us_frame']:.2f} us a frame, "
        f"{g['peak_bytes'] / 1e6:.1f} MB allocated (scratch "
        f"{scratch / 1e6:.1f}); plain "
        f"{out['plain_ms']:.3f} ms [{card}]")
    return out


def nan_rows_check(torch, np, dev, kind, card):
    """Phases 4 and 22: the collapsed (``kind`` "collapsed") or cube
    ("cube") kernel on NaN rows, every route (the collapsed kernel's
    register route, its shared-memory route on the same cluster, and
    either kernel's device-memory route), without and with a beam:
    packed rows equal and end scores equal, NaN where NaN, to the plain
    version. The input: 3 utterances of 12 Dirichlet frames (seed 3) on
    the 8-phone 26-pdf pdf-tied image (seed 8), an all-NaN frame and a
    frame NaN in half its pdfs."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    img = make_synthetic_image(num_phones=8, num_states=26, seed=8,
                               pdf_tied_transitions=True)
    rng = np.random.default_rng(3)
    lp = np.log(rng.dirichlet(np.ones(26), size=(3, 12))).astype(np.float32)
    lp[0, 4] = np.nan
    lp[1, 6, :13] = np.nan
    x = torch.from_numpy(lp).to(dev)
    lens = torch.full((3,), 12, dtype=torch.int32, device=dev)
    for beam in (None, 2.0):
        if kind == "collapsed":
            d = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, device=dev)
            obj, fwd, ref = (d._collapsed_fwd, vc.collapsed_viterbi_forward,
                             vc.collapsed_viterbi_reference)
        else:
            d = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam,
                               backend="pallas", device=dev)
            obj, fwd, ref = (d._pallas_fwd, vcube.cube_viterbi_forward,
                             vcube.cube_viterbi_reference)
        want = ref(obj, x, lens)
        routes = (None, "shared", "global") if obj.plan.registers else (
            None, "global")
        for route in routes:
            if not same_bits(fwd(obj, x, lens, route=route), want):
                fail(f"[{kind} NaN rows] the {route or 'cluster'} route "
                     f"differs from the plain version (beam {beam})")
    log(f"[{kind} NaN rows] 3 x 12 frames with an all-NaN and a half-NaN "
        f"frame: routes {', '.join(r or 'plan' for r in routes)} equal to "
        f"the plain version (packed rows; end scores, NaN where NaN) "
        f"without and with beam 2.0 [{card}]")


def route_entries(name, source, replaces, launches, res, bound_ms, by):
    """The ``{"kernels": [...]}`` entries of a Viterbi kernel's routes
    (``name``, the plan's; ``name.shared``, where the plan keeps the state
    in registers; ``name.global``) from ``viterbi_routes``'s exact
    run."""
    return [{"name": name + suffix, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches.get(name + suffix, 0),
             "max_abs_err": res[key]["err"], "tolerance": 0.0,
             "ms": res[key]["ms"], "plain_ms": res["plain_ms"],
             "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
            for suffix, key in (("", "cluster"), (".shared", "shared"),
                                (".global", "global")) if key in res]


@contextlib.contextmanager
def plain_viterbi():
    """The decoder's kernels replaced by their plain versions (the three
    Viterbi forwards and the backtrace): a plain decode on the card."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    with mock.patch.object(ViterbiDecoder, "_forward_scan",
                           ViterbiDecoder._forward_scan_plain), \
            mock.patch.object(vc, "collapsed_viterbi_forward",
                           vc.collapsed_viterbi_reference), \
            mock.patch.object(vcube, "cube_viterbi_forward",
                              vcube.cube_viterbi_reference), \
            mock.patch.object(vbt, "viterbi_backtrace",
                              vbt.viterbi_backtrace_reference):
        yield


def backtrace_check(torch, tables, packed, end, lens, pack, tag, card,
                    timed=False):
    """Phases 5, 22, 23: the backtrace kernel against its plain walk on
    the same card tensors, segs (padding included) and counts bit-equal,
    on every route the tables can take (``backtrace_routes``: the
    collapsed modes' one, the lane map's two; the rule's pick first).
    With ``timed``, for each route: the kernel's ms with the L2 cache
    flushed before each launch (CUDA events around each launch, queued
    behind the flush, all queued while the card sleeps; the decode runs
    it right after a forward that wrote far more than L2 holds) and with
    L2 warm (device time under the profiler: back to back, a launch is
    shorter than its Python call); the plain walk's ms, and the bound:
    the bytes of the zeroed segs, the counts, the lengths, each walked
    utterance's last end row and end-map entry, and per hop (the hops
    these rows need) one packed entry and one table entry; its ~20
    integer operations a hop over the float32 rate. Returns a dict (the
    picked route's times as ``ms`` and ``warm_ms``; where the rule picks
    another, the global route's as ``global_ms`` and
    ``global_warm_ms``)."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
    args = (tables, packed, end, lens, pack)
    want = vbt.viterbi_backtrace_reference(*args)
    route = vbt.backtrace_route(tables)
    routes = vbt.backtrace_routes(tables)
    err = 0.0
    for r in routes:
        got = vbt.viterbi_backtrace(*args, route=r)
        torch.cuda.synchronize()
        if got[0].dtype != want[0].dtype or got[1].dtype != want[1].dtype:
            fail(f"[backtrace {tag}] dtypes {got[0].dtype}, {got[1].dtype}, "
                 f"the plain walk's {want[0].dtype}, {want[1].dtype}")
        bad_rows = int((got[0] != want[0]).any(dim=2).sum())
        bad_counts = int((got[1] != want[1]).sum())
        if bad_rows or bad_counts:
            fail(f"[backtrace {tag}] the kernel's {r} route differs from the "
                 f"plain walk: {bad_rows} segs rows, {bad_counts} counts")
        err = max(err, float(max(int((got[0] - want[0]).abs().max()),
                                 int((got[1] - want[1]).abs().max()))))
    U, T, _ = packed.shape
    E = end.shape[2]
    hops = int(want[1].sum())
    walked = int((lens > 0).sum())
    out = dict(err=err, hops=hops, longest_walk=int(want[1].max()),
               utterances=U, frames=T, route=route)
    msg = (f"[backtrace {tag}] U={U} T={T}: kernel = plain walk bit for "
           f"bit (segs with padding, counts) on the {' and '.join(routes)} "
           f"route{'s' if len(routes) > 1 else ''} ({route} picked), {hops} "
           f"hops (longest walk {out['longest_walk']})")
    if timed:
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                            device=packed.device)
        times = {}
        for r in routes:
            vbt.viterbi_backtrace(*args, route=r)
            # the card sleeps while the host queues every launch, so no
            # host time between a flush and its launch is timed
            torch.cuda._sleep(SLEEP_CYCLES)
            pairs = []
            for _ in range(20):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                vbt.viterbi_backtrace(*args, route=r)
                stop.record()
                pairs.append((start, stop))
            torch.cuda.synchronize()
            times[r] = (sum(a.elapsed_time(b) for a, b in pairs) / len(pairs),
                        device_ms(torch, lambda r=r: vbt.viterbi_backtrace(
                            *args, route=r), 20))
        del flush
        ms, warm_ms = times[route]
        plain_ms = cuda_ms(torch, lambda: vbt.viterbi_backtrace_reference(
            *args), 1, warm=False)
        nbytes = 12 * U * T + 8 * U + 4 * U + (4 * E + 4) * walked + 8 * hops
        b_ms, by = bound(nbytes, 20 * hops + E * walked, F32_FLOPS)
        out.update(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=by, bytes=nbytes,
                   us_hop=ms * 1e3 / max(out["longest_walk"], 1))
        if "global" in times and route != "global":
            out.update(global_ms=times["global"][0],
                       global_warm_ms=times["global"][1])
        msg += "; " + ", ".join(
            f"{r} route {a:.4f} ms L2 flushed, {b:.4f} ms L2 warm"
            for r, (a, b) in times.items())
        msg += (f" ({out['us_hop']:.2f} us a hop of the longest walk, "
                f"{route} flushed), plain walk {plain_ms:.3f} ms, bound "
                f"{b_ms:.5f} ms ({by}, {nbytes} bytes)")
    log(msg + f" [{card}]")
    return out


def hop_slope(short, long_, tag, card):
    """Microseconds a hop as the slope of the kernel's time between two
    row sets of one shape whose longest walks differ (flushed, warm)."""
    hops = long_["longest_walk"] - short["longest_walk"]
    slope = {k: (long_[k] - short[k]) * 1e3 / hops if hops > 0 else None
             for k in ("ms", "warm_ms")}
    if hops > 0:
        log(f"[backtrace {tag}] {slope['ms']:.3f} us a hop L2 flushed, "
            f"{slope['warm_ms']:.3f} us warm: the slope over "
            f"{short['longest_walk']} -> {long_['longest_walk']} hops of the "
            f"longest walk [{card}]")
    return slope


SCAN_OPS = 17    # a triphone a frame: per state two adds, a compare, a
                 # select and the observation add; the export add and its
                 # first-max compare
SCAN_NAN_UTTS = 16
SCAN_BEAM = 2.0
SCAN_LSU_BYTES = 104     # a slot a frame on the cluster route: state 24 B
                         # read and 16 written, 24 B of records and two
                         # 4 B posteriors (pass 1); state 8 + 8, an 8 B
                         # record, a posterior and a score (pass 2)


def same_bits(got, want):
    """Packed rows equal and end scores equal, NaN where NaN."""
    (pg, eg), (pw, ew) = got, want
    return bool(pg.equal(pw) and eg.shape == ew.shape and (
        (eg == ew) | (eg.isnan() & ew.isnan())).all())


def one_call_device_ms(torch, fn, name=None):
    """Device ms of one call of ``fn`` under the profiler, after a
    warm-up call, with a one-cycle device sleep queued behind it (a
    session whose last kernel runs long has lost it); with ``name``, the
    device time of the kernels whose name holds it, and a session counts
    only if it recorded exactly one. None where three sessions did not
    count."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, busy, top, counts = device_profile(
            torch, lambda: (fn(), torch.cuda._sleep(1)),
            launches_of=(name or "",))
        if name is None and busy > 0:
            return busy
        if name is not None and counts[name] == 1:
            return sum(v for k, v in top.items() if name in k)
    return None


def ms_or_not(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


def sm_clock_ghz():
    """The card's highest SM clock (``nvidia-smi`` clocks.max.sm), GHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) / 1e3


def scan_kernel_check(torch, np, dev, card, dec, lp, lens):
    """Phase 23: ``viterbi_scan_forward``'s two routes (the plan's cluster
    route and the device-memory route, ``route="global"``) on the untied
    cube decoder ``dec`` and phase 4's ``lp``, each bit-equal to both
    plain twins and to the other route; on a 16-utterance copy with NaN
    and -inf frames, on the untied and a non-cube 48-phone image, without
    and with a beam, both routes bit-equal to the general twin; on the
    non-cube image at phase 4's inputs likewise. Times both routes in
    turns (CUDA events, and device time of one call), the non-cube
    image's, the cube twin (wall and device, once) and the general twin
    (once); computes the bounds and the co-resident clusters. Returns a
    dict."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_scan as vscan
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder

    def kernel(d, x, route=None):
        return vscan.viterbi_scan_forward(
            d._scan, x, d._time_pack_for(x.shape[1]), route=route)

    routes = {"cluster": None, "global": "global"}
    plan = dec._scan.plan
    if plan.route != "cluster":
        fail(f"[scan kernel] the plan took the {plan.route} route on the "
             f"untied image, not a cluster")
    U, T, S = lp.shape
    got = {key: kernel(dec, lp, r) for key, r in routes.items()}
    err = 0.0
    for tag, want in (("cube", dec._forward_scan_cube(lp, dec._cube_order)),
                      ("general", dec._forward_scan_general(lp))):
        for key, g in got.items():
            if not same_bits(g, want):
                fail(f"[scan kernel] the {key} route differs from the plain "
                     f"{tag} twin on the untied image")
            err = max(err, float((g[0] - want[0]).abs().max()),
                      float(torch.nan_to_num(g[1] - want[1], nan=0.0
                                             ).abs().max()))
        del want
    for key, r in routes.items():
        if not same_bits(got[key], kernel(dec, lp, r)):
            fail(f"[scan kernel] the {key} route: a second call gave other "
                 f"bits")
    del got
    # NaN and -inf frames on both images, without and with a beam
    partial = make_synthetic_image(num_phones=PHONES, num_states=CLASSES,
                                   full_context=False)
    x = lp[:SCAN_NAN_UTTS].clone()
    x[0, T // 5] = float("nan")
    x[1, T // 3, :S // 2] = float("nan")
    x[2, T // 2, :(2 * S) // 3] = float("-inf")
    for img_tag, image in (("untied", dec.image), ("non-cube", partial)):
        for beam in (None, SCAN_BEAM):
            d = ViterbiDecoder(image, pip=20.0, lmw=1.0, beam=beam,
                               backend="xla", device=dev)
            want = d._forward_scan_general(x)
            for key, r in routes.items():
                if not same_bits(kernel(d, x, r), want):
                    fail(f"[scan kernel] the {key} route differs from the "
                         f"general twin on NaN and -inf frames ({img_tag}, "
                         f"beam {beam})")
    # the non-cube image at phase 4's inputs
    dec_p = ViterbiDecoder(partial, pip=20.0, lmw=1.0, backend="xla",
                           device=dev)
    if dec_p._cube_order is not None:
        fail("the full_context=False image is a cube")
    if dec_p._scan.plan.route != "cluster":
        fail(f"[scan kernel] the non-cube image took {dec_p._scan.plan}")
    want = dec_p._forward_scan_general(lp)
    for key, r in routes.items():
        if not same_bits(kernel(dec_p, lp, r), want):
            fail(f"[scan kernel] the {key} route differs from the general "
                 f"twin on the non-cube image")
    del want
    out = dict(err=err, cluster_size=plan.cluster,
               clusters=vscan.scan_cluster_capacity(dec._scan),
               partial_clusters=vscan.scan_cluster_capacity(dec_p._scan))
    dec_b = ViterbiDecoder(dec.image, pip=20.0, lmw=1.0, beam=SCAN_BEAM,
                           backend="xla", device=dev)
    timed = {"ms": dec, "beam_ms": dec_b, "partial_ms": dec_p}
    ms = {key: {t: [] for t in timed} for key in routes}
    for key in ("cluster", "global", "global", "cluster"):
        for t, d in timed.items():
            ms[key][t].append(cuda_ms(
                torch, lambda: kernel(d, lp, routes[key]), 3))
    for key, name in (("cluster", "viterbi_scan_cluster_kernel"),
                      ("global", "viterbi_scan_kernel")):
        out[key] = dict({t: sum(v) / len(v) for t, v in ms[key].items()},
                        runs=ms[key]["ms"], device_ms=one_call_device_ms(
                            torch, lambda: kernel(dec, lp, routes[key]),
                            name))
    out["plain_ms"] = cuda_ms(
        torch, lambda: dec._forward_scan_cube(lp, dec._cube_order), 1,
        warm=False)
    out["plain_device_ms"] = one_call_device_ms(
        torch, lambda: dec._forward_scan_cube(lp, dec._cube_order))
    out["general_ms"] = cuda_ms(
        torch, lambda: dec._forward_scan_general(lp), 1, warm=False)
    out["partial_general_ms"] = cuda_ms(
        torch, lambda: dec_p._forward_scan_general(lp), 1, warm=False)
    tab = dec._scan
    F, B, P = tab.width, tab.num_biphones, tab.num_phones
    t3 = dec.image.num_triphones
    table_bytes = sum(getattr(tab, k).numel() * 4 for k in (
        "count", "idx", "tpa", "tpb", "fan", "lm", "p0", "end_idxs"))
    nbytes = 4 * U * T * (S + B + P) + table_bytes
    out["bound_ms"], out["bound_by"] = bound(nbytes, SCAN_OPS * U * T * t3,
                                             F32_FLOPS)
    state = 48 * U * T * F * B
    out["state_floor_ms"] = (state + nbytes) / HBM_BYTES_PER_S * 1e3
    # the cluster route: every slot's shared-memory and L1 bytes a frame
    # through its SM's load/store path at 128 bytes a clock, the clusters
    # walking in waves of the co-resident count
    waves = -(-U // out["clusters"])
    slots_sm = F * B / plan.cluster
    ghz = sm_clock_ghz()
    out["lsu_floor_ms"] = (waves * T * slots_sm * SCAN_LSU_BYTES
                           / (128 * ghz * 1e9) * 1e3)
    out["sm_clock_ghz"] = ghz
    out["partial"] = dict(triphones=partial.num_triphones, width=
                          dec_p._scan.width)
    c, g = out["cluster"], out["global"]
    log(f"[scan kernel] U={U} T={T} untied P={P} image: both routes "
        f"bit-equal to the cube and general twins and to each other, second "
        f"calls bit-identical; 16 utterances with NaN and -inf frames on "
        f"the untied and the non-cube image bit-equal to the general twin "
        f"on both routes without and with beam {SCAN_BEAM}; non-cube image "
        f"({partial.num_triphones} triphones, F={dec_p._scan.width}) "
        f"bit-equal to its general twin on both routes; cluster route (c="
        f"{plan.cluster}, {out['clusters']} co-resident clusters, "
        f"{out['partial_clusters']} on the non-cube image) "
        f"{c['ms']:.3f} ms (turns {', '.join(f'{v:.3f}' for v in c['runs'])}"
        f"; {ms_or_not(c['device_ms'])} device), beam {SCAN_BEAM} "
        f"{c['beam_ms']:.3f} ms, non-cube {c['partial_ms']:.3f} ms; "
        f"device-memory route {g['ms']:.3f} ms (turns "
        f"{', '.join(f'{v:.3f}' for v in g['runs'])}; "
        f"{ms_or_not(g['device_ms'])} device), beam {g['beam_ms']:.3f} ms, "
        f"non-cube {g['partial_ms']:.3f} ms; plain cube twin {out['plain_ms']:.1f} ms "
        f"({ms_or_not(out['plain_device_ms'])} device), general twin "
        f"{out['general_ms']:.1f} ms, non-cube general twin "
        f"{out['partial_general_ms']:.1f} ms; bound {out['bound_ms']:.3f} ms"
        f" ({out['bound_by']}); the device-memory route's floor (its DP "
        f"state in device memory, {state / 1e9:.1f} GB) "
        f"{out['state_floor_ms']:.1f} ms; the cluster route's floor ({waves}"
        f" waves x {T} frames x {slots_sm:.0f} slots an SM x "
        f"{SCAN_LSU_BYTES} load/store bytes a slot at 128 B a clock, "
        f"{ghz:.3f} GHz) {out['lsu_floor_ms']:.1f} ms [{card}]")
    return out


def timed_decode(torch, dec, lp, offsets):
    """``decode_corpus`` of the test set through ``dec``: (results, ms,
    launches)."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.corpus_decode import (
        decode_corpus)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = decode_corpus(dec, lp, offsets, batch=B_MAIN)
    torch.cuda.synchronize()
    return results, (time.perf_counter() - t0) * 1e3, dict(kernels.launches)


def fbank_wide_range(torch, np, dev, features):
    """The fbank kernel on a wide-range waveform (a loud 1 kHz tone, white
    noise 60 dB below it, a 0.25 s stretch of zeros: 93 dB between a
    frame's loudest and quietest mel bands), with both mel conventions.
    Kernel and plain version are each held against a float64 twin of the
    float32 windowed frames both transform (their rounding is common to
    both, and larger than either transform's error); the kernel must lie
    no farther from it than the plain version, plus 1e-4. Returns
    {kaldi_weights: (kernel error, plain error)}."""
    n = 48000
    x = 0.9 * np.sin(2 * np.pi * 1000.3 * np.arange(n) / 16000.0)
    x += 0.9e-3 * np.random.default_rng(24).standard_normal(n)
    x[n // 3:n // 3 + 4000] = 0.0
    wave = torch.from_numpy(x.astype(np.float32)).to(dev)
    frames = (features.frame_signal(wave) * torch.from_numpy(
        features.povey_window()).to(dev)).double().cpu().numpy()
    power = np.abs(np.fft.rfft(frames, n=512)) ** 2
    out = {}
    for kw in (False, True):
        mel = power @ features.mel_filterbank(kaldi_weights=kw).astype(
            np.float64)
        twin = np.log(np.maximum(mel, features.EPS))
        got = features.fbank_cuda(wave, kaldi_weights=kw).cpu().numpy()
        want = features.fbank(wave, kaldi_weights=kw).cpu().numpy()
        err = float(np.abs(got - twin).max())
        err_plain = float(np.abs(want - twin).max())
        if not (np.isfinite(got).all() and err <= err_plain + 1e-4):
            fail(f"fbank kernel (kaldi_weights={kw}) on the wide-range "
                 f"waveform lies {err} from the float64 twin, the plain "
                 f"version {err_plain} (gate: plain + 1e-4)")
        out[kw] = (err, err_plain)
    return out


def fbank_phase(torch, np, dev, card, features, n_frames, rng):
    """Phase 24: the fbank kernel's two entries against their plain
    versions on one waveform of ``n_frames`` frames drawn from ``rng``,
    the wide-range gate, times, bounds and the cuFFT yardstick."""
    wave = torch.from_numpy((rng.standard_normal(
        400 + (n_frames - 1) * 160) * 0.1).astype(np.float32)).to(dev)
    fr = features.frame_signal(wave)
    fb = {}
    for kw in (False, True):
        got = features.fbank_cuda(wave, kaldi_weights=kw)
        want = features.fbank(wave, kaldi_weights=kw)
        got_f = features.fbank_frames(fr, kaldi_weights=kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != (n_frames, 40) or not err <= 1e-3:
            fail(f"fbank kernel (kaldi_weights={kw}) differs from its plain "
                 f"version by {err} (tolerance 1e-3), shape "
                 f"{tuple(got.shape)}")
        if not torch.equal(got_f, got):
            fail(f"fbank kernel (kaldi_weights={kw}): the frames entry "
                 f"differs from the waveform entry")
        fb[kw] = err
    wide = fbank_wide_range(torch, np, dev, features)
    # CUDA events: each call's kernel outlasts its host time (the
    # profiler's sums would miss the device events it drops)
    fb_ms = cuda_ms(torch, lambda: features.fbank_frames(fr), 20)
    fb_plain_ms = cuda_ms(torch, lambda: features.fbank(wave), 10)
    fb_full_ms = cuda_ms(torch, lambda: features.fbank_cuda(wave), 20)
    win = torch.from_numpy(features.povey_window()).to(dev)
    fft_ms = cuda_ms(torch, lambda: torch.fft.rfft(fr * win, n=512), 20)
    # the least work of the function, not of the TPU kernel's dense DFT
    # products: a 512-point real FFT (2.5 N log2 N flops), the window,
    # the power (3 a bin), the mel bank's nonzeros (2 each) and the log;
    # bytes: the kernel's tables, the frames (frames entry) or the
    # waveform (waveform entry) read once, the output written once
    mel_nz = max(int(np.count_nonzero(features.mel_filterbank(
        kaldi_weights=kw))) for kw in (False, True))
    fb_ops = n_frames * (2.5 * 512 * 9 + 400 + 3 * 257 + 2 * mel_nz + 2 * 40)
    tables = sum(a.nbytes for a in (
        features.povey_window(), features.fft_twiddles(),
        features.pass_twiddles(), *features.mel_lanes(*features.mel_bands(
            features.mel_filterbank()))))
    fb_bound, fb_by = bound(n_frames * (400 + 40) * 4 + tables, fb_ops,
                            F32_FLOPS)
    fb_wave_bound, fb_wave_by = bound(
        (wave.numel() + n_frames * 40) * 4 + tables, fb_ops, F32_FLOPS)
    log(f"[fbank] {n_frames} frames ({wave.numel() / 16000:.1f} s at 16 kHz):"
        f" max |kernel - plain| {fb[False]:.3e} (HTK bins), {fb[True]:.3e} "
        f"(Kaldi weights), tolerance 1e-3; frames entry bit-equal to the "
        f"waveform entry; wide range (float64 twin): kernel "
        f"{wide[False][0]:.3e} / {wide[True][0]:.3e}, plain "
        f"{wide[False][1]:.3e} / {wide[True][1]:.3e}, gate plain + 1e-4")
    log(f"[fbank] waveform entry {fb_full_ms:.4f} ms, bound "
        f"{fb_wave_bound:.4f} ms ({fb_wave_by}, (160 + 40) x 4 B a frame); "
        f"frames entry {fb_ms:.4f} ms, bound {fb_bound:.4f} ms ({fb_by}, "
        f"(400 + 40) x 4 B a frame); cuFFT torch.fft.rfft(frames * win, "
        f"n=512) {fft_ms:.4f} ms (yardstick of like work); plain "
        f"{fb_plain_ms:.3f} ms (plain fbank; CUDA events) [{card}]")
    return dict(err=fb, wide=wide, frames_ms=fb_ms, ms=fb_full_ms,
                plain_ms=fb_plain_ms, fft_ms=fft_ms, frames_bound_ms=fb_bound,
                frames_bound_by=fb_by, bound_ms=fb_wave_bound,
                bound_by=fb_wave_by)


def fbank_batch_device_ms(torch, features, waves):
    """Device ms of the ``fbank`` kernels of one ``fbank_cuda`` call per
    waveform (numpy), summed under the profiler, and how many kernels the
    session recorded. The profiler now and then drops device events: a
    session that recorded fewer kernels than launches is repeated, up to
    three times in all, and the fullest one's sum is scaled to all
    launches."""
    best = (0.0, 0)
    for _ in range(3):
        _, _, top, counts = device_profile(
            torch, lambda: [features.fbank_cuda(w) for w in waves],
            launches_of=("fbank_kernel",))
        got = (sum(v for k, v in top.items() if "fbank_kernel" in k),
               counts["fbank_kernel"])
        best = max(best, got, key=lambda b: b[1])
        if got[1] == len(waves):
            break
    if best[1] == 0:
        fail("the profiler recorded no fbank kernel in three sessions")
    return best[0] * len(waves) / best[1], best[1]


def decoder_audio_phases(torch, np, dev, card, img, corpus, lp_rand, lens,
                         lp, results, per, decode_ms, report):
    """Phases 22-25: the cube kernel against its plain version, the
    decoder's backends, the fbank kernel against its plain version, and
    the raw-audio serving slice. ``lp_rand``/``lens`` are phase 4's
    inputs, ``lp``/``results``/``per``/``decode_ms`` phase 5's LSTM
    posteriors, collapsed decode, PER and decode-stage ms. Returns the
    two kernels' entries of the ``{"kernels": [...]}`` line."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    from nnacousticmodeling_tpu_torch.decoder.corpus_decode import (
        decode_corpus)
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.io import load_mlf, write_mlf
    from nnacousticmodeling_tpu_torch.models import get_network, networks
    from nnacousticmodeling_tpu_torch.ops import features
    from nnacousticmodeling_tpu_torch.ops.rnn_cuda import lstm_scan_reference
    from nnacousticmodeling_tpu_torch.train import load_jax_params

    phase_s = {}
    phase_done = phase_timer(phase_s)
    offsets = corpus.test.offsets
    lengths = np.diff(offsets)
    audio_s = float(lengths.sum()) / 100.0
    irr = irregular_ends(img)

    # ---- 22. cube_viterbi_forward's two routes against plain ----------
    cube = {}
    decs = {}
    for tag, im, beam in (("exact", img, None), ("beam", img, BEAM),
                          ("irregular exact", irr, None),
                          ("irregular beam", irr, BEAM)):
        d = ViterbiDecoder(im, pip=20.0, lmw=1.0, beam=beam,
                           backend="pallas", device=dev)
        decs[tag] = d
        cube[tag] = viterbi_routes(
            torch, d._pallas_fwd, vcube.cube_viterbi_forward,
            vcube.cube_viterbi_reference, vcube.cube_cluster_capacity,
            lp_rand, lens, f"cube {tag}", card)
    nan_rows_check(torch, np, dev, "cube", card)
    for tag in ("exact", "irregular exact"):
        d = decs[tag]
        packed, end = d._pallas_fwd.forward(lp_rand, lens)
        cube[tag]["backtrace"] = backtrace_check(
            torch, d._bt_cube, packed, end, lens,
            d._time_pack_for(lp_rand.shape[1]), f"phase 22 cube {tag} rows",
            card, timed=tag == "exact")
        del packed, end
    # walks of a trained model's length through the cube kernel's rows
    lp_tgt = target_lp(torch, np, dev, corpus)
    lens_tgt = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    d = decs["exact"]
    packed, end = d._pallas_fwd.forward(lp_tgt, lens_tgt)
    bt_tgt = backtrace_check(
        torch, d._bt_cube, packed, end, lens_tgt,
        d._time_pack_for(lp_tgt.shape[1]), "phase 22 cube exact target rows",
        card, timed=True)
    bt_tgt["hop_us"] = hop_slope(cube["exact"]["backtrace"], bt_tgt,
                                 "phase 22 cube", card)
    cube["exact"]["backtrace_target_rows"] = bt_tgt
    del packed, end
    cv = decs["exact"]._pallas_fwd
    frames = int(lens.sum())
    cells = frames * cv.PS * cv.B
    cube_ops = 13 * cells
    cube_bytes = (frames * (CLASSES + cv.B + cv.P) * 4 + lens.numel() * 4
                  + (cv.pdf.numel() + cv.tps.numel() + 3 * cv.B + cv.P) * 4)
    cube_bound, cube_by = bound(cube_bytes, cube_ops, F32_FLOPS)
    state_mb = lp_rand.shape[0] * 3 * cv.PS * cv.B * 8 / 1e6
    state_bytes = frames * 3 * cv.PS * cv.B * 8 * 2
    log(f"[cube] bound {cube_bound:.3f} ms ({cube_by}); DP state "
        f"{state_mb:.1f} MB for {lp_rand.shape[0]} utterances, on the "
        f"device-memory route its traffic {state_bytes / 1e9:.1f} GB = "
        f"{state_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate, on "
        f"the cluster route none")
    phase_done(22)

    # ---- 23. the decoder's backends on phase 5's posteriors ------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_backends_") as tmp:
        ref_path = Path(tmp, "test_ref.mlf")
        write_mlf(str(ref_path), corpus.ref_mlf["test"])
        ref = load_mlf(str(ref_path))
        routes = {"collapsed": dict(decode_ms=decode_ms,
                                    audio_s_per_s=audio_s / decode_ms * 1e3,
                                    per=per)}
        for backend in ("pallas", "xla"):
            d = ViterbiDecoder(img, pip=20.0, lmw=1.0, backend=backend,
                               device=dev)
            if d.backend != backend:
                fail(f"backend={backend!r} built {d.backend!r}")
            res, ms, launches = timed_decode(torch, d, lp, offsets)
            want = ({"cube_viterbi_forward", "viterbi_backtrace"}
                    if backend == "pallas" else
                    {"viterbi_scan_forward", "viterbi_backtrace"})
            if {k for k, v in launches.items() if v} != want:
                fail(f"the {backend} route launched {launches}, expected "
                     f"{sorted(want)}")
            per_b = per_of(corpus, res, Path(tmp, f"{backend}.mlf"), ref)
            same = sum(a.segments == b.segments for a, b in zip(res, results))
            if same != len(results) or per_b != per:
                fail(f"the {backend} route differs from phase 5's collapsed "
                     f"decode: {len(results) - same} utterances, PER "
                     f"{per_b} vs {per}")
            routes[backend] = dict(decode_ms=ms, audio_s_per_s=audio_s / ms
                                   * 1e3, per=per_b, launches=launches)
        auto_irr = ViterbiDecoder(irr, pip=20.0, lmw=1.0, device=dev)
        if auto_irr.backend != "pallas":
            fail(f"auto on the irregular-end image took {auto_irr.backend!r}"
                 f", not 'pallas'")
        untied = make_synthetic_image(num_phones=PHONES, num_states=CLASSES)
        auto_untied = ViterbiDecoder(untied, pip=20.0, lmw=1.0, device=dev)
        if auto_untied.backend != "xla":
            fail(f"auto on the untied image took {auto_untied.backend!r}, "
                 f"not 'xla'")
        res_u, ms_u, launches_u = timed_decode(torch, auto_untied, lp,
                                               offsets)
        if ({k for k, v in launches_u.items() if v}
                != {"viterbi_scan_forward", "viterbi_backtrace"}
                or not all(r.segments for r in res_u)):
            fail(f"untied decode: launches {launches_u}, "
                 f"{sum(not r.segments for r in res_u)} empty utterances")
        routes["untied auto -> xla"] = dict(
            decode_ms=ms_u, audio_s_per_s=audio_s / ms_u * 1e3,
            segments=sum(len(r.segments) for r in res_u))
        scan = scan_kernel_check(torch, np, dev, card, auto_untied, lp_rand,
                                 lens)
        twin_bt = backtrace_check(
            torch, auto_untied._bt_scan, *auto_untied._forward_scan(lp_rand),
            lens, auto_untied._time_pack_for(lp_rand.shape[1]),
            "phase 23 scan-kernel rows", card, timed=True)
        twin_bt["target_rows"] = backtrace_check(
            torch, auto_untied._bt_scan, *auto_untied._forward_scan(lp_tgt),
            lens_tgt, auto_untied._time_pack_for(lp_tgt.shape[1]),
            "phase 23 scan-kernel target rows", card, timed=True)
        twin_bt["target_rows"]["hop_us"] = hop_slope(
            twin_bt, twin_bt["target_rows"], "phase 23 scan kernel", card)
    del lp_tgt
    log("[backends] phase 5's posteriors, " + "; ".join(
        f"{k}: decode {v['decode_ms']:.1f} ms, {v['audio_s_per_s']:.1f} "
        f"audio-s/s" for k, v in routes.items())
        + f"; pallas and xla give phase 5's segments and PER ({per:.2f} %); "
        f"auto picks pallas on the irregular-end image, xla on the untied "
        f"one [{card}]")
    phase_done(23)

    # ---- 24. the fbank kernel against its plain version ----------------
    n_frames = int(lengths.sum())
    rng = np.random.default_rng(24)
    fbk = fbank_phase(torch, np, dev, card, features, n_frames, rng)
    phase_done(24)

    # ---- 25. the raw-audio serving slice -------------------------------
    waves = [(rng.standard_normal(400 + (int(t) - 1) * 160) * 0.1
              ).astype(np.float32) for t in lengths]
    net = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device=dev)
    net.load_state_dict(load_jax_params(numpy_lstm_params(0), device=dev))
    dec = decs["exact"]
    ap = corpus.log_priors
    with tempfile.TemporaryDirectory(prefix="chip_smoke_audio_") as tmp:
        ref_path = Path(tmp, "test_ref.mlf")
        write_mlf(str(ref_path), corpus.ref_mlf["test"])
        ref = load_mlf(str(ref_path))
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fbs = [features.fbank_cuda(w) for w in waves]
        x = torch.cat([features.cmn(f) for f in fbs]).cpu().numpy()
        t1 = time.perf_counter()
        lp_a = rnn_log_posteriors(net, x, offsets, ap=ap, batch=B_MAIN)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res_a = decode_corpus(dec, lp_a, offsets, batch=B_MAIN)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        per_a = per_of(corpus, res_a, Path(tmp, "kernel.mlf"), ref)
        t4 = time.perf_counter()
        launches = dict(kernels.launches)
        log(f"[audio slice] main-path launches: {launches}")
        for name in ("fbank", "lstm_scan", "cube_viterbi_forward",
                     "viterbi_backtrace"):
            if launches.get(name, 0) <= 0:
                fail(f"the raw-audio path did not launch {name}")
        if launches.get("cube_viterbi_forward.global", 0):
            fail("the raw-audio path took the cube kernel's device-memory "
                 "route, not the cluster route")
        if x.shape != (n_frames, DIM) or not np.isfinite(lp_a).all():
            fail(f"raw-audio features {x.shape} or posteriors malformed")
        if not all(r.segments for r in res_a):
            fail("an utterance decoded to no segments (raw-audio slice)")
        stages = {"features_ms": (t1 - t0) * 1e3,
                  "posteriors_ms": (t2 - t1) * 1e3,
                  "decode_ms": (t3 - t2) * 1e3, "mlf_per_ms": (t4 - t3) * 1e3}
        tput = audio_s / (t4 - t0)
        log(f"[audio slice] LSTM {LAYERS}x{H_MAIN} -> {CLASSES} on fbank+CMN "
            f"of {len(waves)} waveforms ({audio_s:.2f} audio-s): PER "
            f"{per_a:.2f} %, {tput:.1f} audio-s/s; " + ", ".join(
                f"{k} {v:.1f}" for k, v in stages.items()) + f" [{card}]")
        fb_batch_ms, fb_seen = fbank_batch_device_ms(torch, features, waves)
        log(f"[audio slice] the {len(waves)} fbank launches of a batch: "
            f"{fb_batch_ms:.4f} ms of device time, summed under the "
            f"profiler ({fb_seen} of {len(waves)} kernels recorded) "
            f"[{card}]")

        # the plain route: plain fbank, plain LSTM; then the plain cube
        # Viterbi on the kernel run's posteriors
        before = dict(kernels.launches)
        fbs_plain = [features.fbank(torch.from_numpy(w).to(dev))
                     for w in waves]
        # the kernel's own output against its plain version, before CMN
        # (which would cancel a constant per-bin offset)
        fb_main_err = max(float((f - g).abs().max())
                          for f, g in zip(fbs, fbs_plain))
        if not fb_main_err <= 1e-3:
            fail(f"raw-audio fbank kernel differs from its plain version by "
                 f"{fb_main_err} (tolerance 1e-3)")
        x_plain = torch.cat([features.cmn(f) for f in fbs_plain]
                            ).cpu().numpy()
        del fbs, fbs_plain
        with mock.patch.object(networks, "lstm_scan", lstm_scan_reference):
            lp_plain = rnn_log_posteriors(net, x_plain, offsets, ap=ap,
                                          batch=B_MAIN)
        if dict(kernels.launches) != before:
            fail("the plain raw-audio route launched a kernel")
        feat_err = float(np.abs(x - x_plain).max())
        post_err = float(np.abs(lp_a - lp_plain).max())
        if not post_err <= POSTERIOR_ATOL:
            fail(f"raw-audio posteriors differ from the plain route's by "
                 f"{post_err} (tolerance {POSTERIOR_ATOL})")
        with plain_viterbi():
            res_p = decode_corpus(dec, lp_a, offsets, batch=B_MAIN)
        per_p = per_of(corpus, res_p, Path(tmp, "plain.mlf"), ref)
        same = sum(a.segments == b.segments for a, b in zip(res_a, res_p))
        if same != len(res_a) or per_p != per_a:
            fail(f"raw-audio slice: plain cube decode differs: "
                 f"{len(res_a) - same} utterances, PER {per_p} vs {per_a}")
        log(f"[audio slice] plain route: fbank within {fb_main_err:.3e} "
            f"(tolerance 1e-3), features after CMN within {feat_err:.3e}, "
            f"posteriors within {post_err:.3e} (tolerance {POSTERIOR_ATOL});"
            f" plain cube Viterbi: segments of all {same} utterances and PER"
            f" identical")
    del net
    phase_done(25)

    report["decoder_audio"] = dict(
        cube=cube, cube_bound_ms=cube_bound, cube_state_mb=state_mb,
        routes=routes, scan_kernel=scan, scan_backtrace=twin_bt,
        fbank=dict(fbk, batch_device_ms=fb_batch_ms),
        audio_slice=dict(per=per_a, audio_s=audio_s, audio_s_per_s=tput,
                         fbank_err=fb_main_err, feature_err=feat_err,
                         posterior_err=post_err,
                         launches=launches, **stages),
        phase_s=phase_s)
    return route_entries(
        "cube_viterbi_forward",
        "nnacousticmodeling_tpu_torch/csrc/viterbi_cube.cu",
        "nnacousticmodeling_tpu/decoder/viterbi_pallas.py:255", launches,
        cube["exact"], cube_bound, cube_by) + [
        {"name": "viterbi_scan_forward" + suffix, "route": "cuda",
         "source": "nnacousticmodeling_tpu_torch/csrc/viterbi_scan.cu",
         "replaces": "nnacousticmodeling_tpu/decoder/viterbi.py:370, :447 "
                     "(lax.scan twins, no pallas_call)",
         "launches": launches_u.get("viterbi_scan_forward" + suffix, 0),
         "max_abs_err": scan["err"], "tolerance": 0.0,
         "ms": scan[key]["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": None}
        for suffix, key in (("", "cluster"), (".global", "global"))
    ] + [
        {"name": "fbank", "route": "cuda",
         "source": "nnacousticmodeling_tpu_torch/csrc/fbank.cu",
         "replaces": "nnacousticmodeling_tpu/ops/features.py:210",
         "launches": launches["fbank"],
         "max_abs_err": max(fb_main_err, *fbk["err"].values()),
         "tolerance": 1e-3, "ms": fbk["ms"], "plain_ms": fbk["plain_ms"],
         "bound_ms": fbk["bound_ms"], "bound_by": fbk["bound_by"],
         "library_ms": None},
    ]


# ---- phases 26-29: feed-forward nets, the master pipeline, ensembles ------
FF_LAYERS, FF_UNITS, FF_SPLICE, FF_BATCH = 8, 2048, 5, 1024
TDNN_KSIZE, TDNN_UNITS, TDNN_BATCH = (5, 5, 9, 9), 1024, 256
NUM_FOLDS, FOLD_SPEAKERS = 5, 40
# phases 30-32: the epoch lines of train_folds_parallel's log; the host
# seconds phase 31's native decode may take (utterances = this x threads
# / one utterance's seconds, 8 to 128); CTC Adam steps
FOLD_LINE = re.compile(r"stage=(\d+) epoch=(\d+) folds=\[(.*?)\] "
                       r"loss=\[(.*?)\]", re.S)
NATIVE_BUDGET_S = 12.0
FOLD_BATCHES = (256, 128)         # the master's two stages (master.py:49)
CTC_STEPS = 5


def numpy_mlp_params(seed, in_dim):
    """MLP FF_LAYERS x FF_UNITS relu -> CLASSES weights in the JAX pytree
    layout, drawn from a numpy seed (hidden layers scaled sqrt(2 / fan
    in), so the relu stack keeps its scale)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hidden, d = [], in_dim
    for _ in range(FF_LAYERS):
        hidden.append({"w": (rng.standard_normal((d, FF_UNITS))
                             * np.sqrt(2.0 / d)).astype(np.float32),
                       "b": np.zeros(FF_UNITS, np.float32)})
        d = FF_UNITS
    return {"hidden": hidden,
            "out": {"w": (rng.standard_normal((d, CLASSES)) / np.sqrt(d)
                          ).astype(np.float32),
                    "b": np.zeros(CLASSES, np.float32)}}


def mlp_macs(in_dim):
    """Multiply-adds a frame of the FF_LAYERS x FF_UNITS MLP."""
    return (in_dim * FF_UNITS + (FF_LAYERS - 1) * FF_UNITS * FF_UNITS
            + FF_UNITS * CLASSES)


def tdnn_macs(feat):
    """Multiply-adds a frame of the TDNN_KSIZE x TDNN_UNITS TDNN."""
    width = sum(TDNN_KSIZE) - len(TDNN_KSIZE) + 1
    macs, d = 0, feat
    for k in TDNN_KSIZE:
        width -= k - 1
        macs += width * k * d * TDNN_UNITS
        d = TDNN_UNITS
    return macs + d * CLASSES


def ff_train_run(torch, np, train_cli, argv, steps, flops_update, tag,
                 epochs, card):
    """One ``train_cli.main`` run of a feed-forward net: every loss finite;
    the last epoch's ms per update and train frames/s beside the FLOP
    bound of an update at the f32 CUDA-core and bf16 tensor peaks."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    hist = result.history
    losses = [h[k] for h in hist for k in ("main/loss",
                                           "validation/main/loss")]
    if len(hist) != epochs or not np.isfinite(losses).all():
        fail(f"{tag} training history malformed: {hist}")
    last = hist[-1]["elapsed_time"]
    update_ms = last / steps * 1e3
    batch = int(argv[argv.index("-b") + 1])
    frames_per_s = steps * batch / last
    bound_f32 = flops_update / F32_FLOPS * 1e3
    bound_bf16 = flops_update / BF16_TENSOR_FLOPS * 1e3
    log(f"[{tag}] {steps} updates an epoch: epoch times "
        + ", ".join(f"{h['elapsed_time']:.3f} s" for h in hist)
        + f"; epoch {epochs}: {update_ms:.2f} ms per update, "
        f"{frames_per_s:.0f} train frames/s; an update is "
        f"{flops_update / 1e9:.1f} GFLOP: bound {bound_f32:.3f} ms at the "
        f"f32 CUDA-core peak, {bound_bf16:.3f} ms at the dense bf16 "
        f"tensor peak; losses " + ", ".join(
            f"{h['main/loss']:.4f} (val {h['validation/main/loss']:.4f})"
            for h in hist) + f"; whole call {wall_s:.1f} s [{card}]")
    return result, dict(history=hist, update_ms=update_ms,
                        frames_per_s=frames_per_s, gflop=flops_update / 1e9,
                        bound_f32_ms=bound_f32, bound_bf16_ms=bound_bf16,
                        wall_s=wall_s)


def profile_updates(torch, dev, card, net, x, y, bs, dtype, tag):
    """3 updates of ``net`` (batch ``bs``, momentumsgd, no validation)
    under the profiler, after 3 unprofiled ones (cuBLAS / cuDNN plans):
    wall ms, device busy ms and the top device ops."""
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, train_network)
    n = 3 * bs
    cfg = TrainConfig(stages=[TrainStage(1, "momentumsgd", bs, 0.01, False)],
                      log=None, use_validation=False, compute_dtype=dtype)

    def run():
        train_network(net, x[:n], y[:n], cfg, device=dev)

    run()
    wall_ms, busy_ms, top = device_profile(torch, run)
    log_profile(tag, wall_ms, busy_ms, top, card)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, top_device_ms=top)


def master_phase_of(name, argv):
    if name == "train_main":
        if "--train-rpl" in argv:
            return "train rpl"
        return "train folds" if "--train-fold" in argv else "train master"
    if name == "predict_folds_main":
        return "predict"
    return "generate folds" if name == "generate_folds_main" else "evaluate"


class Spy:
    """Wraps a function: keeps its last result and each call's first
    argument and seconds (the card synchronised around it)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.out, self.calls = torch, fn, None, []

    def __call__(self, *args, **kwargs):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.out = self.fn(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.calls.append((args[0], time.perf_counter() - t0))
        return self.out


def ff_ensemble_phases(torch, np, dev, card, img, corpus, dec, tput5,
                       report):
    """Phases 26-29: FF serving, FF and TDNN training through
    ``train_cli``, the six-phase master pipeline, and ensemble serving
    through ``evaluate --rpl``. ``corpus``/``dec`` are phase 5's,
    ``tput5`` its audio-s/s."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.corpus_decode import (
        decode_corpus)
    from nnacousticmodeling_tpu_torch.decoder.image import (
        load_image, save_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    from nnacousticmodeling_tpu_torch.infer import ff_log_posteriors
    from nnacousticmodeling_tpu_torch.io import load_mlf, write_mlf
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops.splice import splice_flat
    from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli
    from nnacousticmodeling_tpu_torch.pipeline import master as master_mod
    from nnacousticmodeling_tpu_torch.train import load_jax_params
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        make_synthetic_corpus, write_corpus_tree)

    phase_s = {}
    phase_done = phase_timer(phase_s)
    out = {}
    offsets = corpus.test.offsets
    lengths = np.diff(offsets)
    audio_s = float(lengths.sum()) / 100.0
    ap = corpus.log_priors
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_ff_")
    tmp = Path(tmp_dir.name)
    ref_path = tmp / "test_ref.mlf"
    write_mlf(str(ref_path), corpus.ref_mlf["test"])
    ref = load_mlf(str(ref_path))

    # ---- 26. FF serving ------------------------------------------------
    x_ff = splice_flat(corpus.test.data, range(-FF_SPLICE, FF_SPLICE + 1))
    in_dim = x_ff.shape[1]
    weights = numpy_mlp_params(2, in_dim)
    net = get_network("ff", FF_LAYERS, [FF_UNITS], CLASSES, "relu",
                      in_dim=in_dim, device=dev)
    net.load_state_dict(load_jax_params(weights, device=dev))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = ff_log_posteriors(net, x_ff, ap=ap)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = decode_corpus(dec, lp, offsets, batch=B_MAIN)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    per = per_of(corpus, results, tmp / "ff.mlf", ref)
    t3 = time.perf_counter()
    launches = dict(kernels.launches)
    log(f"[ff serving] main-path launches: {launches}")
    if launches.get("collapsed_viterbi_forward", 0) <= 0:
        fail("the FF serving path did not launch collapsed_viterbi_forward")
    if launches.get("collapsed_viterbi_forward.global", 0):
        fail("the FF serving path took the collapsed kernel's device-memory "
             "route, not the cluster route")
    if lp.shape != (lengths.sum(), CLASSES) or not np.isfinite(lp).all():
        fail(f"FF posteriors malformed: shape {lp.shape}")
    stages = {"posteriors_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
              "mlf_per_ms": (t3 - t2) * 1e3}
    tput = audio_s / (t3 - t0)
    post_flops = 2.0 * mlp_macs(in_dim) * x_ff.shape[0]
    log(f"[ff serving] MLP {FF_LAYERS}x{FF_UNITS} relu -> {CLASSES} on "
        f"{x_ff.shape[0]} frames spliced +-{FF_SPLICE} ({in_dim}-dim): PER "
        f"{per:.2f} %, {tput:.1f} audio-s/s; " + ", ".join(
            f"{k} {v:.1f}" for k, v in stages.items())
        + f"; the posterior products are {post_flops / 1e12:.2f} TFLOP, "
        f"{post_flops / F32_FLOPS * 1e3:.1f} ms at the f32 CUDA-core peak "
        f"[{card}]")
    cpu_net = get_network("ff", FF_LAYERS, [FF_UNITS], CLASSES, "relu",
                          in_dim=in_dim, device="cpu")
    cpu_net.load_state_dict(load_jax_params(weights, device="cpu"))
    lp_cpu = ff_log_posteriors(cpu_net, x_ff, ap=ap)
    del cpu_net
    post_err = float(np.abs(lp - lp_cpu).max())
    if not post_err <= POSTERIOR_ATOL:
        fail(f"FF posteriors on the card differ from the CPU's by {post_err} "
             f"(tolerance {POSTERIOR_ATOL})")
    with plain_viterbi():
        results_plain = decode_corpus(dec, lp, offsets, batch=B_MAIN)
    per_plain = per_of(corpus, results_plain, tmp / "ff_plain.mlf", ref)
    same = sum(a.segments == b.segments for a, b in zip(results,
                                                        results_plain))
    if same != len(results) or per_plain != per:
        fail(f"FF serving: plain decode differs: {len(results) - same} "
             f"utterances, PER {per_plain} vs {per}")
    log(f"[ff serving] posteriors within {post_err:.3e} of the CPU's "
        f"(tolerance {POSTERIOR_ATOL}); plain Viterbi: segments of all "
        f"{same} utterances and PER identical")
    wall_ms, busy_ms, top = device_profile(
        torch, lambda: ff_log_posteriors(net, x_ff, ap=ap))
    log_profile("ff posteriors profile", wall_ms, busy_ms, top, card)
    out["ff_serving"] = dict(per=per, audio_s_per_s=tput,
                             posterior_err=post_err, launches=launches,
                             tflop=post_flops / 1e12, profile=dict(
                                 wall_ms=wall_ms, device_busy_ms=busy_ms,
                                 top_device_ms=top), **stages)
    del net, lp, lp_cpu, x_ff
    phase_done(26)

    # ---- 27. FF and TDNN training through train_cli --------------------
    # phase 5's corpus with its training utterances spread over
    # FOLD_SPEAKERS speakers (the same frames: the names alone change),
    # so that phase 28's 5 folds all hold speakers
    corpus_k = make_synthetic_corpus(img, **CORPUS,
                                     num_speakers=FOLD_SPEAKERS)
    if not (np.array_equal(corpus_k.train.data, corpus.train.data)
            and np.array_equal(corpus_k.test.data, corpus.test.data)):
        fail("the fold corpus does not hold phase 5's frames")
    tree = tmp / "tree"
    write_corpus_tree(corpus_k, str(tree))
    save_image(str(tree / "recog" / "kaldiTri1909.img"), img)
    np.save(tree / "recog" / "log_ap_Kaldi1909.npy", corpus_k.log_priors)
    data = ["--num-classes", str(CLASSES), "--data-dir", f"{tree}/data",
            "--offset-dir", f"{tree}/data", "--target-dir", f"{tree}/data"]
    n_train = int(corpus.train.data.shape[0])
    ff_args = ["-n", "ff", "-l", str(FF_LAYERS), "-u", str(FF_UNITS), "-a",
               "relu", "--splice", str(FF_SPLICE), "-d", "0.2", "-b",
               str(FF_BATCH), "-o", "momentumsgd", "--lr", "0.01",
               "--early-stopping", "false", "--noplot", "-e", "2"] + data
    ff_flops = 3 * 2 * FF_BATCH * mlp_macs(in_dim)
    ff_steps = n_train // FF_BATCH
    train = {}
    kernels.reset_launches()
    for dtype in ("float32", "bfloat16"):
        res, train[f"ff_{dtype}"] = ff_train_run(
            torch, np, train_cli, ff_args + ["--dtype", dtype, "--out",
                                             str(tmp / f"ff_{dtype}")],
            ff_steps, ff_flops, f"ff train {dtype}", 2, card)
        hist = res.history
        if not hist[1]["main/loss"] < hist[0]["main/loss"]:
            fail(f"FF {dtype} train loss did not fall: "
                 f"{hist[0]['main/loss']} -> {hist[1]['main/loss']}")
        serving = get_network("ff", FF_LAYERS, [FF_UNITS], CLASSES, "relu",
                              in_dim=in_dim, device=dev)
        serving.load_state_dict(load_jax_params(
            tmp / f"ff_{dtype}" / "model.npz", device=dev))
    win = sum(TDNN_KSIZE) - len(TDNN_KSIZE) + 1
    tdnn_args = (["-n", "tdnn", "--tdnn-ksize"]
                 + [str(k) for k in TDNN_KSIZE] + ["-u"]
                 + [str(TDNN_UNITS)] * len(TDNN_KSIZE)
                 + ["-a", "relu", "-d", "0.2", "-b", str(TDNN_BATCH), "-o",
                    "momentumsgd", "--lr", "0.01", "--early-stopping",
                    "false", "--noplot", "-e", "1", "--out",
                    str(tmp / "tdnn")] + data)
    _, train["tdnn"] = ff_train_run(
        torch, np, train_cli, tdnn_args, n_train // TDNN_BATCH,
        3 * 2 * TDNN_BATCH * tdnn_macs(DIM), "tdnn train (epoch 1, warm-up "
        "included)", 1, card)
    serving = get_network("tdnn", 0, [TDNN_UNITS] * len(TDNN_KSIZE), CLASSES,
                          "relu", TDNN_KSIZE, in_dim=win * DIM, device=dev)
    serving.load_state_dict(load_jax_params(tmp / "tdnn" / "model.npz",
                                            device=dev))
    train_launches = dict(kernels.launches)
    if train_launches:
        fail(f"the FF / TDNN training launched a recurrence or Viterbi "
             f"kernel: {train_launches}")
    log("[ff train] every loss finite, FF train losses fall in both "
        "dtypes, each model.npz loads into its serving net")
    # where an update's time goes: 3 updates of each, profiled
    y_train = corpus.train.targets
    x_tr = splice_flat(corpus.train.data, range(-FF_SPLICE, FF_SPLICE + 1))
    for dtype in ("float32", "bfloat16"):
        net = get_network("ff", FF_LAYERS, [FF_UNITS], CLASSES, "relu",
                          in_dim=in_dim, device=dev)
        train[f"ff_{dtype}"]["profile"] = profile_updates(
            torch, dev, card, net, x_tr, y_train, FF_BATCH, dtype,
            f"ff {dtype} update profile (3 updates)")
    half = (win - 1) // 2
    x_tr = splice_flat(corpus.train.data, range(-half, half + 1))
    train["tdnn"]["profile"] = profile_updates(
        torch, dev, card, serving, x_tr, y_train, TDNN_BATCH, "float32",
        "tdnn update profile (3 updates)")
    out["ff_train"] = train
    del serving, net, x_tr
    phase_done(27)

    # ---- 28. the master pipeline ---------------------------------------
    results_dir = tmp / "results"
    spies = {name: Spy(torch, getattr(master_mod, name))
             for name in ("generate_folds_main", "train_main",
                          "predict_folds_main", "evaluate_main")}
    master_args = [
        "--num-folds", str(NUM_FOLDS), "--gen-folds",
        "--data-dir", f"{tree}/data", "--offset-dir", f"{tree}/data",
        "--target-dir", f"{tree}/data", "--utt-list-dir", f"{tree}/data",
        "--recog-dir", f"{tree}/recog", "--output-dir", str(results_dir),
        "--output-id", "smoke", "--num-classes", str(CLASSES),
        f"--network-spec=-n lstm -l {LAYERS} -u {H_MAIN} --timedelay 5 "
        f"-d 0.2",
        "--epoch", "1", "-o", "adam", "momentumsgd", "-b", "256", "128",
        "--lr", "1e-2", "1e-3",
        "--rpl-train-setup=-b 1024 --epoch 2 -o adam --lr 1e-3 "
        "--early-stopping false",
        "--PIP", "20", "--seed", "0", "--eval-data", "test",
        "--device", "cuda"]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.multiple(master_mod, **spies):
        pers = master_mod.main(master_args)
    master_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"[master] main-path launches: {launches}")
    for name in ("lstm_train_forward", "lstm_train_backward",
                 "lstm_train_dw", "lstm_scan", "collapsed_viterbi_forward"):
        if launches.get(name, 0) <= 0:
            fail(f"the master pipeline did not launch {name}")
    if launches.get("collapsed_viterbi_forward.global", 0):
        fail("the master pipeline took the collapsed kernel's device-memory "
             "route")
    per_phase = {}
    for name, spy in spies.items():
        for argv, sec in spy.calls:
            ph = master_phase_of(name, [str(a) for a in argv])
            n, s = per_phase.get(ph, (0, 0.0))
            per_phase[ph] = (n + 1, s + sec)
    want = {"generate folds": 1, "train master": 1, "train folds": NUM_FOLDS,
            "predict": 2, "train rpl": 1, "evaluate": 6}
    if {k: v[0] for k, v in per_phase.items()} != want:
        fail(f"the master pipeline's phases ran {per_phase}, not {want}")
    fold_dir = results_dir / "fold_data" / str(NUM_FOLDS) / "data"
    sizes = [len(np.load(fold_dir / f"offsets_{k}.npy")) - 1
             for k in range(NUM_FOLDS)]
    if min(sizes) <= 0:
        fail(f"an empty fold: utterances a fold {sizes}")
    rpl_log = json.loads((results_dir / "models" / "rpl" / str(NUM_FOLDS)
                          / "smoke" / "log.json").read_text())
    rpl_losses = [h[k] for h in rpl_log for k in ("main/loss",
                                                  "validation/main/loss")]
    if not rpl_log or not np.isfinite(rpl_losses).all():
        fail(f"the RPL's losses are not finite: {rpl_log}")
    if len(pers) != 6 or not all(np.isfinite(v) for v in pers.values()):
        fail(f"the master pipeline returned {pers}, not six finite PERs")
    log(f"[master] LSTM {LAYERS}x{H_MAIN} --timedelay 5 -d 0.2, "
        f"{NUM_FOLDS} folds of {sizes} utterances, RPL4: {master_s:.1f} s; "
        + "; ".join(f"{k} {n}x {s:.1f} s" for k, (n, s) in per_phase.items())
        + f"; RPL losses {[round(v, 4) for v in rpl_losses]}; PER "
        + ", ".join(f"{tag} {v:.2f} %" for (_, tag), v in pers.items())
        + f" [{card}]")
    out["master"] = dict(seconds=master_s, per_phase=per_phase,
                         fold_utterances=sizes, rpl_history=rpl_log,
                         pers={t: v for (_, t), v in pers.items()},
                         launches=launches)
    phase_done(28)

    # ---- 29. ensemble serving through evaluate --rpl -------------------
    models = results_dir / "models"
    ev = ["-n", "lstm", "-l", str(LAYERS), "-u", str(H_MAIN),
          "--timedelay", "5", "-d", "0.2", "--rpl", "--tri",
          "--fold-model-dir", str(models / "folds" / str(NUM_FOLDS) / "smoke"),
          "--master-network",
          str(models / "master" / str(NUM_FOLDS) / "smoke" / "model"),
          "--data-dir", f"{tree}/data", "--offset-dir", f"{tree}/data",
          "--utt-list-dir", f"{tree}/data", "--recog-dir", f"{tree}/recog",
          "--num-classes", str(CLASSES), "--test-or-dev", "test",
          "--device", "cuda"]
    full = ev + ["--rpl-model",
                 str(models / "rpl" / str(NUM_FOLDS) / "smoke" / "model")]
    single = ev + ["--rpl-model", "-", "--fold-network-pattern", "-"]
    runs = {}
    for tag, argv in (("single", single), ("ensemble", full),
                      ("plain", full + ["--scan-impl", "xla"])):
        lp_spy = Spy(torch, evaluate.ensemble_log_posteriors)
        dec_spy = Spy(torch, evaluate.decode_corpus)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.multiple(evaluate, ensemble_log_posteriors=lp_spy,
                                 decode_corpus=dec_spy):
            per_t = evaluate.main(argv)
        wall = time.perf_counter() - t0
        lp_s, dec_s = lp_spy.calls[0][1], dec_spy.calls[0][1]
        stage_s = lp_s + dec_s
        runs[tag] = dict(per=per_t, lp=lp_spy.out, results=dec_spy.out,
                         launches=dict(kernels.launches), wall_s=wall,
                         posteriors_ms=lp_s * 1e3, decode_ms=dec_s * 1e3,
                         audio_s_per_s=audio_s / stage_s,
                         call_audio_s_per_s=audio_s / wall)
    one, ens, plain = runs["single"], runs["ensemble"], runs["plain"]
    log(f"[ensemble] launches: single {one['launches']}; ensemble "
        f"{ens['launches']}; plain {plain['launches']}")
    n_single = one["launches"].get("lstm_scan", 0)
    if n_single <= 0 or ens["launches"].get("lstm_scan", 0) != \
            (NUM_FOLDS + 1) * n_single:
        fail(f"the ensemble launched lstm_scan "
             f"{ens['launches'].get('lstm_scan', 0)} times, not "
             f"{NUM_FOLDS + 1} x the single net's {n_single}")
    if plain["launches"].get("lstm_scan", 0):
        fail("the plain (--scan-impl xla) ensemble launched lstm_scan")
    if ens["lp"].shape != (lengths.sum(), CLASSES) or not np.isfinite(
            ens["lp"]).all():
        fail(f"ensemble posteriors malformed: shape {ens['lp'].shape}")
    post_err = float(np.abs(ens["lp"] - plain["lp"]).max())
    if not post_err <= POSTERIOR_ATOL:
        fail(f"ensemble posteriors differ from the plain route's by "
             f"{post_err} (tolerance {POSTERIOR_ATOL})")
    dec_k = ViterbiDecoder(load_image(str(tree / "recog" /
                                          "kaldiTri1909.img")),
                           pip=20.0, lmw=1.0, device=dev)
    with plain_viterbi():
        res_plain = decode_corpus(dec_k, ens["lp"], corpus_k.test.offsets)
    per_plain = per_of(corpus_k, res_plain, tmp / "ens_plain.mlf", load_mlf(
        str(tree / "recog" / "test_ref.mlf")))
    same = sum(a.segments == b.segments for a, b in zip(ens["results"],
                                                        res_plain))
    if same != len(res_plain) or per_plain != ens["per"]:
        fail(f"ensemble: plain decode differs: {len(res_plain) - same} "
             f"utterances, PER {per_plain} vs {ens['per']}")
    del dec_k
    log(f"[ensemble] {NUM_FOLDS + 1} nets + RPL4: PER {ens['per']:.2f} %, "
        f"{ens['audio_s_per_s']:.1f} audio-s/s (posteriors "
        f"{ens['posteriors_ms']:.1f} ms, decode {ens['decode_ms']:.1f}; "
        f"whole evaluate call {ens['call_audio_s_per_s']:.1f}); the master "
        f"alone {one['audio_s_per_s']:.1f} audio-s/s (posteriors "
        f"{one['posteriors_ms']:.1f} ms; whole call "
        f"{one['call_audio_s_per_s']:.1f}), phase 5's single net "
        f"{tput5:.1f}; lstm_scan {n_single} -> "
        f"{ens['launches']['lstm_scan']} launches; the plain route "
        f"(--scan-impl xla) within {post_err:.3e} (tolerance "
        f"{POSTERIOR_ATOL}), PER {plain['per']:.2f} %; plain Viterbi: "
        f"segments of all {same} utterances and PER identical [{card}]")
    out["ensemble"] = {tag: {k: v for k, v in r.items()
                             if k not in ("lp", "results")}
                       for tag, r in runs.items()}
    out["ensemble"]["posterior_err"] = post_err
    phase_done(29)
    out["phase_s"] = phase_s
    report["ff_ensemble"] = out
    return dict(tmp_dir=tmp_dir, tree=tree, corpus_k=corpus_k,
                results_dir=results_dir,
                fold_train_s=per_phase["train folds"][1])


def patched(target, mapping):
    """``mock.patch.multiple(target, **mapping)``, nothing when empty."""
    return (mock.patch.multiple(target, **mapping) if mapping
            else contextlib.nullcontext())


def fold_loss_rows(np, text):
    """(stage, epoch, folds, per-fold losses) of each epoch line that
    ``train_folds_parallel`` logged in ``text``."""
    rows = []
    for m in FOLD_LINE.finditer(text):
        rows.append((int(m.group(1)), int(m.group(2)), m.group(3),
                     np.array(m.group(4).split(), np.float64)))
    return rows


def fold_updates(torch, np, dev, corpus, plain):
    """3 updates of ``train_folds_parallel`` on 5 LSTM 4x1024 folds
    (dropout 0, momentumsgd lr 1e-2, no validation): 5 pseudo-utterances
    of 640 frames of phase 5's training set, one a fold, so every fold's
    universe is B x L = 2,560 frames and an epoch is one update. With
    ``plain`` (``rnn_cuda`` name -> plain function) patched in. Returns
    the (3, 5) per-update, per-fold losses (logged at full precision),
    the 5 trained param maps and the 5 inits."""
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, load_jax_params)
    from nnacousticmodeling_tpu_torch.train.fold_parallel import (
        train_folds_parallel)

    per = B_MAIN * T_TRAIN // (NUM_FOLDS - 1)
    n = NUM_FOLDS * per
    x, y = corpus.train.data[:n], corpus.train.targets[:n]
    logs = []
    cfg = TrainConfig(
        stages=[TrainStage(epoch=3, optimizer="momentumsgd",
                           batch_size=B_MAIN, lr=0.01, early_stopping=False)],
        bprop_len=T_TRAIN, seed=0, log=logs.append, use_validation=False)
    net = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device=dev)
    inits = [load_jax_params(numpy_lstm_params(20 + k), device=dev)
             for k in range(NUM_FOLDS)]
    full = functools.partial(np.array2string, precision=9,
                             max_line_width=10 ** 6)
    with patched(rnn_cuda, plain), mock.patch.object(
            np, "array2string", lambda a, precision=None: full(a)):
        params = train_folds_parallel(net, x, y, np.arange(0, n + 1, per),
                                      np.arange(NUM_FOLDS), NUM_FOLDS, cfg,
                                      init_params=inits, device=dev)
    torch.cuda.synchronize()
    return (np.stack([r[3] for r in fold_loss_rows(np, "\n".join(logs))]),
            params, inits)


def change_errors(before, got, want):
    """name -> max |(got - before) - (want - before)| / max |want -
    before|: how far a kernel run's change of each parameter is from the
    plain run's, relative to the plain change's largest magnitude."""
    out = {}
    for name, b in before.items():
        d_want = want[name].float() - b.float()
        scale = float(d_want.abs().max())
        diff = float((got[name].float() - want[name].float()).abs().max())
        out[name] = diff / scale if scale > 0 else float("inf")
    return out


def grad_errors(got, want):
    """name -> max |got - want| / max |want| of two gradient maps."""
    return {name: float((got[name] - w).abs().max() / w.abs().max())
            for name, w in want.items()}


def fold_native_ctc_phases(torch, np, dev, card, img, corpus, lp5, results5,
                           ctx, report):
    """Phases 30-32: fold-parallel training through ``train_cli
    --train-all-folds`` on phase 28's fold tree, the native decoder
    through ``evaluate --decoder native`` (and ``--lm-from-mlf`` on the
    card decoder), and CTC on the LSTM training kernels. ``lp5`` /
    ``results5`` are phase 5's posteriors and its collapsed decode;
    ``ctx`` phase 28's tree and fold-training seconds."""
    import io
    import os
    import threading

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder import native
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder.image import save_image
    from nnacousticmodeling_tpu_torch.io import write_mlf
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli
    from nnacousticmodeling_tpu_torch.train import (
        load_jax_params, save_pytree)

    phase_s = {}
    phase_done = phase_timer(phase_s)
    out = {}
    tree, tmp = ctx["tree"], Path(ctx["tmp_dir"].name)
    # the native decoder builds on host cores while phase 30 trains
    built = {}

    def build():
        try:
            t0 = time.perf_counter()
            native.build_native()
            built["s"] = time.perf_counter() - t0
        except Exception as e:  # reported in phase 31
            built["error"] = e

    native_build = threading.Thread(target=build)
    native_build.start()

    # ---- 30. fold-parallel training ------------------------------------
    fold_dir = ctx["results_dir"] / "fold_data" / str(NUM_FOLDS) / "data"
    models = tmp / "fold_parallel"
    argv = ["--tri", "--noplot", "--seed", "0", "--num-classes",
            str(CLASSES), "-b"] + [str(b) for b in FOLD_BATCHES] + [
            "--epoch", "1", "-o", "adam",
            "momentumsgd", "--lr", "1e-2", "1e-3", "--early-stopping",
            "True", "--bproplen", str(T_TRAIN), "--data-dir",
            f"{tree}/data", "--offset-dir",
            f"{tree}/data", "--target-dir", f"{tree}/data",
            "--train-all-folds", "--fold-data-dir", str(fold_dir),
            "--fold-model-dir", str(models), "--out", str(tmp / "fp_out"),
            "-n", "lstm", "-l", str(LAYERS), "-u", str(H_MAIN),
            "--timedelay", "5", "-d", "0.2", "--device", "cuda"]
    buf = io.StringIO()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fold_params = train_cli.main(argv)
    torch.cuda.synchronize()
    fp_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"[fold-parallel] train_cli log:\n{buf.getvalue()}",
          file=sys.stderr)
    log(f"[fold-parallel] main-path launches: {launches}")
    # updates a stage: every fold's universe (the other folds' frames,
    # each utterance 5 frames longer for --timedelay) over bs x L
    frames = []
    for k in range(NUM_FOLDS):
        off = np.load(fold_dir / f"offsets_{k}.npy")
        frames.append(int(off[-1]) + 5 * (len(off) - 1))
    universe = min(sum(frames) - f for f in frames)
    updates = sum(max(universe // (bs * T_TRAIN), 1) for bs in FOLD_BATCHES)
    want = NUM_FOLDS * LAYERS * updates
    for name in ("lstm_train_forward", "lstm_train_backward",
                 "lstm_train_dw"):
        if launches.get(name, 0) != want:
            fail(f"fold-parallel training launched {name} "
                 f"{launches.get(name, 0)} times, not {NUM_FOLDS} folds x "
                 f"{LAYERS} layers x {updates} updates = {want}")
    if launches.get("lstm_scan", 0) != 2 * NUM_FOLDS * LAYERS:
        fail(f"fold-parallel validation launched lstm_scan "
             f"{launches.get('lstm_scan', 0)} times, not 2 stages x "
             f"{NUM_FOLDS} folds x {LAYERS} layers")
    rows = fold_loss_rows(np, buf.getvalue())
    if [(r[0], r[1]) for r in rows] != [(0, 1), (1, 1)] or not all(
            np.isfinite(r[3]).all() and len(r[3]) == NUM_FOLDS
            for r in rows):
        fail(f"fold-parallel log malformed: {buf.getvalue()}")
    if not (rows[1][3] < rows[0][3]).all():
        fail(f"fold-parallel losses did not fall in every fold: "
             f"{rows[0][3]} -> {rows[1][3]}")
    serving = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                          scan_impl="pallas", device=dev)
    for k in range(NUM_FOLDS):
        serving.load_state_dict(load_jax_params(models / f"fold_{k}.npz",
                                                device=dev))
        if not torch.equal(serving.cells[1].wh, fold_params[k]["cells.1.wh"]):
            fail(f"fold_{k}.npz does not hold fold {k}'s trained params")
    del serving, fold_params
    kernels.reset_launches()
    k_hist, k_params, inits = fold_updates(torch, np, dev, corpus, {})
    for name in ("lstm_train_forward", "lstm_train_backward",
                 "lstm_train_dw"):
        if kernels.launches.get(name, 0) != 3 * NUM_FOLDS * LAYERS:
            fail(f"3 fold-parallel updates launched {name} "
                 f"{kernels.launches.get(name, 0)} times, not 3 x "
                 f"{NUM_FOLDS} folds x {LAYERS} layers")
    before = dict(kernels.launches)
    p_hist, p_params, _ = fold_updates(torch, np, dev, corpus, dict(
        lstm_train_forward=rnn_cuda.lstm_train_forward_reference,
        lstm_train_backward=rnn_cuda.lstm_train_backward_reference))
    if dict(kernels.launches) != before:
        fail("the plain fold-parallel run launched a kernel")
    err = float(np.abs(k_hist / p_hist - 1).max())
    if k_hist.shape != (3, NUM_FOLDS) or not np.isfinite(k_hist).all() \
            or not err <= E2E_LOSS_RTOL:
        fail(f"3 fold-parallel kernel updates {k_hist.tolist()} differ from "
             f"3 plain ones {p_hist.tolist()} (tolerance {E2E_LOSS_RTOL} "
             f"relative)")
    # every parameter of every fold: its change over the 3 updates on the
    # kernels against the plain run's (a dropped dW, or a gradient in
    # another fold's slice, is an error of ~1)
    change_err = [change_errors(inits[k], k_params[k], p_params[k])
                  for k in range(NUM_FOLDS)]
    worst = {name: max(e[name] for e in change_err)
             for name in change_err[0]}
    log(f"[fold-parallel] per-parameter change, kernel against plain, worst "
        f"fold: {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}")
    bad = {name: v for name, v in worst.items() if not v <= E2E_CHANGE_RTOL}
    if bad:
        fail(f"3 fold-parallel kernel updates changed parameters unlike the "
             f"plain ones: {bad} (tolerance {E2E_CHANGE_RTOL} of the plain "
             f"change's largest magnitude)")
    change_max = max(worst.values())
    del k_params, p_params, inits
    log(f"[fold-parallel] train_cli --train-all-folds, LSTM {LAYERS}x{H_MAIN}"
        f" --timedelay 5 -d 0.2, {NUM_FOLDS} folds, stages adam b"
        f"{FOLD_BATCHES[0]} / momentumsgd b{FOLD_BATCHES[1]}: {fp_s:.1f} s "
        f"(phase 28's {NUM_FOLDS} sequential "
        f"fold trainings {ctx['fold_train_s']:.1f} s); {updates} updates x "
        f"{NUM_FOLDS} folds x {LAYERS} layers = {want} training forwards, "
        f"backwards and dW launches; losses {rows[0][3].tolist()} -> "
        f"{rows[1][3].tolist()}; each fold_k.npz loads into the serving net; "
        f"3 updates x {NUM_FOLDS} folds on the kernel within {err:.3e} "
        f"relative of plain (tolerance {E2E_LOSS_RTOL}), every parameter's "
        f"change within {change_max:.3e} of plain's (tolerance "
        f"{E2E_CHANGE_RTOL}) [{card}]")
    out["fold_parallel"] = dict(
        seconds=fp_s, sequential_s=ctx["fold_train_s"], updates=updates,
        launches=launches, losses=[r[3].tolist() for r in rows],
        e2e=dict(kernel=k_hist.tolist(), plain=p_hist.tolist(), err=err,
                 change_err=worst))
    phase_done(30)

    # ---- 31. the native decoder ----------------------------------------
    native_build.join()
    if "error" in built:
        fail(f"the native decoder did not build: {built['error']}")
    offsets = corpus.test.offsets
    image_path = tree / "recog" / "kaldiTri1909.img"
    nat = native.NativeDecoder(str(image_path), pip=20.0, lmw=1.0)
    t0 = time.perf_counter()
    first = nat.decode_one(lp5[offsets[0]:offsets[1]])
    one_s = time.perf_counter() - t0
    if first.segments != results5[0].segments:
        fail("the native decoder's segments of utterance 0 differ from "
             "phase 5's card decode of the same posteriors")
    threads = os.cpu_count() or 1
    n_utts = int(min(NUM_TEST, max(8, NATIVE_BUDGET_S * threads / one_s)))
    # the first n_utts test utterances as a tree of their own
    sub = tmp / "native_tree"
    (sub / "data").mkdir(parents=True)
    (sub / "recog").mkdir()
    ck = ctx["corpus_k"]
    end = int(ck.test.offsets[n_utts])
    np.save(sub / "data" / "data_test.npy", ck.test.data[:end])
    np.save(sub / "data" / "offsets_test.npy", ck.test.offsets[:n_utts + 1])
    (sub / "data" / "test.list").write_text(
        "\n".join(ck.test.utt_names[:n_utts]) + "\n")
    write_mlf(str(sub / "recog" / "test_ref.mlf"),
              ck.ref_mlf["test"][:n_utts])
    save_image(str(sub / "recog" / "kaldiTri1909.img"), img)
    np.save(sub / "recog" / "log_ap_Kaldi1909.npy", ck.log_priors)
    model = sub / "lstm"
    save_pytree(str(model), load_jax_params(numpy_lstm_params(0),
                                            device="cpu"))
    ev = ["-n", "lstm", "-l", str(LAYERS), "-u", str(H_MAIN), "--tri",
          "--num-classes", str(CLASSES), "--model", str(model),
          "--data-dir", f"{sub}/data", "--offset-dir", f"{sub}/data",
          "--utt-list-dir", f"{sub}/data", "--recog-dir", f"{sub}/recog",
          "--device", "cuda"]
    runs = {}
    lm_mlfs = [str(tree / "recog" / f"{s}_ref.mlf") for s in ("train", "dev")]
    for tag, extra, patch in (
            ("native", ["--decoder", "native"], {}),
            ("card", [], {}),
            ("card lm", ["--lm-from-mlf"] + lm_mlfs, {}),
            ("plain lm", ["--lm-from-mlf"] + lm_mlfs, dict(
                collapsed_viterbi_forward=vc.collapsed_viterbi_reference))):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(vc, patch), contextlib.redirect_stdout(io.StringIO()):
            per = evaluate.main(ev + extra + ["--out-mlf",
                                              str(tmp / f"{tag}.mlf")])
        runs[tag] = dict(per=per, seconds=time.perf_counter() - t0,
                         launches=dict(kernels.launches),
                         mlf=(tmp / f"{tag}.mlf").read_text())
    log(f"[native] launches: " + "; ".join(
        f"{t} {r['launches']}" for t, r in runs.items()))
    if runs["native"]["launches"].get("collapsed_viterbi_forward", 0) or \
            runs["native"]["launches"].get("lstm_scan", 0) <= 0:
        fail(f"evaluate --decoder native: launches "
             f"{runs['native']['launches']}: posteriors on the card, no "
             f"card decode")
    if runs["native"]["mlf"] != runs["card"]["mlf"] or \
            runs["native"]["per"] != runs["card"]["per"]:
        fail(f"the native decoder's MLF differs from the card's on "
             f"{n_utts} utterances")
    if runs["card lm"]["launches"].get("collapsed_viterbi_forward", 0) <= 0:
        fail("evaluate --lm-from-mlf did not launch the collapsed Viterbi")
    if runs["plain lm"]["launches"].get("collapsed_viterbi_forward", 0):
        fail("the plain --lm-from-mlf decode launched the Viterbi kernel")
    if runs["card lm"]["mlf"] != runs["plain lm"]["mlf"] or \
            runs["card lm"]["per"] != runs["plain lm"]["per"]:
        fail("--lm-from-mlf: the card decoder's MLF differs from the plain "
             "decode's on the same LM image")
    nat_s = runs["native"]["seconds"]
    log(f"[native] native library built in {built['s']:.1f} s (during phase "
        f"30); one utterance ({offsets[1] - offsets[0]} frames, the "
        f"{img.num_triphones}-triphone image) {one_s:.3f} s on one host "
        f"thread, segments = phase 5's card decode; evaluate --decoder "
        f"native on the first {n_utts} test utterances ({threads} threads) "
        f"{nat_s:.1f} s, MLF and PER ({runs['native']['per']:.2f} %) "
        f"identical to --decoder tpu ({runs['card']['seconds']:.1f} s); "
        f"--lm-from-mlf on the card decoder PER {runs['card lm']['per']:.2f}"
        f" % ({runs['card lm']['seconds']:.1f} s), MLF identical to the "
        f"plain decode [{card}]")
    out["native"] = dict(build_s=built["s"], one_utterance_s=one_s,
                         utterances=n_utts, threads=threads,
                         runs={t: {k: v for k, v in r.items() if k != "mlf"}
                               for t, r in runs.items()})
    phase_done(31)

    # ---- 32. CTC -------------------------------------------------------
    out["ctc"], ctc_entries = ctc_phase(torch, np, dev, card, corpus)
    phase_done(32)
    out["phase_s"] = phase_s
    report["fold_native_ctc"] = out
    return ctc_entries


def ctc_phase(torch, np, dev, card, corpus):
    """Phase 32: CTC on phase 5's 128 training utterances as one padded
    batch. Returns the phase's record and the CTC loss kernels' entries
    of the ``{"kernels": [...]}`` line."""
    import torch.nn.functional as F

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ctc import (
        BiRNNCTC, make_ctc_train_step)
    from nnacousticmodeling_tpu_torch.ops import ctc_cuda, rnn_cuda
    from nnacousticmodeling_tpu_torch.train import make_optimizer

    c = corpus.train
    lengths = c.utt_lengths
    t_max = int(lengths.max())
    xs_np = np.zeros((c.num_utts, t_max, DIM), np.float32)
    for u in range(c.num_utts):
        xs_np[u, :lengths[u]] = c.utt(u)
    labels = [[int(p[1:]) + 1 for _, _, p in segs]
              for _, segs in corpus.ref_mlf["train"]]
    y_lens = np.array([len(v) for v in labels])
    ys_np = np.zeros((c.num_utts, int(y_lens.max())), np.int64)
    for u, v in enumerate(labels):
        ys_np[u, :len(v)] = v
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    plain_rnn = dict(
        lstm_train_forward=rnn_cuda.lstm_train_forward_reference,
        lstm_train_backward=rnn_cuda.lstm_train_backward_reference)
    plain_ctc = dict(ctc_loss_forward=ctc_cuda.ctc_loss_forward_reference,
                     ctc_loss_backward=ctc_cuda.ctc_loss_backward_reference)

    def ctc_model():
        return BiRNNCTC(get_network("lstm", LAYERS, [H_MAIN], 1, in_dim=DIM,
                                    scan_impl="pallas", device=dev, seed=3),
                        PHONES, seed=3)

    def ctc_steps(n, plain=False, cuda_graph=True, profiled=False):
        """n steps from ``ctc_model()``'s init, one generator seed: the
        losses, each step's seconds (host clock, synchronised), the first
        step's gradients (every parameter but the stacks' own unused
        heads), the final params, the run's launch counts and, with
        ``profiled``, the profile of one more (replayed) step."""
        model = ctc_model()
        step = make_ctc_train_step(model, make_optimizer(
            "adam", 1e-3, model.parameters()), cuda_graph=cuda_graph)
        gen = torch.Generator(device=dev).manual_seed(11)
        losses, secs, prof = [], [], None
        kernels.reset_launches()
        with patched(rnn_cuda, plain_rnn if plain else {}), \
                patched(ctc_cuda, plain_ctc if plain else {}):
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(xs, lengths, ys, y_lens, gen))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                if i == 0:
                    grads = {name: q.grad.detach().clone()
                             for name, q in model.named_parameters()
                             if q.grad is not None}
            params = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
            launches = dict(kernels.launches)
            if profiled:
                prof = device_profile(
                    torch, lambda: step(xs, lengths, ys, y_lens, gen))
        del model, step
        return ([float(v) for v in losses], secs, grads, params, launches,
                prof)

    # the main path: CTC_STEPS steps, the first a direct call, the second
    # the capture, the rest graph replays
    k_losses, k_secs, k_grads, k_params, launches, prof = ctc_steps(
        CTC_STEPS, profiled=True)
    log(f"[ctc] main-path launches: {launches}")
    for name in ("lstm_train_forward", "lstm_train_backward",
                 "lstm_train_dw"):
        if launches.get(name, 0) != 2 * LAYERS * CTC_STEPS:
            fail(f"CTC launched {name} {launches.get(name, 0)} times, not 2 "
                 f"directions x {LAYERS} layers x {CTC_STEPS} steps")
    for name in ("ctc_loss_forward", "ctc_loss_backward"):
        if launches.get(name, 0) != CTC_STEPS:
            fail(f"CTC launched {name} {launches.get(name, 0)} times, not "
                 f"once a step ({CTC_STEPS})")
    if not np.isfinite(k_losses).all() or not k_losses[-1] < k_losses[0]:
        fail(f"CTC losses not finite or not falling: {k_losses}")
    # the same steps by direct call: bit-equal
    d_losses, d_secs, _, d_params, d_launches, _ = ctc_steps(
        CTC_STEPS, cuda_graph=False)
    diff = [k for k, v in d_params.items() if not torch.equal(k_params[k], v)]
    if d_losses != k_losses or diff or d_launches != launches:
        fail(f"CTC graph replays differ from direct calls: losses "
             f"{k_losses} vs {d_losses}, params {diff}, launches "
             f"{launches} vs {d_launches}")
    del k_params, d_params
    p_losses, p_secs, p_grads, _, p_launches, _ = ctc_steps(1, plain=True)
    if any(p_launches.values()):
        fail(f"the plain CTC step launched a kernel: {p_launches}")
    ctc_err = abs(k_losses[0] / p_losses[0] - 1)
    if not ctc_err <= E2E_LOSS_RTOL:
        fail(f"CTC first-step loss {k_losses[0]} differs from the plain "
             f"route's {p_losses[0]} (tolerance {E2E_LOSS_RTOL} relative)")
    # the first step's gradients of both directions, every layer: the 8
    # training backwards and dW launches and the CTC loss kernels against
    # their plain versions
    g_err = grad_errors(k_grads, p_grads)
    log(f"[ctc] first-step gradients, kernel against plain: "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in g_err.items()})}")
    bad = {name: v for name, v in g_err.items() if not v <= CTC_GRAD_RTOL}
    if bad:
        fail(f"CTC first-step gradients on the kernels differ from plain: "
             f"{bad} (tolerance {CTC_GRAD_RTOL} of the plain gradient's "
             f"largest magnitude)")
    g_max = max(g_err.values())
    del k_grads, p_grads
    graph_ms = 1e3 * float(np.mean(k_secs[2:]))
    direct_ms = 1e3 * float(np.mean(d_secs[1:]))
    capture_ms = 1e3 * k_secs[1]
    wall_ms, busy_ms, top = prof
    log(f"[ctc] BiRNNCTC over LSTM {LAYERS}x{H_MAIN}, {PHONES} phones + "
        f"blank, {c.num_utts} utterances padded to T={t_max} ({int(
            lengths.sum())} frames, labels {int(y_lens.min())}-"
        f"{int(y_lens.max())}): {CTC_STEPS} Adam steps, losses "
        f"{[round(v, 4) for v in k_losses]} bit-equal to {CTC_STEPS} direct "
        f"calls' (and the params); step times: graph "
        f"{[round(v * 1e3, 1) for v in k_secs]} ms, direct "
        f"{[round(v * 1e3, 1) for v in d_secs]} ms (plain "
        f"{p_secs[0] * 1e3:.1f} ms); first-step loss within {ctc_err:.3e} "
        f"relative of plain (tolerance {E2E_LOSS_RTOL}), its gradients within "
        f"{g_max:.3e} of plain's largest (tolerance {CTC_GRAD_RTOL}); "
        f"{2 * LAYERS} training forwards, backwards and dW and one CTC loss "
        f"forward and backward a step [{card}]")
    log(f"[ctc] ms a step: graph replay {graph_ms:.2f}, direct call "
        f"{direct_ms:.2f}; the capture step (capture + replay) "
        f"{capture_ms:.1f}; one replayed step profiled: {wall_ms:.1f} ms "
        f"wall, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} "
        f"%); top: " + "; ".join(f"{k[:50]} {v:.2f} ms"
                                 for k, v in list(top.items())[:6])
        + f" [{card}]")
    record = dict(losses=k_losses, step_s=k_secs, direct_step_s=d_secs,
                  plain_loss=p_losses[0], plain_step_s=p_secs[0],
                  err=ctc_err, grad_err=g_err, launches=launches,
                  t_max=t_max, graph_ms=graph_ms, direct_ms=direct_ms,
                  capture_ms=capture_ms, profile_wall_ms=wall_ms,
                  device_ms=busy_ms, top_device_ms=top)
    record["shapes"] = ctc_shapes_check(torch, np, dev, card, ctc_model,
                                        (xs, lengths, ys, y_lens))
    record["loss_kernels"], entries = ctc_loss_check(
        torch, np, F, ctc_cuda, dev, card, ctc_model, xs, lengths, ys, y_lens,
        launches)
    return record, entries


# Six (T, S) shapes of phase 32's batch (its first T frames and S label
# positions), largest first, stepped by one step function in an
# interleaved order: each shape's first call is direct, its second
# captures, its third (after every capture) replays. The graphs of one
# step function share a memory pool, so what they reserve stays within
# CTC_POOL_RATIO of the largest shape's own (with a pool a graph, it grew
# by about one pool a shape; bench_ctc_step.py measures both).
CTC_SHAPES = {"A": (470, 50), "B": (440, 48), "C": (410, 46),
              "D": (380, 44), "E": (350, 42), "F": (320, 40)}
CTC_ORDER = "ABACBDCEDFEFABCDEF"
CTC_POOL_RATIO = 1.25


def ctc_shape_steps(torch, np, dev, ctc_model, batch, order,
                    cuda_graph=True, on_capture=None):
    """``make_ctc_train_step`` from ``ctc_model()``'s init, one generator
    seed, through ``order`` (keys of CTC_SHAPES) on ``batch`` (xs, frame
    lengths, labels, label lengths) cut to each shape: the losses, the
    final params and the bytes reserved after each shape's second call
    (its capture), over what was reserved before the model was made;
    each is also passed to ``on_capture(key, bytes)`` as it is read."""
    import gc

    from nnacousticmodeling_tpu_torch.models.ctc import make_ctc_train_step
    from nnacousticmodeling_tpu_torch.train import make_optimizer
    xs, lengths, ys, y_lens = batch
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    model = ctc_model()
    step = make_ctc_train_step(model, make_optimizer(
        "adam", 1e-3, model.parameters()), cuda_graph=cuda_graph)
    gen = torch.Generator(device=dev).manual_seed(13)
    losses, reserved, calls = [], [], {}
    for key in order:
        t, s = CTC_SHAPES[key]
        losses.append(step(xs[:, :t], np.minimum(lengths, t), ys[:, :s],
                           np.minimum(y_lens, s), gen))
        calls[key] = calls.get(key, 0) + 1
        if calls[key] == 2:
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(dev) - base)
            if on_capture is not None:
                on_capture(key, reserved[-1])
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, step
    return [float(v) for v in losses], params, reserved


def ctc_shapes_check(torch, np, dev, card, ctc_model, batch):
    """Phase 32's multi-shape check: the largest shape alone (direct,
    capture, replay), then CTC_ORDER by graph and by direct call: the
    reserved memory after all six captures within CTC_POOL_RATIO of the
    largest shape's alone, losses and params bit-equal to the direct
    calls'."""
    _, _, alone = ctc_shape_steps(torch, np, dev, ctc_model, batch, "AAA")
    g_losses, g_params, reserved = ctc_shape_steps(torch, np, dev, ctc_model,
                                                   batch, CTC_ORDER)
    d_losses, d_params, _ = ctc_shape_steps(torch, np, dev, ctc_model, batch,
                                            CTC_ORDER, cuda_graph=False)
    gb = [r / 1e9 for r in reserved]
    ratio = reserved[-1] / alone[-1]
    diff = [k for k, v in d_params.items() if not torch.equal(g_params[k], v)]
    log(f"[ctc shapes] {len(CTC_SHAPES)} (T, S) shapes "
        f"{list(CTC_SHAPES.values())} in the order {CTC_ORDER}: reserved GB "
        f"after each new shape's capture {[round(v, 3) for v in gb]}, the "
        f"largest shape alone {alone[-1] / 1e9:.3f} GB (ratio {ratio:.3f}, "
        f"limit {CTC_POOL_RATIO}); {len(g_losses)} losses and the params "
        f"bit-equal to direct calls: {g_losses == d_losses and not diff} "
        f"[{card}]")
    if not np.isfinite(g_losses).all():
        fail(f"[ctc shapes] losses not finite: {g_losses}")
    if g_losses != d_losses or diff:
        fail(f"[ctc shapes] graph replays in the interleaved order differ "
             f"from direct calls: losses {g_losses} vs {d_losses}, params "
             f"{diff}")
    if not ratio <= CTC_POOL_RATIO:
        fail(f"[ctc shapes] the six shapes' graphs reserve {gb[-1]:.3f} GB, "
             f"{ratio:.3f}x the largest shape's {alone[-1] / 1e9:.3f} GB "
             f"(limit {CTC_POOL_RATIO}x)")
    return dict(order=CTC_ORDER, shapes=CTC_SHAPES, reserved_gb=gb,
                alone_gb=alone[-1] / 1e9, ratio=ratio, losses=g_losses)


def ctc_loss_check(torch, np, F, ctc_cuda, dev, card, ctc_model, xs, lengths,
                   ys, y_lens, launches):
    """The CTC loss kernels' two routes on phase 32's log-probabilities
    (the model's inference logits, B=128, T=470, 48 phones + blank, S=50:
    the main path's warp route) and on a copy whose first utterance
    cannot fit its labels: the warp route bit-equal to the block route
    (loss, the valid frames' states, gradient), each route against the
    plain twins (loss within CTC_LOSS_RTOL, gradient (the batch mean's)
    within CTC_LOSS_GRAD_RTOL of the plain gradient's largest magnitude),
    all finite, two runs of each bit-equal; then a long-label case (S =
    CTC_LONG_S, which only the block route takes) against the twins.
    Times each route, the twins and ``F.ctc_loss``'s forward and backward
    (the library yardstick, on the feasible batch only: it gives inf
    where optax gives its large loss)."""
    lens = torch.as_tensor(lengths, device=dev).long()
    ylens = torch.as_tensor(y_lens, device=dev).long()
    model = ctc_model()
    with torch.no_grad():
        logp = torch.log_softmax(
            model.apply_sequence(xs, lengths=lens).float(), dim=-1)
    del model
    B, T, C = logp.shape
    S = ys.shape[1]
    if ctc_cuda.ctc_route(S, C) != "warp":
        fail(f"[ctc loss] S={S}, C={C} does not take the warp route")
    cut = lens.clone()
    cut[0] = int(y_lens[0]) // 2                # cannot fit its labels
    grad = torch.full((B,), 1.0 / B, device=dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    res = {}
    for tag, xl in (("feasible", lens), ("infeasible", cut)):
        want, want_states = ctc_cuda.ctc_loss_forward_reference(
            logp, ys, xl, ylens)
        want_g = ctc_cuda.ctc_loss_backward_reference(
            logp, ys, xl, ylens, want_states, grad)
        g_scale = float(want_g.abs().max())
        runs = {}
        for route in (None, "block"):
            runs[route] = []
            for _ in range(2):
                loss, states = ctc_cuda.ctc_loss_forward(logp, ys, xl, ylens,
                                                         route=route)
                runs[route].append((loss, states, ctc_cuda.ctc_loss_backward(
                    logp, ys, xl, ylens, states, grad, route=route)))
        torch.cuda.synchronize()
        ok = valid & (torch.arange(T, device=dev)[None, :] < xl[:, None])
        (loss, states, g), (b_loss, b_states, b_g) = (runs[None][0],
                                                      runs["block"][0])
        if not (torch.equal(loss, b_loss) and torch.equal(g, b_g)
                and torch.equal(states[ok], b_states[ok])):
            fail(f"[ctc loss {tag}] the warp route differs from the block "
                 f"route: loss {float((loss - b_loss).abs().max()):.3e}, "
                 f"gradient {float((g - b_g).abs().max()):.3e}")
        r = res[tag] = {}
        for route, name in ((None, "warp"), ("block", "block")):
            loss, _, g = runs[route][0]
            loss_err = float(((loss - want).abs() / want.abs()).max())
            g_abs = float((g - want_g).abs().max())
            r[name] = dict(loss_rel_err=loss_err,
                           loss_abs_err=float((loss - want).abs().max()),
                           grad_abs_err=g_abs, grad_err=g_abs / g_scale)
            if not (bool(torch.isfinite(loss).all())
                    and bool(torch.isfinite(g).all())):
                fail(f"[ctc loss {tag} {name}] the kernels' loss or "
                     f"gradient is not finite")
            if not loss_err <= CTC_LOSS_RTOL or not g_abs / g_scale <= \
                    CTC_LOSS_GRAD_RTOL:
                fail(f"[ctc loss {tag} {name}] kernel against plain: loss "
                     f"{loss_err:.3e} relative (tolerance {CTC_LOSS_RTOL}), "
                     f"gradient {g_abs / g_scale:.3e} of plain's largest "
                     f"(tolerance {CTC_LOSS_GRAD_RTOL})")
            if not (torch.equal(runs[route][1][0], loss)
                    and torch.equal(runs[route][1][2], g)):
                fail(f"[ctc loss {tag} {name}] two kernel runs differ")
        r["loss0"], r["plain_loss0"] = float(runs[None][0][0][0]), float(
            want[0])
        if tag == "infeasible" and not r["loss0"] > 1e4:
            fail(f"[ctc loss] the cut utterance's loss {r['loss0']} is not "
                 f"optax's large finite value")
        del want_states, runs
    long_res = ctc_long_labels_check(torch, np, ctc_cuda, dev, logp)
    lab32 = ys.to(torch.int32)
    lens32, ylens32 = lens.to(torch.int32), ylens.to(torch.int32)
    _, states = ctc_cuda.ctc_loss_forward(logp, lab32, lens32, ylens32)
    times = {}
    for route, name in ((None, "warp"), ("block", "block")):
        def fwd():
            return ctc_cuda.ctc_loss_forward(logp, lab32, lens32, ylens32,
                                             route=route)

        def bwd():
            return ctc_cuda.ctc_loss_backward(logp, lab32, lens32, ylens32,
                                              states, grad, route=route)
        times[name] = dict(fwd_ms=cuda_ms(torch, fwd, 20),
                           bwd_ms=cuda_ms(torch, bwd, 20))
    plain_fwd_ms = cuda_ms(torch, lambda: ctc_cuda.ctc_loss_forward_reference(
        logp, ys, lens, ylens), 2)
    plain_bwd_ms = cuda_ms(torch, lambda: ctc_cuda.ctc_loss_backward_reference(
        logp, ys, lens, ylens, states, grad), 2)
    # the library: F.ctc_loss on the (T, B, C) view, host lengths
    lp_leaf = logp.detach().requires_grad_(True)
    x_list, y_list = [int(v) for v in lengths], [int(v) for v in y_lens]

    def lib_forward():
        return F.ctc_loss(lp_leaf.transpose(0, 1), ys, x_list, y_list,
                          blank=0, reduction="none", zero_infinity=False)

    lib_out = lib_forward()
    lib_fwd_ms = cuda_ms(torch, lib_forward, 20)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        lib_out, lp_leaf, grad, retain_graph=True), 20)
    del lib_out, lp_leaf
    # bounds: the valid frames' log-probability rows read once; each
    # row's own lattice (2 L + 1 states a valid frame) written by the
    # forward and read by the backward; the gradient written whole
    frames = np.minimum(lengths, T)
    lattice = int(np.sum(frames * (2 * y_lens + 1)))
    small = 4 * (B * S + 3 * B)                 # labels, lengths, loss
    fwd_bytes = 4 * (int(frames.sum()) * C + lattice) + small
    bwd_bytes = 4 * (int(frames.sum()) * C + lattice + B * T * C) + small
    positions = int(np.sum(frames * (y_lens + 1)))
    fwd_bound, fwd_by = bound(fwd_bytes, CTC_FWD_OPS * positions, F32_FLOPS)
    bwd_bound, bwd_by = bound(bwd_bytes, CTC_BWD_OPS * positions, F32_FLOPS)
    t_max = int(frames.max())               # frames of the longest chain
    log(f"[ctc loss] kernels on phase 32's log-probabilities (B={B}, T={T}, "
        f"C={C}, S={S}): the warp route bit-equal to the block route (loss, "
        f"states, gradient; feasible and infeasible); against plain: "
        + "; ".join(f"{tag}: loss within {r['warp']['loss_rel_err']:.3e} "
                    f"relative, gradient within {r['warp']['grad_err']:.3e} "
                    f"(block {r['block']['grad_err']:.3e}) of plain's "
                    f"largest" for tag, r in res.items())
        + f"; the cut utterance's loss {res['infeasible']['loss0']:.3f} "
        f"(plain {res['infeasible']['plain_loss0']:.3f}); two runs of each "
        f"bit-equal; S={long_res['S']} on the block route: loss within "
        f"{long_res['loss_rel_err']:.3e}, gradient {long_res['grad_err']:.3e}"
        f" [{card}]")
    for kind, lib_ms, plain_ms, b_ms, by in (
            ("fwd", lib_fwd_ms, plain_fwd_ms, fwd_bound, fwd_by),
            ("bwd", lib_bwd_ms, plain_bwd_ms, bwd_bound, bwd_by)):
        per = {name: times[name][f"{kind}_ms"] for name in ("warp", "block")}
        log(f"[ctc loss] {kind}: "
            + ", ".join(f"{name} {ms:.4f} ms ({1e3 * ms / t_max:.3f} us a "
                        f"frame)" for name, ms in per.items())
            + f", F.ctc_loss {lib_ms:.4f}, plain {plain_ms:.1f}, bound "
            f"{b_ms * 1e3:.2f} us ({by}) [{card}]")
    src = "nnacousticmodeling_tpu_torch/csrc/ctc_loss.cu"
    replaces = ("nnacousticmodeling_tpu/models/ctc.py:92 (optax.ctc_loss, "
                "a lax.scan, no pallas_call)")
    entries = []
    for name, key in (("warp", ""), ("block", ".block")):
        for kind, err, tol, ms, plain_ms, b_ms, by, lib_ms in (
                ("forward", "loss_abs_err", CTC_LOSS_RTOL,
                 times[name]["fwd_ms"], plain_fwd_ms, fwd_bound, fwd_by,
                 lib_fwd_ms),
                ("backward", "grad_abs_err", CTC_LOSS_GRAD_RTOL,
                 times[name]["bwd_ms"], plain_bwd_ms, bwd_bound, bwd_by,
                 lib_bwd_ms)):
            kname = f"ctc_loss_{kind}{key}"
            entries.append(
                {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches.get(kname, 0),
                 "max_abs_err": max(r[name][err] for r in res.values()),
                 "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms})
    record = dict(res, times=times, long_labels=long_res,
                  plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                  lib_fwd_ms=lib_fwd_ms, lib_bwd_ms=lib_bwd_ms,
                  fwd_bound_ms=fwd_bound, bwd_bound_ms=bwd_bound, frames=t_max)
    return record, entries


CTC_LONG_S = 300          # label positions past the warp route's 255


def ctc_long_labels_check(torch, np, ctc_cuda, dev, logp):
    """The block route on label rows only it takes: 8 of phase 32's
    utterances (their first 400 frames), 300 seeded labels each (label
    lengths 150-300, so some cannot fit), against the plain twins."""
    rng = np.random.default_rng(32)
    b, t, S = 8, 400, CTC_LONG_S
    lp = logp[:b, :t].contiguous()
    C = lp.shape[2]
    labels = torch.from_numpy(rng.integers(1, C, (b, S))).to(dev)
    x_lens = torch.full((b,), t, dtype=torch.int64, device=dev)
    y_lens = torch.from_numpy(rng.integers(S // 2, S + 1, b)).to(dev)
    grad = torch.full((b,), 1.0 / b, device=dev)
    if ctc_cuda.ctc_route(S, C) != "block":
        fail(f"[ctc loss] S={S} does not take the block route")
    want, want_states = ctc_cuda.ctc_loss_forward_reference(
        lp, labels, x_lens, y_lens)
    want_g = ctc_cuda.ctc_loss_backward_reference(
        lp, labels, x_lens, y_lens, want_states, grad)
    loss, states = ctc_cuda.ctc_loss_forward(lp, labels, x_lens, y_lens)
    g = ctc_cuda.ctc_loss_backward(lp, labels, x_lens, y_lens, states, grad)
    torch.cuda.synchronize()
    out = dict(S=S, loss_rel_err=float(((loss - want).abs()
                                         / want.abs()).max()),
               grad_err=float((g - want_g).abs().max()
                              / want_g.abs().max()))
    if not (bool(torch.isfinite(loss).all())
            and bool(torch.isfinite(g).all())
            and out["loss_rel_err"] <= CTC_LOSS_RTOL
            and out["grad_err"] <= CTC_LOSS_GRAD_RTOL):
        fail(f"[ctc loss S={S}] the block route against plain: {out} "
             f"(tolerances {CTC_LOSS_RTOL}, {CTC_LOSS_GRAD_RTOL})")
    return out


# ---------------------------------------------------------------------------
# phases 33-35: parallelism across ranks, NCCL, profiling
# ---------------------------------------------------------------------------

RANKS = 2                          # gloo ranks time-sharing the one card
RANK_TIMEOUT_S = 300               # the rank launch, children killed after
FOLDS_34 = 4
ENS_UTTS = 16                      # test utterances of phase 34's ensemble
FUSED_ROUNDS = 6                   # phase 36's pipelined rounds (bench.py's)
MAX_DECODE_OPS = 32                # device operations of one decode call
# PipelinedMLP against the single-device MLP. Its logits, each
# microbatch's float32 products (TF32 off), are held within PIPE_RTOL of
# the full-batch MLP's largest logit (cuBLAS may sum another row count's
# products in another order). Its gradients are held within PIPE_RTOL of
# the largest of the single-device MLP's run on the same 4 microbatches
# (the hops move values, they add no arithmetic; only the order in which
# the microbatches' dW accumulate may differ). Against the full-batch
# gradients no tight gate holds: in this 8-layer relu stack a relu that
# flips on a last-bit difference moves a hidden layer's float32
# gradient by up to ~1e-2 of its largest, as far as the full-batch
# float32 gradient itself lies from a float64 twin (both logged).
PIPE_RTOL = 1e-4
TRAIN_KERNELS = ("lstm_train_forward", "lstm_train_backward",
                 "lstm_train_dw")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase33_argv(tree):
    """Phase 9's training slice, 1 epoch."""
    return ["-n", "lstm", "-l", str(LAYERS), "-u", str(H_MAIN),
            "--num-classes", str(CLASSES), "-b", str(B_MAIN), "--bproplen",
            str(T_TRAIN), "-o", "momentumsgd", "--lr", "0.01",
            "--early-stopping", "false", "--noplot", "-e", "1",
            "--data-dir", f"{tree}/data", "--offset-dir", f"{tree}/data",
            "--target-dir", f"{tree}/data"]


def fold34_data(np, tree):
    """FOLDS_34 pseudo-utterances of phase 5's training frames, one a
    fold, so every fold's universe holds B x L frames (phase 30's
    layout): an epoch is one update."""
    per = -(-B_MAIN * T_TRAIN // (FOLDS_34 - 1))
    n = FOLDS_34 * per
    x = np.load(f"{tree}/data/data_train.npy")[:n]
    y = np.load(f"{tree}/data/targets_train.npy")[:n]
    return x, y, np.arange(0, n + 1, per), np.arange(FOLDS_34)


def rank_worker(rank, work):
    """One of RANKS processes of phases 33-35 (``chip_smoke.py
    --rank-worker RANK DIR``): a gloo rank on the card. Rank 0 writes
    ``ranks.json``; nothing is printed as a result line."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.func import functional_call

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.infer.posteriors import (
        ensemble_log_posteriors)
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ensemble import (
        Ensemble, stack_fold_params)
    from nnacousticmodeling_tpu_torch.parallel import (
        make_mesh, make_sharded_ensemble_forward, param_shardings, sync)
    from nnacousticmodeling_tpu_torch.parallel.comm import all_reduce_
    from nnacousticmodeling_tpu_torch.parallel.pipeline import PipelinedMLP
    from nnacousticmodeling_tpu_torch.pipeline import train_cli
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, load_jax_params, train_network)
    from nnacousticmodeling_tpu_torch.train.fold_parallel import (
        train_folds_parallel)

    meta = json.loads((work / "meta.json").read_text())
    tree = meta["tree"]
    dev = torch.device("cuda", 0)
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # ---- 33a. train_cli --mesh data=2 at phase 9's spec ----------------
    kernels.reset_launches()
    res, s = timed(lambda: train_cli.main(phase33_argv(tree) + [
        "--mesh", f"data={RANKS}", "--coordinator",
        f"localhost:{meta['port']}", "--num-processes", str(RANKS),
        "--process-id", str(rank), "--out", str(work / "m33")]))
    out["33a"] = dict(s=s, launches=dict(kernels.launches),
                      history=res.history)

    # ---- 33b. one FF update, hidden layers column-parallel -------------
    ff = np.load(work / "ff.npz")
    x_ff, y_ff = ff["x"], ff["y"]
    init = load_jax_params(numpy_mlp_params(33, x_ff.shape[1]), device=dev)

    def ff_net(dropout):
        return get_network("ff", FF_LAYERS, [FF_UNITS], CLASSES, "relu",
                           dropout=[dropout], in_dim=x_ff.shape[1],
                           device=dev)

    def ff_cfg(mesh):
        return TrainConfig(
            stages=[TrainStage(1, "momentumsgd", FF_BATCH, 0.01, False)],
            seed=0, log=None, use_validation=False, mesh=mesh,
            model_axis="model" if mesh is not None else None)

    mesh = make_mesh({"data": 1, "model": RANKS}, device=dev)
    net = ff_net(0.2)
    specs = param_shardings(mesh, net.state_dict(), "model")
    tp, s = timed(lambda: train_network(net, x_ff, y_ff, ff_cfg(mesh),
                                        init_params=init, device=dev))
    out["33b"] = dict(s=s, loss=tp.history[0]["main/loss"],
                      sharded=sorted(k for k, v in specs.items() if v))
    if rank == 0:
        single, s1 = timed(lambda: train_network(
            ff_net(0.2), x_ff, y_ff, ff_cfg(None), init_params=init,
            device=dev))
        # the same update in float64: the engine's row order (seed 0's
        # permutation) and dropout masks (a generator seeded 0), one
        # momentumsgd step (-lr * g)
        net64 = ff_net(0.2).double()
        q = {k: v.double().requires_grad_(True) for k, v in init.items()}
        rows = np.random.default_rng(0).permutation(len(x_ff))[:FF_BATCH]
        logits = functional_call(
            net64, q, (torch.from_numpy(x_ff[rows]).to(dev).double(),),
            {"train": True,
             "generator": torch.Generator(device=dev).manual_seed(0)})
        F.cross_entropy(logits, torch.from_numpy(y_ff[rows]).to(dev).long()
                        ).backward()
        want64 = {k: v.detach() - 0.01 * v.grad for k, v in q.items()}
        out["33b"].update(single_loss=single.history[0]["main/loss"],
                          single_s=s1, change_err=change_errors(
                              init, tp.params, single.params),
                          single_vs_f64=change_errors(init, single.params,
                                                      want64),
                          tp_vs_f64=change_errors(init, tp.params, want64))
        del net64, q, logits, want64
    del net, tp
    sync()

    # ---- 34. fold-sharded training and ensemble ------------------------
    x, y, offsets, utt_folds = fold34_data(np, tree)
    inits = [load_jax_params(numpy_lstm_params(20 + k), device=dev)
             for k in range(FOLDS_34)]
    full = functools.partial(np.array2string, precision=9,
                             max_line_width=10 ** 6)

    def folds(mesh):
        logs = []
        cfg = TrainConfig(
            stages=[TrainStage(3, "momentumsgd", B_MAIN, 0.01, False)],
            bprop_len=T_TRAIN, seed=0, log=logs.append,
            use_validation=False)
        net = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                          scan_impl="pallas", device=dev)
        with mock.patch.object(np, "array2string",
                               lambda a, precision=None: full(a)):
            params = train_folds_parallel(
                net, x, y, offsets, utt_folds, FOLDS_34, cfg,
                init_params=inits, device=dev, mesh=mesh)
        rows = [(r[2], r[3].tolist()) for r in
                fold_loss_rows(np, "\n".join(logs))]
        return net, params, rows

    fold_mesh = make_mesh({"fold": RANKS}, device=dev)
    kernels.reset_launches()
    (net, params, rows), s = timed(lambda: folds(fold_mesh))
    out["34"] = dict(s=s, launches=dict(kernels.launches))
    every = [None] * RANKS
    dist.all_gather_object(every, rows)
    if rank == 0:
        # the K folds' losses a row, in fold order, from the two ranks
        got = np.concatenate([np.array([r[1] for r in rk]) for rk in every],
                             axis=1)
        (_, p_single, rows_1), s1 = timed(lambda: folds(None))
        want = np.array([r[1] for r in rows_1])
        out["34"].update(
            losses=got.tolist(), single_losses=want.tolist(), single_s=s1,
            loss_err=float(np.max(np.abs(got - want) / np.abs(want))),
            change_err=[change_errors(inits[k], params[k], p_single[k])
                        for k in range(FOLDS_34)])
        del p_single

    ens = Ensemble(network=net, num_folds=FOLDS_34)
    shard_folds, forward = make_sharded_ensemble_forward(ens, fold_mesh)
    stacked = stack_fold_params(params)
    local = shard_folds(stacked)

    class Sharded:
        device = dev

        def apply_sequence(self, xs, state=None):
            return forward({"master": None, "folds": local, "rpl": None},
                           xs), None

    xt = np.load(f"{tree}/data/data_test.npy")
    off = np.load(f"{tree}/data/offsets_test.npy")[:ENS_UTTS + 1]
    xt = xt[:off[-1]]
    ap = np.load(f"{tree}/recog/log_priors.npy")
    kernels.reset_launches()
    lp_s, s = timed(lambda: rnn_log_posteriors(Sharded(), xt, off, ap=ap,
                                               batch=B_MAIN))
    out["34b"] = dict(s=s, launches=dict(kernels.launches))
    if rank == 0:
        lp_1, s1 = timed(lambda: ensemble_log_posteriors(
            ens, {"master": None, "folds": stacked, "rpl": None}, xt, off,
            ap=ap, batch=B_MAIN))
        out["34b"].update(single_s=s1,
                          err=float(np.abs(lp_s - lp_1).max()))
        np.save(work / "lp_sharded.npy", lp_s)
        np.save(work / "lp_single.npy", lp_1)
    del net, params, stacked, local, ens
    sync()

    # ---- 35. PipelinedMLP over FF 8x2048 -------------------------------
    stage_mesh = make_mesh({"stage": RANKS}, device=dev)
    net = ff_net(0.0)
    p0 = load_jax_params(numpy_mlp_params(35, x_ff.shape[1]), device=dev)
    xt = torch.from_numpy(x_ff).to(dev)
    yt = torch.from_numpy(y_ff).to(dev).long()
    pipe = PipelinedMLP(net, stage_mesh, num_micro=4)

    def pipelined():
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        logits = pipe.apply(p, xt)
        F.cross_entropy(logits, yt).backward()
        return logits.detach(), p

    pipelined()                                   # warm-up
    (logits, p), s = timed(pipelined)
    grads = {k: all_reduce_(v.grad if v.grad is not None
                            else torch.zeros_like(v), stage_mesh, "stage")
             for k, v in p.items()}
    out["35"] = dict(ms=s * 1e3, layers=pipe.stage_layers(rank))
    if rank == 0:
        def plain(micro=1, dtype=torch.float32):
            q = {k: v.to(dtype).clone().requires_grad_(True)
                 for k, v in p0.items()}
            m = FF_BATCH // micro
            ref = torch.cat([functional_call(
                net, q, (xt[i * m:(i + 1) * m].to(dtype),))
                for i in range(micro)])
            F.cross_entropy(ref, yt).backward()
            return ref.detach(), {k: v.grad for k, v in q.items()}

        def rel(a, b):
            return {k: float((a[k].double() - b[k].double()).abs().max()
                             / b[k].double().abs().max()) for k in b}

        plain()
        (ref, g1), s1 = timed(plain)
        _, g4 = plain(4)
        _, g64 = plain(1, torch.float64)
        out["35"].update(
            plain_ms=s1 * 1e3,
            logits_err=float((logits - ref).abs().max()
                             / ref.abs().max()),
            grad_err=rel(grads, g4), grad_vs_full=rel(grads, g1),
            full_vs_f64=rel(g1, g64))
    every = [None] * RANKS
    dist.all_gather_object(every, {k: out[k].get("launches", {})
                                   for k in ("33a", "33b", "34", "34b")})
    out["rank_launches"] = every
    sync()
    if rank == 0:
        (work / "ranks.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def parallel_phases(torch, np, dev, card, corpus, dec, report):
    """Phases 33-35: data and tensor parallel training, fold-sharded
    training and ensemble, the pipeline (RANKS gloo ranks time-sharing
    the card, one launch of this script's worker mode), a one-rank NCCL
    world and ``utils.profiling.trace``. Returns the ranks' launches of
    the LSTM kernels for the ``{"kernels": [...]}`` line."""
    import torch.distributed as dist

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.corpus_decode import (
        decode_corpus)
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops.splice import splice_flat
    from nnacousticmodeling_tpu_torch.parallel import (
        initialize_distributed, make_mesh, sync)
    from nnacousticmodeling_tpu_torch.pipeline import train_cli
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, load_jax_params, train_network)
    from nnacousticmodeling_tpu_torch.utils.profiling import trace
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        write_corpus_tree)

    phase_s = {}
    phase_done = phase_timer(phase_s)
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_")
    work = Path(tmp.name)
    tree = work / "tree"
    write_corpus_tree(corpus, str(tree))
    x_ff = splice_flat(corpus.train.data, range(-FF_SPLICE, FF_SPLICE + 1)
                       )[:FF_BATCH]
    y_ff = corpus.train.targets[:FF_BATCH]
    np.savez(work / "ff.npz", x=x_ff, y=y_ff)
    (work / "meta.json").write_text(json.dumps(dict(port=free_port(),
                                                    tree=str(tree))))

    # ---- the ranks: 33a, 33b, 34 and 35's pipeline in one launch -------
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank-worker",
         str(r), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        fail(f"the {RANKS} ranks of phases 33-35 ran out of their "
             f"{RANK_TIMEOUT_S} s")
    ranks_s = time.perf_counter() - t0
    for r, text in enumerate(logs):
        print(f"[ranks] rank {r} output:\n{text[-6000:]}", file=sys.stderr)
    rcs = [p.returncode for p in procs]
    if rcs != [0] * RANKS:
        fail(f"phases 33-35: the ranks exited {rcs}; rank output tails: "
             + " | ".join(t[-1500:] for t in logs))
    res = json.loads((work / "ranks.json").read_text())
    backends = [f"rank {r} of {RANKS}, backend gloo" in t
                for r, t in enumerate(logs)]
    if not all(backends):
        fail(f"the ranks did not all report the gloo backend: {backends}")
    log(f"[ranks] {RANKS} gloo ranks on one card ran phases 33-35's "
        f"multi-rank parts in {ranks_s:.1f} s (each rank: 33a "
        f"{res['33a']['s']:.1f} s, 33b {res['33b']['s']:.1f} s, 34 "
        f"{res['34']['s']:.1f} s + ensemble {res['34b']['s']:.1f} s, 35 "
        f"pipeline {res['35']['ms']:.1f} ms; time-shared ranks, no "
        f"scaling figure) [{card}]")

    # ---- 33a. data-parallel training against the single-process run ----
    la = res["33a"]["launches"]
    n_train = int(corpus.train.data.shape[0])
    updates = n_train // (B_MAIN * T_TRAIN)
    for name in TRAIN_KERNELS:
        if la.get(name, 0) != updates * LAYERS:
            fail(f"phase 33: rank 0 launched {name} {la.get(name, 0)} "
                 f"times, not {updates} updates x {LAYERS} layers")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    single = train_cli.main(phase33_argv(tree) + ["--out",
                                                  str(work / "s33")])
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t1
    before = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                         scan_impl="pallas", device=dev, seed=0).state_dict()
    got = load_jax_params(str(work / "m33" / "model.npz"), device=dev)
    want = single.params
    h_got, h_want = res["33a"]["history"][0], single.history[0]
    loss_err = max(abs(h_got[k] - h_want[k]) / abs(h_want[k])
                   for k in ("main/loss", "validation/main/loss"))
    ch = change_errors(before, got, want)
    if not (loss_err <= E2E_LOSS_RTOL
            and max(ch.values()) <= E2E_CHANGE_RTOL):
        fail(f"phase 33: --mesh data={RANKS} differs from the single run: "
             f"losses {h_got} vs {h_want} (tolerance {E2E_LOSS_RTOL} "
             f"relative), changes {ch} (tolerance {E2E_CHANGE_RTOL})")
    log(f"[33 data-parallel] train_cli --mesh data={RANKS}, LSTM "
        f"{LAYERS}x{H_MAIN} -> {CLASSES}, TBPTT b{B_MAIN} L{T_TRAIN} "
        f"({B_MAIN // RANKS} rows a rank), 1 epoch of {updates} updates: "
        f"rank 0 launched " + ", ".join(f"{n} {la[n]}" for n in
                                        TRAIN_KERNELS)
        + f", lstm_scan {la.get('lstm_scan', 0)}; loss "
        f"{h_got['main/loss']:.6f} (val {h_got['validation/main/loss']:.6f})"
        f" against the single run's {h_want['main/loss']:.6f} (val "
        f"{h_want['validation/main/loss']:.6f}): {loss_err:.3e} relative "
        f"(tolerance {E2E_LOSS_RTOL}); every leaf's change within "
        f"{max(ch.values()):.3e} of the single run's largest (tolerance "
        f"{E2E_CHANGE_RTOL}); ranks {res['33a']['s']:.1f} s, single "
        f"{single_s:.1f} s [{card}]")
    del before, got, want, single

    # ---- 33b. one column-parallel FF update ----------------------------
    b = res["33b"]
    hidden = sorted(f"hidden.{i}.{leaf}" for i in range(FF_LAYERS)
                    for leaf in ("w", "b"))
    if b["sharded"] != hidden:
        fail(f"phase 33: the column-parallel leaves are {b['sharded']}, "
             f"not the hidden layers' {hidden}")
    ff_err = abs(b["loss"] - b["single_loss"]) / abs(b["single_loss"])
    ff_ch = max(b["change_err"].values())
    f64 = (max(b["single_vs_f64"].values()), max(b["tp_vs_f64"].values()))
    if not (ff_err <= E2E_LOSS_RTOL and ff_ch <= E2E_CHANGE_RTOL):
        fail(f"phase 33: the --mesh data=1,model={RANKS} FF update differs "
             f"from the single update: loss {b['loss']} vs "
             f"{b['single_loss']}, changes {b['change_err']}")
    log(f"[33 tensor-parallel] FF {FF_LAYERS}x{FF_UNITS} relu -> {CLASSES}"
        f" -d 0.2, one update of b{FF_BATCH} at data=1,model={RANKS}: the "
        f"{FF_LAYERS} hidden layers column-parallel (out replicated: "
        f"{CLASSES} does not divide), loss {b['loss']:.6f} against "
        f"{b['single_loss']:.6f} ({ff_err:.3e} relative), every leaf's "
        f"change within {ff_ch:.3e} of the single update's largest (the "
        f"float64 update: single {f64[0]:.3e}, tensor-parallel "
        f"{f64[1]:.3e}); {b['s']:.2f} s on the ranks, {b['single_s']:.2f} "
        f"s alone [{card}]")
    phase_done(33)

    # ---- 34. fold-sharded training and ensemble -------------------------
    f34 = res["34"]
    per_rank = FOLDS_34 // RANKS
    for r, counts in enumerate(res["rank_launches"]):
        for name in TRAIN_KERNELS:
            if counts["34"].get(name, 0) != 3 * per_rank * LAYERS:
                fail(f"phase 34: rank {r} launched {name} "
                     f"{counts['34'].get(name, 0)} times, not 3 updates x "
                     f"{per_rank} folds x {LAYERS} layers")
    worst = max(max(c.values()) for c in f34["change_err"])
    if not (np.isfinite(f34["losses"]).all()
            and np.array(f34["losses"]).shape == (3, FOLDS_34)
            and f34["loss_err"] <= E2E_LOSS_RTOL
            and worst <= E2E_CHANGE_RTOL):
        fail(f"phase 34: fold=2 training differs from the single run: "
             f"losses {f34['losses']} vs {f34['single_losses']} "
             f"(tolerance {E2E_LOSS_RTOL}), worst change {worst} "
             f"(tolerance {E2E_CHANGE_RTOL})")
    log(f"[34 fold-sharded] train_folds_parallel, {FOLDS_34} LSTM "
        f"{LAYERS}x{H_MAIN} folds at fold={RANKS} ({per_rank} a rank), 3 "
        f"updates on the kernels: per-fold losses within "
        f"{f34['loss_err']:.3e} relative of the single 4-fold run "
        f"(tolerance {E2E_LOSS_RTOL}), every parameter's change within "
        f"{worst:.3e} (tolerance {E2E_CHANGE_RTOL}); each rank launched "
        f"the three training kernels {3 * per_rank * LAYERS} times; ranks "
        f"{f34['s']:.1f} s, single {f34['single_s']:.1f} s [{card}]")
    e = res["34b"]
    scans = [c["34b"].get("lstm_scan", 0) for c in res["rank_launches"]]
    if e["err"] > POSTERIOR_ATOL or min(scans) <= 0 or scans[0] % (
            per_rank * LAYERS):
        fail(f"phase 34: sharded ensemble posteriors within {e['err']} "
             f"(tolerance {POSTERIOR_ATOL}), lstm_scan launches {scans}")
    off = corpus.test.offsets[:ENS_UTTS + 1]
    lp_s = np.load(work / "lp_sharded.npy")
    lp_1 = np.load(work / "lp_single.npy")
    seg_s = decode_corpus(dec, lp_s, off, batch=B_MAIN)
    seg_1 = decode_corpus(dec, lp_1, off, batch=B_MAIN)
    same = sum(a.segments == b.segments for a, b in zip(seg_s, seg_1))
    if same != ENS_UTTS or not all(r.segments for r in seg_s):
        fail(f"phase 34: the sharded ensemble's decode differs in "
             f"{ENS_UTTS - same} of {ENS_UTTS} utterances")
    log(f"[34 ensemble] make_sharded_ensemble_forward at fold={RANKS} over "
        f"those {FOLDS_34} nets, {ENS_UTTS} test utterances: posteriors "
        f"within {e['err']:.3e} of the single-process Ensemble (tolerance "
        f"{POSTERIOR_ATOL}), Viterbi segments of all {same} identical; "
        f"lstm_scan launches a rank {scans}; ranks {e['s']:.2f} s, single "
        f"{e['single_s']:.2f} s [{card}]")
    phase_done(34)

    # ---- 35. pipeline, NCCL, profiling ----------------------------------
    pp = res["35"]
    g_worst = max(pp["grad_err"].values())
    g_full = max(pp["grad_vs_full"].values())
    g_f64 = max(pp["full_vs_f64"].values())
    if not (pp["logits_err"] <= PIPE_RTOL and g_worst <= PIPE_RTOL):
        fail(f"phase 35: PipelinedMLP differs from the MLP: logits "
             f"{pp['logits_err']}, gradients {pp['grad_err']} (tolerance "
             f"{PIPE_RTOL} of max)")
    log(f"[35 pipeline] PipelinedMLP FF {FF_LAYERS}x{FF_UNITS} -> {CLASSES}"
        f", stage={RANKS}, 4 microbatches of {FF_BATCH // 4} (stage 0 "
        f"layers {pp['layers']}, host-staged gloo hops): logits within "
        f"{pp['logits_err']:.3e} of the MLP's largest, every gradient "
        f"within {g_worst:.3e} of the largest of the MLP's on the same "
        f"microbatches (tolerance {PIPE_RTOL}; of the full batch's "
        f"{g_full:.3e}, which lies {g_f64:.3e} from a float64 twin); "
        f"forward+backward {pp['ms']:.1f} ms on time-shared ranks, "
        f"{pp['plain_ms']:.1f} ms on one [{card}]")

    # a one-rank NCCL world: one data=1 update equals the plain one
    backend = initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                     device="cuda")
    try:
        if backend != "nccl":
            fail(f"a one-rank world on the card picked {backend}, not nccl")
        ones = torch.ones(4, device=dev)
        dist.all_reduce(ones)
        sync("nccl")
        init = load_jax_params(numpy_mlp_params(36, x_ff.shape[1]),
                               device=dev)
        runs = []
        for mesh in (make_mesh({"data": 1}), None):
            net = get_network("ff", FF_LAYERS, [FF_UNITS], CLASSES,
                              in_dim=x_ff.shape[1], device=dev)
            cfg = TrainConfig(
                stages=[TrainStage(1, "momentumsgd", FF_BATCH, 0.01, False)],
                log=None, use_validation=False, mesh=mesh)
            runs.append(train_network(net, x_ff, y_ff, cfg,
                                      init_params=init, device=dev).params)
    finally:
        dist.destroy_process_group()
    if not (torch.equal(ones, torch.ones_like(ones)) and all(
            torch.equal(runs[0][k], runs[1][k]) for k in runs[1])):
        fail("phase 35: the one-rank NCCL world's data=1 update differs "
             "from the plain update")
    log("[35 nccl] initialize_distributed picked nccl for a one-rank world "
        "on the card; an all-reduce, a barrier and one data=1 FF update "
        "(params broadcast from rank 0 over NCCL) equal to the plain update "
        "bit for bit")

    # utils.profiling.trace around one phase-5 serving batch
    net = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device=dev)
    net.load_state_dict(load_jax_params(numpy_lstm_params(0), device=dev))
    off = corpus.test.offsets[:33]
    x5 = corpus.test.data[:off[-1]]
    rnn_log_posteriors(net, x5, off, ap=corpus.log_priors, batch=B_MAIN)
    # the profiler now and then drops a session's device events (see
    # profiled_calls): up to three sessions, each into its own directory
    for attempt in range(3):
        tdir = work / f"trace{attempt}"
        with trace(str(tdir)):
            rnn_log_posteriors(net, x5, off, ap=corpus.log_priors,
                               batch=B_MAIN)
            torch.cuda.synchronize()
        files = sorted(tdir.glob("*.pt.trace.json"))
        events = (json.loads(files[0].read_text())["traceEvents"]
                  if files else [])
        scan_events = [e for e in events if e.get("cat") == "kernel"
                       and "lstm_scan" in str(e.get("name"))]
        if scan_events:
            break
    if not scan_events:
        fail(f"phase 35: the trace ({[f.name for f in files]}) names no "
             f"lstm_scan kernel")
    log(f"[35 profiling] utils.profiling.trace around one serving batch "
        f"(32 utterances), session {attempt + 1}: {files[0].name}, "
        f"{files[0].stat().st_size} "
        f"bytes, {len(scan_events)} lstm_scan kernel events "
        f"({scan_events[0]['name'][:50]}) [{card}]")
    phase_done(35)
    tmp.cleanup()
    out.update(ranks=res, ranks_s=ranks_s, phase_s=phase_s,
               single33_s=single_s)
    report["parallel"] = out
    return {name: {"phase33_rank0": res["33a"]["launches"].get(name, 0),
                   "phase34_ranks": sum(c["34"].get(name, 0)
                                        for c in res["rank_launches"]),
                   "phase34_ensemble_ranks": sum(
                       c["34b"].get(name, 0) for c in res["rank_launches"])}
            for name in TRAIN_KERNELS + ("lstm_scan",)}


def fused_phase(torch, np, dev, card, net, dec, corpus, lp5, results5, per5,
                tput5, report):
    """Phase 36: the fused serving path on phase 5's ``net``, ``dec`` and
    test set (``lp5``/``results5``/``per5``/``tput5``: its posteriors,
    decode, PER and audio-s/s). Returns the launches of the first f32
    call, the path's run for the ``{"kernels": [...]}`` line."""
    import traceback

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    from nnacousticmodeling_tpu_torch.io import load_mlf, write_mlf
    from nnacousticmodeling_tpu_torch.models.precision import (
        HalfPrecisionNet)
    from nnacousticmodeling_tpu_torch.ops.numerics import log_softmax

    phase_s = {}
    phase_done = phase_timer(phase_s)
    offsets = corpus.test.offsets
    lengths = np.diff(offsets)
    audio_s = float(lengths.sum()) / 100.0
    if len(lengths) != B_MAIN or lengths.max() > T_MAIN:
        fail(f"phase 36 needs {B_MAIN} test utterances of at most {T_MAIN} "
             f"frames, got {len(lengths)} of at most {lengths.max()}")
    # one padded batch, as rnn_log_posteriors padded phase 5's (one
    # T_MAIN bucket of B_MAIN rows); made outside every timed window
    xs = np.zeros((B_MAIN, T_MAIN, DIM), np.float32)
    for u in range(B_MAIN):
        xs[u, :lengths[u]] = corpus.test.data[offsets[u]:offsets[u + 1]]
    x_dev = torch.from_numpy(xs).to(dev)
    lens_dev = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    ap_dev = torch.from_numpy(np.asarray(corpus.log_priors, np.float32)
                              ).to(dev)
    decode = dec.decode_arrays_fn()
    nets = {"f32": net, "bf16": HalfPrecisionNet(net)}

    def program(model):
        with torch.inference_mode():
            y, _ = model.apply_sequence(x_dev)
            lp = log_softmax(y - ap_dev, dim=-1)
            return lp, decode(lp, lens_dev)

    def results_of(d, out):
        return d._to_results(out[0].cpu().numpy(), out[1].cpu().numpy())

    def segments_differ(got, want):
        return sum(a.segments != b.segments for a, b in zip(got, want))

    # ---- (a) f32: phase 5's posteriors, segments and PER; (b) ---------
    kernels.reset_launches()
    lp32, out32 = program(net)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"[fused] main-path launches: {launches}")
    if (launches.get("lstm_scan", 0) != LAYERS
            or launches.get("collapsed_viterbi_forward", 0) != 1
            or launches.get("collapsed_viterbi_forward.global", 0)
            or launches.get("viterbi_backtrace", 0) != 1):
        fail(f"the fused program launched {launches}: not lstm_scan once a "
             f"layer, the collapsed Viterbi once on its cluster route and "
             f"the backtrace once")
    lp32_host = lp32.cpu().numpy()
    post_diff = max(float(np.abs(lp32_host[u, :n] - lp5[o:o + n]).max())
                    for u, (o, n) in enumerate(zip(offsets, lengths)))
    if not post_diff <= POSTERIOR_ATOL:
        fail(f"fused f32 posteriors differ from phase 5's by {post_diff} "
             f"(tolerance {POSTERIOR_ATOL})")
    res32 = results_of(dec, out32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fused_") as tmp:
        ref_path = Path(tmp, "test_ref.mlf")
        write_mlf(str(ref_path), corpus.ref_mlf["test"])
        per32 = per_of(corpus, res32, Path(tmp, "fused.mlf"),
                       load_mlf(str(ref_path)))
    diff = segments_differ(res32, results5)
    if diff or per32 != per5:
        fail(f"the fused f32 decode differs from phase 5's: {diff} "
             f"utterances, PER {per32} vs {per5}")
    batch32 = dec.decode_batch(lp32_host, lengths)
    diff = segments_differ(res32, batch32)
    if diff:
        fail(f"decode_arrays_fn differs from decode_batch on the fused f32 "
             f"posteriors in {diff} utterances")
    log(f"[fused] f32: posteriors within {post_diff:.3e} of phase 5's "
        f"(tolerance {POSTERIOR_ATOL}); segments of all {B_MAIN} utterances "
        f"and PER ({per32:.2f} %) identical to phase 5's and to "
        f"decode_batch's")

    # bf16 through HalfPrecisionNet; the parity flag as bench.py:324-330
    lp16, out16 = program(nets["bf16"])
    batch16 = dec.decode_batch(lp16, lengths)
    diff = segments_differ(results_of(dec, out16), batch16)
    if diff:
        fail(f"decode_arrays_fn differs from decode_batch on the fused bf16 "
             f"posteriors in {diff} utterances")
    bf16_parity = segments_differ(batch32, batch16) == 0
    bf16_diff = float((lp16 - lp32).abs().amax())
    log(f"[fused] bf16: decode_arrays_fn = decode_batch; bf16 decoded-"
        f"segment parity {bf16_parity} ({segments_differ(batch32, batch16)} "
        f"utterances differ from f32), posteriors {bf16_diff:.3e} from f32 "
        f"(a record, not a gate)")
    firsts = {"f32": out32, "bf16": out16}
    del lp32, lp16, lp32_host, batch16

    # ---- (c) pipelined rounds with no synchronising call ---------------
    rounds = {}
    for tag, model in nets.items():
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            torch.cuda.set_sync_debug_mode("error")
            for _ in range(FUSED_ROUNDS):
                outs.append(program(model)[1])
        except RuntimeError as e:
            traceback.print_exc()
            fail(f"the fused {tag} program made a synchronising call: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FUSED_ROUNDS
        first = firsts[tag]
        if not all(torch.equal(o[0], first[0]) and torch.equal(o[1], first[1])
                   for o in outs):
            fail(f"a pipelined {tag} round gave other segments than its "
                 f"first call")
        rounds[tag] = dict(round_ms=ms, audio_s_per_s=audio_s / ms * 1e3)
    log(f"[fused] {FUSED_ROUNDS} pipelined rounds each under "
        f"set_sync_debug_mode('error'), no synchronising call: " + "; ".join(
            f"{k} {v['round_ms']:.1f} ms a round, {v['audio_s_per_s']:.1f} "
            f"audio-s/s" for k, v in rounds.items())
        + f" ({audio_s:.2f} audio-s a round); phase 5's host-copy path "
        f"{tput5:.1f} audio-s/s [{card}]")

    # ---- (d) the profiled repeat: no copy between host and device ------
    wall_ms, busy_ms, top, counts = device_profile(
        torch, lambda: program(net), launches_of=(
            "lstm_scan", "collapsed_viterbi_cluster",
            "collapsed_viterbi_kernel", "viterbi_backtrace_kernel",
            "Memcpy DtoH", "Memcpy HtoD", ""))
    log_profile("fused profile", wall_ms, busy_ms, top, card)
    if counts["Memcpy DtoH"] or counts["Memcpy HtoD"]:
        fail(f"the fused program copied between host and device: {counts}")
    if counts["lstm_scan"] != LAYERS:
        fail(f"the fused program ran {counts['lstm_scan']} lstm_scan device "
             f"kernels, not one a layer ({LAYERS})")
    if (counts["collapsed_viterbi_cluster"] != 1
            or counts["collapsed_viterbi_kernel"]
            or counts["viterbi_backtrace_kernel"] != 1):
        fail(f"the fused program's decoder device kernels: {counts}, not "
             f"one collapsed_viterbi_cluster_kernel alone and one "
             f"viterbi_backtrace_kernel")
    # one decode_arrays_fn call alone: one launch of each decoder kernel,
    # at most MAX_DECODE_OPS device operations, and how long the host
    # takes to queue them
    lp_dec = program(net)[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    decode(lp_dec, lens_dev)
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t0) * 1e3
    dec_launches = dict(kernels.launches)
    if dec_launches != {"collapsed_viterbi_forward": 1,
                        "collapsed_viterbi_forward.registers": 1,
                        "viterbi_backtrace": 1}:
        fail(f"one decode_arrays_fn call launched {dec_launches}, not the "
             f"collapsed Viterbi (its register route) and the backtrace "
             f"once each")
    dec_wall, dec_busy, dec_top, dec_counts = device_profile(
        torch, lambda: decode(lp_dec, lens_dev),
        launches_of=("", "collapsed_viterbi_cluster",
                     "viterbi_backtrace_kernel"))
    if dec_counts[""] > MAX_DECODE_OPS:
        fail(f"one decode_arrays_fn call is {dec_counts['']} device "
             f"operations, more than {MAX_DECODE_OPS}")
    log(f"[fused] profiled repeat: no Memcpy DtoH / HtoD, {counts['']} "
        f"device operations, lstm_scan {counts['lstm_scan']} kernels, "
        f"collapsed_viterbi_cluster_kernel 1, viterbi_backtrace_kernel 1; "
        f"one decode_arrays_fn call alone (T={T_MAIN}): launches "
        f"{dec_launches}, {dec_counts['']} device operations (at most "
        f"{MAX_DECODE_OPS}; {dec_counts['collapsed_viterbi_cluster']} "
        f"Viterbi kernel, {dec_counts['viterbi_backtrace_kernel']} "
        f"backtrace kernel), {dec_busy:.3f} ms device busy, queued in "
        f"{queued_ms:.3f} ms, done after {done_ms:.3f} ms [{card}]")
    log_profile("decode_arrays_fn profile", dec_wall, dec_busy, dec_top,
                card)
    del lp_dec

    # ---- (e) decode_fn: the scan kernel and the backtrace ---------------
    lp32, _ = program(net)
    lp32_host = lp32.cpu().numpy()
    torch.cuda.synchronize()
    kernels.reset_launches()
    res_twin = results_of(dec, dec.decode_fn()(lp32, lens_dev))
    fn_launches = dict(kernels.launches)
    if fn_launches != {"viterbi_scan_forward": 1, "viterbi_backtrace": 1}:
        fail(f"one decode_fn call launched {fn_launches}, not the scan "
             f"kernel and the backtrace once each")
    diff = segments_differ(res_twin, results5)
    if diff:
        fail(f"decode_fn (the scan kernel on the tied cube) differs from "
             f"phase 5's segments in {diff} utterances")
    untied = make_synthetic_image(num_phones=PHONES, num_states=CLASSES)
    dec_x = ViterbiDecoder(untied, pip=20.0, lmw=1.0, backend="xla",
                           device=dev)
    res_u = results_of(dec_x, dec_x.decode_fn()(lp32, lens_dev))
    want_u = dec_x.decode_batch(lp32_host, lengths)
    diff = segments_differ(res_u, want_u)
    if diff or not all(r.segments for r in res_u):
        fail(f"decode_fn on the untied image differs from decode_batch "
             f"(backend='xla') in {diff} utterances")
    # one decode_fn call alone, as (d) timed decode_arrays_fn's
    fn = dec.decode_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(lp32, lens_dev)
    fn_queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    fn_done_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(3):      # a session now and then loses a long kernel
        fn_wall, fn_busy, fn_top, fn_counts = device_profile(
            torch, lambda: fn(lp32, lens_dev), launches_of=(
                "", "viterbi_scan_cluster_kernel", "viterbi_scan_kernel",
                "viterbi_backtrace_kernel"))
        if fn_counts["viterbi_scan_cluster_kernel"] == 1:
            break
    if (fn_counts[""] > MAX_DECODE_OPS
            or fn_counts["viterbi_scan_cluster_kernel"] != 1
            or fn_counts["viterbi_scan_kernel"]
            or fn_counts["viterbi_backtrace_kernel"] != 1):
        fail(f"one decode_fn call ran {fn_counts}: more than "
             f"{MAX_DECODE_OPS} device operations, or not one scan kernel "
             f"on its cluster route and one backtrace kernel")
    log(f"[fused] decode_fn: launches {fn_launches}; phase 5's segments on "
        f"the tied image, decode_batch's (backend='xla') on phase 23's "
        f"untied image; one call (T={T_MAIN}) {fn_counts['']} device "
        f"operations (decode_arrays_fn {dec_counts['']}), {fn_busy:.3f} ms "
        f"device busy (decode_arrays_fn {dec_busy:.3f}), queued in "
        f"{fn_queued_ms:.3f} ms, done after {fn_done_ms:.3f} ms "
        f"(decode_arrays_fn {queued_ms:.3f} / {done_ms:.3f}) [{card}]")
    log_profile("decode_fn profile", fn_wall, fn_busy, fn_top, card)
    del lp32, lp32_host
    phase_done(36)
    report["fused"] = dict(
        posterior_diff=post_diff, per=per32, bf16_parity=bf16_parity,
        bf16_posterior_diff=bf16_diff, rounds=rounds,
        phase5_audio_s_per_s=tput5, launches=launches,
        profile=dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     top_device_ms=top, counts=counts),
        decode_call=dict(device_ops=dec_counts[""], device_busy_ms=dec_busy,
                         launches=dec_launches,
                         viterbi_kernels=dec_counts[
                             "collapsed_viterbi_cluster"],
                         backtrace_kernels=dec_counts[
                             "viterbi_backtrace_kernel"],
                         top_device_ms=dec_top, profiled_wall_ms=dec_wall,
                         queued_ms=queued_ms, done_ms=done_ms),
        decode_fn_call=dict(device_ops=fn_counts[""], device_busy_ms=fn_busy,
                            launches=fn_launches, top_device_ms=fn_top,
                            profiled_wall_ms=fn_wall, queued_ms=fn_queued_ms,
                            done_ms=fn_done_ms),
        seconds=phase_s[36])
    return launches


GRAPH_STEPS = 3      # phase 37: updates an epoch, three epochs a run


def graph_run(torch, dev, net_of, x, y, bs, dtype, cuda_graph, profiled):
    """Three epochs of GRAPH_STEPS updates of the net ``net_of()``
    (momentum SGD lr 1e-2, no validation, seed 0) through
    ``train_network``, the updates captured as a CUDA graph or
    (``cuda_graph`` false) direct calls; cuDNN deterministic, so that two
    runs give the same bits. Epoch 2 is timed; with ``profiled`` epoch 3
    runs under the profiler, from the hook after epoch 2 to the hook
    after it. Returns the result, the launch counts, the capture ms and
    the profile (wall ms, busy ms, top device ops, cudaGraphLaunch
    calls) or None."""
    from torch.profiler import ProfilerActivity, profile

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, engine, train_network)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = []

    def hook(stage, epoch):
        if profiled and epoch >= 2:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            (prof.start if epoch == 2 else prof.stop)()

    capture_ms = []
    real_capture = engine._capture_update

    def timed_capture(step, generator):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_capture(step, generator)
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t) * 1e3)
        return out

    cfg = TrainConfig(
        stages=[TrainStage(epoch=3, optimizer="momentumsgd", batch_size=bs,
                           lr=0.01, early_stopping=False)],
        bprop_len=T_TRAIN, seed=0, log=None, use_validation=False,
        compute_dtype=dtype, epoch_hook=hook)
    net = net_of()
    kernels.reset_launches()
    with mock.patch.object(engine, "_capture_update", timed_capture), \
            torch.backends.cudnn.flags(deterministic=True):
        result = train_network(net, x, y, cfg, device=dev,
                               cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    prof_out = None
    if profiled:
        wall_ms = (marks[1] - marks[0]) * 1e3
        busy_ms, top = device_time(prof)
        replays = sum(ev.count for ev in prof.key_averages()
                      if ev.key == "cudaGraphLaunch")
        prof_out = (wall_ms, busy_ms, top, replays)
    return result, dict(kernels.launches), capture_ms, prof_out


def graph_phase(torch, np, dev, card, corpus, report):
    """Phase 37: each training update as one CUDA graph replay against
    the direct call (``train_network(..., cuda_graph=False)``) at full
    width, for the nets of phases 9, 14, 19, 20 and 27: LSTM 4x1024 ->
    1909 in float32 and bf16 (dropout 0.2), the GRU (dropout 0.2), the
    PeepholeLSTM and the ZoneoutLSTM in the SPECOM configuration (``-d
    0.2``: zoneout c 0.2, h 0.5) at TBPTT b128 L20 on the first
    GRAPH_STEPS x 128 x 20 training frames; the MLP 8x2048 relu -> 1909
    f32 and bf16 (b1024, spliced +-5, dropout 0.2) and the TDNN 5 5 9 9 x
    1024 (b256, dropout 0.2). Each net three epochs of GRAPH_STEPS
    updates from one seed and init, by graph and by direct call (cuDNN
    deterministic in both, so the TDNN's times are not phase 27's).
    Gates: params and history bit-equal, the same kernel launch counts,
    every loss finite, one ``cudaGraphLaunch`` an update in the graph
    run's profiled third epoch. Logged: each run's ms per update (epoch
    2, unprofiled), the capture ms of the stage, the busy share of the
    profiled epoch and its device ms an update against the unprofiled
    graph update."""
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops.splice import splice_flat

    def recurrent(name, dropout):
        n = GRAPH_STEPS * B_MAIN * T_TRAIN
        x, y = corpus.train.data[:n], corpus.train.targets[:n]

        def net_of():
            return get_network(name, LAYERS, [H_MAIN], CLASSES,
                               dropout=dropout, in_dim=DIM,
                               scan_impl="pallas", device=dev)
        return net_of, x, y, B_MAIN

    def feed_forward(name, units, splice, bs, **kw):
        n = GRAPH_STEPS * bs
        x = splice_flat(corpus.train.data, range(-splice, splice + 1))[:n]

        def net_of():
            return get_network(name, len(units), units, CLASSES, "relu",
                               dropout=[0.2], in_dim=x.shape[1], device=dev,
                               **kw)
        return net_of, x, corpus.train.targets[:n], bs

    tdnn_splice = (sum(TDNN_KSIZE) - len(TDNN_KSIZE)) // 2
    cases = [
        ("LSTM f32", "float32", recurrent("lstm", [0.2])),
        ("LSTM bf16", "bfloat16", recurrent("lstm", [0.2])),
        ("GRU", "float32", recurrent("gru", [0.2])),
        ("PeepholeLSTM", "float32", recurrent("peepholelstm", [0.0])),
        ("ZoneoutLSTM SPECOM", "float32", recurrent("zoneoutlstm", [0.2])),
        ("FF 8x2048 f32", "float32",
         feed_forward("ff", [FF_UNITS] * FF_LAYERS, FF_SPLICE, FF_BATCH)),
        ("FF 8x2048 bf16", "bfloat16",
         feed_forward("ff", [FF_UNITS] * FF_LAYERS, FF_SPLICE, FF_BATCH)),
        ("TDNN", "float32",
         feed_forward("tdnn", [TDNN_UNITS] * len(TDNN_KSIZE), tdnn_splice,
                      TDNN_BATCH, tdnn_ksize=TDNN_KSIZE)),
    ]
    out = {}
    for tag, dtype, (net_of, x, y, bs) in cases:
        got, got_launches, capture_ms, prof = graph_run(
            torch, dev, net_of, x, y, bs, dtype, True, True)
        want, want_launches, direct_captures, _ = graph_run(
            torch, dev, net_of, x, y, bs, dtype, False, False)
        losses = [h["main/loss"] for h in got.history]
        if (not np.isfinite(losses).all() or len(capture_ms) != 1
                or direct_captures):
            fail(f"[graph {tag}] losses {losses}, captures {capture_ms} "
                 f"(graph run), {direct_captures} (direct run)")
        diff = [k for k, v in want.params.items()
                if not torch.equal(got.params[k], v)]
        hist_diff = [(hg, hw) for hg, hw in zip(got.history, want.history)
                     if any(hg[k] != hw[k] for k in hw
                            if k != "elapsed_time")]
        if diff or hist_diff or got_launches != want_launches:
            fail(f"[graph {tag}] the graph run differs from the direct "
                 f"calls: params {diff}, history {hist_diff}, launches "
                 f"{got_launches} vs {want_launches}")
        wall_ms, busy_ms, top, replays = prof
        if replays != GRAPH_STEPS:
            fail(f"[graph {tag}] the profiled epoch made {replays} graph "
                 f"launches, not one an update ({GRAPH_STEPS})")
        ms = {k: r.history[1]["elapsed_time"] / GRAPH_STEPS * 1e3
              for k, r in (("graph", got), ("direct", want))}
        # the profiler slows the replays down: the device ms of an update
        # (profiled epoch) over the unprofiled epoch's ms per update too
        dev_ms = busy_ms / GRAPH_STEPS
        out[tag] = dict(graph_ms=ms["graph"], direct_ms=ms["direct"],
                        capture_ms=capture_ms[0], profile_wall_ms=wall_ms,
                        profile_busy_ms=busy_ms, device_ms_per_update=dev_ms,
                        top_device_ms=top, launches=got_launches,
                        losses=losses)
        log(f"[graph {tag}] {GRAPH_STEPS} x 3 updates: params, history and "
            f"launches {got_launches} bit-equal to the direct calls'; ms per "
            f"update (epoch 2): graph {ms['graph']:.2f}, direct "
            f"{ms['direct']:.2f}; capture {capture_ms[0]:.1f} ms; profiled "
            f"epoch 3: {replays} cudaGraphLaunch, {wall_ms:.1f} ms wall, "
            f"device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %), {dev_ms:.2f} ms device an "
            f"update = {100 * dev_ms / ms['graph']:.1f} % of the unprofiled "
            f"graph update [{card}]")
    report["graph"] = out


FOLD_GRAPH_STEPS = 3     # phase 38: updates an epoch, three epochs a run


def graph_nodes(graph):
    """The node count of a captured ``torch.cuda.CUDAGraph`` built with
    ``keep_graph=True`` (``libcuda``'s ``cuGraphGetNodes``), or None where
    this torch or ``libcuda`` does not expose it."""
    import ctypes
    try:
        n = ctypes.c_size_t(0)
        rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None
    return int(n.value) if rc == 0 else None


def fold_graph_run(torch, np, dev, net_of, x, y, offsets, bs, cuda_graph,
                   profiled):
    """Three epochs of FOLD_GRAPH_STEPS updates of NUM_FOLDS folds of the
    net ``net_of()`` through ``train_folds_parallel`` (momentum SGD lr
    1e-2, no validation, seed 0: the same K inits in every run), fold k
    the k-th utterance of ``offsets``, the updates captured as a CUDA
    graph or (``cuda_graph`` false) direct calls. Epoch 2 is timed from
    epoch 1's log line to its own (each comes after the epoch's losses
    reached the host); with ``profiled`` epoch 3 runs under the profiler.
    Returns the logged per-fold losses (full precision), the K param
    maps, the launch counts, the captures' ms (instantiation included)
    and node counts, epoch 2's ms and the profile (busy ms, top device
    ops, cudaGraphLaunch calls) or None."""
    from torch.profiler import ProfilerActivity, profile

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, engine)
    from nnacousticmodeling_tpu_torch.train.fold_parallel import (
        train_folds_parallel)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    lines, marks = [], []

    def on_line(msg):
        lines.append(msg)
        if FOLD_LINE.search(msg):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if profiled and len(marks) in (2, 3):
                (prof.start if len(marks) == 2 else prof.stop)()

    capture_ms, nodes = [], []
    real_capture = engine._capture_update
    kept = functools.partial(torch.cuda.CUDAGraph, keep_graph=True)

    def timed_capture(step, generator):
        # the graph kept for its node count, instantiated here as
        # capture_end does without keep_graph
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mock.patch.object(torch.cuda, "CUDAGraph", kept):
            graph, launched = real_capture(step, generator)
        graph.instantiate()
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t) * 1e3)
        nodes.append(graph_nodes(graph))
        return graph, launched

    cfg = TrainConfig(
        stages=[TrainStage(epoch=3, optimizer="momentumsgd", batch_size=bs,
                           lr=0.01, early_stopping=False)],
        bprop_len=T_TRAIN, seed=0, log=on_line, use_validation=False)
    full = functools.partial(np.array2string, precision=9,
                             max_line_width=10 ** 6)
    kernels.reset_launches()
    with mock.patch.object(engine, "_capture_update", timed_capture), \
            mock.patch.object(np, "array2string",
                              lambda a, precision=None: full(a)):
        params = train_folds_parallel(
            net_of(), x, y, offsets, np.arange(NUM_FOLDS), NUM_FOLDS, cfg,
            device=dev, cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    prof_out = None
    if profiled:
        busy_ms, top = device_time(prof)
        replays = sum(ev.count for ev in prof.key_averages()
                      if ev.key == "cudaGraphLaunch")
        prof_out = (busy_ms, top, replays)
    losses = [m.group(4) for m in FOLD_LINE.finditer("\n".join(lines))]
    return (losses, params, dict(kernels.launches), (capture_ms, nodes),
            (marks[1] - marks[0]) * 1e3, prof_out)


def fold_graph_phase(torch, np, dev, card, corpus, report):
    """Phase 38: each fold-parallel update as one CUDA graph replay
    against the direct call (``train_folds_parallel(...,
    cuda_graph=False)``) at full width, NUM_FOLDS folds: the LSTM 4x1024
    -> 1909 at the master's spec (dropout 0.2, ``--timedelay 5``
    through ``apply_time_delay``) and the ZoneoutLSTM of phase 20 (``-d
    0.2``) at TBPTT b128 L20, fold k training on the other folds'
    pseudo-utterances of FOLD_GRAPH_STEPS x 128 x 20 / (NUM_FOLDS - 1)
    frames of the training set, so that an epoch is FOLD_GRAPH_STEPS
    updates; the FF 8x2048 relu -> 1909 of phase 27 (b1024, spliced +-5,
    dropout 0.2) likewise. Each net three epochs by graph and by direct
    call from one seed. Gates: every fold's logged losses, the params
    and the kernel launch counts bit-equal, every loss finite, one
    capture in the graph run and none in the direct run, one
    ``cudaGraphLaunch`` an update in the graph run's profiled third
    epoch, the LSTM training kernels launched FOLD_GRAPH_STEPS x 3 x
    NUM_FOLDS x LAYERS times. Logged: each run's ms per update (epoch 2),
    the capture ms and the graph's node count, the device ms of an update
    (profiled epoch), and phase 30's ``--train-all-folds`` seconds."""
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops.splice import splice_flat
    from nnacousticmodeling_tpu_torch.ops.timedelay import apply_time_delay

    def folds_of(x, y, bs, frames_a_step):
        per = FOLD_GRAPH_STEPS * bs * frames_a_step // (NUM_FOLDS - 1)
        n = NUM_FOLDS * per
        return x[:n], y[:n], np.arange(0, n + 1, per)

    def recurrent(name, timedelay):
        x, y, offsets = folds_of(corpus.train.data, corpus.train.targets,
                                 B_MAIN, T_TRAIN)
        x, y, offsets = apply_time_delay(x, y, offsets, timedelay)

        def net_of():
            return get_network(name, LAYERS, [H_MAIN], CLASSES,
                               dropout=[0.2], in_dim=DIM,
                               scan_impl="pallas", device=dev)
        return net_of, x, y, offsets, B_MAIN

    def feed_forward():
        x, y, offsets = folds_of(
            splice_flat(corpus.train.data, range(-FF_SPLICE, FF_SPLICE + 1)),
            corpus.train.targets, FF_BATCH, 1)

        def net_of():
            return get_network("ff", FF_LAYERS, [FF_UNITS] * FF_LAYERS,
                               CLASSES, "relu", dropout=[0.2],
                               in_dim=x.shape[1], device=dev)
        return net_of, x, y, offsets, FF_BATCH

    cases = [("LSTM --timedelay 5 -d 0.2", recurrent("lstm", 5)),
             ("ZoneoutLSTM -d 0.2", recurrent("zoneoutlstm", 0)),
             ("FF 8x2048", feed_forward())]
    out = {}
    for tag, (net_of, x, y, offsets, bs) in cases:
        got, got_params, got_launches, (capture_ms, nodes), graph_ms, \
            prof = fold_graph_run(torch, np, dev, net_of, x, y, offsets, bs,
                                  True, True)
        want, want_params, want_launches, (direct_captures, _), direct_ms, \
            _ = fold_graph_run(torch, np, dev, net_of, x, y, offsets, bs,
                               False, False)
        rows = np.array([r.split() for r in got], np.float64)
        if (rows.shape != (3, NUM_FOLDS) or not np.isfinite(rows).all()
                or len(capture_ms) != 1 or direct_captures):
            fail(f"[fold graph {tag}] losses {got}, captures {capture_ms} "
                 f"(graph run), {direct_captures} (direct run)")
        diff = [(k, n) for k in range(NUM_FOLDS) for n, v in
                want_params[k].items() if not torch.equal(got_params[k][n],
                                                          v)]
        if diff or got != want or got_launches != want_launches:
            fail(f"[fold graph {tag}] the graph run differs from the direct "
                 f"calls: params {diff[:8]}, losses {got} vs {want}, "
                 f"launches {got_launches} vs {want_launches}")
        if tag.startswith("LSTM"):
            want_n = FOLD_GRAPH_STEPS * 3 * NUM_FOLDS * LAYERS
            if any(got_launches.get(name, 0) != want_n for name in
                   ("lstm_train_forward", "lstm_train_backward",
                    "lstm_train_dw")):
                fail(f"[fold graph {tag}] training kernel launches "
                     f"{got_launches}, not {FOLD_GRAPH_STEPS} x 3 updates x "
                     f"{NUM_FOLDS} folds x {LAYERS} layers = {want_n} each")
        busy_ms, top, replays = prof
        if replays != FOLD_GRAPH_STEPS:
            fail(f"[fold graph {tag}] the profiled epoch made {replays} "
                 f"graph launches, not one an update ({FOLD_GRAPH_STEPS})")
        ms = {"graph": graph_ms / FOLD_GRAPH_STEPS,
              "direct": direct_ms / FOLD_GRAPH_STEPS}
        dev_ms = busy_ms / FOLD_GRAPH_STEPS
        dev_text = (f"{dev_ms:.2f} ms device an update = "
                    f"{100 * dev_ms / ms['graph']:.1f} % of the graph "
                    f"update" if busy_ms > 0 else
                    "device time not measured (the profiler recorded none)")
        out[tag] = dict(graph_ms=ms["graph"], direct_ms=ms["direct"],
                        capture_ms=capture_ms[0], graph_nodes=nodes[0],
                        profile_busy_ms=busy_ms,
                        device_ms_per_update=dev_ms, top_device_ms=top,
                        launches=got_launches, losses=rows.tolist())
        log(f"[fold graph {tag}] {NUM_FOLDS} folds, {FOLD_GRAPH_STEPS} x 3 "
            f"updates: every fold's losses, params and launches "
            f"{got_launches} bit-equal to the direct calls'; ms per "
            f"fold-parallel update (epoch 2): graph {ms['graph']:.2f}, "
            f"direct {ms['direct']:.2f}; capture {capture_ms[0]:.1f} ms, "
            f"{'not exposed' if nodes[0] is None else nodes[0]} graph "
            f"nodes; profiled epoch 3: {replays} cudaGraphLaunch, {dev_text} "
            f"[{card}]")
    fp = report.get("fold_native_ctc", {}).get("fold_parallel", {})
    if "seconds" in fp:
        log(f"[fold graph] phase 30's train_cli --train-all-folds (the "
            f"updates graph replays): {fp['seconds']:.2f} s, phase 28's "
            f"{NUM_FOLDS} sequential fold trainings "
            f"{fp['sequential_s']:.2f} s [{card}]")
    report["fold_graph"] = out


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--rank-worker":
        rank_worker(int(sys.argv[2]), Path(sys.argv[3]))
        return
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "nnacousticmodeling_tpu_torch" / "csrc").is_dir():
        fail(f"no nnacousticmodeling_tpu_torch/csrc beside {__file__}: run "
             f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder.corpus_decode import (
        decode_corpus)
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.io import load_mlf, write_mlf
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models import networks
    from nnacousticmodeling_tpu_torch.ops.rnn_cuda import (
        lstm_scan, lstm_scan_reference)
    from nnacousticmodeling_tpu_torch.train import load_jax_params
    from nnacousticmodeling_tpu_torch.utils.device import resolve_device
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        make_synthetic_corpus)

    report = {}
    # ---- 1. device ----------------------------------------------------
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {card}")
    report["card"] = card

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        print(f"[build] {name} ptxas:\n{text}", file=sys.stderr)
    log(f"[build] {sorted(kernels.SOURCES)} built in {build_s:.1f} s "
        f"({len(reports)} compiled)")
    report["build_s"] = build_s

    # ---- 3. lstm_scan against its plain version ------------------------
    g = torch.Generator().manual_seed(0)
    proj = torch.randn(T_MAIN, B_MAIN, 4 * H_MAIN, generator=g).to(dev)
    wh = (torch.randn(H_MAIN, 4 * H_MAIN, generator=g)
          / H_MAIN ** 0.5).to(dev)
    c0 = torch.zeros(B_MAIN, H_MAIN, device=dev)
    h0 = torch.zeros(B_MAIN, H_MAIN, device=dev)
    (ck_, hk_), hs_k = lstm_scan(proj, wh, c0, h0)
    (ck2, hk2), hs_k2 = lstm_scan(proj, wh, c0, h0)
    (cr_, hr_), hs_r = lstm_scan_reference(proj, wh, c0, h0)
    torch.cuda.synchronize()
    lstm_err = max(float((hs_k - hs_r).abs().max()),
                   float((ck_ - cr_).abs().max()),
                   float((hk_ - hr_).abs().max()))
    if not np.isfinite(lstm_err) or lstm_err > LSTM_ATOL:
        fail(f"lstm_scan differs from its plain version by {lstm_err} "
             f"(tolerance {LSTM_ATOL})")
    if not (torch.equal(hs_k, hs_k2) and torch.equal(ck_, ck2)
            and torch.equal(hk_, hk2)):
        fail("lstm_scan: a second call on the same inputs gave other bits")
    del hs_k2, ck2, hk2
    lstm_ms = cuda_ms(torch, lambda: lstm_scan(proj, wh, c0, h0), 3)
    lstm_plain_ms = cuda_ms(
        torch, lambda: lstm_scan_reference(proj, wh, c0, h0), 1, warm=False)
    cudnn = torch.nn.LSTM(H_MAIN, H_MAIN, device=dev, dtype=torch.bfloat16)
    x_lib = torch.randn(T_MAIN, B_MAIN, H_MAIN, generator=g).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        lstm_lib_ms = cuda_ms(torch, lambda: cudnn(x_lib), 3)
    lstm_bytes = (proj.numel() * 4 + wh.numel() * 4 + 2 * c0.numel() * 4
                  + hs_k.numel() * 4 + 2 * c0.numel() * 4)
    lstm_flops = 2 * T_MAIN * B_MAIN * H_MAIN * 4 * H_MAIN
    lstm_bound, lstm_by = bound(lstm_bytes, lstm_flops, BF16_TENSOR_FLOPS)
    log(f"[lstm_scan] T={T_MAIN} B={B_MAIN} H={H_MAIN} f32 proj: max |kernel"
        f" - plain| = {lstm_err:.3e} (tolerance {LSTM_ATOL}), a second call "
        f"bit-identical; kernel "
        f"{lstm_ms:.3f} ms, plain {lstm_plain_ms:.3f} ms, cuDNN nn.LSTM "
        f"bf16 (input projection included) {lstm_lib_ms:.3f} ms, bound "
        f"{lstm_bound:.3f} ms ({lstm_by}) [{card}]")
    del proj, wh, hs_k, hs_r, cudnn, x_lib

    # ---- 4. collapsed_viterbi_forward's two routes against plain -------
    t0 = time.perf_counter()
    img = make_synthetic_image(num_phones=PHONES, num_states=CLASSES,
                               pdf_tied_transitions=True)
    dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, device=dev)
    dec_beam = ViterbiDecoder(img, pip=20.0, lmw=1.0, beam=BEAM, device=dev)
    ck = dec._collapsed_fwd
    log(f"[viterbi] image P={img.num_phones} S={img.num_states} "
        f"triphones={img.num_triphones}: Pp={ck.Pp} L={ck.L} PS={ck.PS} "
        f"(host precompute {time.perf_counter() - t0:.1f} s)")
    lp_rand, lens = random_lp(torch, np, dev)
    vit = {tag: viterbi_routes(
        torch, d._collapsed_fwd, vc.collapsed_viterbi_forward,
        vc.collapsed_viterbi_reference, vc.collapsed_cluster_capacity,
        lp_rand, lens, f"viterbi {tag}", card)
        for tag, d in (("exact", dec), ("beam", dec_beam))}
    nan_rows_check(torch, np, dev, "collapsed", card)
    frames = int(lens.sum())
    cells = frames * ck.PS * ck.L
    vit_ops = 13 * cells + 2 * frames * ck.PS * ck.Pp
    vit_bytes = (frames * (CLASSES + ck.L + ck.P) * 4 + B_MAIN * 4
                 + (ck.pdf.numel() + ck.tps.numel() + ck.src.numel()
                    + ck.lmq.numel() + 3 * ck.L + ck.Pp + ck.P) * 4)
    vit_bound, vit_by = bound(vit_bytes, vit_ops, F32_FLOPS)
    state_bytes = frames * 3 * ck.PS * ck.L * 8 * 2
    log(f"[viterbi] bound {vit_bound:.3f} ms ({vit_by}); the device-memory "
        f"route's DP state traffic alone is {state_bytes / 1e9:.1f} GB = "
        f"{state_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate; the "
        f"cluster route keeps it in shared memory")

    # ---- 5. the slice --------------------------------------------------
    t0 = time.perf_counter()
    corpus = make_synthetic_corpus(img, **CORPUS)
    x, offsets = corpus.test.data, corpus.test.offsets
    lengths = np.diff(offsets)
    audio_s = float(lengths.sum()) / 100.0
    net = get_network("lstm", LAYERS, [H_MAIN], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device=dev)
    net.load_state_dict(load_jax_params(numpy_lstm_params(0), device=dev))
    ap = corpus.log_priors
    log(f"[slice] {NUM_TEST} utterances, {int(lengths.sum())} frames "
        f"(min {lengths.min()}, mean {lengths.mean():.1f}, max "
        f"{lengths.max()}), {audio_s:.2f} audio-s; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ref_path = Path(tmp, "test_ref.mlf")
        write_mlf(str(ref_path), corpus.ref_mlf["test"])
        ref = load_mlf(str(ref_path))

        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = rnn_log_posteriors(net, x, offsets, ap=ap, batch=B_MAIN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results = decode_corpus(dec, lp, offsets, batch=B_MAIN)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per = per_of(corpus, results, Path(tmp, "kernel.mlf"), ref)
        t3 = time.perf_counter()
        launches = dict(kernels.launches)
        log(f"[slice] main-path launches: {launches}")
        for name in ("lstm_scan", "collapsed_viterbi_forward",
                     "viterbi_backtrace"):
            if launches.get(name, 0) <= 0:
                fail(f"the main path did not launch {name}")
        if launches.get("collapsed_viterbi_forward.global", 0):
            fail("the main path took the collapsed kernel's device-memory "
                 "route, not the cluster route")
        if launches.get("collapsed_viterbi_forward.registers", 0) != \
                launches["collapsed_viterbi_forward"]:
            fail("the main path's collapsed forwards did not all keep the "
                 "state in registers")
        if lp.shape != (lengths.sum(), CLASSES) or not np.isfinite(lp).all():
            fail(f"posteriors malformed: shape {lp.shape}")
        if not all(r.segments for r in results):
            fail("an utterance decoded to no segments")
        stages = {"posteriors_ms": (t1 - t0) * 1e3,
                  "decode_ms": (t2 - t1) * 1e3,
                  "mlf_per_ms": (t3 - t2) * 1e3}
        tput = audio_s / (t3 - t0)
        log(f"[slice] kernel run: PER {per:.2f} %, {tput:.1f} audio-s/s; "
            + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
            + f" [{card}]")

        # plain LSTM on the card: the network's recurrence through
        # lstm_scan_reference instead of the kernel
        with mock.patch.object(networks, "lstm_scan", lstm_scan_reference):
            lp_plain = rnn_log_posteriors(net, x, offsets, ap=ap,
                                          batch=B_MAIN)
        post_err = float(np.abs(lp - lp_plain).max())
        if not post_err <= POSTERIOR_ATOL:
            fail(f"posteriors differ from the plain LSTM's by {post_err} "
                 f"(tolerance {POSTERIOR_ATOL})")
        # plain Viterbi forward and backtrace on the card, decoding the
        # kernel run's posteriors
        with plain_viterbi():
            results_plain = decode_corpus(dec, lp, offsets, batch=B_MAIN)
        per_plain = per_of(corpus, results_plain, Path(tmp, "plain.mlf"),
                           ref)
        same = sum(a.segments == b.segments
                   for a, b in zip(results, results_plain))
        if same != len(results) or per_plain != per:
            fail(f"plain decode differs: {len(results) - same} utterances, "
                 f"PER {per_plain} vs {per}")
        log(f"[slice] plain LSTM posteriors within {post_err:.3e} "
            f"(tolerance {POSTERIOR_ATOL}); plain Viterbi: segments of all "
            f"{same} utterances and PER identical")

    # ---- 5. the backtrace kernel on phase 5's collapsed rows -----------
    # the posteriors in one T_MAIN-frame batch (phase 36's shape)
    lens5 = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    packed5, end5 = dec._collapsed_fwd.forward(
        padded_lp(torch, torch.from_numpy(lp).to(dev), offsets), lens5)
    bt = backtrace_check(torch, dec._bt_collapsed, packed5, end5, lens5,
                         dec._collapsed_fwd.pack, "phase 5 collapsed rows",
                         card, timed=True)
    segs5, counts5 = dec._collapsed_backtrace(packed5, end5, lens5)
    res_bt = dec._to_results(segs5.cpu().numpy(), counts5.cpu().numpy())
    if any(a.segments != b.segments for a, b in zip(res_bt, results)):
        fail("the backtrace kernel on phase 5's rows in one batch gives "
             "other segments than phase 5's decode")
    del packed5, end5, segs5, counts5
    packed5, end5 = dec._collapsed_fwd.forward(
        target_lp(torch, np, dev, corpus), lens5)
    bt_long = backtrace_check(torch, dec._bt_collapsed, packed5, end5,
                              lens5, dec._collapsed_fwd.pack,
                              "phase 5 target rows", card, timed=True)
    del packed5, end5
    bt_long["hop_us"] = hop_slope(bt, bt_long, "phase 5", card)

    # ---- 6. where the time goes: the main path once more, profiled ------
    def serve():
        lp_prof = rnn_log_posteriors(net, x, offsets, ap=ap, batch=B_MAIN)
        decode_corpus(dec, lp_prof, offsets, batch=B_MAIN)

    wall_ms, busy_ms, top, counts = device_profile(
        torch, serve, launches_of=("lstm_scan", "collapsed_viterbi_cluster",
                                   "collapsed_viterbi_kernel"))
    scan_kernels = counts["lstm_scan"]
    report["profile"] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                             top_device_ms=top, lstm_scan_kernels=scan_kernels,
                             viterbi_kernels=counts)
    log_profile("profile", wall_ms, busy_ms, top, card)
    if scan_kernels != LAYERS:
        fail(f"the profiled serving run ran {scan_kernels} lstm_scan device "
             f"kernels, not one a layer ({LAYERS})")
    if (counts["collapsed_viterbi_cluster"] <= 0
            or counts["collapsed_viterbi_kernel"]):
        fail(f"the profiled serving run's Viterbi device kernels: {counts}, "
             f"not collapsed_viterbi_cluster_kernel alone")
    vit_dev = sum(v for k, v in top.items()
                  if "collapsed_viterbi_cluster" in k)
    log(f"[profile] lstm_scan: {scan_kernels} device kernels for {LAYERS} "
        f"layers, one persistent launch a call; the decode ran "
        f"{counts['collapsed_viterbi_cluster']} collapsed_viterbi_cluster_"
        f"kernel ({vit_dev:.2f} ms device) and no device-memory route")

    # ---- 36. the fused serving path, while phase 5's state lives -------
    fused_launches = fused_phase(torch, np, dev, card, net, dec, corpus, lp,
                                 results, per, tput, report)
    del net, dec_beam

    train_kernels = train_phases(torch, np, dev, card, corpus, report)
    gated_kernels = gated_phases(torch, np, dev, card, corpus, dec, report)
    peephole_kernels = peephole_phases(torch, np, dev, card, corpus, dec, lp,
                                       report)
    decoder_audio_kernels = decoder_audio_phases(
        torch, np, dev, card, img, corpus, lp_rand, lens, lp, results, per,
        stages["decode_ms"], report)
    ctx = ff_ensemble_phases(torch, np, dev, card, img, corpus, dec, tput,
                             report)
    ctc_kernels = fold_native_ctc_phases(torch, np, dev, card, img, corpus,
                                         lp, results, ctx, report)
    ctx["tmp_dir"].cleanup()
    rank_launches = parallel_phases(torch, np, dev, card, corpus, dec,
                                    report)
    graph_phase(torch, np, dev, card, corpus, report)
    fold_graph_phase(torch, np, dev, card, corpus, report)

    report.update(
        lstm=dict(err=lstm_err, ms=lstm_ms, plain_ms=lstm_plain_ms,
                  library_ms=lstm_lib_ms, bound_ms=lstm_bound),
        viterbi=vit, viterbi_bound_ms=vit_bound,
        viterbi_state_bytes=state_bytes, slice=dict(
            per=per, audio_s=audio_s, audio_s_per_s=tput, posterior_err=
            post_err, launches=launches, **stages), backtrace=bt,
        backtrace_target_rows=bt_long)
    kernels_line = {"kernels": [
        {"name": "lstm_scan", "route": "cuda",
         "source": "nnacousticmodeling_tpu_torch/csrc/lstm_scan.cu",
         "replaces": "nnacousticmodeling_tpu/ops/rnn_pallas.py:49",
         "launches": launches["lstm_scan"], "max_abs_err": lstm_err,
         "tolerance": LSTM_ATOL, "ms": lstm_ms, "plain_ms": lstm_plain_ms,
         "bound_ms": lstm_bound, "bound_by": lstm_by,
         "library_ms": lstm_lib_ms},
    ] + route_entries(
        "collapsed_viterbi_forward",
        "nnacousticmodeling_tpu_torch/csrc/viterbi_collapsed.cu",
        "nnacousticmodeling_tpu/decoder/viterbi_collapsed.py:347", launches,
        vit["exact"], vit_bound, vit_by) + [
        {"name": "viterbi_backtrace", "route": "cuda",
         "source": "nnacousticmodeling_tpu_torch/csrc/viterbi_backtrace.cu",
         "replaces": "nnacousticmodeling_tpu/decoder/viterbi.py:217 (a "
                     "lax.while_loop, no pallas_call)",
         "launches": launches["viterbi_backtrace"], "max_abs_err": bt["err"],
         "tolerance": 0.0, "ms": bt["ms"], "plain_ms": bt["plain_ms"],
         "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
         "library_ms": None},
    ] + train_kernels + gated_kernels
        + peephole_kernels + decoder_audio_kernels + ctc_kernels}
    for entry in kernels_line["kernels"]:
        if entry["name"] in rank_launches:
            entry["rank_launches"] = rank_launches[entry["name"]]
        if entry["name"] in fused_launches:
            entry["fused_launches"] = fused_launches[entry["name"]]
    report["kernels"] = kernels_line["kernels"]
    report["total_s"] = time.perf_counter() - t_start
    print(f"[report] {json.dumps(report)}", file=sys.stderr)
    log(f"[done] {report['total_s']:.1f} s")
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
