"""A whole run of each tiny cell on the CPU (everything but the look for
a card) comes out correct, and with the timed path broken underneath it
comes out not correct: once for each fault a cell can have
(``benchmark/faults.py``). Each fault is planted where a later change
could make it: a step that leaves its state unchanged, half of the batch
left out with the mean taken over the rest, an answer altered where it
is produced, a scan's state dropped past the first frames, the delay
trim's tail left in, a second epoch on the first epoch's rows. (A
one-chip cell has no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.tests.tiny import run_tiny

SERVE = "lstm_serve_testset"
TRAIN = ["lstm_train_tbptt", "gru_train_tbptt", "lstm_train_adam_b512"]


@pytest.mark.parametrize("name", [SERVE] + TRAIN)
def test_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0


# ---- serving --------------------------------------------------------------

@pytest.mark.parametrize("fault", sorted(faults.PLANTED["serve"]))
def test_serve_fault_is_caught(fault):
    with faults.PLANTED["serve"][fault]():
        result = run_tiny(SERVE)
    assert not result["correct"], result["compared"]


def test_later_frames_fault_is_caught_past_the_first_frames():
    """A scan that drops its state past the first frames reads right on
    ``posterior_gap_start`` and is caught over the whole utterance."""
    with faults.scan_state_dropped():
        result = run_tiny(SERVE)
    compared = result["compared"]
    assert (compared["posterior_gap_start"]["value"]
            <= compared["posterior_gap_start"]["limit"])
    assert (compared["posterior_gap_widest"]["value"]
            > compared["posterior_gap_widest"]["limit"])


# ---- training ---------------------------------------------------------------

@pytest.mark.parametrize("fault", sorted(faults.PLANTED["train"]))
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_caught(name, fault):
    with faults.PLANTED["train"][fault]():
        result = run_tiny(name)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("name", TRAIN)
def test_window_fault_is_caught_past_the_first_epoch(name):
    """Stale rows from the second epoch on read right on the first
    epoch's numbers and are caught on the window's."""
    with faults.stale_rows():
        result = run_tiny(name)
    compared = result["compared"]
    for k in ("loss_gap", "grad_norm_gap", "change_norm_gap",
              "logit_gap_start"):
        assert compared[k]["value"] <= compared[k]["limit"], k
    assert (compared["window_loss_gap"]["value"]
            > compared["window_loss_gap"]["limit"])
