"""Cells cut to a size the CPU runs in seconds, for the tests: the same
generators, references and comparisons as the benchmark's runs, with two
small layers, 40 pdfs, a 6-phone image and a few short utterances."""

from __future__ import annotations

from benchmark import common


def tiny_cell(name: str) -> common.Cell:
    cell = common.load_cell(name)
    cell.config["model"].update(layers=2, units=32, num_classes=40)
    cell.config["decoder"]["phones"] = 6
    if cell.traffic["kind"] == "serve":
        cell.traffic.update(utterances=20, median=30, sigma=0.3,
                            min_frames=12, max_frames=60, batch=8)
    else:
        cell.traffic.update(utterances=40, dev_utterances=8, median=30,
                            sigma=0.3, min_frames=12, max_frames=60,
                            batch=4, bprop_len=5)
        if cell.traffic["optimizer"] == "adam":
            # Adam's first steps move every weight by about its learning
            # rate whatever the gradient's size: at two 32-unit layers too
            # many weights sit near a sign flip for the cell's limits
            cell.config["model"]["units"] = 128
            cell.traffic.update(utterances=80, batch=32)
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 11, seconds: float = 3.0
             ) -> dict:
    """One run of the tiny cell on the CPU through the harness's
    ``execute`` (everything but its look for a card); the window long
    enough for the passes over the set that a run checks."""
    from benchmark import run
    return run.execute(name, seed, seconds, False, device="cpu",
                       cell=tiny_cell(name))
