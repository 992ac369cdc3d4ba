"""The comparison that decides `correct` fails when the timed path is
broken, and when a lower precision stands in for the program.

A whole run of a small cell on the CPU (S's widths at 256x320, float32 with
TF32 off as the cells; the harness's look for a card is skipped), with one
fault of S2M2's `FAULTS` (`archs/s2m2.py`) planted in the program underneath: the refiner's step
returning its state unchanged, the disparity one pixel off where the model
produces it, half of a batch left out. Then the control, the reference on
TF32 operands in the program's place, and the program's own bf16 path. A
cell holds one card, so no exchange between cards can be left out. The
small cell compares exactly the numbers the committed cells compare, with
limits set from its own readings as theirs are (PERF.md)."""
import contextlib
import json
from pathlib import Path

import pytest

from portbench import faults, harness, readings
from portbench.tests.conftest import write_root

LIMITS = Path(__file__).resolve().parents[1] / "limits"
SMALL = {"model": {"feature_channels": 128, "refine_iter": 3},
         "traffic": {"height": 256, "width": 320, "max_disp": 50}}
# From the small cell's readings on the CPU (`readings.readings`, 12 program
# seeds 2147483901-912, the TF32 reference on 3 seeds 2147483921-923), as
# program's largest / control's smallest: disp_clear_median_px 1.17e-5 /
# 1.47e-4, occ_median 5.96e-7 / 4.65e-6, conf_median 3.58e-7 / 8.30e-6;
# each limit is lower x (upper / lower)^0.6.
SMALL_LIMITS = {"disp_clear_median_px": 5.3e-5, "occ_median": 2.0e-6, "conf_median": 2.4e-6}
SEED = 2**31 + 41


def run(tmp_path, batch=1, fault=None):
    """A run of the small cell, with the fault `fault` of its architecture
    planted in the program."""
    root = write_root(tmp_path, SMALL_LIMITS, batch, **SMALL)
    cell = harness.load_cell("tiny.stream", False, root)
    with faults.plant(cell, fault) if fault else contextlib.nullcontext():
        return harness.run_cell(cell, SEED, 1.0, False, device="cpu", log=lambda _: None)


def test_the_small_cell_compares_the_committed_cells_numbers():
    committed = [sorted(json.loads(p.read_text())) for p in sorted(LIMITS.glob("*.json"))]
    assert committed and all(keys == sorted(SMALL_LIMITS) for keys in committed)


@pytest.mark.parametrize("batch", [1, 2])
def test_sound_run_is_correct(tmp_path, batch):
    res = run(tmp_path, batch)
    assert res["correct"] and res["failed"] == 0, res["checks"]


def test_refiner_returning_its_state_unchanged_is_caught(tmp_path):
    res = run(tmp_path, fault="refiner_unchanged")
    assert not res["correct"] and res["failed"] > 0


def test_disparity_altered_where_it_is_produced_is_caught(tmp_path):
    res = run(tmp_path, fault="disp_plus1")
    assert not res["correct"] and res["failed"] > 0


def test_half_of_a_batch_left_out_is_caught(tmp_path):
    res = run(tmp_path, batch=2, fault="half_batch")
    assert not res["correct"] and res["failed"] > 0


def test_lower_precision_in_the_programs_place_is_caught(tmp_path, monkeypatch):
    """The control: the reference in the program's place with every conv
    and linear on TF32 operands."""
    monkeypatch.setattr(harness, "build_engine", lambda cell, device, precision=None:
                        readings.control(cell, "ref_tf32", SEED, device))
    monkeypatch.setattr(harness, "set_weights", lambda engine, w: None)
    res = run(tmp_path)
    assert not res["correct"] and res["failed"] > 0


def test_the_programs_own_bf16_path_is_caught(tmp_path, monkeypatch):
    build = harness.build_engine
    monkeypatch.setattr(harness, "build_engine",
                        lambda cell, device, precision=None: build(cell, device, "bf16"))
    res = run(tmp_path)
    assert not res["correct"] and res["failed"] > 0
