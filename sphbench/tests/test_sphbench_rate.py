"""The rate is all the work over all the time: a stalled call lowers it."""

import time

import torch

from sphbench import harness


class FakeSim:
    """``timed_window``'s view of a simulation: ``run`` sleeps for the
    given seconds per call."""

    def __init__(self, waits, natoms=1000):
        self.waits = list(waits)
        self.natoms = natoms
        self.mesh = None
        self.device = torch.device("cpu")
        self.rebuilds = 0
        self._strip_violations = 0
        self._strip_decays = 0
        self.calls = 0

    def run(self, k):
        time.sleep(self.waits[min(self.calls, len(self.waits) - 1)])
        self.calls += 1


def test_rate_counts_every_call_and_all_the_time():
    steady = harness.timed_window(FakeSim([0.02]), 10, 0.2, timer=False)
    stalled = harness.timed_window(FakeSim([0.02, 0.02, 0.3, 0.02]), 10,
                                   0.2, timer=False)
    assert steady["work"] == 1000 * 10 * steady["calls"]
    assert abs(steady["rate"] - steady["work"] / steady["wall_s"]) < 1e-9
    # the stalled window's rate carries the stall; a median of calls
    # would not
    assert stalled["rate"] < 0.5 * steady["rate"]
    assert stalled["wall_s"] >= 0.34


def test_window_runs_past_its_length_only_by_the_last_call():
    rec = harness.timed_window(FakeSim([0.05]), 5, 0.2, timer=False)
    assert 0.2 <= rec["wall_s"] < 0.2 + 0.05 * 3
