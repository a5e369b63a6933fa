"""Bricks across cards in the torch port, on the CPU without CUDA.

Every hand-kernel launch (``cuda_build.launch*``) enters the device guard
of its tensors' card and takes that card's current stream; a launch whose
tensors lie on two devices raises before anything runs. Shown with a fake
library, fake tensors on ``cuda:2`` and patched ``torch.cuda.device`` /
``current_stream``. The Timer table's marks record one event per brick
card and take the slowest card's interval per phase (fake events); on the
CPU they split by the host clock as before. ``set_mesh`` spreads the bricks
round-robin over the devices, by default every visible card. The bench's
sync and the profile's per-card split cover every brick's card."""

import contextlib
import types

import pytest
import torch

from tpusph_torch import bench, dist, profile_step, runner
from tpusph_torch.api import Simulation
from tpusph_torch.ops import all_kernels, cuda_build


class FakeTensor:
    def __init__(self, device, ptr):
        self.device = torch.device(device)
        self._ptr = ptr

    def data_ptr(self):
        return self._ptr


class FakeCuda:
    """``torch.cuda.device`` / ``current_stream`` stand-ins: the guard sets
    the current device while entered; a stream is (device index, 7)."""

    def __init__(self):
        self.current = torch.device("cuda", 0)
        self.entered = []

    @contextlib.contextmanager
    def device(self, dev):
        prev, self.current = self.current, torch.device(dev)
        self.entered.append(self.current)
        try:
            yield
        finally:
            self.current = prev

    def current_stream(self, dev=None):
        dev = self.current if dev is None else torch.device(dev)
        return types.SimpleNamespace(cuda_stream=(dev.index, 7))


class FakeLib:
    """A loaded library whose every launcher records the current device,
    its arguments and returns 0."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, self.cuda.current, args))
            return 0
        return fn


@pytest.fixture
def fake(monkeypatch):
    cuda = FakeCuda()
    lib = FakeLib(cuda)
    handles = {name: lib for name in cuda_build.SOURCES}
    monkeypatch.setattr(cuda_build, "load",
                        lambda: cuda_build._Lib(handles, ""))
    monkeypatch.setattr(torch.cuda, "device", cuda.device)
    monkeypatch.setattr(torch.cuda, "current_stream", cuda.current_stream)
    return cuda, lib


def _geom_ints(names):
    return {k: 1 for k in names}


def _launcher(name, sweep):
    fn = getattr(cuda_build, name)
    return lambda tensors, /, **kw: fn(sweep, *tensors, **kw)


# (launcher, tensor count, keyword floats, int names, library function)
LAUNCHERS = [
    (_launcher("launch", "force"), 7, dict(cutmax2=1.0),
     cuda_build._INT_ARGS, "strip_force_launch"),
    (_launcher("launch_vapor", "vapor"), 5, dict(cut2=1.0),
     cuda_build._VAPOR_INT_ARGS, "strip_vapor_launch"),
    (_launcher("launch_column", "rho"), 4,
     dict(lx=1.0, ly=1.0, lcol=1.0, cutmax2=1.0),
     cuda_build._COLUMN_INT_ARGS, "column_rho_launch"),
    (_launcher("launch_band", "cgrad"), 4,
     dict(lx=1.0, ly=1.0, lcol=1.0, cutmax2=1.0),
     cuda_build._BAND_INT_ARGS, "band_cgrad_launch"),
    (_launcher("launch_compact", "force"), 7, dict(cutmax2=1.0, cut2=1.0),
     cuda_build._COMPACT_INT_ARGS, "compact_force_launch"),
]
IDS = ["launch", "launch_vapor", "launch_column", "launch_band",
       "launch_compact"]


@pytest.mark.parametrize("launcher,ntens,floats,ints,fn_name", LAUNCHERS,
                         ids=IDS)
def test_launch_enters_its_cards_guard(fake, launcher, ntens, floats, ints,
                                       fn_name):
    cuda, lib = fake
    ts = [FakeTensor("cuda:2", 100 + k) for k in range(ntens)]
    launcher(ts, **floats, **_geom_ints(ints))
    assert len(lib.calls) == 1
    name, current, args = lib.calls[0]
    assert name == fn_name
    # launched under cuda:2's guard, into cuda:2's current stream
    assert current == torch.device("cuda", 2)
    assert cuda.entered == [torch.device("cuda", 2)]
    assert args[-1] == (2, 7)
    assert list(args[:ntens]) == [100 + k for k in range(ntens)]
    # the guard is left after the launch
    assert cuda.current == torch.device("cuda", 0)


@pytest.mark.parametrize("launcher,ntens,floats,ints,fn_name", LAUNCHERS,
                         ids=IDS)
def test_launch_on_two_devices_raises(fake, launcher, ntens, floats, ints,
                                      fn_name):
    cuda, lib = fake
    ts = [FakeTensor("cuda:2", 100 + k) for k in range(ntens)]
    ts[-1] = FakeTensor("cuda:3", 999)
    with pytest.raises(ValueError, match="one CUDA device"):
        launcher(ts, **floats, **_geom_ints(ints))
    assert lib.calls == [] and cuda.entered == []


def test_launch_off_the_card_raises(fake):
    cuda, lib = fake
    ts = [FakeTensor("cpu", k) for k in range(7)]
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_build.launch("rho", *ts, cutmax2=1.0,
                          **_geom_ints(cuda_build._INT_ARGS))
    assert lib.calls == [] and cuda.entered == []


def test_launch_count_by_card():
    c = cuda_build.LaunchCount()
    for idx in (0, 2, 2, 3):
        c.count(torch.device("cuda", idx))
    assert c.launches == 4 and c.by_card == {0: 1, 2: 2, 3: 1}
    c.reset()
    assert c.launches == 0 and c.by_card == {}
    # every registered kernel wrapper counts by card
    assert all(isinstance(k, cuda_build.LaunchCount)
               for k in all_kernels().values())


# ---------------------------------------------------------- the Timer table

class FakeEvent:
    """A CUDA event whose record time comes from a per-device script."""
    clock = {}

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.dev = None
        self.t = None

    def record(self, stream):
        self.dev = stream.cuda_stream[0]
        self.t = FakeEvent.clock[self.dev].pop(0)

    def elapsed_time(self, other):
        assert other.dev == self.dev
        return other.t - self.t


def _run_marks(timer):
    for name in (None, "Modify", "Neigh", "Pair", "Modify"):
        timer.mark(name)
    timer.commit()


def test_phase_timer_takes_the_slowest_card(monkeypatch):
    cuda = FakeCuda()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", cuda.current_stream)
    # ms at the five marks of two steps, per card
    FakeEvent.clock = {0: [0, 1, 5, 6, 8] + [10, 12, 13, 20, 21],
                       1: [0, 2, 3, 9, 10] + [10, 11, 15, 16, 18]}
    timer = runner._PhaseTimer([torch.device("cuda", 0),
                                torch.device("cuda", 1),
                                torch.device("cuda", 0)])
    assert timer.devices == [torch.device("cuda", 0),
                             torch.device("cuda", 1)]
    _run_marks(timer)
    _run_marks(timer)
    assert all(len(evs) == 2 for marks in timer.steps for _, evs in marks)
    got = timer.split()
    # step 1: Modify max(1, 2) + max(2, 1), Neigh max(4, 1), Pair max(1, 6)
    # step 2: Modify max(2, 1) + max(1, 2), Neigh max(1, 4), Pair max(7, 1)
    want = {"Modify": (2 + 2 + 2 + 2) / 1e3, "Neigh": (4 + 4) / 1e3,
            "Pair": (6 + 7) / 1e3}
    assert got == pytest.approx(want, abs=1e-12)


def test_phase_timer_one_card_is_its_own_split(monkeypatch):
    cuda = FakeCuda()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", cuda.current_stream)
    FakeEvent.clock = {0: [0, 1, 5, 6, 8]}
    timer = runner._PhaseTimer([torch.device("cuda", 0)])
    _run_marks(timer)
    assert [len(evs) for _, evs in timer.steps[0]] == [1] * 5
    assert timer.split() == {"Modify": (1 + 2) / 1e3, "Neigh": 4 / 1e3,
                             "Pair": 1 / 1e3}


def test_phase_timer_cpu_uses_the_host_clock(monkeypatch):
    clock = iter([10.0, 10.5, 12.0, 12.25, 13.0])
    monkeypatch.setattr(runner.time, "perf_counter", lambda: next(clock))
    timer = runner._PhaseTimer([torch.device("cpu")] * 4)
    assert not timer.cuda and timer.devices == [torch.device("cpu")]
    _run_marks(timer)
    assert timer.split() == {"Modify": 0.5 + 0.75, "Neigh": 1.5,
                             "Pair": 0.25}


def test_dist_runner_marks_every_brick_device(monkeypatch, tmp_path):
    """The brick runner builds its timer over every brick's device (all
    ``cpu`` here: one host clock), and its table has the brick phases."""
    seen = []

    class Recording(runner._PhaseTimer):
        def __init__(self, devices):
            seen.append(list(devices))
            super().__init__(devices)

    monkeypatch.setattr(dist, "_PhaseTimer", Recording)
    sim = bench.build_bench_sim(16 ** 3, mode="dynamic", device="cpu",
                                backend="cellgrid")
    sim.set_mesh(2)
    sim.log_path = str(tmp_path / "log.bricks")    # the Timer table
    sim.run(2)
    assert seen == [[torch.device("cpu")] * 2]
    assert sim.mesh == [torch.device("cpu")] * 2
    assert set(sim._runner.phase_times) <= {"Modify", "Neigh", "Comm",
                                            "Pair"}
    assert "Pair" in sim._runner.phase_times


# ------------------------------------------------------------ placing bricks

def test_set_mesh_round_robin_over_given_devices():
    sim = Simulation(device="cpu")
    sim.set_mesh(4, devices=["cuda:0", "cuda:1"])
    assert sim.mesh == [torch.device("cuda", k) for k in (0, 1, 0, 1)]
    sim.set_mesh(devices=[f"cuda:{k}" for k in range(4)])
    assert sim.mesh == [torch.device("cuda", k) for k in range(4)]
    sim.set_mesh(8, devices=[f"cuda:{k}" for k in range(4)])
    assert sim.mesh == [torch.device("cuda", k % 4) for k in range(8)]
    # only a caller that names one device gets every brick on it
    sim.set_mesh(4, devices=["cuda:0"])
    assert sim.mesh == [torch.device("cuda", 0)] * 4


def test_set_mesh_default_spreads_over_every_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", k) for k in range(4)]
    sim = Simulation(device="cpu")
    sim.set_mesh(2)                         # on the CPU: all on it
    assert sim.mesh == [torch.device("cpu")] * 2
    sim.device = torch.device("cuda")      # as on a node of four cards
    sim.set_mesh(4)
    assert sim.mesh == cards
    sim.set_mesh()
    assert sim.mesh == cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    sim.set_mesh(4)
    assert sim.mesh == [torch.device("cuda", 0)] * 4


def test_bench_sync_waits_on_every_brick_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    cards = [torch.device("cuda", k) for k in range(4)]
    sim = types.SimpleNamespace(device=torch.device("cuda", 0), mesh=cards)
    bench.sync(sim)
    assert synced == cards
    synced.clear()
    bench.sync(types.SimpleNamespace(device=torch.device("cuda", 0),
                                     mesh=None))
    assert synced == [torch.device("cuda", 0)]
    synced.clear()
    bench.sync(types.SimpleNamespace(device=torch.device("cpu"),
                                     mesh=[torch.device("cpu")] * 4))
    assert synced == []
    # the bench line's card count: the distinct brick devices
    one_card = types.SimpleNamespace(device=torch.device("cuda"),
                                     mesh=[torch.device("cuda", 0)] * 4)
    assert bench.run_devices(one_card) == [torch.device("cuda", 0)]


def test_profile_per_card_split():
    def evt(dev, t0, t1, name="cell_sweep_kernel<2, 1, 5>",
            kind=profile_step.DeviceType.CUDA):
        return types.SimpleNamespace(
            device_type=kind, device_index=dev, name=name,
            time_range=types.SimpleNamespace(elapsed_us=lambda: t1 - t0))

    prof = types.SimpleNamespace(events=lambda: [
        evt(0, 0, 300), evt(0, 400, 500, name="Memcpy PtoP"),
        evt(1, 0, 900), evt(2, 0, 100),
        evt(0, 0, 5000, name="aten::add", kind=profile_step.DeviceType.CPU),
    ])
    cards = profile_step.per_card(prof, [0, 1, 2, 3], wall_s=1e-3)
    assert cards[0]["busy_ms"] == pytest.approx(0.4)
    assert cards[0]["launches"] == 1
    assert cards[1]["busy_ms"] == pytest.approx(0.9)
    assert cards[2]["launches"] == 1
    assert cards[3] == dict(busy_ms=0.0, launches=0, idle_share=1.0)
    assert cards[1]["idle_share"] == pytest.approx(0.1)
    assert cards[0]["idle_share"] == pytest.approx(0.6)
