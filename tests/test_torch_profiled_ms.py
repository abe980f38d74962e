"""``chip_smoke.py``'s device-time arithmetic on the CPU, on fake
``torch.profiler`` key averages.

The profiler can drop records of a kernel: a profile of five launches of
the wide kernel held one record, and dividing the profile's total by the
five calls read a fifth of the kernel's time. ``profiled_ms`` divides each
name's time by its own record count (times the launches per call the
wrapper's counter saw), and ``device_profile`` takes a second profile
before it gives up on one that holds no record.
"""

import importlib.util
import os
import types

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _avg(key, count, us):
    """One row of ``prof.key_averages()`` as ``cuda_kernels`` keeps it."""
    return types.SimpleNamespace(
        key=key, count=count, self_device_time_total=us,
        device_type=torch.autograd.DeviceType.CUDA)


WIDE = "void gauss_jordan_wide_kernel<128>(float const*, float*, int)"
WARP = "void gauss_jordan_warp_kernel<32>(float const*, float*, int)"

# (rows, reps, symbol, launches, want ms, want records)
CASES = {
    # every launch recorded: the old rule and the new agree
    "all-records": ([_avg(WIDE, 5, 5 * 1304.0)], 5, "wide", 5, 1.304, 5),
    # one record of five launches: its own time, not a fifth of it
    "dropped-records": ([_avg(WIDE, 1, 1304.0)], 5, "wide", 5, 1.304, 1),
    # other kernels in the window (a warm-up's GEMM) are not the kernel's
    "other-kernels": ([_avg(WARP, 100, 100 * 282.0),
                       _avg("ampere_sgemm_128x64_nn", 3, 3 * 50.0)],
                      100, "warp", 100, 0.282, 100),
    # two launches a call (a solve split over two buffers)
    "two-launches-a-call": ([_avg(WARP, 10, 10 * 140.0)], 5, "warp", 10,
                            0.280, 10),
    # no counter: one launch a call
    "no-counter": ([_avg(WIDE, 2, 2 * 1000.0)], 5, "wide", 0, 1.0, 2),
    # the plain version: many names, some launched k times a call, one
    # record of a once-a-call kernel dropped
    "generic-names": ([_avg("elementwise_div", 320, 320 * 2.0),
                       _avg("reduce_kernel", 9, 9 * 30.0)],
                      10, "", 0, (32 * 2.0 + 30.0) / 1e3, 329),
    # a name the profiler saw less than once a call still counts once
    "generic-dropped-below-one": ([_avg("bmm_kernel", 2, 2 * 500.0)],
                                  5, "", 0, 0.5, 2),
    # nothing of the kernel in the profile: not measured
    "no-record": ([_avg("ampere_sgemm_128x64_nn", 3, 150.0)], 5, "wide", 5,
                  None, 0),
    "empty": ([], 5, "", 0, None, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiled_ms_divides_by_the_kernels_own_records(smoke, case):
    rows, reps, which, launches, want_ms, want_records = CASES[case]
    symbol = {"wide": smoke.WIDE_SYMBOL, "warp": smoke.WARP_SYMBOL,
              "": ""}[which]
    ms, records = smoke.profiled_ms(rows, reps, symbol, launches)
    assert records == want_records
    if want_ms is None:
        assert ms is None
    else:
        assert ms == pytest.approx(want_ms, rel=1e-12)


class _FakeProfile:
    """``torch.profiler.profile`` whose n-th use reports ``rows[n]``."""

    def __init__(self, rows):
        self.rows = list(rows)
        self.uses = 0

    def __call__(self, activities):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uses += 1
        return False

    def key_averages(self):
        return self.rows[self.uses - 1]


@pytest.fixture()
def fake_profiler(monkeypatch):
    def install(rows):
        import torch.profiler

        prof = _FakeProfile(rows)
        monkeypatch.setattr(torch.profiler, "profile", prof)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        return prof

    return install


def test_device_profile_takes_a_second_profile_before_giving_up(
        smoke, fake_profiler):
    """A first profile with no record is taken again; the counter's
    launches in the window are reported beside the records."""
    prof = fake_profiler([[], [_avg(WIDE, 1, 1304.0)]])
    counter = types.SimpleNamespace(count=0)

    def call():
        counter.count += 1

    got = smoke.device_profile(call, 5, smoke.WIDE_SYMBOL, counter)
    assert prof.uses == 2
    assert got["profiles"] == 2 and got["records"] == 1
    assert got["launched"] == 5
    assert got["ms"] == pytest.approx(1.304)


def test_device_ms_fails_only_when_the_second_profile_sees_nothing(
        smoke, fake_profiler):
    fake_profiler([[], []])
    with pytest.raises(AssertionError, match="two profiles"):
        smoke.device_ms(lambda: None, 5)
    prof = fake_profiler([[], []])
    assert smoke.device_ms(lambda: None, 5, required=False) is None
    assert prof.uses == 2
