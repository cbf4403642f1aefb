"""chip_smoke.py's ``recorded``: how a check of launches by name treats a
profiler recording that failed it; and ``check_flash_route``'s admission
of launches lost to the profiler.

A recording that fails is taken again, at most ``PROFILE_TRIES`` times in
all. A failed recording counts as lost events only where a later one
passes and shows at least every launch the failed one showed; else, and
where none passes, the check's own error stands. The recordings here are
name -> launches tables handed out in order, so no card is needed.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CHIP_SMOKE)

WANT = {"paged_decode_split_kernel": 150, "vflash_fwd_tc_kernel": 10}
FULL = dict(WANT, other_kernel=7)


def _record(tables):
    """``recorded`` over ``tables`` in order; (result, recordings taken)."""
    taken = []

    def take():
        taken.append(tables[len(taken)])
        return taken[-1]

    def route(table):
        got = {k: table.get(k, 0) for k in WANT}
        CHIP_SMOKE.check(got == WANT, f"ran {got}, want {WANT}")

    out = CHIP_SMOKE.recorded(take, lambda t: t, route, "test")
    return out, len(taken)


@pytest.mark.parametrize("tables, taken", [
    ([FULL], 1),
    ([dict(FULL, paged_decode_split_kernel=145), FULL], 2),
    ([dict(FULL, vflash_fwd_tc_kernel=0, other_kernel=0),
      dict(FULL, paged_decode_split_kernel=3), FULL], 3),
], ids=["complete", "one-lost", "two-lost"])
def test_a_lossy_recording_is_taken_again(tables, taken):
    out, n = _record(tables)
    assert out == FULL and n == taken


@pytest.mark.parametrize("tables, match", [
    ([dict(FULL, paged_decode_split_kernel=151), FULL], "lost no events"),
    ([dict(FULL, paged_decode_split_kernel=145, stray_kernel=1), FULL],
     "lost no events"),
    ([dict(FULL, paged_decode_split_kernel=145)] * 3, "want"),
], ids=["more-launches", "another-kernel", "never-passes"])
def test_a_failure_that_is_no_loss_stands(tables, match):
    with pytest.raises(CHIP_SMOKE.PhaseError, match=match):
        _record(tables)
    assert CHIP_SMOKE.PROFILE_TRIES == 3


ROUTE = {"flash_fwd_tc_kernel": 5, "flash_bwd_dq_tc_kernel": 5,
         "flash_bwd_dkv_tc_kernel": 5, "elementwise_kernel": 9}
WANT_ROUTE = {"fwd": 5, "dq": 5, "dkv": 5}


@pytest.mark.parametrize("table, lost, passes", [
    (ROUTE, 0, True),
    (ROUTE, 1, True),
    (dict(ROUTE, flash_bwd_dkv_tc_kernel=4), 1, True),
    (dict(ROUTE, flash_bwd_dkv_tc_kernel=4), 0, False),
    (dict(ROUTE, flash_bwd_dkv_tc_kernel=3), 1, False),
    (dict(ROUTE, flash_bwd_dkv_tc_kernel=6), 1, False),
    (dict(ROUTE, flash_bwd_dkv_kernel=1), 1, False),
], ids=["exact", "exact-admitting", "one-lost", "one-lost-not-admitted",
        "two-lost", "one-extra", "cuda-core-ran"])
def test_flash_route_admits_at_most_the_lost_launches(table, lost, passes):
    def run():
        CHIP_SMOKE.check_flash_route(table, WANT_ROUTE, "test", lost=lost)

    if passes:
        run()
    else:
        with pytest.raises(CHIP_SMOKE.PhaseError):
            run()
