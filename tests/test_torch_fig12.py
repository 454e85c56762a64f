"""The port's fig12 point function against the reference's: every point of
the fig12 smoke grid (``benchmarks/fig12_serving_slo.py --smoke``) gives
a byte-identical SLO row, and chip_smoke.py's pooled table and gate equal
the reference benchmark script's."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from repro.serving import fig12 as j_fig12
from repro_torch.serving import fig12 as t_fig12

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GRID = _chip_smoke().fig12_smoke_grid()
_ROWS = {}


def _key(item):
    return (item["policy"], item["arrivals"], item["lo_load"],
            item["set_index"])


def _both(item):
    if _key(item) not in _ROWS:
        _ROWS[_key(item)] = (t_fig12.simulate_fig12_point(**item),
                             j_fig12.simulate_fig12_point(**item))
    return _ROWS[_key(item)]


def test_grid_is_the_reference_smoke_sweep():
    from benchmarks.fig12_serving_slo import sweep
    want = [dict(it) for it in sweep(2, n_lo=24, n_hi=8).items]

    def dumps(items):
        return sorted(json.dumps(it, sort_keys=True) for it in items)
    assert dumps(GRID) == dumps(want)
    assert len(GRID) == 16


@pytest.mark.parametrize("item", GRID, ids=lambda it: "-".join(
    str(v) for v in _key(it)))
def test_fig12_point_rows_byte_identical(item):
    got, want = _both(item)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["hi_finished"] == item["n_hi"]


def test_pooled_table_and_gate_equal_the_reference_benchmark():
    from benchmarks.fig12_serving_slo import _cell_stats
    cs = _chip_smoke()
    rows = [{**item, **_both(item)[0]} for item in GRID]
    gate = cs.fig12_gate(rows)
    for (pol, arr, load), got in gate["table"].items():
        cell = [{**it, **_both(it)[1]} for it in GRID
                if (it["policy"], it["arrivals"], it["lo_load"])
                == (pol, arr, load)]
        assert got == _cell_stats(cell)
    assert gate["ok"]
    assert gate["sat_hi_p99_np/mesc"] > 1.0


def test_policies_are_the_reference_table():
    assert sorted(t_fig12.POLICIES) == sorted(j_fig12.POLICIES)
    for name in t_fig12.POLICIES:
        assert dataclasses.asdict(t_fig12.POLICIES[name]()) \
            == dataclasses.asdict(j_fig12.POLICIES[name]())
    assert t_fig12.SERVING_SEMANTICS_VERSION \
        == j_fig12.SERVING_SEMANTICS_VERSION


def test_unknown_policy_raises():
    for mod in (t_fig12, j_fig12):
        with pytest.raises(ValueError, match="unknown policy"):
            mod.simulate_fig12_point(policy="edf", arrivals="poisson",
                                     lanes=1, set_index=0)
