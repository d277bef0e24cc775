"""A whole run of each cell on the CPU at a small size: the last line has
exactly the contract's keys, the checks last, and a sound run is correct."""

import pytest

from _cpu_run import BENCH, CELLS, cpu_run
from glmbench import spec


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contracts_keys_and_is_correct(cell):
    rc, result, lines = cpu_run(cell)
    assert rc == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    expected = {m["name"] for m in spec.find(cell, bench=BENCH)["end_to_end"]}
    assert set(result["metrics"]) == expected
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}


def test_the_same_seed_gives_the_same_inputs():
    from glmbench.data import dense_cat, fremtpl2

    config = dict(spec.find("dense_cat.ops")["config"], rows=500)
    a, b = dense_cat.make(config, 2**31 + 5, 1)[0], dense_cat.make(config, 2**31 + 5, 1)[0]
    assert (a["dense"] == b["dense"]).all() and (a["y"] == b["y"]).all()
    config = dict(spec.find("fremtpl2.refit")["config"], rows=500)
    f, g = fremtpl2.make(config, 7, 2), fremtpl2.make(config, 7, 2)
    assert f[1]["frame"].equals(g[1]["frame"])
    assert not f[0]["frame"].equals(f[1]["frame"])


def test_a_run_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from glmbench.harness import main

    rc = main(["--workload", "dense_cat.ops", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
