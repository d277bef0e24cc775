"""The harness finds every piece of a cell by name, and a later cell,
mix or metric is added as files and entries alone."""

import json

import pytest

from glmbench import spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_config_mix_loop_and_data(cell):
    found = spec.find(cell)
    assert found["cell"]["name"] == cell
    assert hasattr(spec.loop_module(found["mix"]), "Loop")
    data = spec.data_module(found["config"])
    for name in ("make", "to_program", "penalty_scale", "reference_design"):
        assert callable(getattr(data, name))
    names = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert found["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric).read)


def test_a_metric_split_by_cell_shares_its_quantitys_reader(tmp_path):
    """``device_idle.fit`` and ``device_idle.ops`` have no files of their
    own and read through ``device_idle.py``; a file of the full name wins."""
    for name in ("device_idle.fit", "device_idle.ops"):
        assert spec.metric_reader(name).__file__ == str(spec.HERE / "metrics" / "device_idle.py")
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "q.py").write_text("def read(ctx):\n    return 1.0\n")
    (tmp_path / "metrics" / "q.b.py").write_text("def read(ctx):\n    return 2.0\n")
    assert spec.metric_reader("q.a", here=tmp_path).read({}) == 1.0
    assert spec.metric_reader("q.b", here=tmp_path).read({}) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("r.a", here=tmp_path)


def test_config_files_are_the_benchmarks_and_cut_nothing():
    for entry in BENCH["configs"]:
        config = json.loads((spec.ROOT / entry["file"]).read_text())
        assert config["name"] == entry["name"]
        assert config["reduced"] == entry["reduced"] == []


def test_a_new_mix_is_a_data_file_found_by_name(tmp_path):
    """A dummy mix written under TMPDIR, named by a new cell, is found by
    the lookup, and the loop it names is the harness's own."""
    (tmp_path / "traffic").mkdir()
    mix = {"loop": "path", "trace_requests": 1, "check_samples": 1}
    (tmp_path / "traffic" / "dummy.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "dense_cat.dummy", "config": "tabmat_dense_cat",
                               "traffic": "dummy", "chips": 1, "why": "a test"})
    found = spec.find("dense_cat.dummy", here=tmp_path, bench=bench)
    assert found["mix"] == mix
    assert found["config"]["name"] == "tabmat_dense_cat"
    assert spec.loop_module(found["mix"]).Loop.__module__ == "glmbench_loop_path"
    # a metric without a list of cells goes where its end-to-end metric goes
    bench["per_layer"].append({"name": "x", "unit": "1", "better": "lower",
                               "source": "host_clock", "layer": "solver", "moves": "fit_s"})
    assert "x" in {m["name"] for m in spec.find("fremtpl2.refit", bench=bench)["per_layer"]}
    assert "x" not in {m["name"] for m in spec.find("dense_cat.ops", bench=bench)["per_layer"]}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find("no.such_cell")
