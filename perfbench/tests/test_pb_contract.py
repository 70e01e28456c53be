"""BENCHMARK.json against the benchmark's contract, and the discovery of
every file it names."""
import json
import re

import pytest

from perfbench import bench

B = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"] and B["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_setup_s_everywhere_and_each_cell_reports_enough():
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    for w in B["workloads"]:
        e2e = bench.end_to_end_of(B, w["name"])
        assert len(e2e) >= 2 and bench.per_layer_of(B, w["name"])


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_its_cells_report(m):
    e2e = {x["name"] for x in B["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", [w["name"] for w in B["workloads"]]):
        assert m["moves"] in {x["name"] for x in bench.end_to_end_of(B, cell)}


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_of_its_layer(m):
    path = bench.metric_file(m["name"])
    assert path.exists()
    mod = bench.module_from(path, "t_" + path.stem)
    assert mod.LAYER == m["layer"] and callable(mod.read)


def test_share_metrics_are_named_as_rooflines_or_mfu():
    for m in B["per_layer"]:
        if m["unit"] == "%" and "idle" not in m["name"]:
            assert "_roofline" in m["name"] or "mfu" in m["name"]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(w):
    c = bench.cell(B, w["name"])
    assert c["config_file"]["name"] == w["config"]
    assert c["config_file"]["reduced"] == c["config_entry"]["reduced"]
    assert (bench.HERE / "drivers" / f"{c['traffic_file']['driver']}.py").exists()
    for lim in c["limits"]["numbers"].values():
        assert "limit" in lim and lim["set_from"]


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_widths_are_published(c):
    conf = bench.load_json(bench.ROOT / c["file"])
    widths = ("hidden_size", "intermediate_size", "head_dim", "num_attention_heads",
              "num_key_value_heads", "vocab_size")
    assert not any(k in c["reduced"] for k in widths)
    for k in c["reduced"]:
        assert k in conf["published"] and conf["published"][k] != conf[k]


def test_port_config_matches_each_file():
    from perfbench import port
    for c in B["configs"]:
        cfg = port.config(bench.load_json(bench.ROOT / c["file"]))
        assert cfg.d_model == bench.load_json(bench.ROOT / c["file"])["hidden_size"]


def test_helpers():
    assert bench.percentile([5, 1, 3, 2, 4], 50) == 3
    assert bench.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert bench.forbidden_loaded(["jax.numpy", "repro_torch.models", "repro", "numpy",
                                   "jaxlib", "flax.linen", "reproduce"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro"]
