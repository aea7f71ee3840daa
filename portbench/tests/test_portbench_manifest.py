"""BENCHMARK.json against the contract's rules that a file can be held to:
names and units, the files found by name, the ``moves`` rule, the bounds,
the configurations against the port's registered ones."""
import dataclasses
import json
import re

import pytest

from portbench import manifest
from portbench.manifest import HERE, ROOT, load_cell, load_manifest

M = load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = [w["name"] for w in M["workloads"]]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    names = ([c["name"] for c in M["configs"]] + CELLS
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_end_to_end_metrics_and_bounds():
    assert set(E2E) == {"setup_s", "serve_tokens_per_s", "serve_itl_p95_ms",
                        "train_tokens_per_s", "train_peak_gb"}
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in \
        E2E["setup_s"]
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in CELLS:
        e2e = [m for m in M["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(_reports(m, cell) for m in M["per_layer"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric["moves"] in E2E and metric["source"] in (
        "device_trace", "program_span", "program_counter", "host_clock")
    assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    for cell in CELLS:
        if _reports(metric, cell):
            assert _reports(E2E[metric["moves"]], cell), (metric["name"],
                                                          cell)
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].split(".")[0].endswith("_roofline")
    assert callable(manifest.metric_reader(metric["name"]))


def test_a_metric_with_nothing_to_read_reads_none():
    for m in M["per_layer"]:
        assert manifest.metric_reader(m["name"])({"kind": "none"}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = load_cell(cell, M)
    assert c.cell["kind"] == c.mix["kind"] == \
        json.loads((HERE / "traffic" / f"{c.spec['traffic']}.json")
                   .read_text())["kind"]
    assert set(c.cell["check"]["limits"]) and all(
        v >= 0 for v in c.cell["check"]["limits"].values())
    assert c.config["name"] == c.spec["config"]


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_runs(conf):
    """The file lies under paths, names its cuts as the manifest does, and
    the port's config built from it is the registered one but for the
    depth and the departures from it that the file lists."""
    from repro_torch.models import get_config
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"] and len(data["source"]) <= 200
    assert sorted(data["cuts"]) == sorted(conf["reduced"])
    widths = re.compile(r"(_size$|_dim$|_rank$|^head|experts_per_tok|"
                        r"latent|state|projection|expansion)")
    assert not [k for k in conf["reduced"] if widths.search(k)]
    built = manifest.port_config(data)
    reg = get_config(data["port_arch"])
    assert built.hd == reg.hd
    departures = data.get("departures", {})
    same = dataclasses.replace(built, groups=reg.groups,
                               head_dim=reg.head_dim,
                               **{k: getattr(reg, k) for k in departures})
    assert same == reg
    assert built.attn_window == data["sliding_window"]
    assert {g.pattern for g in built.groups} == {
        ("local",) if data["sliding_window"] else ("attn",)}
    assert built.n_layers == data["num_hidden_layers"]


def test_run_seconds_fits_the_full_check():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_benchmark_json_is_small_and_one_line_strings():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    for s in re.findall(r'"([^"]*)"', text):
        assert "\t" not in s and "\n" not in s
