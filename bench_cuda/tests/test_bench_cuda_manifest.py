"""BENCHMARK.json against the benchmark's contract: its keys, the character
sets of every name and unit, every cell's files found by name, the metrics
each cell reports, and the check's time budget."""
import json
import os
import re

import pytest

from bench_cuda import harness

MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(TEXT_RE.match(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert os.path.isdir(os.path.join(harness.ROOT, p))
        assert not p.endswith("_torch")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_keys(group, entry):
    assert harness.NAME_RE.match(entry["name"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    extra = set(entry) - keys
    assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer")
                     else set())
    assert keys <= set(entry)
    if group == "configs":
        assert TEXT_RE.match(entry["source"]) and TEXT_RE.match(entry["why"])
        assert entry["file"].startswith("bench_cuda/")
        assert len(entry["reduced"]) <= 16
        assert all(harness.NAME_RE.match(k) for k in entry["reduced"])
    elif group == "workloads":
        assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
        assert harness.NAME_RE.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and TEXT_RE.match(entry["why"])
    else:
        assert harness.UNIT_RE.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert set(entry.get("workloads", CELLS)) <= set(CELLS)
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert TEXT_RE.match(entry["layer"])
        e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
        assert entry["moves"] in e2e
        moved = e2e[entry["moves"]].get("workloads", CELLS)
        assert set(entry.get("workloads", CELLS)) <= set(moved)


def test_unique_names_and_pairs():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST[
        "per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_four_chip_cells_at_most_a_quarter():
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


def test_check_fits_its_time():
    n = len(CELLS)
    total = ((2 + 14 * n) * (MANIFEST["run_seconds"] + 60) + n * 2 * 90
             + 1200)
    assert total <= 43200
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.find_cell(name, MANIFEST)
    work = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    conf = next(c for c in MANIFEST["configs"] if c["name"] == work["config"])
    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        assert json.load(f)["name"] == conf["name"]
    assert cell.config["name"] == work["config"]
    assert harness.driver(cell.mix).run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    from bench_cuda import checks
    assert checks.limits(name)


def test_every_config_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
