"""Each driver's control flow at a small size on the CPU (the look for a
card skipped; the program's plain paths), and ``correct`` coming out false
under each cell's own limits when the timed path is broken underneath or
when the reference in a lower precision stands in for the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_cuda import calibrate, checks, faults, harness
from bench_cuda.tests import tiny

STREAM = "nowcast_128_bf16.stream"
TRAIN = ("nowcast_128_bf16.train", "generator_default.train")


@pytest.fixture(scope="module")
def sound():
    """Readings of the sound program at the small size, by cell."""
    return {name: tiny.run(name) for name in (STREAM,) + TRAIN}


def test_stream_run(sound):
    out = sound[STREAM]
    assert out.attempted > 0 and out.failed == 0
    assert set(out.readings) == set(checks.limits(STREAM))
    assert set(out.e2e) == {"setup_s", "request_p50_ms", "request_p95_ms"}
    assert out.e2e["request_p95_ms"] >= out.e2e["request_p50_ms"] > 0


@pytest.mark.parametrize("name", TRAIN)
def test_train_run(sound, name):
    out = sound[name]
    assert out.attempted > 0 and out.failed == 0
    assert set(out.readings) == set(checks.limits(name))
    assert out.e2e["train_samples_per_s"] > 0
    assert all(v < 0.05 for v in out.readings.values()), out.readings


@pytest.mark.parametrize("name,fault", [(STREAM, f) for f in faults.STREAM]
                         + [(n, f) for n in TRAIN for f in faults.TRAIN])
def test_fault_is_not_correct(sound, name, fault):
    out = tiny.run(name, fault=fault)
    assert not checks.judge(out.readings, checks.limits(name)), out.readings
    worst = max(out.readings[k] / sound[name].readings[k]
                for k in out.readings if sound[name].readings[k] > 0)
    assert worst > 10


@pytest.mark.parametrize("name", (STREAM,) + TRAIN)
def test_control_is_not_correct(name):
    """The reference one precision below the configuration's, in the
    program's place (``calibrate.control``)."""
    c = tiny.cell(name)
    readings = calibrate.control(c, tiny.SEED, 0.5, 20, device="cpu")
    assert not checks.judge(readings, checks.limits(name)), readings


def _run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "bench_cuda.run", "--workload", STREAM,
         "--seed", str(tiny.SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_no_result():
    out = _run_cli(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_as_a_file_from_another_directory(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "bench_cuda", "run.py"),
         "--workload", "nope.nope", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no workload" in out.stderr
    assert "ModuleNotFoundError" not in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_manifest_cells_have_limits_for_every_reading():
    manifest = harness.load_manifest()
    for w in manifest["workloads"]:
        lim = checks.limits(w["name"])
        assert lim and all(v > 0 for v in lim.values())
        json.dumps(lim)
