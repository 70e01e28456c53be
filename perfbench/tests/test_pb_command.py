"""The command's refusals: no result where there is no CUDA device, and none
in a directory that holds only BENCHMARK.json and the benchmark's folder."""
import shutil
import subprocess
import sys

from perfbench import bench

ARGS = ["--workload", "command-r-plus-104b-l8.chat_1k_256", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_cuda_device():
    out = _run(bench.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_no_result_with_only_the_benchmark_files(tmp_path):
    shutil.copy(bench.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(bench.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_unknown_cell_is_refused():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "no.such",
                          "--seed", "1", "--seconds", "1"], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
