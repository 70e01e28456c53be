"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
repro (the JAX package), compared whole; the reference loads nothing of the
program."""
import json
import subprocess
import sys

from perfbench import bench

ROOT = str(bench.ROOT)


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT}/src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _modules(
        "import json, sys\n"
        "from perfbench import harness\n"
        "from perfbench.tests import tiny\n"
        "for cell in ('command-r-plus-104b-l8.chat_1k_256', 'olmo-1b.pretrain_8x2k'):\n"
        "    harness.run(tiny.ctx(cell, seconds=0.3))\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert "repro_torch" in mods                       # the program did run
    assert bench.forbidden_loaded(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import json, sys\n"
                    "import perfbench.reference.dense_lm\n"
                    "print(json.dumps(sorted(sys.modules)))\n")
    assert not [m for m in mods if m.split(".")[0] == "repro_torch"]
    assert bench.forbidden_loaded(mods) == []


def test_the_harness_files_name_no_forbidden_package():
    for path in (bench.HERE).rglob("*.py"):
        text = path.read_text()
        for name in ("import jax", "from jax", "import repro\n", "from repro ", "from repro.",
                     "import repro.", "chip_smoke", "benchmarks"):
            if path.name == "test_pb_imports.py":
                continue
            assert name not in text, f"{path}: {name!r}"
