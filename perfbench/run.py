#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA devices as
the cell asks for (``BENCHMARK.json``). Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number the correctness check compares with its limit, which are also the
last lines of standard error. Exits non-zero, printing no result, where
there is no CUDA device or too few, where the program cannot be imported,
or where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.

The kernels are built into ``build/repro_torch`` inside the checkout, and
every other cache the run could write is pointed inside it too.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """The wall-clock time this process started (``/proc``), else the
    script's first line."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_START


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    t_process = min(process_start(), T_START)

    # one process, few threads: the host's launches are the decode path's
    # pace, and idle worker threads of the CPU's thread pools only contend
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from perfbench import bench
    try:
        ctx_cell = bench.cell(bench.benchmark(), a.workload)
    except (OSError, KeyError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < ctx_cell["chips"]:
        print(f"perfbench: the cell needs {ctx_cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program cannot be imported: {e}", file=sys.stderr)
        return 4

    from perfbench import harness
    ctx = harness.Ctx.of_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                              t_process=t_process)
    out = harness.run(ctx)
    loaded = bench.forbidden_loaded(sys.modules)
    if loaded:
        print(f"perfbench: modules that may not be loaded are: {loaded}", file=sys.stderr)
        return 5
    harness.report_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
