"""Parallel what-if sweep driver: workloads x machines x knob grids.

One cycle simulation is paid per (workload, machine) point — recorded with
events — then every knob point is answered by DAG replay, which is orders of
magnitude cheaper than re-simulation (the ROADMAP "speed" axis: replay
instead of resimulate).  (workload, machine) points fan out over per-point
worker processes, and finished points are cached as JSON keyed by a hash of
the full configuration, so an interrupted or extended sweep only pays for
new points.

Crash-proofing (docs/robustness.md):

  * **per-point workers** — every point runs in its own ``mp.Process`` with
    a pipe back to the parent, so one crashing / OOM-killed / hanging point
    cannot take down the rest of the sweep (the old shared ``mp.Pool``
    died wholesale);
  * **timeouts + retry with exponential backoff** — a point that exceeds
    ``timeout_s`` is terminated and retried (``retries`` times, waiting
    ``backoff_s * 2**attempt`` between attempts); a point that exhausts its
    retries raises :class:`SweepError` *after* every completed point has
    already been flushed;
  * **incremental atomic cache flush** — each point's rows are written to
    its cache file the moment the point completes (temp file + ``os.replace``
    via ``repro_torch.utils.ioutil``), not at sweep end, so a killed sweep loses
    at most in-flight points;
  * **corrupt-cache quarantine** — a truncated/invalid cache file is moved
    aside to ``<name>.corrupt`` and the point recomputed, instead of the
    whole sweep dying on ``json.JSONDecodeError``.

Hierarchical-fidelity points record the first-wave engine; the replay ratio
(predicted / measured wave makespan) is applied to the composed total, which
keeps the wave-composition arithmetic of ``simulate_fa3`` intact.

Cache files carry an ``obs.manifest`` provenance stamp (``{"manifest": ...,
"rows": [...]}``); the hash key deliberately covers only the *configuration*
(workload, machine, fidelity, kernel, knob grid), not the code version — a
stale cache written by older simulator code is still served, but the
manifest's git sha makes that auditable (see docs/analysis.md).  Bare-list
cache files from before the stamp are still read.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.whatif import Knobs
from repro_torch.utils.ioutil import atomic_write_json


class SweepError(RuntimeError):
    """A sweep point failed permanently (all retries exhausted).  Every
    *other* completed point has already been flushed to the cache, so the
    re-run only pays for the failed point."""


@dataclass(frozen=True)
class SweepPoint:
    """One (workload, machine) cell of the sweep, before knob expansion."""
    workload: object            # AttnWorkload (frozen dataclass, picklable)
    machine: object             # GPUMachine (frozen dataclass, picklable)
    fidelity: str = "auto"
    n_sub: int = 8
    kernel: str = "fa3"         # registered kernel program name
    mem_fidelity: Optional[str] = None  # engine memory model override
                                        # (None = let fidelity decide)


def _key(point: SweepPoint, grid: Sequence[Knobs]) -> str:
    blob = json.dumps([asdict(point.workload), asdict(point.machine),
                       point.fidelity, point.n_sub, point.kernel,
                       point.mem_fidelity,
                       [asdict(k) for k in grid]], sort_keys=True)
    return hashlib.md5(blob.encode()).hexdigest()[:16]


def _sweep_one(args) -> List[Dict]:
    """Worker: one cycle simulation + a full knob-grid replay."""
    point, grid = args
    from repro_torch.analysis import dag as dag_mod
    from repro_torch.analysis import whatif
    from repro_torch.core.simfa import simulate_fa3

    t0 = time.perf_counter()
    eopts = {"mem_fidelity": point.mem_fidelity} if point.mem_fidelity else None
    base = simulate_fa3(point.workload, point.machine, fidelity=point.fidelity,
                        n_sub=point.n_sub, record_events=True,
                        kernel=point.kernel, engine_opts=eopts)
    sim_s = time.perf_counter() - t0
    dag = dag_mod.build(base.trace.events, base.trace.dispatch_parent)
    rows = []
    for knobs in grid:
        r = whatif.replay(dag, knobs)
        ratio = r.makespan / max(dag.makespan, 1)
        pred_cycles = base.cycles * ratio
        rows.append({
            "workload": point.workload.name,
            "machine": point.machine.name,
            "kernel": point.kernel,
            "fidelity": base.fidelity,
            "mem_fidelity": base.mem_fidelity,
            "knobs": asdict(knobs),
            "knobs_label": knobs.label(),
            "base_cycles": base.cycles,
            "base_us": base.latency_us,
            "pred_cycles": pred_cycles,
            "pred_us": pred_cycles / (point.machine.freq_ghz * 1e3),
            "speedup": base.cycles / max(pred_cycles, 1e-9),
            "sim_s": sim_s,
            "replay_s": r.replay_s,
        })
    return rows


# ---------------------------------------------------------------------------
# cache I/O (atomic writes, quarantined reads)
# ---------------------------------------------------------------------------

def _cache_path(cache_dir: str, point: SweepPoint,
                grid: Sequence[Knobs]) -> str:
    return os.path.join(cache_dir, f"whatif_{_key(point, grid)}.json")


def _load_cache(path: str) -> Optional[List[Dict]]:
    """Read one cache file; quarantine and miss on any corruption.

    A torn write (pre-atomic-write artifacts), a truncated disk, or a
    schema from some future refactor must cost one recompute, never the
    sweep: the bad file is renamed to ``<path>.corrupt`` (atomic, same
    directory) so it stays inspectable without being re-read forever."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
        # stamped format is {"manifest": ..., "rows": [...]};
        # pre-manifest caches were bare row lists
        rows = payload["rows"] if isinstance(payload, dict) else payload
        if not isinstance(rows, list):
            raise KeyError("rows")
        return rows
    except (json.JSONDecodeError, KeyError, UnicodeDecodeError, OSError):
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        return None


def _flush_point(cache_dir: str, point: SweepPoint, grid: Sequence[Knobs],
                 rows: List[Dict]) -> None:
    from repro_torch.obs.manifest import build_manifest
    os.makedirs(cache_dir, exist_ok=True)
    manifest = build_manifest(
        machine=point.machine, workload=point.workload,
        kernel=point.kernel, fidelity=point.fidelity,
        mem_fidelity=(rows[0].get("mem_fidelity") if rows
                      else point.mem_fidelity),
        extra={"grid_points": len(grid)})
    atomic_write_json(_cache_path(cache_dir, point, grid),
                      {"manifest": manifest, "rows": rows})


# ---------------------------------------------------------------------------
# per-point worker processes
# ---------------------------------------------------------------------------

def _point_main(conn, worker: Callable, args) -> None:
    """Child entry: run one point, ship ("ok", rows) or ("err", msg) back.
    Any uncaught explosion (or a kill -9) simply leaves the pipe without a
    result — the parent treats both identically as a crashed attempt."""
    try:
        rows = worker(args)
    except BaseException as e:          # noqa: BLE001 — crash isolation
        try:
            conn.send(("err", f"{type(e).__name__}: {e}"))
        except Exception:
            pass
        os._exit(1)
    try:
        conn.send(("ok", rows))
        conn.close()
    except Exception:
        os._exit(1)
    os._exit(0)


def run_sweep(points: Sequence[SweepPoint], grid: Sequence[Knobs], *,
              processes: Optional[int] = None,
              cache_dir: Optional[str] = None,
              timeout_s: Optional[float] = None,
              retries: int = 2,
              backoff_s: float = 0.5,
              worker: Optional[Callable] = None) -> List[Dict]:
    """Run the sweep; ``processes<=1`` runs serially (tests, small sweeps).

    With ``cache_dir`` set, each (workload, machine, grid) cell is read
    from / written to ``<cache_dir>/<hash>.json`` — incrementally (each
    point flushes on completion) and atomically (temp file + rename), with
    corrupted cache files quarantined to ``<name>.corrupt`` and recomputed.

    ``timeout_s`` bounds each point's wall time (parallel mode; the child
    is terminated on expiry).  Crashed or timed-out points are retried up
    to ``retries`` extra times with exponential backoff (``backoff_s *
    2**attempt``); a point failing every attempt raises :class:`SweepError`
    after all other points finished and flushed.  ``worker`` overrides the
    per-point function (tests inject crashy/fast workers); it must accept
    ``(point, grid)`` and return a row list."""
    grid = list(grid)
    worker = worker or _sweep_one
    results: List[Optional[List[Dict]]] = [None] * len(points)
    todo: List[int] = []
    for i, point in enumerate(points):
        if cache_dir:
            cached = _load_cache(_cache_path(cache_dir, point, grid))
            if cached is not None:
                results[i] = cached
                continue
        todo.append(i)

    if todo:
        if processes is None:
            processes = min(len(todo), os.cpu_count() or 1)
        # serial only when explicitly requested (processes<=1): a lone todo
        # point under processes>1 still gets a worker process, because the
        # process boundary is what timeout kill / crash isolation hang on
        if processes <= 1:
            _run_serial(points, grid, todo, results, cache_dir, worker,
                        retries, backoff_s)
        else:
            _run_parallel(points, grid, todo, results, cache_dir, worker,
                          processes, timeout_s, retries, backoff_s)

    return [row for rows in results for row in rows]


def _run_serial(points, grid, todo, results, cache_dir, worker,
                retries, backoff_s) -> None:
    for i in todo:
        last = None
        for attempt in range(retries + 1):
            if attempt:
                time.sleep(backoff_s * 2 ** (attempt - 1))
            try:
                rows = worker((points[i], grid))
                break
            except Exception as e:      # in-process retry (no isolation)
                last = e
        else:
            raise SweepError(
                f"sweep point {i} ({points[i].workload.name} on "
                f"{points[i].machine.name}) failed after {retries + 1} "
                f"attempts: {last}") from last
        results[i] = rows
        if cache_dir:
            _flush_point(cache_dir, points[i], grid, rows)


def _run_parallel(points, grid, todo, results, cache_dir, worker,
                  processes, timeout_s, retries, backoff_s) -> None:
    """Per-point process scheduler with kill-on-timeout and backoff retry.

    ``waiting`` holds ``(index, attempt, not_before)`` triples (backoff is
    enforced by the ``not_before`` wall-clock stamp, without blocking other
    points); ``running`` maps index -> live child.  A child that dies
    without delivering rows — crash, ``os._exit``, kill — counts exactly
    like a timeout: terminate (if needed), back off, retry."""
    ctx = mp.get_context()
    waiting: List[Tuple[int, int, float]] = [(i, 0, 0.0) for i in todo]
    running: Dict[int, Tuple] = {}      # idx -> (proc, conn, attempt, t0)
    failures: List[str] = []

    def _reap(idx: int, ok: bool, payload) -> None:
        proc, conn, attempt, _t0 = running.pop(idx)
        conn.close()
        if ok:
            results[idx] = payload
            if cache_dir:
                _flush_point(cache_dir, points[idx], grid, payload)
            return
        if attempt < retries:
            delay = backoff_s * 2 ** attempt
            waiting.append((idx, attempt + 1, time.monotonic() + delay))
        else:
            failures.append(
                f"sweep point {idx} ({points[idx].workload.name} on "
                f"{points[idx].machine.name}) failed after "
                f"{retries + 1} attempts: {payload}")

    while waiting or running:
        now = time.monotonic()
        # launch due points into free slots
        ready = [w for w in waiting if w[2] <= now]
        for w in sorted(ready, key=lambda t: t[0]):
            if len(running) >= processes:
                break
            waiting.remove(w)
            idx, attempt, _ = w
            parent, child = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_point_main,
                               args=(child, worker, (points[idx], grid)),
                               daemon=True)
            proc.start()
            child.close()
            running[idx] = (proc, parent, attempt, now)
        # collect finished / crashed / overdue children
        progressed = False
        for idx in list(running):
            proc, conn, attempt, t0 = running[idx]
            if conn.poll():
                try:
                    status, payload = conn.recv()
                except (EOFError, OSError):
                    # EOF with no message: the child died (crash / exit /
                    # kill) before delivering rows
                    status, payload = "err", "worker died without delivering rows"
                proc.join(timeout=5)
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
                _reap(idx, status == "ok", payload)
                progressed = True
            elif not proc.is_alive():
                proc.join()
                _reap(idx, False,
                      f"worker died (exit code {proc.exitcode}) before "
                      f"delivering rows")
                progressed = True
            elif timeout_s is not None and time.monotonic() - t0 > timeout_s:
                proc.terminate()
                proc.join()
                _reap(idx, False, f"timed out after {timeout_s} s")
                progressed = True
        if not progressed and (running or waiting):
            time.sleep(0.02)

    if failures:
        raise SweepError("; ".join(failures))


def knob_grid(tma_bw=(1.0,), wgmma=(1.0,), softmax=(1.0,)) -> List[Knobs]:
    """Cartesian grid over per-resource multipliers."""
    return [Knobs(tma_bw=t, wgmma=w, softmax=s)
            for t in tma_bw for w in wgmma for s in softmax]
