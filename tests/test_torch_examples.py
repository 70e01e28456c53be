"""The port's example scripts (``examples/torch_*.py``) run on the CPU, in this
process, with ``tests/test_examples.py``'s arguments for the JAX package's
twins; the train twin also resumes a directory that the JAX package's
``examples/train_e2e.py`` wrote."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _example(name):
    """``examples/<name>.py`` as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_runs(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert "quickstart OK" in capsys.readouterr().out
    assert out["serve_tokens"] == 24 and out["loss_after"] < out["losses"][0]


def test_serve_e2e_twin_runs(capsys):
    out = _example("torch_serve_e2e").main(
        ["--device", "cpu", "--requests", "5", "--slots", "2", "--max-new", "3",
         "--prompt-len", "8", "--max-seq", "32"])
    text = capsys.readouterr().out
    assert "SimFA-H800 split-KV decode prediction" in text
    assert "SimFA-H100 bf16 decode kernel plan" in text
    assert "tok/s on the CPU" in text and text.rstrip().endswith("serve_e2e OK")
    assert out["tokens"] == 15


def _train_args(ck):
    return ["--arch", "qwen2.5-3b", "--steps", "24", "--batch", "2", "--seq", "32",
            "--ckpt-every", "8", "--ckpt-dir", str(ck), "--log-every", "8"]


def _preempted(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv + ["--preempt-at", "10"])
    assert e.value.code == 17


def test_train_e2e_twin_preempts_and_resumes(tmp_path, capsys):
    twin = _example("torch_train_e2e")
    args = _train_args(tmp_path / "ck") + ["--device", "cpu"]
    _preempted(twin.main, args)
    assert "simulated preemption" in capsys.readouterr().out
    out = twin.main(args)
    text = capsys.readouterr().out
    assert "resumed from checkpoint step 8 (port layout" in text
    assert "done: 24 steps" in text
    assert out["start_step"] == 8 and len(out["losses"]) == 16


def test_train_e2e_twin_resumes_the_jax_example(tmp_path, capsys):
    """The JAX package's train example preempted at step 10 (its last checkpoint step
    8, in the JAX manager's layout); the twin resumes that directory and
    finishes."""
    ck = tmp_path / "ck"
    _preempted(_example("train_e2e").main, _train_args(ck))
    assert "simulated preemption" in capsys.readouterr().out
    out = _example("torch_train_e2e").main(_train_args(ck) + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "resumed from checkpoint step 8 (jax layout" in text
    assert "done: 24 steps" in text and out["start_step"] == 8


def test_train_e2e_twin_resumes_a_step_0(tmp_path, capsys):
    """A step 0 (what a ``--steps 0`` run saves: its init) is resumed, not
    replaced by the run's own init: a seed-1 init saved at step 0 and resumed
    by a seed-0 run trains as a seed-1 run does."""
    twin = _example("torch_train_e2e")

    def run(ck, *extra):
        return twin.main(["--arch", "qwen2.5-3b", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", str(tmp_path / ck), "--device", "cpu", *extra])

    assert run("resumed", "--steps", "0", "--seed", "1")["losses"] == []
    out = run("resumed", "--steps", "2")
    assert "resumed from checkpoint step 0 (port layout" in capsys.readouterr().out
    assert out["start_step"] == 0
    assert out["losses"] == run("seed_1", "--steps", "2", "--seed", "1")["losses"]
