"""The hand-over of parameters between the two packages, and the port's
isolation: it imports torch only, and its entry points refuse to run without a
card unless the CPU is asked for."""
import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro_torch import compat
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi

from test_torch_models import numpy_params


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmo-1b", "llama3-8b", "minicpm-2b"])
def test_converter_round_trip(arch):
    cj, ct = jregistry.get(arch).reduced(), tregistry.get(arch).reduced()
    tree = numpy_params(cj, 0)
    pt = compat.params_from_jax(ct, tree, device="cpu")
    assert len(pt["blocks"]) == ct.num_layers
    wq = np.asarray(tree["blocks"]["attn"]["wq"]["w"])
    assert wq.shape[0] == ct.num_layers
    for i in range(ct.num_layers):       # layer i of the stack, not transposed
        np.testing.assert_array_equal(pt["blocks"][i]["attn"]["wq"]["w"].numpy(), wq[i])
    assert ("unembed" in pt) == (not ct.tie_embeddings)
    back = compat.params_to_jax(ct, pt)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the converter copies: the port's tensors do not alias the numpy arrays
    pt["emb"]["table"][0, 0] += 1.0
    assert np.asarray(tree["emb"]["table"])[0, 0] != float(pt["emb"]["table"][0, 0])


def test_jax_initialised_weights_cross_over():
    """Weights made by the JAX package's own init serve both sides."""
    cj = dataclasses.replace(jregistry.get("qwen2.5-3b").reduced(), compute_dtype="bfloat16")
    ct = tregistry.get("qwen2.5-3b").reduced()
    pj = japi.init(cj, jax.random.PRNGKey(0))
    pt = compat.params_from_jax(ct, jax.tree.map(np.asarray, pj), device="cpu")
    toks = np.random.default_rng(0).integers(0, ct.vocab_size, (1, 7))
    hj, _ = japi.prefill(cj, pj, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        ht, _ = tapi.prefill(ct, pt, {"tokens": torch.from_numpy(toks)})
    # bf16 compute through two layers, rounded at other places in the two frameworks
    np.testing.assert_allclose(ht.float().numpy(), np.asarray(hj, np.float32),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch", sorted(tregistry.ARCHS))
def test_configs_are_equal_copies(arch):
    cj, ct = jregistry.get(arch), tregistry.get(arch)
    assert type(cj) is not type(ct)                      # a copy, not a re-export
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert dataclasses.asdict(cj.reduced()) == dataclasses.asdict(ct.reduced())
    assert cj.param_count() == ct.param_count()
    assert cj.active_param_count() == ct.active_param_count()


def test_config_registry_and_workloads_are_equal_copies():
    from repro.configs import llama3 as jl
    from repro_torch.configs import llama3 as tl
    assert list(jregistry.ARCHS) == list(tregistry.ARCHS)
    assert jregistry.ASSIGNED == tregistry.ASSIGNED
    assert [(c.name, s.name, ok, why) for c, s, ok, why in jregistry.cells()] == \
           [(c.name, s.name, ok, why) for c, s, ok, why in tregistry.cells()]
    assert dataclasses.asdict(jl.workload("70B", 2048, batch=2, causal=True)) == \
           dataclasses.asdict(tl.workload("70B", 2048, batch=2, causal=True))
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get("no-such-arch")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        need = {"repro_torch.compat", "repro_torch.configs.registry", "repro_torch.models.layers",
                "repro_torch.models.attention", "repro_torch.models.transformer",
                "repro_torch.models.api", "repro_torch.kernels.ref", "repro_torch.kernels.ops",
                "repro_torch.kernels._build", "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.flash_decode", "repro_torch.serve.decode",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.core.simfa", "repro_torch.core.engine",
                "repro_torch.core.kprog.registry", "repro_torch.analysis.dag",
                "repro_torch.obs.counters", "repro_torch.faults.watchdog"}
        missing = need - set(names)
        assert not missing, missing
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "jaxlib"
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        assert "triton" not in sys.modules
        print("imported", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_cuda_is_the_default_and_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cfg = tregistry.get("qwen2.5-3b").reduced()
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_cache(cfg, 1, 8)
    params = tapi.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    assert tapi.resolve_device("cpu") == torch.device("cpu")


def test_params_from_jax_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    cj, ct = jregistry.get("qwen2.5-3b").reduced(), tregistry.get("qwen2.5-3b").reduced()
    tree = numpy_params(cj, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.params_from_jax(ct, tree)
    pt = compat.params_from_jax(ct, tree, device="cpu")
    assert pt["emb"]["table"].device == torch.device("cpu")


def test_kernel_build_without_a_compiler_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_libs", {})
    import os
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(_build.NvccError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert _build.build_dir() == tmp_path / "b"
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "flash_fwd")
    _build.check(0, "flash_fwd")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import pathlib
    script = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    src = script.read_text()
    assert "import jax" not in src and "from repro." not in src and "import repro\n" not in src
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
