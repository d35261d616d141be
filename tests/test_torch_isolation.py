"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
reference package, and its entry points run on CUDA or raise."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.net import fastsim, loopsim
from repro_torch.net.topology import FatTree
from repro_torch.net import workloads
from repro_torch.core import lb_schemes as lbs
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import Model
from repro_torch.serve import batching, serve_step

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_without_jax_or_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any import of jax now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro.")
                        or (m.startswith("jax") and sys.modules[m] is not None))
        assert not leaked, leaked
        assert "repro_torch.net.fastsim" in names, names
        assert "repro_torch.kernels.jsq_scan.ops" in names, names
        for name in ("repro_torch.net.loopsim",
                     "repro_torch.kernels.slot_step.ops",
                     "repro_torch.kernels.slot_step.kernel",
                     "repro_torch.kernels.slot_step.ref",
                     "repro_torch.core.entropy",
                     "repro_torch.faults.schedule",
                     "repro_torch.phases.schedule",
                     "repro_torch.collectives.planner",
                     "repro_torch.core.theory",
                     "repro_torch.configs.base",
                     "repro_torch.configs.deepseek_v3_671b",
                     "repro_torch.kernels.flash_attn.ops",
                     "repro_torch.kernels.flash_attn.kernel",
                     "repro_torch.kernels.flash_attn.ref",
                     "repro_torch.models.layers",
                     "repro_torch.models.transformer",
                     "repro_torch.models.registry",
                     "repro_torch.serve.serve_step",
                     "repro_torch.serve.batching",
                     "repro_torch.launch.serve",
                     "repro_torch.kernels.ssd_scan.ops",
                     "repro_torch.kernels.ssd_scan.kernel",
                     "repro_torch.kernels.ssd_scan.ref",
                     "repro_torch.models._params",
                     "repro_torch.models.mamba2",
                     "repro_torch.models.hybrid",
                     "repro_torch.interop",
                     "repro_torch.core.retry",
                     "repro_torch.obs.log",
                     "repro_torch.obs.trace",
                     "repro_torch.obs.report",
                     "repro_torch.sweep.spec",
                     "repro_torch.sweep.planner",
                     "repro_torch.sweep.costmodel",
                     "repro_torch.sweep.results",
                     "repro_torch.sweep.compile_cache",
                     "repro_torch.sweep.runner",
                     "repro_torch.sweep.__main__"):
            assert name in names, name
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 81


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    tree = FatTree(4)
    wl = workloads.permutation(tree, 4, np.random.default_rng(0))
    s = lbs.host_pkt()
    with pytest.raises(RuntimeError, match="CUDA"):
        fastsim.simulate(tree, wl, s)
    with pytest.raises(RuntimeError, match="CUDA"):
        fastsim.simulate_batch(tree, wl, s, [0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        fastsim.simulate_megabatch([(tree, wl, s, [0], None)])
    with pytest.raises(RuntimeError, match="CUDA"):
        fastsim.simulate(tree, wl, s, device="cuda")
    cfg = loopsim.LoopConfig(max_slots=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        loopsim.simulate(tree, wl, s, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        loopsim.simulate_batch(tree, wl, s, [0, 1], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        loopsim.simulate_megabatch([(tree, wl, s, cfg, [0], None, None)])


def test_serving_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    model = Model(get_config("yi-6b", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(0)
    params = model.init_params(0, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_step.greedy_decode(model, params, prompt, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_step.zero_cache(model, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        batching.ContinuousBatcher(model, params, n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "yi-6b", "--smoke"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_serving_entry_points_raise_without_a_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    model = Model(get_config(arch, smoke=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(0)
    params = model.init_params(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_step.greedy_decode(model, params, np.zeros((1, 4), np.int32), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_step.zero_cache(model, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        batching.ContinuousBatcher(model, params, n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", arch, "--smoke"])
