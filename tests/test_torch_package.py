"""Package rules of the PyTorch port: it never imports jax or photon_tpu,
it runs on CUDA unless asked for the CPU, and CPU tensors take the kernels'
plain versions without counting a launch."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_tpu_torch.core.losses import get_loss
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.ops import _build
from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad
from photon_tpu_torch.ops.slab_reduce import (
    aligned_segment_grad,
    build_aligned_layout,
    device_layout,
    position_partial_sums,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "photon_tpu_torch")


def _port_files():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, git-ignored
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import photon_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'photon_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'photon_tpu.')) or m == 'photon_tpu')\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_source_imports_photon_tpu_or_jax():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("photon_tpu", "jax", "jaxlib"):
                    offenders.append(f"{path}: {name}")
    assert not offenders, offenders


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from photon_tpu_torch.drivers import train

    args = train.build_parser().parse_args([
        "--input", os.path.join(ROOT, "tests", "fixtures", "a1a.libsvm"),
        "--output-dir", str(tmp_path),
    ])
    assert args.backend == "gpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(args)


def test_cpu_tensors_take_the_plain_version():
    before = (fused_value_and_grad.launches, position_partial_sums.launches)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32, size=(64, 4)).astype(np.int32)
    vals = rng.standard_normal((64, 4)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (ids, vals)]
    fused_value_and_grad(
        get_loss("logistic"), torch.zeros(32), *t,
        torch.zeros(64), torch.zeros(64), torch.ones(64),
    )
    al = device_layout(build_aligned_layout(ids, vals, 32), "cpu")
    aligned_segment_grad(torch.ones(64), al, 32)
    assert (fused_value_and_grad.launches, position_partial_sums.launches) == before == (0, 0)


def test_build_needs_nvcc_only_when_building(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    assert _build.sources() == ["fused_sparse", "position_reduce"]
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
