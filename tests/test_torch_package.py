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
from photon_tpu_torch.ops import _build, probe_kernels
from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad
from photon_tpu_torch.ops.benes import benes_segment_grad, benes_xu_product, build_benes_aux
from photon_tpu_torch.ops.slab_reduce import (
    aligned_gather_products,
    aligned_segment_grad,
    build_aligned_layout,
    device_layout,
    position_partial_sums,
)
from photon_tpu_torch.ops.vperm import (
    build_xchg_aux,
    build_xchg_sorted_route,
    chunk_expand_pass,
    compensated_scan,
    chunk_pass,
    lane_pass,
    xchg_segment_grad,
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
        "want = {'photon_tpu_torch.tools.probe_common', 'photon_tpu_torch.tools.probe_permute',\n"
        "        'photon_tpu_torch.tools.probe_tiles', 'photon_tpu_torch.tools.probe_blocklocal',\n"
        "        'photon_tpu_torch.utils.env', 'photon_tpu_torch.ops.probe_kernels',\n"
        "        'photon_tpu_torch.serving.scorer', 'photon_tpu_torch.serving.fleet',\n"
        "        'photon_tpu_torch.serving.router', 'photon_tpu_torch.serving.traffic',\n"
        "        'photon_tpu_torch.serving.batcher', 'photon_tpu_torch.telemetry.report',\n"
        "        'photon_tpu_torch.telemetry.distributed', 'photon_tpu_torch.fault.retry',\n"
        "        'photon_tpu_torch.fault.injection', 'photon_tpu_torch.fault.watchdog',\n"
        "        'photon_tpu_torch.game.lowp', 'photon_tpu_torch.drivers.score_game',\n"
        "        'photon_tpu_torch.drivers.serve_game', 'photon_tpu_torch.data.streaming',\n"
        "        'photon_tpu_torch.data.stream_layouts', 'photon_tpu_torch.utils.caches',\n"
        "        'photon_tpu_torch.utils.io_pool', 'photon_tpu_torch.game.tiles',\n"
        "        'photon_tpu_torch.game.stream_descent', 'photon_tpu_torch.serving.transport',\n"
        "        'photon_tpu_torch.serving.netfault', 'photon_tpu_torch.serving.replica_proc',\n"
        "        'photon_tpu_torch.serving.supervisor'}\n"
        "assert want <= set(mods), sorted(want - set(mods))\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'photon_tpu', 'ml_dtypes')\n"
        "             or m.startswith(('jax.', 'photon_tpu.', 'ml_dtypes.')))\n"
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
                if top in ("photon_tpu", "jax", "jaxlib", "ml_dtypes"):
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


@pytest.mark.parametrize("driver", ["score_game", "serve_game"])
def test_serving_drivers_default_to_the_card(monkeypatch, tmp_path, driver):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"photon_tpu_torch.drivers.{driver}")
    args = mod.build_parser().parse_args([
        "--input", "synthetic-game:8:2:3:2", "--model", str(tmp_path / "m"),
        "--output-dir", str(tmp_path / "out"),
    ])
    assert args.backend == "gpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(args)


def test_streamed_train_game_defaults_to_the_card(monkeypatch, tmp_path):
    from photon_tpu_torch.drivers import train_game

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_game.build_parser().parse_args([
        "--input", "synthetic-game:8:4:3:2", "--stream-chunks", "5",
        "--coordinate", "fixed:type=fixed,shard=global",
        "--output-dir", str(tmp_path),
    ])
    assert args.backend == "gpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        train_game.run(args)


def test_cpu_tensors_take_the_plain_version():
    kernels = (fused_value_and_grad, position_partial_sums, chunk_pass,
               lane_pass, chunk_expand_pass, aligned_gather_products,
               compensated_scan)
    before = tuple(k.launches for k in kernels)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32, size=(64, 4)).astype(np.int32)
    vals = rng.standard_normal((64, 4)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (ids, vals)]
    fused_value_and_grad(
        get_loss("logistic"), torch.zeros(32), *t,
        torch.zeros(64), torch.zeros(64), torch.ones(64),
    )
    layout = build_aligned_layout(ids, vals, 32)
    al = device_layout(layout, "cpu")
    aligned_segment_grad(torch.ones(64), al, 32)
    aux = build_xchg_aux(layout, ids, vals=vals, device="cpu")  # K4 bake
    xchg_segment_grad(torch.ones(64), t[1], al, aux, 32)  # K6, K4, K2
    sorted_aux = build_xchg_sorted_route(ids, 32, device="cpu")  # cumsum's route
    xchg_segment_grad(torch.ones(64), t[1], None, sorted_aux, 32)  # K4, CS
    benes = build_benes_aux(layout, 64, 4, device="cpu")
    benes_xu_product(torch.ones(32), al, benes, 64, 4)  # K3
    benes_segment_grad(torch.ones(64), t[1], al, benes, 32)  # K2
    x = torch.zeros(64, 128)
    idx = torch.zeros(64, 128, dtype=torch.int32)
    probe_kernels.window_gather(x, idx, 128)  # PK1
    probe_kernels.lane_swap(x, x)  # PK2
    probe_kernels.copy_scale(x)  # PK3
    probe_kernels.tile_transpose(x, 32)  # PK4
    probe_kernels.fused_chunk(x, idx, idx.view(128, 64), idx, 64)  # PK5
    probe_kernels.sublane_gather(x, idx)  # PK6
    probe_kernels.lane_repeat(x[:, :4].contiguous(), 32)  # PK7
    kernels += probe_kernels.KERNELS
    before += (0,) * len(probe_kernels.KERNELS)
    assert tuple(k.launches for k in kernels) == before == (0,) * len(kernels)


def test_build_needs_nvcc_only_when_building(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    assert _build.sources() == [
        "compensated_scan", "fused_sparse", "position_reduce", "probes",
        "slab_gather", "vperm"]
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
