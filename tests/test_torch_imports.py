"""Import hygiene of the port: ``protoclip_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and nothing imports ``triton`` at
module level (this CPU-only environment has no triton; kernels build and
import their toolchains inside the functions that launch them)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "protoclip_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "protoclip_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node, node.module


def _module_level(tree):
    """Import nodes that run when the module is imported (outside any
    function or class body)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def test_port_has_files():
    assert len(PORT_FILES) > 20
    rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("ops/block_variants.py", "scripts/bench_block_variants.py", "ops/kernels.py",
                   "models/resnet.py", "io/checkpoint.py", "io/mat.py", "memory/cache.py",
                   "data/types.py", "data/splits.py", "data/builders.py", "data/registry.py",
                   "data/loader.py", "core/config.py", "obs/logging.py", "obs/plots.py",
                   "train/runner.py", "cli/main.py", "ops/losses.py", "train/optim.py",
                   "train/episodic.py", "train/resume.py", "train/qt.py",
                   "train/qt_runner.py", "data/query.py", "__main__.py",
                   "toolkit/__init__.py", "toolkit/classifier.py", "toolkit/ood.py",
                   "toolkit/tsne.py", "toolkit/robot.py", "toolkit/paper_figures.py",
                   "toolkit/speech.py", "toolkit/ros_utils.py", "toolkit/ros_nodes.py",
                   "cli/ood.py", "cli/tsne.py", "cli/transcribe.py", "cli/ros_node.py",
                   "toolkit/microbatch.py", "obs/profiler.py", "io/export.py", "cli/export.py",
                   "cli/serve.py", "client.py", "native/__init__.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/sharding.py", "parallel/dryrun.py",
                   "models/encoder.py", "io/download.py", "scripts/_env.py",
                   "scripts/validate_experiment.py", "scripts/validate_accuracy.py",
                   "examples/__init__.py", "examples/train_quickstart.py",
                   "examples/serving_quickstart.py", "scripts/validate_bundle.py",
                   "scripts/bench_serve_http.py", "scripts/bench_int8_peak.py",
                   "scripts/bench_rn50_int8.py", "scripts/bench_episodic_sharding.py"):
        assert "protoclip_tpu_torch/" + module in rel, module
    assert (REPO / "protoclip_tpu_torch" / "native" / "preprocess.cpp").is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_module_level_triton(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node, name in _imported_modules(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"
    top = set(map(id, _module_level(tree)))
    for node, name in _imported_modules(tree):
        if name.split(".")[0] == "triton":
            assert id(node) not in top, f"{path.name}:{node.lineno} imports triton at module level"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import protoclip_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'protoclip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'protoclip_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('protoclip_tpu_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split("\n")[-2]
    n_modules, bad = out.split(" ", 1)
    assert bad == "[]", bad
    assert int(n_modules) > 20


def test_python_m_package_runs_the_cli():
    """``python -m protoclip_tpu_torch`` is the runner's CLI (``cli/main.py``)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "protoclip_tpu_torch", "--help"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "--only_test" in out.stdout and "--device" in out.stdout
