"""What the benchmark loads: no JAX, no JAX package; the reference none of
the program.  Each check runs in a fresh interpreter, since a test
session may hold modules of its own."""

import ast
import json
import subprocess
import sys

from benchmark.harness import FORBIDDEN_MODULES, ROOT, Bench

PACKAGE = ROOT / "benchmark"


def _loaded_after(code: str) -> list:
    probe = code + ("\nimport sys, json\n"
                    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _benchmark_modules() -> list:
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PACKAGE.rglob("*.py")
                  if "tests" not in p.parts and "metrics" not in p.parts)


def test_nothing_the_benchmark_runs_loads_jax():
    # every module of the benchmark, every metric reader, and the program's
    # modules the drivers import
    readers = [str(p) for p in (PACKAGE / "metrics").glob("*.py")]
    code = "\n".join(
        [f"import {m}" for m in _benchmark_modules()]
        + ["import runpy", f"for p in {readers!r}: runpy.run_path(p)"]
        + ["import protoclip_tpu_torch.train.runner, protoclip_tpu_torch.memory.banks",
           "import protoclip_tpu_torch.data.loader, protoclip_tpu_torch.cli.ros_node",
           "import protoclip_tpu_torch.toolkit.classifier, protoclip_tpu_torch.cli.serve",
           "import protoclip_tpu_torch.cli.export, protoclip_tpu_torch.io.export"])
    loaded = _loaded_after(code)
    assert "protoclip_tpu_torch" in loaded  # the whole name is no forbidden one
    assert not [m for m in loaded if m in FORBIDDEN_MODULES]


def test_forbidden_names_are_compared_whole():
    from benchmark import harness

    sys.modules.setdefault("protoclip_tpu_torch_probe", type(sys)("protoclip_tpu_torch_probe"))
    try:
        assert "protoclip_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["protoclip_tpu_torch_probe"]


def test_the_reference_imports_nothing_of_the_program():
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in (PACKAGE / "reference").glob("*.py"))
    loaded = _loaded_after("\n".join(f"import {m}" for m in modules))
    assert "protoclip_tpu_torch" not in loaded
    assert not [m for m in loaded if m in FORBIDDEN_MODULES]
    for path in (PACKAGE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        banned = FORBIDDEN_MODULES + ("protoclip_tpu_torch",)
        assert not [n for n in names if n.split(".")[0] in banned], path


def test_load_generator_imports_no_torch():
    loaded = _loaded_after("import benchmark.drivers.loadgen")
    assert "torch" not in loaded


def test_run_exits_nonzero_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          Bench().spec["workloads"][0]["name"], "--seed", "2147483700",
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          Bench().spec["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    # past the look for a card, the program is what is missing
    past = subprocess.run([sys.executable, "-c", "import time; from benchmark import harness; "
                           f"harness.run_cell({Bench().spec['workloads'][0]['name']!r}, 1, 1.0, "
                           "False, t0=time.perf_counter(), device='cpu')"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert past.returncode != 0
    assert "No module named 'protoclip_tpu_torch'" in past.stderr
