"""The port stands alone: no file of ``src/repro_torch/``, no
``examples/torch_*.py`` and not ``chip_smoke.py`` imports ``jax`` or anything of the ``repro`` package, and
no function of the port defaults to the CPU."""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for mod in _imports(tree):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_no_entry_point_defaults_to_cpu():
    """Every ``device`` default is ``cuda``; shape stand-ins
    (``shapes.input_specs``) may default to ``meta``, which allocates
    nothing and computes nothing."""
    seen = metas = 0
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = node.args.args + node.args.kwonlyargs
            defaults = ([None] * (len(node.args.args) - len(node.args.defaults))
                        + list(node.args.defaults) + list(node.args.kw_defaults))
            for arg, default in zip(args, defaults):
                if arg.arg != "device" or default is None:
                    continue
                seen += 1
                assert isinstance(default, ast.Constant) and default.value in ("cuda", "meta"), \
                    f"{path.name}:{node.name} device default"
                metas += default.value == "meta"
    assert seen >= 5 and metas == 1


def test_port_imports_without_cuda_or_triton():
    """Importing every module builds nothing: kernels compile at first use."""
    import importlib
    from repro_torch.kernels import common
    loaded = dict(common._LIBS)
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        importlib.import_module(".".join(parts))
    assert common._LIBS == loaded


LM_MODULES = ("repro_torch.models.components", "repro_torch.models.transformer",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.configs.base", "repro_torch.configs.chatglm3_6b",
              "repro_torch.launch.lm_decode", "repro_torch.convert",
              "repro_torch.train.optim", "repro_torch.data.lm",
              "repro_torch.ckpt.manager", "repro_torch.launch.steps",
              "repro_torch.launch.shapes", "repro_torch.launch.train")


def test_lm_modules_load_neither_jax_nor_the_reference():
    """A fresh interpreter importing the LM path (decode and training
    modules, every config through the registry) has loaded no ``jax``,
    nothing of ``repro`` and no ``ml_dtypes``."""
    code = ("import sys, importlib\n"
            f"for m in {LM_MODULES!r}: importlib.import_module(m)\n"
            "from repro_torch.configs import base\n"
            "base.all_assigned()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=ROOT, env={**__import__("os").environ,
                                  "PYTHONPATH": str(ROOT / "src")})
