"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the GPU unless the caller names the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import quickwit_tpu_torch
from quickwit_tpu_torch.common.uri import Uri
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.index.synthetic import (
    HDFS_MAPPER, synthetic_hdfs_split)
from quickwit_tpu_torch.query.ast import Term
from quickwit_tpu_torch.search.executor import execute_plan
from quickwit_tpu_torch.search.leaf import (
    leaf_search_single_split, prepare_plan_only, warmup_device_arrays)
from quickwit_tpu_torch.search.models import SearchRequest
from quickwit_tpu_torch.storage.ram import RamStorage

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "quickwit_tpu_torch"


def _all_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        quickwit_tpu_torch.__path__, "quickwit_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    modules = _all_modules()
    assert "quickwit_tpu_torch.search.leaf" in modules
    assert "quickwit_tpu_torch.ops.kernels.score_topk" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'quickwit_tpu.'))\n"
        "             or m == 'quickwit_tpu')\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "quickwit_tpu"}, roots


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = RamStorage(Uri.parse("ram:///iso"))
    storage.put("s.split", synthetic_hdfs_split(2048, seed=1))
    reader = SplitReader(storage, "s.split")
    request = SearchRequest(index_ids=["hdfs-logs"],
                            query_ast=Term("severity_text", "ERROR"),
                            max_hits=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        leaf_search_single_split(request, HDFS_MAPPER, reader, "s")
    plan = prepare_plan_only(request, HDFS_MAPPER, reader, "s")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warmup_device_arrays(reader, plan)
    arrays, staged = warmup_device_arrays(reader, plan, device="cpu")
    assert staged == sum(a.nbytes for a in plan.arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_plan(plan, 10, arrays)
    # a warm reader stages nothing the second time
    assert warmup_device_arrays(reader, plan, device="cpu")[1] == 0
    resp = leaf_search_single_split(request, HDFS_MAPPER, reader, "s",
                                    device="cpu")
    assert resp.num_hits > 0
