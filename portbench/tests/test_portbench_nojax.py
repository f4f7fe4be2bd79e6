"""A run loads neither JAX nor the JAX package: the harness and a tiny CPU
cell, imported and run in a fresh process, leave no module whose whole
top-level name is jax, jaxlib, flax or rakau_tpu (rakau_tpu_torch is no
match); and the harness alone in an empty checkout gives no result."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests import tiny
r = tiny.run("plummer8m.query")
print(json.dumps({{"correct": r["correct"],
                  "loaded": harness.forbidden_modules(),
                  "torch_port": "rakau_tpu_torch" in sys.modules}}))
"""


def test_no_jax_after_a_run():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=str(ROOT))],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r == {"correct": True, "loaded": [], "torch_port": True}


def test_the_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "rakau_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtools", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rakau_tpu.engine", sys)
    assert harness.forbidden_modules() == ["rakau_tpu.engine"]


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "plummer8m.query", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
