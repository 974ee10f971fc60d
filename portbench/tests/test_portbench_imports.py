"""What a run loads: no JAX and no JAX package in the process, and nothing
of the port in the reference."""

import ast
import glob
import json
import os
import subprocess
import sys

import _tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "g2o_tpu"}

DRY = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import bench
out = bench.run_cell(sys.argv[2], "venice1778.cold", 11, 0.0, True, "cpu")
print(json.dumps(dict(correct=out["correct"],
                      tops=sorted({m.split(".")[0] for m in sys.modules}),
                      forbidden=bench.forbidden_modules())))
"""


def test_a_run_loads_no_jax(tmp_path):
    root = _tiny.make_root(tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", DRY, _tiny.ROOT, root],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "g2o_tpu_torch" in out["tops"] and "torch" in out["tops"]
    # the part before the first dot, compared whole
    assert not FORBIDDEN & set(out["tops"]), out["tops"]
    assert out["forbidden"] == []


def _imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(_tiny.ROOT, "portbench", "reference",
                                   "*.py"))
    assert files
    for path in files:
        tops = set(_imported_tops(path))
        assert not tops & (FORBIDDEN | {"g2o_tpu_torch"}), (path, tops)
        assert tops <= {"__future__", "math", "typing", "torch",
                        "portbench"}, (path, tops)
