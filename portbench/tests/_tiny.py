"""A copy of the benchmark at tiny sizes in a scratch root, for runs of the
harness on the CPU."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = dict(cameras=12, points=300, observations=1600)
# where float32's and TF32's rounding part as far as at the cells' sizes
SMALL = dict(cameras=40, points=6000, observations=33000)
SEED = 2 ** 31 + 12345


def config(base, sizes=None, **over):
    with open(os.path.join(ROOT, "portbench", "configs", base + ".json")) as f:
        cfg = json.load(f)
    cfg.update(sizes or TINY, **over)
    return cfg


def traffic(name="cold"):
    with open(os.path.join(ROOT, "portbench", "traffic", name + ".json")) as f:
        return json.load(f)


def make_root(tmp, sizes=None):
    """``tmp`` holding BENCHMARK.json and portbench/, every configuration
    cut to ``sizes`` (``TINY``); returns the root."""
    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        name = os.path.basename(c["file"])[:-len(".json")]
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(config(name, sizes), f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
