"""Generate a sphere pose-graph dataset — port of
``examples/create_sphere.py``, the analogue of the reference
``examples/sphere/create_sphere.cpp``: poses on a sphere connected by
odometry and level-crossing loop closures, written as a ``.g2o`` file.
The graph is built and written on the host; ``-device`` is accepted and
has nothing to place.

Run: python -m g2o_tpu_torch.examples.create_sphere out.g2o
     [nodes_per_level] [laps]
"""

import sys

from g2o_tpu_torch.examples import split_device


def main(argv=None):
    _, args = split_device(argv)
    out = args[0] if len(args) > 0 else "sphere.g2o"
    npl = int(args[1]) if len(args) > 1 else 50
    laps = int(args[2]) if len(args) > 2 else 50

    import g2o_tpu_torch.types  # noqa: F401  (register tags)
    from g2o_tpu_torch.io import g2o_format
    from g2o_tpu_torch.sim.generators import create_sphere

    g = create_sphere(nodes_per_level=npl, laps=laps, radius=100.0, seed=0)
    g2o_format.save(g, out)
    print(f"wrote {out}: {len(g.vertices())} vertices, "
          f"{len(g.edges())} edges")
    return 0


if __name__ == "__main__":
    sys.exit(main())
