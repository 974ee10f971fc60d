"""Run an example of ``examples/`` (the JAX package's scripts) or of
``g2o_tpu_torch/examples`` in-process and compare what two runs print
(``g2o_tpu_torch.examples.output_difference``).

Imports neither JAX nor ``g2o_tpu`` at module level, so the card tests
(``tests/test_torch_cuda.py``) use it too."""

import contextlib
import importlib
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(pkg, name, args, cwd, device="cpu"):
    """``(return value, stdout)`` of example ``name``'s ``main`` run with
    ``args`` in directory ``cwd``: the JAX script with ``sys.argv``
    patched (``pkg="jax"``), or the port's with ``-device`` appended."""
    out = io.StringIO()
    old = os.getcwd(), list(sys.argv)
    os.chdir(cwd)
    try:
        if pkg == "jax":
            if ROOT not in sys.path:
                sys.path.insert(0, ROOT)
            import jax

            mod = importlib.import_module(f"examples.{name}")
            update = jax.config.update
            # bal_example turns on a compilation cache under /tmp for the
            # whole process; the comparison runs without it
            jax.config.update = lambda k, v: None \
                if k == "jax_compilation_cache_dir" else update(k, v)
            sys.argv = [f"{name}.py", *args]
            try:
                with contextlib.redirect_stdout(out):
                    ret = mod.main()
            finally:
                jax.config.update = update
        else:
            mod = importlib.import_module(f"g2o_tpu_torch.examples.{name}")
            with contextlib.redirect_stdout(out):
                ret = mod.main([*args, "-device", device])
    finally:
        os.chdir(old[0])
        sys.argv = old[1]
    return ret, out.getvalue()


def assert_same_output(got, want, rtol=1e-6, floor=1e-9):
    """``g2o_tpu_torch.examples.output_difference`` as an assertion."""
    from g2o_tpu_torch.examples import output_difference

    diff = output_difference(got, want, rtol, floor)
    assert diff is None, (diff, got, want)
