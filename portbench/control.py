"""Readings that set the limits of the judgement (not part of a run).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--program --seconds 5 | --trials [--faults a,b]]

By default: the control, the plain reference put in the port's place at
TF32 (float32 with TF32 operands in every product, the nearest precision
below the configurations' float32), runs job 0 of each seed and is judged
like the port.  ``--program``: one cell run of the port per seed, all in
this process.  ``--trials``: the port's job 0, judged trial by trial; with
``--faults``, once for each fault of ``portbench/faults.py`` (``none``: no
fault) on one build per seed.  Prints one JSON line per reading.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_gaps(config, traffic, seed, device):
    """The judgement of the reference's own TF32 run of job 0."""
    import torch

    from portbench import scene as scene_mod
    from portbench.reference import check
    from portbench.reference.bal import Arith
    from portbench.reference.schur import levenberg_marquardt

    ar = Arith(torch.float32, tf32=True)
    scene = scene_mod.make_scene(config, seed, device)
    x0 = scene_mod.job_start(scene, traffic, 0)
    rec = check.JobRecord(x0)
    delta = float(config["huber_delta"])
    solver = config["reference_solver"]
    iters = int(traffic["lm_iterations"])
    levenberg_marquardt(x0, scene.obs, delta, solver, iters, ar, rec)
    return check.judge(rec, scene.obs, delta, solver, iters)


def program_gaps(config, traffic, seed, device, faults=("none",), job=0):
    """``{fault: judgement}`` of the port's runs of job ``job``, one for
    each fault planted (``none``: the sound run), on one build."""
    from portbench import bench
    from portbench import faults as faults_mod
    from portbench import scene as scene_mod
    from portbench.reference import check

    import g2o_tpu_torch

    scene = scene_mod.make_scene(config, seed, device)
    x0 = scene_mod.job_start(scene, traffic, job)
    problem, solver, order = bench.build_program(config, scene, x0, device)
    inst = bench.Instrument(problem, solver, False)
    iters = int(traffic["lm_iterations"])
    out = {}
    for fault in faults:
        run = g2o_tpu_torch.optimize_fused
        if fault != "none":
            run = faults_mod.planted(fault, run)
        problem.set_estimates({order.cam: x0[0],
                               order.pt: x0[1][order.nat_of_int]})
        inst.current = []
        inst.lin_x.clear()
        res = run(problem, solver, iters)
        rec = bench.to_record(problem, order, x0, inst.current,
                              problem.estimates, res)
        inst.current = None
        out[fault] = check.judge(rec, scene.obs,
                                 float(config["huber_delta"]),
                                 config["reference_solver"], iters)
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--trials", action="store_true",
                    help="judge a job of the port, trial by trial")
    ap.add_argument("--faults", default="none")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import bench

    _, _, config, traffic, _, _ = bench.find_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.trials:
            readings = program_gaps(config, traffic, seed, args.device,
                                    args.faults.split(","))
        elif args.program:
            out = bench.run_cell(ROOT, args.workload, seed, args.seconds,
                                 False, args.device)
            readings = {"program": {k: v["value"]
                                    for k, v in out["checks"].items()}}
            readings["program"]["attempted"] = out["attempted"]
        else:
            readings = {"tf32": control_gaps(config, traffic, seed,
                                             args.device)}
        for side, gaps in readings.items():
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  side=side, gaps=gaps,
                                  seconds=time.perf_counter() - t0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
