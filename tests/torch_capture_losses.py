"""How often does a capture of phase 14's fresh processes lose a kernel
(ROADMAP C6), and what precedes the captures that do? Runs ``chip_smoke.py``'s
phase-14 job ``--runs`` times on the card: as the smoke runs it (the trace
and the busy shares in a fresh process, then the config-5 tools in a second
one, ``profile_trace.run_job``) and, with ``--layout both``, also with both
parts in one fresh process (the layout before the second process: the
config-5 captures last in it). Prints each capture's retakes (a capture
whose audit found a launch without its kernel is taken again,
``profile_trace.retaken``, so a retake is a loss) and every capture's record
(its process, its session's index there, the tool, the process's seconds
and kernel launches before it, whether trace_detail's reader ran, its
launches and lost_at; ``profile_trace.CaptureLog``).

The job is the smoke's (``profile_trace`` over ``TRACE_FRAMES`` frames with
its export, ``profile_cg`` in both layouts, ``profile_cg_sharded``, and
the busy shares of phases 8 and 11), from the bench state after
``--warm`` frames of the bench scene (the smoke warms 96).

    PYTHONPATH=. python tests/torch_capture_losses.py [--runs 3] [--warm 16] [--layout two|both] [--out DIR]

(run from the checkout's root; ``python -m tests.…`` can find another
``tests`` package first)

Prints one JSON line a run and layout ({capture: retakes}, the captures
still short after their last take, the seconds, the export's audit, the
records) and a last line with the losses by layout and capture over all
runs.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke
from slam_robot_tpu_torch import SlamConfig, bench
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.ops.cuda import build
from slam_robot_tpu_torch.tools import profile_trace
from slam_robot_tpu_torch.utils.benchscene import make_frames


def retakes(res: dict) -> tuple:
    """The retakes of every capture of a job's result, and the captures
    whose last take still lost a kernel (the smoke fails on those)."""
    out, audits = {}, {}
    for name, r in res["tools"].items():
        if "retakes" in r["figures"]:
            out[name], audits[name] = r["figures"]["retakes"], r["figures"]["audit"]
    out["export"] = res["tools"]["profile_trace"]["figures"]["trace_retakes"]
    for k, f in res["busy"].items():
        if k != "5":  # profile_cg padded's, when the caller merged it in
            out[f"busy {k}"], audits[f"busy {k}"] = f["retakes"], f["audit"]
    left = [k for k, a in audits.items() if profile_trace.audit_fault(a) is not None]
    if res["detail"]["audit"]["lost_launches"]:
        left.append("export")
    return out, left


# both parts of the job in one fresh process, the layout before the second
# process; the second part's result then holds every capture's record
ONE_PROCESS = ("import sys, torch; from slam_robot_tpu_torch.tools import profile_trace as p; "
               "d = torch.device('cuda'); p.do_job(sys.argv[1], d, 'trace'); "
               "p.do_job(sys.argv[1], d, 'cg')")


def one_process(job_dir: str) -> dict:
    """The job's two parts in one fresh process, as ``run_job`` merges them."""
    subprocess.run([sys.executable, "-c", ONE_PROCESS, job_dir], check=True,
                   timeout=chip_smoke.JOB_TIMEOUT_S)
    parts = {}
    for part in profile_trace.PARTS:
        with open(os.path.join(job_dir, profile_trace.part_file(part))) as f:
            parts[part] = json.load(f)
    res = {"tools": {**parts["trace"]["tools"], **parts["cg"]["tools"]},
           "detail": parts["trace"]["detail"], "busy": parts["trace"]["busy"],
           "captures": [dict(c, process=1) for c in parts["cg"]["captures"]]}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--warm", type=int, default=16, help="bench frames before the job's")
    ap.add_argument("--layout", choices=["two", "both"], default="two",
                    help="the smoke's two processes, or also both parts in one")
    ap.add_argument("--out", default="build/capture_losses", help="the job's directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    build.build()
    build.load_library()
    cfg = SlamConfig()
    frames = make_frames(cfg, args.warm + chip_smoke.TRACE_FRAMES, device=dev)
    ps = pipeline.init(cfg, device=dev)
    ps, _ = bench.run_scan(ps, torch.stack(frames[:args.warm]), cfg)
    profile_trace.write_job(args.out, ps, torch.stack(frames[args.warm:]), cfg, top=15,
                            cg={"layouts": ["scatter", "padded"], "gn_iters": 5, "cg_iters": 20,
                                "top": 10, "small": False, "shards": [1, 2, 4, 8]},
                            busy={"small": False, "steps": chip_smoke.FLEET_PROFILE_STEPS,
                                  "fleet_goals": chip_smoke.FLEET_GOALS})
    layouts = {"two": lambda: profile_trace.run_job(args.out, dev, chip_smoke.JOB_TIMEOUT_S)}
    if args.layout == "both":
        layouts["one"] = lambda: one_process(args.out)
    losses = {name: collections.Counter() for name in layouts}
    captures = collections.Counter()
    for run in range(args.runs):
        for name, job in layouts.items():
            t0 = time.perf_counter()
            res = job()
            got, left = retakes(res)
            captures[name] += len(got)
            losses[name].update({k: v for k, v in got.items() if v})
            print(json.dumps({"run": run, "layout": name, "s": round(time.perf_counter() - t0, 1),
                              "retakes": got, "lost_after_every_take": left,
                              "export_audit": res["detail"]["audit"],
                              "captures": res["captures"]}), flush=True)
    print(json.dumps({"runs": args.runs, "captures": dict(captures),
                      "losses_by_capture": {k: dict(v) for k, v in losses.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
