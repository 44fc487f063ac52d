"""How often does a capture of phase 14's fresh process lose a kernel
(ROADMAP C6)? Runs ``chip_smoke.py``'s phase-14 job ``--runs`` times on the
card, each in a fresh process, and prints each capture's retakes: a capture
whose audit found a launch without its kernel is taken again
(``profile_trace.retaken``), so a retake is a loss.

The job is the smoke's (``profile_trace`` over ``TRACE_FRAMES`` frames with
its export, ``profile_cg`` in both layouts, ``profile_cg_sharded``, and
the busy shares of phases 8 and 11), from the bench state after
``--warm`` frames of the bench scene (the smoke warms 96).

    PYTHONPATH=. python tests/torch_capture_losses.py [--runs 3] [--warm 16] [--out DIR]

(run from the checkout's root; ``python -m tests.…`` can find another
``tests`` package first)

Prints one JSON line a run ({capture: retakes}, the captures still short
after their last take, the seconds, the export's audit) and a last line
with the losses by capture over all runs.
"""

import argparse
import collections
import json
import os
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
        if k != "5":  # profile_cg padded's
            out[f"busy {k}"], audits[f"busy {k}"] = f["retakes"], f["audit"]
    left = [k for k, a in audits.items() if profile_trace.audit_fault(a) is not None]
    if res["detail"]["audit"]["lost_launches"]:
        left.append("export")
    return out, left


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--warm", type=int, default=16, help="bench frames before the job's")
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
    losses, captures = collections.Counter(), 0
    for run in range(args.runs):
        t0 = time.perf_counter()
        res = profile_trace.run_job(args.out, dev, chip_smoke.JOB_TIMEOUT_S)
        got, left = retakes(res)
        captures += len(got)
        losses.update({k: v for k, v in got.items() if v})
        print(json.dumps({"run": run, "s": round(time.perf_counter() - t0, 1), "retakes": got,
                          "lost_after_every_take": left,
                          "export_audit": res["detail"]["audit"]}), flush=True)
        os.remove(os.path.join(args.out, profile_trace.RESULT_FILE))
    print(json.dumps({"runs": args.runs, "captures": captures,
                      "losses_by_capture": dict(losses)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
