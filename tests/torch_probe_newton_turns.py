"""T14's and T15's five cases (``probe_newton``: extract, grad, jvp,
fori_grad, the Newton skeleton) by CUDA-graph replay and by CUDA events,
the kernel of ``csrc/probe_newton.cu`` against another body of the same
entry point (a source file given on the command line, such as an earlier
commit's, or an edited copy that tries another ``kWarps``), in turns, in one
process on the card. Run from the root of a checkout:

    mkdir -p build/k14 && git show <commit>:slam_robot_tpu_torch/csrc/probe_newton.cu > build/k14/other.cu
    python3 tests/torch_probe_newton_turns.py --other build/k14/other.cu

Each body is compiled by nvcc (``-Xptxas -v``, printed) into a library of
its own under ``build/k14/`` and put in the wrapper's place
(``probe_newton.KERNEL``), so that every body runs through the same Python
path. Each body is first held against the plain version on the probes'
inputs and on lanes past the window's edges (atol 1e-3; 2e-3 px for the
skeleton), twice, the two calls bitwise equal, and the two bodies' outputs
are compared (``same_bits``: whether they are bitwise equal, and their
largest difference; the loops at 0, 1 and 6 iterations). Then, per case, the bodies
are timed in turns (A B B A): by graph replay (``chip_smoke._graph_ms``,
50 calls a graph: the device alone) and by events (``chip_smoke._time_ms``,
200 calls: the host's call and the device); B1's ``newton_level`` on the
skeleton's inputs is timed by graph beside the skeleton. Prints the card
and one JSON line (also written to ``build/k14/turns.json``); exits 1 when
a body disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import build  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import newton as nk  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import probe_newton as pn  # noqa: E402
from slam_robot_tpu_torch.tools import probe_newton_kernel as t14  # noqa: E402

OUT = ROOT / "build" / "k14"
SOURCE = ROOT / "slam_robot_tpu_torch" / "csrc" / "probe_newton.cu"


def compile_bodies(bodies: dict) -> dict:
    """{name: source} -> {name: the loaded C function}, every nvcc started
    at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in bodies.items():
        lib = OUT / f"lib_{name}.so"
        cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-Xptxas=-v", f"-I{SOURCE.parent}", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        text = p.communicate()[0]
        print(f"nvcc {name}: exit {p.returncode}\n{text}", flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        fn = ctypes.CDLL(str(lib)).probe_newton
        fn.argtypes = build.SIGNATURES["probe_newton"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def check(args_sets, stages) -> dict:
    """The current body against the plain version: the largest error and
    whether two calls were bitwise equal, per input set and stage."""
    res = {}
    for tag, args in args_sets.items():
        for name, stage in stages.items():
            got = pn.probe_newton(*args, stage, t14.IT)
            again = pn.probe_newton(*args, stage, t14.IT)
            want = pn.probe_newton_plain(*args, stage, t14.IT)
            torch.cuda.synchronize()
            atol = 2e-3 if stage == pn.NEWTON else 1e-3
            err = float((got - want).abs().max())
            res[f"{tag}/{name}"] = {"max_abs_err": err, "ok": err <= atol,
                                    "repeatable": bool(torch.equal(got, again))}
    return res


def same_bits(fns, args_sets, stages) -> dict:
    """This body's output against the other's, per input set, stage and
    iteration count: bitwise equal or not, and the largest difference."""
    res = {}
    for tag, args in args_sets.items():
        for name, stage in stages.items():
            for iters in ((0, 1, t14.IT) if stage in (pn.FORI_GRAD, pn.NEWTON) else (t14.IT,)):
                outs = []
                for body in ("other", "this"):
                    pn.KERNEL._fn = fns[body]
                    outs.append(pn.probe_newton(*args, stage, iters))
                res[f"{tag}/{name}/{iters}"] = {
                    "same_bits": bool(torch.equal(*outs)),
                    "max_abs_diff": float((outs[0] - outs[1]).abs().max())}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another source of the entry point")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card_line(), flush=True)
    fns = compile_bodies({"other": Path(ns.other), "this": SOURCE})
    dev = torch.device("cuda")
    args = t14.inputs(dev)
    args_sets = {"probe": args, "edges": t14.edge_inputs(dev, 3),
                 "edges17x23": t14.edge_inputs(dev, 4, 257, 17, 23)}
    report = {"card": chip_smoke._card_line(), "checks": {}, "graph_ms": {}, "events_ms": {}}
    ok = True
    for name, fn in fns.items():
        pn.KERNEL._fn = fn
        report["checks"][name] = check(args_sets, pn.STAGES)
        ok &= all(r["ok"] and r["repeatable"] for r in report["checks"][name].values())
    report["same_bits"] = same_bits(fns, args_sets, pn.STAGES)

    order = list(fns) + list(reversed(list(fns)))
    for case, stage in pn.STAGES.items():
        def call(stage=stage):
            return pn.probe_newton(*args, stage, t14.IT)

        for key, timer in (("graph_ms", chip_smoke._graph_ms),
                           ("events_ms", lambda f: chip_smoke._time_ms(f, 200))):
            readings = {name: [] for name in fns}
            for name in order:
                pn.KERNEL._fn = fns[name]
                readings[name].append(timer(call))
            report[key][case] = readings
    pn.KERNEL._fn = None

    win, pos, ref, wmask = args
    f, n = win.shape[0], ref.shape[1] * ref.shape[2]
    b1_args = (win, pos, torch.zeros_like(pos), ref, torch.ones_like(ref),
               ref.sum((1, 2)) / n, (ref * ref).sum((1, 2)) / n, torch.ones((f,), device=dev),
               wmask, torch.full((f, 2), 1e4, device=dev))
    report["b1_graph_ms"] = [chip_smoke._graph_ms(
        lambda: nk.newton_level(*b1_args, threshold=1e-3, max_iters=t14.IT)) for _ in range(2)]
    report["b1_lane_iterations"] = chip_smoke._newton_lane_iters(b1_args, 1e-3, t14.IT)
    report["ok"] = ok
    text = json.dumps(report)
    (OUT / "turns.json").write_text(text)
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
