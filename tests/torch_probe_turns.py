"""The redesigned probe kernels by CUDA-graph replay and by CUDA events,
against other bodies of the same entry points (source files given on the
command line, such as an earlier commit's, or an edited copy that tries
other constants), in turns, in one process on the card: T5, T7 e-g and T11
(``probe_control``, ``csrc/probe_control.cu``), T16 (``probe_decimate``)
and T17 (``probe_two_level``) of ``csrc/probe_pyramid.cu``, T13's g6
(``probe_sample_grouped``) and g3 (``probe_banded_pair``) and T4
(``probe_band_grad``) of ``csrc/probe_banded.cu``, the window copy of T1,
T2, T6, T7 a-c and T12 (``probe_windows``) and T7 d and h (``probe_fill``)
of ``csrc/probe_windows.cu``; and the card's smallest launch, an empty
kernel of one block at 32 and at 1024 threads, and at T16's grid of 75
blocks of 256 (its source written under ``build/turns/``). Run from the
root of a checkout:

    mkdir -p build/turns
    for f in probe_control probe_pyramid; do
        git show <commit>:slam_robot_tpu_torch/csrc/$f.cu > build/turns/parent_$f.cu; done
    sed 's/kDecX = 16, kDecY = 4;/kDecX = 16, kDecY = 8;/' \
        slam_robot_tpu_torch/csrc/probe_pyramid.cu > build/turns/dec16x8_probe_pyramid.cu
    python3 tests/torch_probe_turns.py --body parent_control=build/turns/parent_probe_control.cu \
        --body parent_pyramid=build/turns/parent_probe_pyramid.cu \
        --body dec16x8_pyramid=build/turns/dec16x8_probe_pyramid.cu

Each body is compiled by nvcc (``-Xptxas -v``, printed) into a library of
its own under ``build/turns/``; the entry points it exports are put in the
wrappers' places (``probe_control.KERNEL``, ``probe_pyramid.DECIMATE``,
``probe_pyramid.TWO_LEVEL``, ``probe_banded.SAMPLE_GROUPED``,
``probe_banded.BANDED_PAIR``, ``probe_banded.BAND_GRAD``,
``probe_windows.WINDOWS``, ``probe_windows.FILL``), so that every body
runs through the same Python path. The checkout's own sources are the
bodies "this_control", "this_pyramid", "this_banded" and "this_windows".
Each body is first held against the plain versions, each call twice and
the two calls bitwise equal:

- the control loops and branch bit for bit: every probe case and its
  seeded twins, shapes from 1x1 to 1x1024 on values at the loops' edges
  (NaN, +-inf, -0.0, past 2.4 from the start, passing after each step or
  never) and F's sums on each side of 2 and at 2.0, 8x128 on x and out 4
  bytes off 16;
- T16 bit for bit at the probe's 480x640 and at W % 8 != 0, and on an
  input and an output off 16 bytes; T7 d and h bit for bit;
- T17 atol 1e-5 at the probe's 480x640, at 6x6 and at shapes with partial
  strips;
- g6 and g3 exactly, at the probes' inputs, g6 at smaller windows with
  taps past every edge, g3 at K % 4 != 0 and on an output 4 bytes off 16;
- T4 rtol 1e-5 at the probe's inputs and at windows 16, 48 and 100 wide
  with the band past both edges;
- the window copy exactly, every probe case on its inputs and each of its
  five cases at windows 32, 30 and 48 wide with positions past every edge.

Then, per case, the bodies are timed in turns (A B ... B A): by graph
replay (``chip_smoke._graph_ms``, 50 calls a graph: the device alone) and
by events (``chip_smoke._time_ms``, 200 calls: the host's call and the
device). A case with a one-call PyTorch equivalent (T16's
``img[::2, ::2].contiguous()``) has that call timed by graph before and
after its turns; the empty kernel is timed by graph and events at each
shape, in turns; B2's three ``sep5`` calls for T17's two levels by graph.
Prints the card and one JSON line (also written to
``build/turns/turns.json``); exits 1 when a body disagrees with a plain
version.
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
from slam_robot_tpu_torch.ops.cuda import blur as bk  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import build  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import probe_banded as pb  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import probe_control as pc  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import probe_pyramid as pp  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw  # noqa: E402
from slam_robot_tpu_torch import tools  # noqa: E402
from slam_robot_tpu_torch.tools import probe_mosaic2 as t7  # noqa: E402
from slam_robot_tpu_torch.tools import probe_mosaic4 as t13  # noqa: E402
from slam_robot_tpu_torch.tools.probe_pyramid_fused import frame  # noqa: E402

OUT = ROOT / "build" / "turns"
CSRC = ROOT / "slam_robot_tpu_torch" / "csrc"
# entry point -> the wrapper's kernel that launches it
KERNELS = {"probe_control": pc.KERNEL, "probe_decimate": pp.DECIMATE,
           "probe_fill": pw.FILL, "probe_two_level": pp.TWO_LEVEL,
           "probe_sample_grouped": pb.SAMPLE_GROUPED, "probe_banded_pair": pb.BANDED_PAIR,
           "probe_band_grad": pb.BAND_GRAD, "probe_windows": pw.WINDOWS}
# the probe cases (tools.all_cases) that each entry point runs, timed by name
PROBE_CASES = {"probe_control": pc.KERNEL, "probe_decimate": pp.DECIMATE,
               "probe_fill": pw.FILL, "probe_band_grad": pb.BAND_GRAD,
               "probe_windows": pw.WINDOWS}
T17_SHAPES = [(480, 640), (6, 6), (50, 70), (102, 150), (34, 646)]
CONTROL_SHAPES = [(1, 1), (8, 2), (8, 128), (24, 40), (1, 1024), (1023, 1), (3, 5)]
DECIMATE_SHAPES = [(480, 640), (6, 8), (102, 150), (6, 10), (34, 646)]
# the card's smallest launch, an empty kernel: blocks x threads (one block,
# and T16's grid)
EMPTY_SHAPES = ((1, 32), (1, 1024), (75, 256))
EMPTY_SOURCE = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def compile_bodies(bodies: dict) -> tuple[dict, object]:
    """{name: source} -> ({name: {entry point: the loaded C function}}, the
    empty kernel's launch function), every nvcc started at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    empty = OUT / "empty.cu"
    empty.write_text(EMPTY_SOURCE)
    procs = {}
    for name, src in {**bodies, "empty": empty}.items():
        lib = OUT / f"lib_{name}.so"
        cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-Xptxas=-v", f"-I{CSRC}", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        text = p.communicate()[0]
        print(f"nvcc {name}: exit {p.returncode}\n{text}", flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        libs[name] = ctypes.CDLL(str(lib))
    launch_empty = libs.pop("empty").empty_launch
    launch_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    launch_empty.restype = ctypes.c_int
    fns = {}
    for name, so in libs.items():
        fns[name] = {}
        for entry in KERNELS:
            fn = getattr(so, entry, None)
            if fn is not None:
                fn.argtypes = build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
                fns[name][entry] = fn
    return fns, launch_empty


def _rand(shape, seed, dev, lo=0.0, hi=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def edge_lanes(dev, f: int, wh: int, ww: int, seed: int = 7):
    """g6's inputs at a wh x ww window: random pixels and fractions, origins
    from 3 past the top-left edge to past the bottom-right one."""
    win = _rand((f, wh, ww), seed, dev, 0.0, 255.0)
    fx, fy = _rand((f,), seed + 1, dev), _rand((f,), seed + 2, dev)
    span = torch.arange(f, device=dev)
    x0 = (span * 5 % (ww + 6) - 3 - t13.S // 2).to(torch.int32)
    y0 = (span * 7 % (wh + 6) - 3 - t13.S // 2).to(torch.int32)
    return win, fx, fy, x0, y0


def checks(dev, entries) -> dict:
    """The installed bodies of ``entries`` against the plain versions:
    {case: (ok, the largest error, two calls bitwise equal)}."""
    res = {}
    if "probe_control" in entries:
        res.update(control_checks(dev))
    if "probe_decimate" in entries:
        res.update(decimate_checks(dev))
    if "probe_fill" in entries:
        res.update(exact_checks(dev, "probe_fill", "fill"))
    if "probe_two_level" in entries:
        res.update(t17_checks(dev))
    if "probe_sample_grouped" in entries:
        res.update(g6_checks(dev))
    if "probe_banded_pair" in entries:
        res.update(g3_checks(dev))
    if "probe_band_grad" in entries:
        res.update(t4_checks(dev))
    if "probe_windows" in entries:
        res.update(window_checks(dev))
    return res


def probe_cases(entry: str, kind: str = "CASES") -> list:
    """The probe cases (or their seeded twins) whose wrapper launches ``entry``."""
    return [c for c in tools.all_cases(kind) if c.kernel is PROBE_CASES[entry]]


def _same_bits(a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _off16(dev, n: int) -> torch.Tensor:
    """n floats that start 4 bytes past 16."""
    t = torch.zeros(n + 1, device=dev)[1:]
    assert t.data_ptr() % 16 == 4
    return t


def exact_checks(dev, entry: str, tag: str) -> dict:
    """Every probe case of ``entry`` and its seeded twins, bit for bit."""
    res = {}
    for case in probe_cases(entry) + probe_cases(entry, "SEEDED"):
        args = case.inputs(dev)
        got = case.run(*args)
        res[f"{tag} {case.name}"] = {"ok": _same_bits(got, case.plain(*args)),
                                     "repeatable": _same_bits(got, case.run(*args))}
    return res


def control_checks(dev) -> dict:
    res = exact_checks(dev, "probe_control", "control")
    for mode in (pc.ROW_DONE, pc.FIXED, pc.REDUCE, pc.ELEMENT_DONE):
        for shape in CONTROL_SHAPES:
            if mode == pc.REDUCE:
                inputs = [t7.sum_edges(dev, 1, shape, kind) for kind in t7.SUM_KINDS]
            else:
                inputs = [t7.loop_edges(dev, seed, shape) for seed in range(2)]
            for i, x in enumerate(inputs):
                got = pc.control(x, mode)
                res[f"control case {mode} {shape[0]}x{shape[1]} input {i}"] = {
                    "ok": _same_bits(got, pc.control_plain(x, mode)),
                    "repeatable": _same_bits(got, pc.control(x, mode))}
        # x and out 4 bytes off 16 (element by element)
        x = t7.loop_edges(dev, 5, (8, 128))
        xo, out = _off16(dev, x.numel()).view(8, 128), _off16(dev, x.numel()).view(8, 128)
        xo.copy_(x)
        pc.KERNEL.launch(xo.data_ptr(), out.data_ptr(), 8, 128, mode, build.stream_handle(dev))
        res[f"control case {mode} 8x128 off 16"] = {
            "ok": _same_bits(out, pc.control_plain(x, mode)), "repeatable": True}
    return res


def decimate_checks(dev) -> dict:
    res = exact_checks(dev, "probe_decimate", "decimate")
    for h, w in DECIMATE_SHAPES:
        img = _rand((h, w), h + w, dev)
        got = pp.decimate(img)
        src, out = _off16(dev, h * w).view(h, w), _off16(dev, h * w // 4).view(h // 2, w // 2)
        src.copy_(img)
        pp.DECIMATE.launch(src.data_ptr(), out.data_ptr(), h, w, build.stream_handle(dev))
        want = img[::2, ::2]
        res[f"decimate {h}x{w}"] = {"ok": bool(torch.equal(got, want) and torch.equal(out, want)),
                                    "repeatable": bool(torch.equal(got, pp.decimate(img)))}
    return res


def t4_checks(dev) -> dict:
    res = {}
    for case in probe_cases("probe_band_grad"):
        args = case.inputs(dev)
        got, want = case.run(*args), case.plain(*args)
        err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        res[f"t4 {case.name}"] = {"ok": err <= 1e-5, "max_rel_err": err,
                                  "repeatable": bool(torch.equal(got, case.run(*args)))}
    for ws, x in ((16, -3.4), (48, 40.5), (100, 7.5)):
        win = _rand((ws, ws), ws, dev)
        xy = torch.tensor([x, 0.7], device=dev)
        got, want = pb.band_grad(win, xy, 13), pb.band_grad_plain(win, xy, 13)
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=0))
        res[f"t4 ws {ws} x {x}"] = {"ok": ok, "max_abs_err": float((got - want).abs().max()),
                                    "repeatable": bool(torch.equal(got, pb.band_grad(win, xy,
                                                                                     13)))}
    return res


def window_checks(dev) -> dict:
    res = {}
    for case in probe_cases("probe_windows"):
        args = case.inputs(dev)
        got = case.run(*args)
        res[f"windows {case.name}"] = {"ok": bool(torch.equal(got, case.plain(*args))),
                                       "repeatable": bool(torch.equal(got, case.run(*args)))}
    for size, (h, w) in ((32, (128, 256)), (30, (64, 96)), (48, (100, 120))):
        img = _rand((h, w), size, dev)
        ints = torch.tensor([[-5, -7], [w + 9, -3], [-9, h + 2], [w + 40, h + 40], [3, 4],
                             [w - size, h - size]], dtype=torch.int32, device=dev)
        floats = ints.to(torch.float32) + torch.linspace(-0.9, 0.9, ints.numel(),
                                                         device=dev).view(-1, 2)
        mask = torch.tensor([1, 0, -1, 2, 0, 1], dtype=torch.int32, device=dev)
        for case in (pw.INT, pw.FLOORED, pw.ROWS, pw.MASKED, pw.DIAGONAL):
            pos = floats if case == pw.FLOORED else None if case == pw.MASKED else ints
            got = pw.windows(img, pos, size, case, mask)
            res[f"windows case {case} ws {size}"] = {
                "ok": bool(torch.equal(got, pw.windows_plain(img, pos, size, case, mask))),
                "repeatable": bool(torch.equal(got, pw.windows(img, pos, size, case, mask)))}
    return res


def t17_checks(dev) -> dict:
    res = {}
    k = pp.taps().to(dev)
    for h, w in T17_SHAPES:
        img = _rand((h, w), h * w, dev)
        got, again = pp.two_level(img, k), pp.two_level(img, k)
        want = pp.two_level_plain(img, k)
        err = max(float((g - x).abs().max()) for g, x in zip(got, want))
        res[f"t17 {h}x{w}"] = {"ok": err <= 1e-5, "max_abs_err": err,
                               "repeatable": all(map(torch.equal, got, again))}
    return res


def g6_checks(dev) -> dict:
    res = {}
    g6 = {"probe": t13.sample_inputs(dev), "edges 32x32 F=37": edge_lanes(dev, 37, 32, 32),
          "edges 17x23 F=5": edge_lanes(dev, 5, 17, 23), "edges 14x14 F=130": edge_lanes(dev, 130, 14, 14)}
    for tag, args in g6.items():
        got = pb.sample_grouped(*args, t13.S, 1)
        again = pb.sample_grouped(*args, t13.S, 1)
        want = pb.sample_grouped_plain(*args, t13.S)
        res[f"g6 {tag}"] = {"ok": bool(torch.equal(got, want)),
                            "max_abs_err": float((got - want).abs().max()),
                            "repeatable": bool(torch.equal(got, again))}
    return res


def g3_checks(dev) -> dict:
    res = {}
    fr, st = t13.band_inputs(dev)
    g3 = {"probe": (fr, st, t13.W, t13.S, t13.G), "K % 4 = 2": (fr, st, 30, t13.S, t13.G),
          "K % 4 = 1, G = 1": (fr[:9], st[:9], 33, 5, 1)}
    for tag, (a, b, length, size, groups) in g3.items():
        got = pb.banded_pair_grouped(a, b, length, size, groups)
        want = pb.banded_pair_grouped_plain(a, b, length, size, groups)
        res[f"g3 {tag}"] = {"ok": bool(torch.equal(got, want)),
                            "repeatable": bool(torch.equal(
                                got, pb.banded_pair_grouped(a, b, length, size, groups)))}
    # an output 4 bytes off 16 (element by element), through the entry point
    buf = torch.empty(16 * 104 * 128 + 1, device=dev)
    off = buf[1:].view(16, 104, 128)
    assert off.data_ptr() % 16 == 4
    pb.BANDED_PAIR.launch(fr.data_ptr(), st.data_ptr(), off.data_ptr(), 16, t13.G, t13.S, t13.W,
                          build.stream_handle(dev))
    res["g3 unaligned"] = {"ok": bool(torch.equal(
        off, pb.banded_pair_grouped_plain(fr, st, t13.W, t13.S, t13.G))), "repeatable": True}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", action="append", default=[], metavar="NAME=SOURCE",
                    help="another source of some of the entry points")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke._card_line()
    print(card, flush=True)
    bodies = {f"this_{f}": CSRC / f"probe_{f}.cu"
              for f in ("control", "pyramid", "banded", "windows")}
    bodies.update(dict(b.split("=", 1) for b in ns.body))
    fns, launch_empty = compile_bodies(bodies)
    dev = torch.device("cuda")
    report = {"card": card, "checks": {}, "graph_ms": {}, "events_ms": {},
              "library_graph_ms": {}, "empty_graph_ms": {}, "empty_events_ms": {}}

    def install(name):
        for entry, fn in fns[name].items():
            KERNELS[entry]._fn = fn

    ok = True
    for name in fns:
        install(name)
        report["checks"][name] = checks(dev, fns[name])
        ok &= all(r["ok"] and r["repeatable"] for r in report["checks"][name].values())

    img, k = frame(dev), pp.taps().to(dev)
    g0, g1 = bk.gaussian_weights(pp.SIGMA0), bk.gaussian_weights(pp.SIGMA_DOWN)
    sample, band = t13.sample_inputs(dev), t13.band_inputs(dev)
    cases = {"probe_two_level": lambda: pp.two_level(img, k),
             "probe_sample_grouped": lambda: pb.sample_grouped(*sample, t13.S, t13.G),
             "probe_banded_pair": lambda: pb.banded_pair_grouped(*band, t13.W, t13.S, t13.G)}
    timed = {entry: (entry, call, None) for entry, call in cases.items()}
    for entry in PROBE_CASES:
        for case in probe_cases(entry):
            args = case.inputs(dev)
            timed[case.name] = (entry, lambda c=case, a=args: c.run(*a),
                                case.library(*args) if case.library else None)
    for label, (entry, call, library) in timed.items():
        names = [n for n in fns if entry in fns[n]]
        order = names + list(reversed(names))
        if library is not None:
            report["library_graph_ms"][label] = [chip_smoke._graph_ms(library)]
        for key, timer in (("graph_ms", chip_smoke._graph_ms),
                           ("events_ms", lambda f: chip_smoke._time_ms(f, 200))):
            readings = {n: [] for n in names}
            for n in order:
                install(n)
                readings[n].append(timer(call))
            report[key][label] = readings
        if library is not None:
            report["library_graph_ms"][label].append(chip_smoke._graph_ms(library))

    # the empty kernel in turns, A B C C B A (the stream read on each call:
    # under capture it is the graph's)
    def empty(blocks, threads):
        build.check_launch("empty_kernel",
                           launch_empty(blocks, threads, build.stream_handle(dev)))

    for key, timer in (("empty_graph_ms", chip_smoke._graph_ms),
                       ("empty_events_ms", lambda f: chip_smoke._time_ms(f, 200))):
        readings = {f"{b}x{t}": [] for b, t in EMPTY_SHAPES}
        for b, t in EMPTY_SHAPES + EMPTY_SHAPES[::-1]:
            readings[f"{b}x{t}"].append(timer(lambda b=b, t=t: empty(b, t)))
        report[key] = readings

    def three_calls():
        return bk.sep5(bk.sep5(bk.sep5(img, g0, 1), bk.PYRDOWN_WEIGHTS, 2), g1, 1)

    report["b2_three_calls_graph_ms"] = [chip_smoke._graph_ms(three_calls) for _ in range(2)]
    for kern in KERNELS.values():
        kern._fn = None
    report["ok"] = ok
    text = json.dumps(report)
    (OUT / "turns.json").write_text(text)
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
