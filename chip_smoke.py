"""Drive the PyTorch port's SLAM step, replay driver, closed loop,
benchmark suite, alternative trackers, host I/O, live view, headline
benchmark and profiling tools on one CUDA card and check them.

Run from the repository root:

    python3 chip_smoke.py                         # all phases, 64 frames
    python3 chip_smoke.py --profile 8 --out DIR   # + a torch.profiler trace

Phases, one line each (phases 2 and 3 several):
  0. the card (nvidia-smi name and power limit) and the torch version;
     fails when torch sees no CUDA device
  1. build the hand-written kernels from slam_robot_tpu_torch/csrc with nvcc
  2. B2: sep5 (the blur kernel behind pyramid.blur/pyr_down) against its
     plain PyTorch version on every level shape of a 480x640 pyramid plus
     an odd shape, atol 1e-5, with times (the 11 calls and the 480x640 blur
     alone, by events and by CUDA-graph replay), the one-call PyTorch
     equivalent (reflect pad + conv2d) and the bound; then pyramid_flat (the whole
     flat pyramid in two launches) against the plain pyramid at 480x640,
     47x63 and 120x158 (a padded row of 696 B), atol 1e-5 on every element,
     the padding and the zero region included, its largest difference from
     the 11-launch route it replaced, and both timed in turns (route, new,
     new, route) by CUDA events and by CUDA-graph replay, with each launch's
     device time (torch.profiler, its capture audited: a launch whose kernel
     the capture lost fails the phase) and the bound
  3. B1: newton_level (one level of the track kernel) against its plain
     version for F=32 and F=256 lanes, windows cut from a rendered bench
     frame's pyramid with perturbed starts, every level (the coarsest window
     is 31x32), with times and the bound, group=4 equal to group=1 bit for
     bit; then newton_track (a whole tracking direction in one launch)
     against the plain level loop at F=32 and F=256 on the frame pair, lanes
     at budgets of 6, 3 and 1 level (adaptive_fwd_px's first attempt): the
     forward pass on the pyramid with the backward stack its epilogue
     samples and every level's window cut where the plain loop cuts it, the
     backward pass on the window cache; each direction timed in turns with
     the level loop through newton_level, by events and by graph replay,
     beside its bound
  4. the main path: pipeline.init(SlamConfig()), then the bench sweep's
     first 64 frames rendered by the port, with maybe_polish; launch counters
     (two pyramid_flat launches a frame, two newton_track launches a sweep,
     no sep5 launch), NaN/Inf, map size, dropped rows, the normalize canary
     and the Sim(3)-aligned trajectory error against the sweep's ground truth
  5. with --profile K: tools/profile_trace.profile over frames 64..63+K
     (device busy time against the same frames' unprofiled wall time,
     launches, host time by span; fails on a launch whose kernel the
     capture lost); the trace and table written to --out
  6. the replay driver (run_replay.main, in-process) at 640x480 with the
     default SlamConfig: 16 SyntheticSource frames recorded as .npy, replayed
     with --final-ba --dump, replayed again with --live (same summary),
     --synthetic 16, --synthetic 4 --debug-numerics, and checked_step on a
     frame with a NaN block; the launch gates of phase 4 on every run
  7. the probes: each module of slam_robot_tpu_torch.tools (the ports of
     the JAX package's tools/probe_*.py Mosaic probes) runs its main with
     --device cuda in-process, and all 32 cases must pass, each kernel
     against its plain version and the original's expected values; the
     kernels whose original inputs are constant (the batched product, the
     masked copy, every loop and branch) pass again on seeded non-uniform
     inputs (the modules' SEEDED cases); then every case is timed beside
     its bound: the kernel and the plain version by CUDA events (200
     back-to-back calls: the host's call and the device), the kernel by
     CUDA-graph replay (the device alone), and where there is a one-call
     PyTorch equivalent, it too by events and by graph replay, in turns;
     the async window copies (T8-T10) print the path they took, which must
     be the copy engine's bulk copies at the probes' shape; the fused
     two-level pyramid against B2's three calls for the same two levels, and the
     Newton skeleton against B1 on the skeleton's inputs, each also by
     device time (CUDA-graph replay, no host launch path), and the two
     device-time ratios
  8. the closed loop through run_sim.main in-process: the 64-rollout fleet
     of 300 steps (BASELINE config 4) on the card and on the CPU (reached
     count within 1, median final distance within 0.01 m, and every
     rollout's final distance within 1e-3 m but for goals whose commands
     parted at a decision tie, found by stepping both devices in lockstep:
     near-equal Dubins types or pursuit samples that steer apart, or the
     stop radius; the card also steps from each of the CPU's states and
     may land more than 1e-4 apart only at a tie, with the shares of such
     states, of ties and of goals apart capped), with wall time and rollout
     steps/s (its profile of 30 steps, launches per step and device busy
     share, is taken in phase 14's fresh process); --mesh on the one card
     (the same summary); --slam (30 steps at 160x120, depth 4, 96
     features: finite states and estimates, phase 4's launch gates);
     pyramid_flat and newton_track at those shapes against their plain
     versions with phases 2 and 3's tolerances, timed beside their bounds;
     and stop's line
  9. parity: the port's tools.parity on the card for the four sequences
     of the JAX package's tools/parity.py (six draws, 284 frames), each
     sequence in a process of its own (python -m
     slam_robot_tpu_torch.tools.parity --seq NAME --out F), the four at
     once and beside phases 8, 10, 11 and 12 (a step is the host's work,
     and the card idles most of it; the steps' ms are therefore not one
     process's alone): per draw its drift against the JAX package's golden and the
     gate (printed with its verdict and counted in one "parity drift: k of
     6" line, a reading, not a gate of this script: the goldens are XLA:CPU's
     float order), truth ATE and cap, median px and golden + 0.1, n_obs,
     n_points, wall s, median step ms and launches a frame; fails on a
     process that leaves no report or runs past its time, a NaN/Inf, a
     truth cap or median-px gate missed, the production 3-seed median over
     its bar, or phase 4's launch gates; then pyramid_flat and
     newton_track at the sequences' shapes (240x320, depth 5, F=192) in
     their reference-exact mode against their plain versions with phases 2
     and 3's tolerances: the forward pass with no backward stack, the
     backward pass on the view ring through a per-lane plane offset with no
     window cache, each timed beside its bound
 10. (in a process of its own, python chip_smoke.py --part knobs, beside
     phases 8, 9, 11 and 12) the step's seven off-by-default knobs at once (mid-frame re-solve,
     constant-velocity motion, cycle retries, adaptive first attempt,
     adaptive seed depth, idle-frame drop, duplicate cleaning) on
     SlamConfig(): the sweep's frames 0-31, then their last camera pair
     three times more; fails when a knob that fires on this input by
     construction or on every keyframe fired 0 times, on phase 4's gates
     (NaN/Inf, rows dropped, canary, launches; > 200 points; aligned ATE of
     the kept frames < 5 %); then check_not_moving on the run's last state
     with an idle tail (two frames go, obs table and rings equal to the
     CPU's) and one matcher.track with a lane copied onto another (exactly
     the higher slot is cleaned)
 11. the port's tools/bench_suite at full size, each config's JSON lines
     with its call time and peak device memory (per line, the device busy
     share of its timed work is taken in phase 14's fresh process and
     printed there as a phase 11 line): config 1 (the step at 640x480 without BA;
     phase 4's launch gates, and pyramid_flat and newton_track at its
     shapes on its own frames against their plain versions with phases 2
     and 3's tolerances), config 2 (window BA 10x500: finite cost, LM
     iterations), config 4 (64 rollouts at goal seed 2: the reach count as
     the CPU's, or apart only at decision ties within phase 8's caps),
     config 5 (ops/ba_cg at 10k frames, 500k points, 1M observations, 5 GN x
     20 CG, diag: finite cost below cost0, ATE not above its initial value
     by more than 0.1 %, ok with no spill overflow, no host read inside a
     solve (device.SYNCS and CUDA sync debug mode "error"), the scatter
     layout timed twice and its cost within 1e-4 of the padded one's; the
     four-shard solve on the one card within 1e-4 in cost and 0.1 mm in
     frames; the multi-robot map at R = 8 lowering its mean point error),
     then tools/calibrate --synthetic 20 at 640x480 (phase 4's launch gates,
     finite solved k, reprojection error below its value before the solve)
 12. (in a process of its own, python chip_smoke.py --part alt, beside
     phases 8-11; its inputs, phase 4's frames and state after 16 frames
     and phase 6's summary, written to build/smoke_parts/) the alternative
     trackers, host I/O and the live view: (a) the step
     with tracker_impl="lanes" and (b) with tracker_kind="klt" at
     SlamConfig()'s widths over the sweep's frames 0-31 (two pyramid_flat
     launches a frame, no newton_track; phase 4's gates, at least 250 and
     100 points, the gates for 32 frames); (c) from (a)'s state after frame 16, matcher.track for
     frame 17 with each on the card and on the host's CPU (matched masks
     agree on 98 % of candidate lanes, positions of lanes matched on both
     within 2e-3 px on 95 %), each tracker's CUDA-graph pass equal to its
     eager pass bit for bit, and brute.track_feature on 256 lanes from
     frame 0 to 2 (1e-4 px on 99 %, ok equal); (d) io/native's library on
     the host (the YUYV conversions exact, the ring's rate, 16 frames fed
     through native.FrameRing into the step equal bit for bit to phase 4's
     state after them, V4L2Source on /dev/video0); (e) run_replay
     --synthetic 16 --serve PORT --view-every 1, per frame and --live, with
     a client reading /, /status, three /stream parts (480x640 JPEGs),
     /points and /point?id=N while it runs and PIL out of reach, the
     summaries as phase 6's synthetic run's, and the JPEG encoder's time a
     640x480 overlay
 13. the headline benchmark: the port's bench.run at SlamConfig() for seed
     0, bench.py's 96 warm frames and 16 timed ones (the standalone
     bench's 64 cut to the script's time limit), its warm going on from phase
     4's state after frame 63 (phase 4 steps frames 0-63 as the warm does);
     the scan's first pass and two timed passes, the eager steps and the
     live ring; fps, each pass's ms a frame, syncs and launches a frame in
     the timed window, points, ATE, the error split and peak memory; fails
     on a dropped row, the canary, a NaN/Inf in a state, <= 300 points, an
     aligned ATE over 5 %, phase 4's launch gates over the timed passes and
     the live segment, timed passes that end apart, or a live segment whose
     final state is not the scan's, bit for bit
 14. the profiling tools (slam_robot_tpu_torch/tools, the ports of the JAX
     package's tools/profile_*.py, probe_live.py and trace_detail.py) from
     phase 13's warm state: profile_tpu, profile_step (ms, syncs and
     launches a stage), profile_tracker (events and graph replay),
     probe_live (rtt and every ported variant over 2 frames, each final
     state equal to eager's bit for bit), profile_scan (default and noslam,
     one pass of 8 frames); then, in a fresh process (profile_trace
     --job --part trace: a long-lived process loses kernels from its
     traces, ROADMAP C6), profile_trace over 1 frame (its traced pass first, which pays
     for the process's first launches; device busy share, categories, top
     kernels, host ms by span) and trace_detail on its export (1 frame
     with the host's spans; python -m, beside the next two: B1's and B2's
     rows against the port's counters, and the launches that lost their
     kernel), the busy shares of phase 8's fleet (30 steps) and of phase
     11's suite lines (config 1's steps, a config-2 solve, 30 steps of
     config 4's fleet, config 5's solve from profile_cg's padded one, the
     four-shard solve, a sweep of the multi-robot map), and once that
     process has ended, in a second fresh one (--part cg), profile_cg at
     config 5 in both layouts, and profile_cg_sharded (1, 2, 4 and 8 shards
     against one, phase 11's tolerances, and the projection from the padded
     solve's rate); every capture's record printed (its process, session,
     tool, the launches before it, whether trace_detail ran, lost_at);
     fails on a non-finite number, a profile whose device time is counted
     twice on a stream or lies outside its run's markers (the profiled
     pass's own events on the device's clock; the busy share against an
     unprofiled wall is printed, not gated), any capture with a kernel
     launch whose kernel it lost (ROADMAP C6; the export's by
     trace_detail's audit, every other capture's by
     profile_trace.audit), B1's or B2's launches in the profile, or their
     rows in the export, other than the port's counters over the same
     pass, B1 or B2 rows outside the span that launches them (track_sweep,
     pyramid), a failed or timed-out fresh process, or a variant's state
     apart. No profile runs in this script's own process after phase 2
     but phase 5's (off by default), and each audits its capture

The JSON line before the card's line holds the main path's, the replay
runs', every probe case's, the closed loop's, the parity replays', the
knobs', the bench suite's, phase 12's, the bench's and the tools' figures.
The line
before the last is a JSON object with one entry per kernel entry point, its
launches counted over phases 4, 6 and 8-14 (pyramid_flat, newton_track:
the main path, the replay driver, the SLAM loop, the parity replays, the
knobs' run, bench_suite config 1 and calibrate, phase 12's runs, the bench
and the profiling tools; no newton_track on phase 12's tracker runs),
phase 7's mains
(sep5_reflect101: probe2's reference runs pyramid.blur and pyr_down) or
phase 7 (the probes' entry points); the last line is {"ok": true, "device":
{...}}. Any failure raises, and the script exits non-zero without printing
that line.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the main path's length: keyframes, slow windows, polish at 20, xslow at 48
MAIN_FRAMES = 64
# the replay runs' length: 2 keyframes and both BA windows, within ~60 s
REPLAY_FRAMES = 16
# phase 10's sweep frames, before its stationary stretch
KNOB_FRAMES = 32
# phase 8's fleet: BASELINE config 4, 64 parallel rollouts of 300 steps; its
# profile (and config 4's busy share) over 30 steps, in phase 14's fresh
# process
FLEET_GOALS, FLEET_STEPS = 64, 300
FLEET_PROFILE_STEPS = 30
# choices this close (Dubins lengths in m, pursuit scores, turn commands, the
# distance to the stop radius) are near-ties that float32 order decides
# (tests/test_torch_sim.py)
LOOP_TIE = 1e-4
# phase 8's caps on what ties may excuse: the share of the CPU's fleet states
# from which the card's commands or next state land more than LOOP_TIE apart
# (the CPU tests' bound on the JAX package's states; their 1e-5 is below the
# card's float32 rounding, up to 1.2e-5 away from ties), the share of states
# that are ties (10.8 % on the CPU), and the share of goals that may end more
# than 1e-3 m apart
STATES_APART_MAX = 0.02
TIE_SHARE_MAX = 0.2
EXEMPT_GOALS_MAX = 0.5

# phase 12: the alternative trackers' sweep (the bench sweep's first
# frames, as many as the script's time limit allows), the state (c) starts
# from (after frame 16), the frames fed through the native ring and served
# by the live view
ALT_FRAMES = 32
ALT_STATE_FRAME = 16
RING_FRAMES = 16
SERVE_FRAMES = 16
# phase 12's gates: points at 64 (or 32) frames, lanes then KLT (the JAX
# package on the CPU: 692 and 289 at 64 frames); the card against the
# card host's CPU on one state (matched masks agree on 98 % of candidate
# lanes, positions of lanes matched on both within 2e-3 px on 95 %; brute:
# 1e-4 px on 99 %, ok equal)
ALT_MIN_POINTS = {"lanes": {64: 500, 32: 250}, "klt": {64: 200, 32: 100}}
ALT_MASK_AGREE = 0.98
ALT_PX, ALT_PX_SHARE = 2e-3, 0.95
BRUTE_PX, BRUTE_PX_SHARE = 1e-4, 0.99
BRUTE_SAD = 2.0

# phase 9: seconds the parity processes may take together
PARITY_TIMEOUT_S = 480
# phases 9, 10 and 12 run in processes of their own, all at once, beside
# phases 8 and 11 in this one (each phase is the host's work, and the card
# idles through most of it): the seconds the processes may take together,
# and the directory of their inputs, logs and reports
PARTS_TIMEOUT_S = 720
PARTS_DIR = Path(__file__).resolve().parent / "build" / "smoke_parts"
# the nice value of the processes off the block's longest path (phase 9's
# and phase 10's): the host's cores go first to this process and phase 12's,
# whose CPU witnesses (config 5's solve, the trackers on the CPU) otherwise
# share them with every other process's host loop
PARTS_NICE = 10

# phase 13: bench.py's warm frames and timed ones, seed 0 (seeds 1 and 2,
# and the 64 timed frames, run in the standalone bench, python -m
# slam_robot_tpu_torch.bench; 16 timed frames fit the script's time limit)
BENCH_WARM, BENCH_TIMED = 96, 16

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 FLOP/s outside the tensor cores (every kernel is float32 CUDA-core
# code)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# B2: one 5-tap pass is 5 multiplies and 4 adds per output value
BLUR_FLOPS_PER_TAP_PASS = 9
# B1: per patch pixel and Newton iteration, counted from csrc/newton.cu:
# bilinear value and derivatives 16, first moments 18, residual derivatives
# and g/H sums 56
NEWTON_FLOPS_PER_PIXEL_ITER = 90


def _bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over HBM
    bandwidth and float32 operations over peak, and which of the two it is."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 50) -> float:
    """Mean device ms per call of ``fn`` with the host's launch path taken
    out: ``reps`` calls captured in one CUDA graph, the graph replayed and
    timed with CUDA events. ``fn`` must launch kernels only (no host read)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _gate_capture(name: str, audit: dict) -> None:
    """A profile's capture by its audit (``profile_trace.audit``): fails on a
    kernel launch whose kernel the capture lost (ROADMAP C6), or on kernels
    with no launch to hold them against."""
    from slam_robot_tpu_torch.tools import profile_trace

    fault = profile_trace.audit_fault(audit)
    if fault is not None:
        raise AssertionError(f"{name}: the profile's capture is incomplete: {fault} "
                             f"({json.dumps(audit)})")


def _kernel_us(fn, names, reps: int = 20) -> tuple:
    """Mean device us per call of each kernel whose name holds one of
    ``names``, from torch.profiler over ``reps`` calls of ``fn``
    (``profile_trace.traced``: the calls inside the capture's window), the
    capture audited and taken again if it lost a kernel; and the retakes."""
    import torch
    from torch.profiler import ProfilerActivity

    from slam_robot_tpu_torch.tools import profile_trace

    def calls():
        for _ in range(reps):
            fn()

    def take():
        prof = profile_trace.traced(calls, dev, [ProfilerActivity.CUDA])
        return prof, profile_trace.run_audit(prof, dev)

    dev = torch.device("cuda")
    fn()
    torch.cuda.synchronize()
    (prof, audit), retakes = profile_trace.retaken(
        take, lambda got: profile_trace.audit_fault(got[1]))
    _gate_capture("phase 2's per-launch profile", audit)
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                out[name] = t / reps
    return out, retakes


def phase_blur(frame):
    """B2's sep5 vs plain on the pyramid's shapes; returns the JSON entry."""
    import torch

    from slam_robot_tpu_torch.ops.cuda import blur as bk

    g11 = bk.gaussian_weights(1.1)
    g08 = bk.gaussian_weights(0.8)
    # the 11 calls of build_pyramid at 480x640, in order
    calls = [(frame.shape, g11, 1)]
    h, w = frame.shape
    for _ in range(5):
        calls.append(((h, w), bk.PYRDOWN_WEIGHTS, 2))
        h, w = (h + 1) // 2, (w + 1) // 2
        calls.append(((h, w), g08, 1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [torch.rand(s, generator=gen, device="cuda") for s, _, _ in calls]
    inputs[0] = frame.contiguous()
    max_err = 0.0
    for x, (_, wts, stride) in zip(inputs, calls):
        got = bk.sep5(x, wts, stride)
        want = bk.sep5_plain(x, wts, stride)
        torch.cuda.synchronize()
        assert got.shape == want.shape, (got.shape, want.shape)
        max_err = max(max_err, float((got - want).abs().max()))
    odd = torch.rand((47, 63), generator=gen, device="cuda")
    for stride in (1, 2):
        err = float((bk.sep5(odd, g08, stride) - bk.sep5_plain(odd, g08, stride)).abs().max())
        max_err = max(max_err, err)
    if not max_err <= 1e-5:
        raise AssertionError(f"blur kernel disagrees with its plain version: {max_err}")

    # the one-call PyTorch equivalent (timed as a yardstick, never used by
    # the port): reflect pad, a 5x5 conv2d with the outer product of the
    # taps, and the decimating slice where the level decimates
    import torch.nn.functional as tf

    def outer5(wts):
        k = torch.tensor(wts, device="cuda")
        return torch.outer(k, k)[None, None]

    k2d = [outer5(wts) for _, wts, _ in calls]

    def library(x, k, stride):
        y = tf.conv2d(tf.pad(x[None, None], (2, 2, 2, 2), mode="reflect"), k)[0, 0]
        return y[::2, ::2] if stride == 2 else y

    lib_err = max(float((library(x, k, s) - bk.sep5_plain(x, wts, s)).abs().max())
                  for x, k, (_, wts, s) in zip(inputs, k2d, calls))

    def run_kernel():
        for x, (_, wts, stride) in zip(inputs, calls):
            bk.sep5(x, wts, stride)

    def run_plain():
        for x, (_, wts, stride) in zip(inputs, calls):
            bk.sep5_plain(x, wts, stride)

    def run_library():
        for x, k, (_, _, stride) in zip(inputs, k2d, calls):
            library(x, k, stride)

    plain_ms = _time_ms(run_plain, 50)
    ms = _time_ms(run_kernel, 50)
    lib_ms = _time_ms(run_library, 50)
    lib_ms2 = _time_ms(run_library, 50)
    ms2 = _time_ms(run_kernel, 50)
    plain_ms2 = _time_ms(run_plain, 50)
    lvl0_ms = _time_ms(lambda: bk.sep5(inputs[0], g11, 1), 200)
    # the device alone (a CUDA graph replayed), in turns
    gr = [_graph_ms(run_kernel), _graph_ms(run_kernel)]
    lvl0_gr = [_graph_ms(lambda: bk.sep5(inputs[0], g11, 1)) for _ in range(2)]
    # each input read once, each output written once; the two 5-tap passes
    # over the rows that the output keeps
    n_bytes = n_flops = 0
    for x, (_, _, stride) in zip(inputs, calls):
        h, w = x.shape
        ho, wo = ((h + 1) // 2, (w + 1) // 2) if stride == 2 else (h, w)
        n_bytes += 4 * (h * w + ho * wo)
        n_flops += BLUR_FLOPS_PER_TAP_PASS * (ho * w + ho * wo)
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    print(f"phase 2 blur: max_abs_err {max_err:.3e} (atol 1e-5) over 11 pyramid calls "
          f"+ 47x63; 11 calls kernel {ms:.4f}/{ms2:.4f} ms, plain {plain_ms:.4f}/"
          f"{plain_ms2:.4f} ms, pad+conv2d {lib_ms:.4f}/{lib_ms2:.4f} ms (its max_abs_err "
          f"{lib_err:.3e}); bound {bound_ms:.5f} ms by {bound_by} ({n_bytes} B, "
          f"{n_flops} flop); 480x640 blur alone {lvl0_ms:.4f} ms; by graph replay (the "
          f"device) the 11 calls {gr[0]:.5f} / {gr[1]:.5f} ms, the 480x640 blur "
          f"{lvl0_gr[0]:.5f} / {lvl0_gr[1]:.5f} ms", flush=True)
    return {"name": "sep5_reflect101", "route": "cuda",
            "source": "slam_robot_tpu_torch/csrc/blur.cu",
            "replaces": "slam_robot_tpu/ops/pallas/blur.py:35",
            "max_abs_err": max_err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": min(lib_ms, lib_ms2),
            "graph_ms": min(gr), "level0_ms": lvl0_ms, "level0_graph_ms": min(lvl0_gr),
            "timed": "the 11 build_pyramid calls at 480x640, per frame"}


def _in_turns(route, new, timer) -> tuple[list[float], list[float]]:
    """``timer`` of the pre-PR route and of the new kernel in turns (route,
    new, new, route): (route's two readings, new's two)."""
    r1, n1, n2, r2 = timer(route), timer(new), timer(new), timer(route)
    return [r1, r2], [n1, n2]


def _pyramid_work(h0: int, w0: int, depth: int) -> tuple[int, int]:
    """(bytes, operations) of a flat pyramid: the frame read once, the flat
    tensor written once; per level the two 5-tap passes over the rows (then
    columns) the level keeps."""
    from slam_robot_tpu_torch.ops.cuda import blur as bk

    dims = bk.level_dims(h0, w0, depth)
    n_bytes = 4 * (h0 * w0 + depth * (h0 + 2 * bk.PAD) * (w0 + 2 * bk.PAD))
    n_flops = BLUR_FLOPS_PER_TAP_PASS * 2 * h0 * w0
    for (h, w), (_, ws) in zip(dims[1:], dims[:-1]):
        n_flops += BLUR_FLOPS_PER_TAP_PASS * (h * ws + h * w + 2 * h * w)
    return n_bytes, n_flops


def phase_pyramid(frame):
    """B2's pyramid_flat against the plain flat pyramid on three shapes, and
    timed in turns with the 11-launch route it replaced; returns the JSON
    entry."""
    import torch

    from slam_robot_tpu_torch.ops import pyramid
    from slam_robot_tpu_torch.ops.cuda import blur as bk

    gen = torch.Generator(device="cuda").manual_seed(5)
    grey = pyramid.to_grey(frame).contiguous()
    h0, w0 = grey.shape
    # 158 wide: a padded row of 174 floats (696 B), not a multiple of 16 B
    shapes = {"480x640": grey, "47x63": torch.rand((47, 63), generator=gen, device="cuda"),
              "120x158": torch.rand((120, 158), generator=gen, device="cuda")}
    max_err, route_err = 0.0, {}
    for name, g in shapes.items():
        got = bk.pyramid_flat(g, 6)
        want = bk.pyramid_flat_plain(g, 6)
        torch.cuda.synchronize()
        assert got.shape == want.shape, (got.shape, want.shape)
        max_err = max(max_err, float((got - want).abs().max()))
        if not torch.equal(got[want == 0], want[want == 0]):
            raise AssertionError(f"pyramid_flat {name}: the zero region is not zero")
        if min(bk.level_dims(*g.shape, 6)[-1]) >= 3:  # the route's sep5 needs >= 3
            route = bk.pyramid_flat_plain(g, 6, sep=bk.sep5)
            route_err[name] = float((got - route).abs().max())
    if not max_err <= 1e-5:
        raise AssertionError(f"pyramid_flat disagrees with the plain pyramid: {max_err}")

    def new():
        return bk.pyramid_flat(grey, 6)

    def route():
        return bk.pyramid_flat_plain(grey, 6, sep=bk.sep5)

    ev_route, ev_new = _in_turns(route, new, lambda fn: _time_ms(fn, 100))
    gr_route, gr_new = _in_turns(route, new, _graph_ms)
    plain_ms = _time_ms(lambda: bk.pyramid_flat_plain(grey, 6), 20)
    # each launch's device time (the profiler's kernel rows)
    launch_us, retakes = _kernel_us(new, ("pyramid_tiles", "pyramid_walk"))
    n_bytes, n_flops = _pyramid_work(h0, w0, 6)
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    print(f"phase 2 pyramid_flat: max_abs_err {max_err:.3e} (atol 1e-5, padding and zero "
          f"region included) on {', '.join(shapes)}; against the 11-launch route "
          f"{json.dumps(route_err)}; 480x640 depth 6 in turns (route, new, new, route) by "
          f"events {ev_route[0]:.4f} / {ev_new[0]:.4f} / {ev_new[1]:.4f} / {ev_route[1]:.4f} "
          f"ms, by graph replay {gr_route[0]:.5f} / {gr_new[0]:.5f} / {gr_new[1]:.5f} / "
          f"{gr_route[1]:.5f} ms; per launch (profiler) {json.dumps(launch_us)} us (capture "
          f"retakes {retakes}); plain "
          f"{plain_ms:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} ({n_bytes} B, {n_flops} "
          f"flop); {bk.pyramid_plan(h0, w0, 6)['launches']} launches", flush=True)
    # no single PyTorch call builds a pyramid: library_ms is null
    return {"name": "pyramid_flat", "route": "cuda", "source": bk.SOURCE,
            "replaces": "slam_robot_tpu/ops/pallas/blur.py:35",
            "max_abs_err": max_err, "ms": min(ev_new), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "graph_ms": min(gr_new), "route_ms": min(ev_route), "route_graph_ms": min(gr_route),
            "route_max_abs_diff": route_err, "launch_us": launch_us,
            "timed": "build_pyramid's flat pyramid of a 480x640 frame, depth 6"}


def _newton_lane_iters(args, threshold: float, max_iters: int,
                       unconverged: list | None = None) -> int:
    """Newton iterations that these lanes take (a lane stops when converged
    or out of bounds), from the plain version's step-by-step loop: the work
    this data needs, not the max_iters * F it could. ``unconverged``, when
    given, receives the mask of the active lanes that ran every iteration
    without meeting the step threshold (and stayed in bounds)."""
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    win, pos, org, ref, ref_valid, ref_mean, ref_sumsq, active, wmask, bounds = args
    F, WH, WW = win.shape
    status = pos.new_zeros((F,))
    done = ~((1.0 - active) < 0.5)
    total = 0
    for _ in range(max_iters):
        total += int((~done).sum())
        pos, status, done = nk._newton_iter(
            pos, status, done, win.reshape(F, WH * WW), WW, org, ref,
            wmask[None] * ref_valid, ref_mean, ref_sumsq, bounds[:, 0], bounds[:, 1],
            float(threshold), nk.SIZE, WH)
    if unconverged is not None:
        unconverged.append((active > 0.5) & ~done)
    return total


def phase_newton(frames):
    """B1's one-level call (newton_level) vs plain on real windows; returns
    its figures."""
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.ops import corners, patch, pyramid, tracker_fused
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    cfg = SlamConfig()
    pa = pyramid.build_pyramid(frames[0], 6)
    pb = pyramid.build_pyramid(frames[2], 6)
    grey = pa.data[0, pyramid.PAD:-pyramid.PAD, pyramid.PAD:-pyramid.PAD]
    cpts, cval = corners.detect(grey, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
    pts = cpts[cval]
    wmask = patch.radial_mask(13, 15.0, device="cuda")
    dims = pyramid.level_dims(480, 640, 6)
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    n_status_diff = 0
    timing = {}
    for F in (32, 256):
        idx = torch.arange(F, device="cuda") % pts.shape[0]
        p0 = pts[idx]
        stacks = tracker_fused.get_patch_stacks(pa, p0, 13)
        start = p0 + 3.0 * (torch.rand((F, 2), generator=gen, device="cuda") - 0.5)
        active = (torch.rand((F,), generator=gen, device="cuda") > 0.1).to(torch.float32)
        for lvl in range(6):
            h, w = dims[lvl]
            wh, ww = min(32, h + 16), min(32, w + 16)
            pos0 = (start / 2.0 ** lvl).contiguous()
            if lvl == 5:
                pos0[:4] = torch.tensor([[0.2, 5.0], [19.5, 7.0], [3.0, 0.3], [10.0, 14.8]],
                                        device="cuda")
            win, org = tracker_fused._gather_windows(pb, lvl, pos0, wh, ww)
            args = (win, pos0, org, stacks.data[:, lvl].contiguous(),
                    stacks.valid[:, lvl].to(torch.float32).contiguous(),
                    stacks.mean[:, lvl].contiguous(), stacks.sumsq[:, lvl].contiguous(),
                    active, wmask,
                    torch.tensor([float(w), float(h)], device="cuda").expand(F, 2).contiguous())
            pos_k, st_k = nk.newton_level(*args, threshold=cfg.track_threshold,
                                          max_iters=cfg.track_max_iters)
            pos_p, st_p = nk.newton_window_steps(*args, cfg.track_threshold,
                                                 cfg.track_max_iters)
            torch.cuda.synchronize()
            err = (pos_k - pos_p).abs().max(dim=1).values
            max_err = max(max_err, float(err.max()))
            # a status may flip only for a lane ending within 2e-3 px of the margin
            diff = (st_k != st_p) & ~_near_margin(pos_p, w, h)
            n_status_diff += int(diff.sum())
            if F == 256 and lvl == 0:
                # group G maps onto the same kernel: bit-identical to G = 1
                pos_g, st_g = nk.newton_level(*args, threshold=cfg.track_threshold,
                                              max_iters=cfg.track_max_iters, group=4)
                if not (torch.equal(pos_g, pos_k) and torch.equal(st_g, st_k)):
                    raise AssertionError("newton_level(group=4) differs from group=1")
                n_bytes = sum(a.numel() * a.element_size() for a in args) \
                    + pos_k.numel() * 4 + st_k.numel() * 4
                lane_iters = _newton_lane_iters(args, cfg.track_threshold,
                                                cfg.track_max_iters)
                bound = _bound(n_bytes, NEWTON_FLOPS_PER_PIXEL_ITER * 169 * lane_iters)
                bound_note = (f"bound {bound[0]:.5f} ms by {bound[1]} ({n_bytes} B, "
                              f"{lane_iters} lane-iterations)")
            if lvl in (0, 5):
                k_ms = _time_ms(lambda: nk.newton_level(*args, threshold=cfg.track_threshold,
                                                        max_iters=cfg.track_max_iters), 100)
                p_ms = _time_ms(lambda: nk.newton_window_steps(
                    *args, cfg.track_threshold, cfg.track_max_iters), 20)
                timing[(F, lvl, wh, ww)] = (k_ms, p_ms)
    # tolerance: convergence threshold 1e-3 px; a lane whose last step lands
    # near it may take one more or one fewer step in another summation order
    if not max_err <= 2e-3:
        raise AssertionError(f"newton kernel pos disagrees: max_abs_err {max_err}")
    if n_status_diff:
        raise AssertionError(f"newton kernel status disagrees on {n_status_diff} lanes")
    tline = ", ".join(f"F={F} L{lvl} {wh}x{ww}: kernel {k:.4f} ms plain {p:.4f} ms"
                      for (F, lvl, wh, ww), (k, p) in timing.items())
    print(f"phase 3 newton: pos max_abs_err {max_err:.3e} (atol 2e-3), status equal, "
          f"group=4 equal to group=1 bit for bit; {tline}; F=256 L0 {bound_note}",
          flush=True)
    k_ms, p_ms = timing[(256, 0, 32, 32)]
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "timed": "one level-0 launch, F=256 lanes, 32x32 windows, 6 iterations",
            "all_timings": {f"F{F}_L{lvl}_{wh}x{ww}": {"ms": k, "plain_ms": p}
                            for (F, lvl, wh, ww), (k, p) in timing.items()}}


def _counting_solver(stats: dict, lanes: dict | None = None):
    """The plain level solver, counting the lanes each level takes and the
    Newton iterations they run (the work these inputs need), and keeping the
    positions each level starts from (level 0 first); ``lanes``, when
    given, gets under ``unconverged`` each level's mask of lanes that ran
    out of iterations before converging (level 0 first)."""
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    stats.update(lane_levels=0, lane_iters=0, starts=[])
    if lanes is not None:
        lanes["unconverged"] = []

    def solver(*args, threshold, max_iters, size):
        stats["starts"].insert(0, args[1])
        stats["lane_levels"] += int((args[7] > 0.5).sum())
        masks = None if lanes is None else []
        stats["lane_iters"] += _newton_lane_iters(args, threshold, max_iters, masks)
        if lanes is not None:
            lanes["unconverged"].insert(0, masks[0])
        return nk.newton_window_steps(*args, threshold=threshold, max_iters=max_iters,
                                      size=size)

    return solver


def _near_margin(pos, w: float, h: float):
    """Lanes ending within 2e-3 px of a w x h level's 0.01 px margin."""
    import torch

    x, y = pos[:, 0], pos[:, 1]
    return torch.minimum(torch.minimum(x - 0.01, y - 0.01),
                         torch.minimum(w - 0.01 - x, h - 0.01 - y)).abs() < 2e-3


def _track_check(pa, pb, pts, cfg, F: int, gen, dims, wmask, kw) -> dict:
    """newton_track against the plain level loop at F lanes on a frame pair:
    lanes on ``pts`` (repeated), starts perturbed by up to 1.5 px, half the
    lanes at ``levels_unsure`` levels, 30 % at ``levels_confident`` and 20 %
    at one level both ways (adaptive_fwd_px's first attempt), 10 % inactive;
    the forward pass on pb's planes with the backward stack its
    epilogue samples, the backward pass on pa's window cache. Returns the
    largest differences, the lanes whose ok differs away from the margin,
    the lane-level windows cut elsewhere, each direction's work (lane-levels,
    lane-iterations), the calls' arguments and, per direction (``lanes``),
    each lane's distance from the plain loop's end, that end, and the lanes
    that the plain loop's last level left unconverged."""
    import torch

    from slam_robot_tpu_torch.ops import tracker_fused
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    h0, w0 = dims[0]
    dev = pts.device
    idx = torch.arange(F, device=dev) % pts.shape[0]
    from_pt = pts[idx]
    packed = tracker_fused.pack_stacks(tracker_fused.get_patch_stacks(pa, from_pt, 13))
    init = from_pt + 3.0 * (torch.rand((F, 2), generator=gen, device=dev) - 0.5)
    draw = torch.rand((F,), generator=gen, device=dev)
    lvls = torch.where(draw > 0.5, cfg.levels_unsure,
                       torch.where(draw > 0.2, cfg.levels_confident, 1)).to(torch.int32)
    active = torch.rand((F,), generator=gen, device=dev) > 0.1
    cache = tracker_fused.get_window_stacks(pa, from_pt)
    fwd_args = (init, lvls, active, packed, wmask, dims)
    pos, ok, stack, orgs = nk.newton_track(*fwd_args, planes=pb.data, stack=True,
                                           origins=True, **kw)
    fstats, flanes = {}, {}
    ppos, pok, pwin = nk.track_levels(_counting_solver(fstats, flanes), *fwd_args,
                                      planes=pb.data, return_windows=True, **kw)
    bwd_args = (from_pt, lvls, ok, stack, wmask, dims)
    bpos, bok = nk.newton_track(*bwd_args, win_cache=cache, **kw)
    bstats, blanes = {}, {}
    pbpos, pbok = nk.track_levels(_counting_solver(bstats, blanes), *bwd_args,
                                  win_cache=cache, **kw)
    torch.cuda.synchronize()
    max_err, n_ok_diff = 0.0, 0
    for got, want in (((pos, ok), (ppos, pok)), ((bpos, bok), (pbpos, pbok))):
        max_err = max(max_err, float((got[0] - want[0]).abs().max()))
        n_ok_diff += int(((got[1] != want[1]) & ~_near_margin(want[0], w0, h0)).sum())
    # the epilogue against its plain version on the kernel's own positions
    # and windows
    stack_err = float((stack - nk.stack_at_origins(pb.data, 0, dims, pos, orgs)).abs().max())
    # every level's window cut where the plain loop cuts it, but for a
    # start within 2e-3 px of a pixel boundary
    plain_orgs = torch.stack([o for _, o in pwin], 1)
    n_org_floor = int((plain_orgs != orgs).any(-1).sum())
    n_org_diff = nk.origin_mismatches(pb.data, dims, orgs, plain_orgs, fstats.pop("starts"))
    del bstats["starts"]
    return dict(max_err=max_err, n_ok_diff=n_ok_diff, stack_err=stack_err,
                n_org_floor=n_org_floor, n_org_diff=n_org_diff, fwd_ok=int(ok.sum()),
                bwd_ok=int(bok.sum()), fwd=fstats, bwd=bstats, fwd_args=fwd_args,
                bwd_args=bwd_args, cache=cache,
                lanes={"forward": dict(gap=(pos - ppos).abs().amax(1), plain=ppos,
                                       unconverged=flanes["unconverged"][0]),
                       "backward": dict(gap=(bpos - pbpos).abs().amax(1), plain=pbpos,
                                        unconverged=blanes["unconverged"][0])})


def _track_work(F: int, L: int, st: dict, stack: bool) -> tuple[int, int]:
    """(bytes, operations) of one tracking direction. Bytes: per lane and
    level that ran Newton, its packed references and the 14x14 support its
    taps reach, read once; with ``stack`` (the forward pass's epilogue), per
    lane and level that did not, the 14x14 support the stack samples (where
    Newton ran, the stack samples the support its taps read); pts, lvls,
    active and the mask read once; pos, ok and the stack written once.
    Operations: 90 per pixel and Newton iteration over the lane-iterations
    these inputs take."""
    D = 2 * 169 + 2
    region = 4 * 14 * 14
    lanes = F * (8 + 4 + 1 + 8 + 1) + 4 * 169
    extra = (F * L - st["lane_levels"]) * region + F * L * 4 * D if stack else 0
    n_bytes = (4 * D + region) * st["lane_levels"] + lanes + extra
    return n_bytes, NEWTON_FLOPS_PER_PIXEL_ITER * 169 * st["lane_iters"]


def phase_track(frames):
    """B1's newton_track against the plain level loop, one direction per
    launch, on a rendered frame pair; returns the JSON entry."""
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.ops import corners, patch, pyramid
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    cfg = SlamConfig()
    kw = dict(threshold=cfg.track_threshold, max_iters=cfg.track_max_iters,
              iters_coarse=cfg.track_iters_coarse)
    pa = pyramid.build_pyramid(frames[0], 6)
    pb = pyramid.build_pyramid(frames[2], 6)
    grey = pa.data[0, pyramid.PAD:-pyramid.PAD, pyramid.PAD:-pyramid.PAD]
    cpts, cval = corners.detect(grey, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
    pts = cpts[cval]
    wmask = patch.radial_mask(13, 15.0, device="cuda")
    dims = pyramid.level_dims(480, 640, 6)
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err = stack_err = 0.0
    n_ok_diff = n_org_diff = n_org_floor = 0
    out = {}
    for F in (32, 256):
        r = _track_check(pa, pb, pts, cfg, F, gen, dims, wmask, kw)
        max_err, stack_err = max(max_err, r["max_err"]), max(stack_err, r["stack_err"])
        n_ok_diff += r["n_ok_diff"]
        n_org_diff += r["n_org_diff"]
        n_org_floor += r["n_org_floor"]
        out[F] = {k: r[k] for k in ("fwd_ok", "bwd_ok", "fwd", "bwd")}
    fwd_args, bwd_args, cache = r["fwd_args"], r["bwd_args"], r["cache"]

    # tolerances as phase 3's newton_level: pos 2e-3 px, ok equal but for
    # lanes ending within 2e-3 px of the margin; the stack 1e-5
    if not max_err <= 2e-3:
        raise AssertionError(f"newton_track pos disagrees: max_abs_err {max_err}")
    if n_ok_diff:
        raise AssertionError(f"newton_track ok disagrees on {n_ok_diff} lanes")
    if not stack_err <= 1e-5:
        raise AssertionError(f"newton_track's backward stack disagrees: {stack_err}")
    if n_org_diff:
        raise AssertionError(f"newton_track cut {n_org_diff} lane-level windows elsewhere "
                             f"than the plain loop")

    # F = 256, in turns with the route it replaced: the level loop through
    # newton_level (one launch per level) and the stack sampled after it
    def fwd_new():
        return nk.newton_track(*fwd_args, planes=pb.data, stack=True, **kw)

    def fwd_route():
        p, _, win = nk.track_levels(nk.newton_level, *fwd_args, planes=pb.data,
                                    return_windows=True, **kw)
        return nk.stack_from_windows(win, p, dims)

    def bwd_new():
        return nk.newton_track(*bwd_args, win_cache=cache, **kw)

    def bwd_route():
        return nk.track_levels(nk.newton_level, *bwd_args, win_cache=cache, **kw)

    timing = {}
    for name, route, new in (("forward", fwd_route, fwd_new), ("backward", bwd_route, bwd_new)):
        ev_r, ev_n = _in_turns(route, new, lambda fn: _time_ms(fn, 50))
        gr_r, gr_n = _in_turns(route, new, lambda fn: _graph_ms(fn, 20))
        timing[name] = dict(route_ms=ev_r, ms=ev_n, route_graph_ms=gr_r, graph_ms=gr_n)
    timing["forward"]["plain_ms"] = _time_ms(
        lambda: nk.newton_track_plain(*fwd_args, planes=pb.data, stack=True, **kw), 5)
    timing["backward"]["plain_ms"] = _time_ms(
        lambda: nk.newton_track_plain(*bwd_args, win_cache=cache, **kw), 5)
    for name, st in (("forward", out[256]["fwd"]), ("backward", out[256]["bwd"])):
        n_bytes, n_flops = _track_work(256, 6, st, name == "forward")
        timing[name]["bound_ms"], timing[name]["bound_by"] = _bound(n_bytes, n_flops)
        timing[name].update(bytes=n_bytes, flops=n_flops, **st)
    for name, t in timing.items():
        print(f"phase 3 newton_track {name}, F=256, in turns (route, new, new, route) by "
              f"events {t['route_ms'][0]:.4f} / {t['ms'][0]:.4f} / {t['ms'][1]:.4f} / "
              f"{t['route_ms'][1]:.4f} ms, by graph replay {t['route_graph_ms'][0]:.5f} / "
              f"{t['graph_ms'][0]:.5f} / {t['graph_ms'][1]:.5f} / {t['route_graph_ms'][1]:.5f} "
              f"ms; plain "
              f"{t['plain_ms']:.3f} ms; bound {t['bound_ms']:.5f} ms by {t['bound_by']} "
              f"({t['bytes']} B, {t['lane_iters']} lane-iterations over "
              f"{t['lane_levels']} lane-levels)", flush=True)
    print(f"phase 3 newton_track: pos max_abs_err {max_err:.3e} (atol 2e-3), ok equal "
          f"(near-margin lanes excepted), backward stack max_abs_err {stack_err:.3e} (atol "
          f"1e-5); every window cut where the plain loop cuts it ({n_org_floor} lane-levels "
          f"at a pixel boundary); "
          f"{json.dumps({f: {k: v for k, v in o.items() if 'ok' in k} for f, o in out.items()})}",
          flush=True)
    f = timing["forward"]
    # no single PyTorch call runs a Newton cascade: library_ms is null
    return {"name": "newton_track", "route": "cuda", "source": nk.KERNEL.source,
            "replaces": "slam_robot_tpu/ops/pallas/newton.py:338",
            "max_abs_err": max(max_err, stack_err), "ms": min(f["ms"]),
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None,
            "timed": "the forward direction with its stack, F=256, 6 levels",
            "directions": timing}


def _reset_counts() -> None:
    """Set the main path's kernel and sweep counts to 0."""
    from slam_robot_tpu_torch.ops import tracker_fused
    from slam_robot_tpu_torch.ops.cuda import blur as bk
    from slam_robot_tpu_torch.ops.cuda import newton as nk

    bk.PYRAMID.launches = bk.KERNEL.launches = nk.KERNEL.launches = 0
    tracker_fused.SWEEPS.n = 0


def _read_counts() -> dict:
    from slam_robot_tpu_torch import bench

    return {k: v for k, v in bench.counts().items() if k != "syncs"}


def _check_counts(name: str, counts: dict, n_frames: int) -> None:
    """One pyramid a frame in two pyramid_flat launches, no sep5 launch (no
    route of the 11 calls), one newton_track launch per tracking direction:
    two per sweep that ran, and sweeps that ran."""
    if counts["pyramid_flat"] != 2 * n_frames:
        raise AssertionError(f"{name}: pyramid_flat launches {counts} != 2 per frame")
    if counts["sep5_reflect101"]:
        raise AssertionError(f"{name}: the 11-launch pyramid route ran: {counts}")
    if counts["sweeps"] <= 0 or counts["newton_track"] != 2 * counts["sweeps"]:
        raise AssertionError(f"{name}: newton_track launches {counts} != 2 per sweep")


def _map_state(ps, fn):
    """A (nested) state NamedTuple with ``fn`` applied to every tensor."""
    return type(ps)(*(_map_state(v, fn) if isinstance(v, tuple) else fn(v) for v in ps))


def _drive_sweep(cfg, frames, keep=()):
    """pipeline.step and maybe_polish over ``frames`` from a fresh state on
    the card, the kernel counts set to 0 first. Fails on a non-finite state
    field. Returns (state, figures, {i: copy of the state after frame i for
    i in keep})."""
    import numpy as np
    import torch

    from slam_robot_tpu_torch.device import SYNCS
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.utils.benchscene import sweep_pose
    from slam_robot_tpu_torch.utils.dump import ate_aligned

    ps = pipeline.init(cfg, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()
    sync0 = SYNCS.n
    step_ms = []
    kfs = 0
    dropped = 0
    canary_max = 0.0
    kept = {}
    n_frames = len(frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        ps, met = pipeline.step(ps, frames[i], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
        kfs += int(met["is_keyframe"])
        dropped += int(met["fast_obs_dropped"] + met["slow_obs_dropped"]
                       + met["reproject_obs_dropped"])
        canary_max = max(canary_max, float(met["normalize_canary_px"]))
        if i in keep:
            kept[i] = _map_state(ps, lambda t: t.clone())
    counts = _read_counts()
    syncs = (SYNCS.n - sync0) / n_frames
    m = ps.map
    for name, t in list(m._asdict().items()) + list(ps.matcher._asdict().items()):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in state field {name}")
    n_live = int(m.point_mask.sum())
    nf = int(m.n_frames)
    true_t = np.stack([sweep_pose(i)[1] for i in range(nf)])
    est_t = m.frame_trans[:nf].cpu().numpy()
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    ate_pct = 100.0 * ate_aligned(est_t, true_t) / max(path, 1e-9)
    tail = step_ms[-16:]
    figures = {"frames": n_frames, "n_points": int(m.n_points), "live_points": n_live,
               "keyframes": kfs, "obs_dropped": dropped, "canary_max_px": canary_max,
               "ate_aligned_pct": ate_pct, "median_step_ms_last16": statistics.median(tail),
               "host_syncs_per_frame": syncs, "launches": counts,
               "launches_per_frame": {k: v / n_frames for k, v in counts.items()}}
    return ps, figures, kept


def _sweep_line(f: dict) -> str:
    return (f"{f['frames']} frames, median step {f['median_step_ms_last16']:.2f} ms over the "
            f"last {min(16, f['frames'])}, {f['host_syncs_per_frame']:.1f} host syncs/frame, "
            f"launches {f['launches']} ({json.dumps(f['launches_per_frame'])} per frame), "
            f"n_points {f['n_points']} (live {f['live_points']}), keyframes {f['keyframes']}, "
            f"dropped {f['obs_dropped']}, canary max {f['canary_max_px']:.4f} px, Sim(3)-aligned "
            f"ATE {f['ate_aligned_pct']:.3f} % of path")


def _gate_sweep(name: str, f: dict, min_points: int) -> None:
    """Phase 4's gates on a sweep's figures: at least ``min_points`` points,
    no row dropped, canary < 0.1 px, a finite aligned ATE < 5 % of path."""
    if f["n_points"] < min_points:
        raise AssertionError(f"{name}: map too small: n_points {f['n_points']} < {min_points}")
    if f["obs_dropped"]:
        raise AssertionError(f"{name}: {f['obs_dropped']} obs rows dropped by the fixed windows")
    if not f["canary_max_px"] < 0.1:
        raise AssertionError(f"{name}: normalize canary {f['canary_max_px']} px >= 0.1")
    if not math.isfinite(f["ate_aligned_pct"]):
        raise AssertionError(f"{name}: ATE is not finite")
    if not f["ate_aligned_pct"] < 5.0:
        raise AssertionError(f"{name}: aligned ATE {f['ate_aligned_pct']:.2f} % of path >= 5 %")


def phase_main(frames):
    """Drive pipeline.step over ``frames``; returns (counts, summary, state,
    a copy of the state after the first RING_FRAMES frames)."""
    from slam_robot_tpu_torch import SlamConfig

    ps, summary, kept = _drive_sweep(SlamConfig(), frames, keep=(RING_FRAMES - 1,))
    counts = summary["launches"]
    _check_counts("main path", counts, len(frames))
    print(f"phase 4 main path: {_sweep_line(summary)}", flush=True)
    _gate_sweep("main path", summary, min_points=301)
    return counts, summary, ps, kept[RING_FRAMES - 1]


def phase_profile(ps, frames, start: int, out_dir: str):
    """Phase 5: the port's tools/profile_trace.profile over frames[start:]
    stepped from ``ps``: device busy ms, the idle share against the same
    frames' unprofiled wall time (the profiler slows the host several-fold),
    launches, host ms by span. Writes the trace and the operator table to
    ``out_dir``; returns a summary."""
    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.tools import profile_trace

    cfg = SlamConfig()

    def run():
        state = ps
        for i in range(start, len(frames)):
            state, _ = pipeline.step(state, frames[i], cfg)

    n = len(frames) - start
    p = profile_trace.profile(run, ps.map.device, n, out_dir)
    _gate_capture("phase 5", p["audit"])
    summary = {"frames": n, "profiled_wall_ms_per_frame": p["profiled_wall_ms"],
               "device_busy_ms_per_frame": p["device_ms"],
               "device_idle_share": 1.0 - p["busy_share"],
               "kernel_launches_per_frame": p["kernel_launches"] / n,
               "host_ms_per_frame_by_span": p["host_ms_by_span"]}
    print(f"phase 5 profile: {json.dumps(summary)}", flush=True)
    return summary


def _state_leaves(ps):
    """Every tensor of a PipelineState, in field order."""
    out = []
    for v in ps:
        out.extend(_state_leaves(v) if isinstance(v, tuple) else [v])
    return out


def phase_replay(card: str):
    """Drive run_replay.main in-process on the card; returns (counts, runs)."""
    import contextlib
    import io
    import re
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from slam_robot_tpu_torch import SlamConfig, run_replay
    from slam_robot_tpu_torch.io.recorder import Recorder
    from slam_robot_tpu_torch.io.sources import SyntheticSource
    from slam_robot_tpu_torch.models import pipeline

    root = Path(__file__).resolve().parent / "build" / "replay"
    shutil.rmtree(root, ignore_errors=True)
    frames_dir, dump_path = root / "frames", root / "z"
    cfg = SlamConfig()
    # the card has no PIL: record .npy, the bytes both replays read
    src = SyntheticSource(cfg, n_frames=REPLAY_FRAMES, device="cuda")
    rec = Recorder(str(frames_dir), fmt="npy")
    for i in range(REPLAY_FRAMES):
        rec.save(i, src.get(i % 2, i))
    rec.close()

    counts = {"pyramid_flat": 0, "newton_track": 0, "sep5_reflect101": 0, "sweeps": 0}
    runs = {}

    def run(name, argv, n_frames):
        _reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_replay.main(argv + ["--device", "cuda", "--quiet"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = out.getvalue()
        if rc != 0:
            raise AssertionError(f"run_replay {name} exited {rc}: {text[-2000:]}")
        summary = json.loads(text.strip().splitlines()[-1])
        launches = _read_counts()
        for k, v in launches.items():
            counts[k] += v
        if summary["frames"] != n_frames:
            raise AssertionError(f"{name}: {summary['frames']} frames, want {n_frames}: "
                                 f"{text[-2000:]}")
        _check_counts(f"replay {name}", launches, n_frames)
        if not math.isfinite(summary["error"]):  # the last BA cost
            raise AssertionError(f"{name}: BA cost {summary['error']}")
        if summary["n_points"] <= 5:
            raise AssertionError(f"{name}: map too small: {summary}")
        runs[name] = {"call_s": wall, "summary": summary, "launches": launches,
                      "launches_per_frame": {k: v / n_frames for k, v in launches.items()}}
        return summary, text

    load = ["--load", str(frames_dir), "--max-frames", str(REPLAY_FRAMES)]
    replay, text = run("replay", load + ["--final-ba", "--dump", str(dump_path)],
                       REPLAY_FRAMES)
    final = re.search(r"final full BA: (\d+) iters, mean reproj err (\S+)px", text)
    if final is None or not math.isfinite(float(final.group(2))):
        raise AssertionError(f"final BA line missing or not finite: {text[-1000:]}")
    dump_lines = dump_path.read_text().splitlines()
    if len(dump_lines) < REPLAY_FRAMES:
        raise AssertionError(f"map dump has {len(dump_lines)} lines")
    runs["replay"]["final_ba"] = {"iters": int(final.group(1)),
                                  "mean_reproj_err_px": float(final.group(2)),
                                  "dump_lines": len(dump_lines)}
    live, _ = run("live", load + ["--live"], REPLAY_FRAMES)
    keys = ("frames", "iterations", "n_points", "n_obs")
    if any(live[k] != replay[k] for k in keys):
        raise AssertionError(f"live and replay summaries differ: {live} vs {replay}")
    run("synthetic", ["--synthetic", str(REPLAY_FRAMES)], REPLAY_FRAMES)
    run("checked", ["--synthetic", "4", "--debug-numerics"], 4)

    # checked_step on the first recorded frame: clean, it returns no error
    # and step's state exactly; with a 10x10 NaN block it names the NaN
    ps0 = pipeline.init(cfg, device="cuda")
    img = torch.as_tensor(np.load(frames_dir / f"{0:08d}.npy"), device="cuda")
    ps_step, _ = pipeline.step(ps0, img, cfg)
    err, (ps_checked, _) = pipeline.checked_step(ps0, img, cfg)
    if err.get() is not None:
        raise AssertionError(f"checked_step flagged a clean frame: {err.get()}")
    if not all(torch.equal(a, b) for a, b in
               zip(_state_leaves(ps_step), _state_leaves(ps_checked))):
        raise AssertionError("checked_step's state differs from step's")
    bad = img.clone()
    bad[200:210, 300:310] = float("nan")
    err, _ = pipeline.checked_step(ps0, bad, cfg)
    msg = err.get()
    if msg is None or "nan" not in msg.lower():
        raise AssertionError(f"checked_step missed a NaN frame: {msg}")
    runs["checked"]["nan_frame_error"] = msg
    # call_s: the whole main() call (init, source, final BA); the summary's
    # wall_s and fps: run_replay's own frame loop
    line = {name: {"call_s": r["call_s"], **r["summary"],
                   "launches_per_frame": r["launches_per_frame"],
                   **({"final_ba": r["final_ba"]} if "final_ba" in r else {})}
            for name, r in runs.items()}
    print(f"phase 6 replay on {card}: {json.dumps(line)}; NaN frame: {msg}; "
          f"launches {counts}", flush=True)
    return counts, runs


def _case_bytes(case, args, out) -> int:
    """Bytes a probe case must move: its own count where it has one, else
    every input read once and every output written once."""
    from slam_robot_tpu_torch.tools import flat_tensors

    if case.n_bytes is not None:
        return int(case.n_bytes(*args))
    return sum(t.numel() * t.element_size() for t in flat_tensors(args) + flat_tensors(out))


def phase_probes():
    """Phase 7: every probe module's main on the card, then every case timed.
    Returns (the JSON entries of the probes' entry points, every case's
    measurements by case name)."""
    import collections
    import contextlib
    import importlib
    import io

    import torch

    from slam_robot_tpu_torch import tools
    from slam_robot_tpu_torch.ops.cuda import blur as bk
    from slam_robot_tpu_torch.ops.cuda import probe_windows as pw

    t0 = time.time()
    modules = [importlib.import_module(f"slam_robot_tpu_torch.tools.{name}")
               for name in tools.PROBES]
    cases = [c for m in modules for c in m.CASES]
    kernels = {c.kernel.name: c.kernel for c in cases}
    for k in kernels.values():
        k.launches = 0
    bk.KERNEL.launches = 0  # probe2's reference runs pyramid.blur / pyr_down
    n_pass = 0
    for m in modules:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = m.main(["--device", "cuda"])
        lines = out.getvalue().strip().splitlines()
        passed = [ln for ln in lines if ln.startswith("PASS ")]
        if rc != 0 or len(passed) != len(m.CASES) or len(lines) != len(m.CASES):
            raise AssertionError(f"{m.__name__} exited {rc}:\n" + "\n".join(lines))
        n_pass += len(passed)
    launches = {name: k.launches for name, k in kernels.items()}
    sep5_launches = bk.KERNEL.launches
    if sep5_launches <= 0:
        raise AssertionError("probe2's reference never ran sep5_reflect101")
    # each case's wrapper launches its entry point once
    want = dict(collections.Counter(c.kernel.name for c in cases))
    if launches != want:
        raise AssertionError(f"probe launches {launches}, expected one per case {want}")
    if n_pass != 32:
        raise AssertionError(f"{n_pass} probe cases passed, expected 32")
    check_s = time.time() - t0

    dev = torch.device("cuda")
    # the kernels whose original inputs are constant, again on seeded
    # non-uniform ones (their launches are comparisons, not counted)
    seeded = tools.all_cases("SEEDED")
    for c in seeded:
        ok, detail = tools.check(c, dev)
        print(f"phase 7 {c.name}: {'PASS' if ok else 'FAIL'}, {detail}", flush=True)
        if not ok:
            raise AssertionError(f"probe case {c.name} failed on seeded inputs: {detail}")
    rows = {}
    for c in cases:
        args = c.inputs(dev)
        got, plain = c.run(*args), c.plain(*args)
        torch.cuda.synchronize()
        err = tools.max_abs_err(got, plain)

        def run():
            return c.run(*args)

        # every case by events (the host's call and the device) and by graph
        # replay (the device alone); a case with a library call, it too, in
        # turns
        ms = _time_ms(run, 200)
        lib_ms = lib_graph_ms = None
        if c.library is not None:
            lib_call = c.library(*args)
            lib_ms = _time_ms(lib_call, 200)
            lib_graph_ms = _graph_ms(lib_call)
        graph_ms = _graph_ms(run)
        plain_ms = _time_ms(lambda: c.plain(*args), 20)
        n_bytes = _case_bytes(c, args, got)
        n_flops = int(c.flops(*args)) if c.flops is not None else 0
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        rows[c.name] = {"kernel": c.kernel.name, "replaces": c.replaces, "max_abs_err": err,
                        "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": n_bytes, "flops": n_flops}
        lib = ""
        if c.library is not None:
            rows[c.name].update(library_graph_ms=lib_graph_ms)
            lib = (f", library {lib_ms:.4f} ms ({lib_graph_ms:.5f}); kernel/library "
                   f"{ms / lib_ms:.3f}x by events (the host's call), "
                   f"{graph_ms / lib_graph_ms:.3f}x by graph replay (the device)")
        if c.kernel is pw.WINDOWS_ASYNC:
            # the probes' image is one the copy engine's bulk copies take
            rows[c.name]["path"] = pw.ROUTE_NAMES[pw.async_route(args[0])]
            lib += f"; path {rows[c.name]['path']}"
            if rows[c.name]["path"] != pw.ROUTE_NAMES[pw.BULK]:
                raise AssertionError(f"{c.name}: the async copy took {rows[c.name]['path']}, "
                                     f"not the copy engine, at the probes' shape")
        print(f"phase 7 {c.name}: kernel {ms:.4f} ms ({graph_ms:.5f} by graph replay){lib}, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} B, "
              f"{n_flops} flop), max_abs_err {err:.3g}", flush=True)

    # the fused two-level pyramid against B2's three calls for the same two
    # levels (the probe's own comparison), in turns
    from slam_robot_tpu_torch.ops.cuda import probe_pyramid as pp
    from slam_robot_tpu_torch.tools.probe_pyramid_fused import frame

    img, k = frame(dev), pp.taps().to(dev)
    g0, g1 = bk.gaussian_weights(pp.SIGMA0), bk.gaussian_weights(pp.SIGMA_DOWN)

    def three_calls():
        return bk.sep5(bk.sep5(bk.sep5(img, g0, 1), bk.PYRDOWN_WEIGHTS, 2), g1, 1)

    b2 = [_time_ms(three_calls, 200), _time_ms(lambda: pp.two_level(img, k), 200)]
    b2 += [_time_ms(lambda: pp.two_level(img, k), 200), _time_ms(three_calls, 200)]
    rows["probe2"]["b2_three_calls_ms"] = min(b2[0], b2[3])
    print(f"phase 7 probe2 against B2's three calls (in turns B2, fused, fused, B2): "
          f"{b2[0]:.4f} / {b2[1]:.4f} / {b2[2]:.4f} / {b2[3]:.4f} ms", flush=True)

    # the Newton skeleton against B1 on the skeleton's inputs (256 lanes, 6
    # iterations at most; B1's patch is centred on the position, its bounds
    # are far away), then both pairs with the host's launch path taken out
    from slam_robot_tpu_torch.ops.cuda import newton as nk
    from slam_robot_tpu_torch.ops.cuda import probe_newton as pn
    from slam_robot_tpu_torch.tools import probe_newton_kernel as t14

    win, pos, ref, wmask = t14.inputs(dev)
    f, n = win.shape[0], ref.shape[1] * ref.shape[2]
    b1_args = (win, pos, torch.zeros_like(pos), ref, torch.ones_like(ref),
               ref.sum((1, 2)) / n, (ref * ref).sum((1, 2)) / n, torch.ones((f,), device=dev),
               wmask, torch.full((f, 2), 1e4, device=dev))
    lane_iters = _newton_lane_iters(b1_args, 1e-3, t14.IT)

    def b1():
        return nk.newton_level(*b1_args, threshold=1e-3, max_iters=t14.IT)

    def skeleton():
        return pn.probe_newton(win, pos, ref, wmask, pn.NEWTON, t14.IT)

    b1_ms = min(_time_ms(b1, 200), _time_ms(b1, 200))
    graph = {"B2 three calls": three_calls, "probe2": lambda: pp.two_level(img, k),
             "newton-skeleton": skeleton, "B1": b1}
    dev_ms = {name: [_graph_ms(fn)] for name, fn in graph.items()}
    for name, fn in reversed(list(graph.items())):
        dev_ms[name].append(_graph_ms(fn))
    dev_ms = {name: min(v) for name, v in dev_ms.items()}
    rows["probe2"]["graph_ms"] = dev_ms["probe2"]
    rows["probe2"]["b2_three_calls_graph_ms"] = dev_ms["B2 three calls"]
    rows["newton-skeleton"].update(graph_ms=dev_ms["newton-skeleton"], b1_ms=b1_ms,
                                   b1_graph_ms=dev_ms["B1"], b1_lane_iterations=lane_iters)
    ratios = {"B1/T14": dev_ms["B1"] / dev_ms["newton-skeleton"],
              "B2 three calls/T17": dev_ms["B2 three calls"] / dev_ms["probe2"]}
    rows["newton-skeleton"]["b1_over_t14"] = ratios["B1/T14"]
    rows["probe2"]["b2_over_t17"] = ratios["B2 three calls/T17"]
    print(f"phase 7 device ms per call (a CUDA graph of 50 calls, the lesser of two "
          f"replays): {json.dumps(dev_ms)}; B1 (newton_level, one level of newton_track) on "
          f"the skeleton's inputs {b1_ms:.4f} ms by events, {lane_iters} of {f * t14.IT} "
          f"lane-iterations; device-time ratios {json.dumps(ratios)}", flush=True)

    entries = []
    for name, kern in kernels.items():
        mine = [(case, r) for case, r in rows.items() if r["kernel"] == name]
        first = mine[0][1]  # the entry's first case is the one timed
        entries.append({
            "name": name, "route": "cuda", "source": kern.source,
            "replaces": first["replaces"],
            "replaces_all": sorted({r["replaces"] for _, r in mine}),
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for _, r in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "graph_ms": first.get("graph_ms"), "library_graph_ms": first.get("library_graph_ms"),
            "timed": mine[0][0], "cases": [case for case, _ in mine]})
    print(f"phase 7 probes: {n_pass} cases passed on the card in {check_s:.2f} s, "
          f"{len(seeded)} seeded cases passed, launches {launches}, sep5_reflect101 "
          f"{sep5_launches} (probe2's reference); phase {time.time() - t0:.2f} s", flush=True)
    return entries, rows, sep5_launches


def _run_sim(argv):
    """run_sim.main in-process: (its JSON summary, its results, wall s)."""
    import contextlib
    import io

    import torch

    from slam_robot_tpu_torch import run_sim

    out, res = io.StringIO(), {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = run_sim.main(argv, results=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"run_sim {argv} exited {rc}: {text[-2000:]}")
    return json.loads(text.strip().splitlines()[-1]), res, wall


def _decision_ties(vs, goal):
    """States whose commands a float32 near-tie decides: among the Dubins
    types within LOOP_TIE m of the shortest and, on each, the samples within
    LOOP_TIE of its best pursuit score (``sim.pursuit_samples``, pure
    pursuit's own scoring), the turn commands span more than LOOP_TIE; or
    the distance to the goal lies within LOOP_TIE of ``sim.STOP_RADIUS``.
    (Many states tie between types that trace one curve; those steer alike
    and do not count.)"""
    import torch

    from slam_robot_tpu_torch.models import planner, sim

    paths, lengths = planner.all_paths(vs.pos, vs.heading, goal[..., :2], goal[..., 2])
    pos, heading = vs.pos[..., None, :], vs.heading[..., None]          # [B,1,2], [B,1]
    score, turn = sim.pursuit_samples(pos.expand(*lengths.shape, 2),
                                      heading.expand_as(lengths), paths)  # [B,18,193]
    cand = (((lengths - lengths.min(-1, keepdim=True).values) <= LOOP_TIE)[..., None]
            & (score >= score.max(-1, keepdim=True).values - LOOP_TIE))
    span = (torch.where(cand, turn, -math.inf).amax((-2, -1))
            - torch.where(cand, turn, math.inf).amin((-2, -1)))
    stop = (planner.norm(goal[..., :2] - vs.pos) - sim.STOP_RADIUS).abs() < LOOP_TIE
    return (span > LOOP_TIE) | stop


def _fleet_lockstep(goals, n_steps: int) -> dict:
    """sim.rollout's loop on the card and on the CPU in lockstep from the
    same goals. Per goal: the first step whose commands part (turn by more
    than 1e-4, or speed; -1 where none do), whether the CPU's state there
    was a decision tie, and each device's final distances. Per state of the
    CPU's rollouts, as the CPU tests step from the JAX package's states: the
    largest difference between the card's commands and next state from that
    same state and the CPU's, whether each state where it passes LOOP_TIE is
    a decision tie, and the share of all states that are ties (found on the
    card)."""
    import torch

    from slam_robot_tpu_torch.models import sim, vehicle

    devs = ("cuda", "cpu")
    g = {d: goals.to(d) for d in devs}
    vs = {d: vehicle.init_state(batch=goals.shape[:1], device=d) for d in devs}
    first = torch.full(goals.shape[:1], -1, dtype=torch.long)
    tied = torch.zeros(goals.shape[:1], dtype=torch.bool)
    gaps = torch.zeros(n_steps, *goals.shape[:1])
    differ_tied = torch.zeros(n_steps, *goals.shape[:1], dtype=torch.bool)
    states, dist = [], {}
    for s in range(n_steps):
        cmd = {d: sim.pure_pursuit(vs[d], g[d]) for d in devs}
        split = (((cmd["cuda"][1].cpu() - cmd["cpu"][1]).abs() > 1e-4)
                 | (cmd["cuda"][0].cpu() != cmd["cpu"][0])) & (first < 0)
        if bool(split.any()):
            first[split] = s
            tied |= split & _decision_ties(vs["cpu"], g["cpu"])
        # the card one step from the CPU's own state
        here = vehicle.VehicleState(*(x.cuda() for x in vs["cpu"]))
        shared = sim.pure_pursuit(here, g["cuda"])
        nxt = {d: vehicle.step(st, *c[:2], 0.1)
               for d, st, c in (("cuda", here, shared), ("cpu", vs["cpu"], cmd["cpu"]))}
        for a, b in zip(tuple(shared) + tuple(nxt["cuda"]), tuple(cmd["cpu"]) + tuple(nxt["cpu"])):
            gap = (a.cpu() - b).abs()
            gaps[s] = torch.maximum(gaps[s], gap.reshape(len(gap), -1).amax(-1))
        at = gaps[s] > LOOP_TIE
        if bool(at.any()):
            differ_tied[s, at] = _decision_ties(vehicle.VehicleState(*(x[at] for x in vs["cpu"])),
                                                g["cpu"][at])
        states.append(here)
        for d in devs:
            dist[d] = cmd[d][2]
        vs = {"cuda": vehicle.step(vs["cuda"], *cmd["cuda"][:2], 0.1), "cpu": nxt["cpu"]}
    n_ties = sum(int(_decision_ties(st, g["cuda"]).sum()) for st in states)
    return {"first": first, "tied": tied, "dist": {d: v.cpu() for d, v in dist.items()},
            "gaps": gaps, "differ_tied": differ_tied,
            "tie_share": n_ties / (n_steps * goals.shape[0])}


def _finite(name: str, tensors) -> None:
    import torch

    for t in tensors:
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {name}")


def _pyramid_figures(grey, depth: int) -> dict:
    """pyramid_flat against pyramid_flat_plain on ``grey`` at ``depth``, every
    element (the edge padding and the zero region included) within atol
    1e-5, timed by events and by graph replay beside its bound."""
    import torch

    from slam_robot_tpu_torch.ops.cuda import blur as bk

    h0, w0 = grey.shape
    got, want = bk.pyramid_flat(grey, depth), bk.pyramid_flat_plain(grey, depth)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"pyramid_flat at {h0}x{w0} depth {depth}: max_abs_err {err}")
    if not torch.equal(got[want == 0], want[want == 0]):
        raise AssertionError("pyramid_flat: the zero region is not zero")
    n_bytes, n_flops = _pyramid_work(h0, w0, depth)
    b_ms, b_by = _bound(n_bytes, n_flops)
    return {"shape": f"{h0}x{w0}, depth {depth}", "max_abs_err": err,
            "launches_per_call": bk.pyramid_plan(h0, w0, depth)["launches"],
            "ms": _time_ms(lambda: bk.pyramid_flat(grey, depth), 100),
            "graph_ms": _graph_ms(lambda: bk.pyramid_flat(grey, depth)),
            "plain_ms": _time_ms(lambda: bk.pyramid_flat_plain(grey, depth), 20),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "flops": n_flops}


def _direction_figures(calls: dict, plain: dict, work: dict) -> dict:
    """Per tracking direction: the kernel's call by events and by graph
    replay, its plain version by events, and the bound of ``work``
    ({direction: ((bytes, operations), lane stats)})."""
    out = {}
    for name, ((n_bytes, n_flops), st) in work.items():
        b_ms, b_by = _bound(n_bytes, n_flops)
        out[name] = {"ms": _time_ms(calls[name], 100), "graph_ms": _graph_ms(calls[name], 20),
                     "plain_ms": _time_ms(plain[name], 5), "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": n_bytes, "flops": n_flops, **st}
    return out


def phase_loop_kernels(cfg, frames=None) -> dict:
    """B2's pyramid_flat and B1's newton_track at ``cfg``'s shapes (the SLAM
    loop's: a 120x160 frame, depth 4; F = 96 lanes over 4 levels) against
    their plain versions with phases 2 and 3's tolerances, each timed by
    events and by graph replay beside its bound; returns both figures. The
    frame pair is ``frames`` or, by default, two of the loop's views."""
    import torch

    from slam_robot_tpu_torch.models import renderer, sim, vehicle
    from slam_robot_tpu_torch.ops import corners, patch, pyramid
    from slam_robot_tpu_torch.ops.cuda import newton as nk
    from slam_robot_tpu_torch.utils import synthetic

    h0, w0, depth, F = cfg.image_height, cfg.image_width, cfg.pyramid_depth, cfg.max_features
    if frames is None:
        world = sim.make_world(400, seed=0, device="cuda")
        k = torch.as_tensor(synthetic.reference_intrinsics(cfg), device="cuda")
        # the loop's camera turned to +Z, where the landmarks are, and one
        # 0.2 s step later
        vs = vehicle.init_state(heading=math.pi / 2, device="cuda")
        frames = []
        for _ in range(2):
            q, t = sim.camera_pose(vs)
            frames.append(renderer.render(q, t, k, world.points, world.brightness, h0, w0))
            vs = vehicle.step(vs, 0.5, 0.2, 0.2)

    pyr = _pyramid_figures(frames[0].contiguous(), depth)

    # B1: both directions at F lanes over the loop's pyramids
    kw = dict(threshold=cfg.track_threshold, max_iters=cfg.track_max_iters,
              iters_coarse=cfg.track_iters_coarse)
    pa, pb = pyramid.build_pyramid(frames[0], depth), pyramid.build_pyramid(frames[1], depth)
    gpa = pa.data[0, pyramid.PAD:-pyramid.PAD, pyramid.PAD:-pyramid.PAD]
    cpts, cval = corners.detect(gpa, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
    pts = cpts[cval]
    wmask = patch.radial_mask(13, 15.0, device="cuda")
    dims = pyramid.level_dims(h0, w0, depth)
    gen = torch.Generator(device="cuda").manual_seed(8)
    r = _track_check(pa, pb, pts, cfg, F, gen, dims, wmask, kw)
    if not r["max_err"] <= 2e-3:
        raise AssertionError(f"newton_track at F={F} L={depth}: pos max_abs_err {r['max_err']}")
    if r["n_ok_diff"]:
        raise AssertionError(f"newton_track at F={F} L={depth}: ok disagrees on "
                             f"{r['n_ok_diff']} lanes")
    if not r["stack_err"] <= 1e-5:
        raise AssertionError(f"newton_track at F={F} L={depth}: stack {r['stack_err']}")
    if r["n_org_diff"]:
        raise AssertionError(f"newton_track at F={F} L={depth}: {r['n_org_diff']} windows "
                             f"cut elsewhere than the plain loop")
    track = {"shape": f"F={F}, {depth} levels, {h0}x{w0}", "corners": int(pts.shape[0]),
             "max_abs_err": max(r["max_err"], r["stack_err"]), "pos_err": r["max_err"],
             "stack_err": r["stack_err"], "fwd_ok": r["fwd_ok"], "bwd_ok": r["bwd_ok"]}
    calls = {"forward": lambda: nk.newton_track(*r["fwd_args"], planes=pb.data, stack=True,
                                                **kw),
             "backward": lambda: nk.newton_track(*r["bwd_args"], win_cache=r["cache"], **kw)}
    plain = {"forward": lambda: nk.newton_track_plain(*r["fwd_args"], planes=pb.data,
                                                      stack=True, **kw),
             "backward": lambda: nk.newton_track_plain(*r["bwd_args"], win_cache=r["cache"],
                                                       **kw)}
    work = {"forward": (_track_work(F, depth, r["fwd"], True), r["fwd"]),
            "backward": (_track_work(F, depth, r["bwd"], False), r["bwd"])}
    track.update(_direction_figures(calls, plain, work))
    return {"pyramid_flat": pyr, "newton_track": track}


def phase_loop(card: str):
    """Phase 8: the closed loop through run_sim.main in-process. Returns (the
    SLAM run's kernel counts, the phase's summary, the kernels' figures at
    the loop's shapes)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from slam_robot_tpu_torch import SlamConfig, stop
    from slam_robot_tpu_torch.run_sim import SLAM_LOOP

    t0 = time.time()
    # 1. the fleet (BASELINE config 4) on the card and on the CPU
    argv = ["--goals", str(FLEET_GOALS), "--steps", str(FLEET_STEPS)]
    card_sum, on_card, card_s = _run_sim(argv)
    cpu_sum, on_cpu, cpu_s = _run_sim(argv + ["--device", "cpu"])
    d_card, d_cpu = on_card["dist"].cpu().numpy(), on_cpu["dist"].numpy()
    _finite("the card's fleet", [on_card["traj"], on_card["dist"]])
    reached = [int((d < 0.5).sum()) for d in (d_card, d_cpu)]
    median = [float(np.median(d)) for d in (d_card, d_cpu)]
    if abs(reached[0] - reached[1]) > 1:
        raise AssertionError(f"fleet reached {reached[0]} on the card, {reached[1]} on the CPU")
    if abs(median[0] - median[1]) > 0.01:
        raise AssertionError(f"fleet median {median[0]} m on the card, {median[1]} on the CPU")
    lock = _fleet_lockstep(on_card["goals"], FLEET_STEPS)
    first, tied = lock["first"], lock["tied"]
    if not (np.array_equal(lock["dist"]["cuda"].numpy(), d_card)
            and np.array_equal(lock["dist"]["cpu"].numpy(), d_cpu)):
        raise AssertionError("the lockstep loop's distances differ from run_sim's")
    gaps, differ_tied = lock["gaps"].numpy(), lock["differ_tied"].numpy()
    differ = gaps > LOOP_TIE
    if (differ & ~differ_tied).any() or differ.mean() > STATES_APART_MAX:
        raise AssertionError(
            f"{int(differ.sum())} of {differ.size} states step more than {LOOP_TIE} apart on the card "
            f"and the CPU ({int((differ & ~differ_tied).sum())} without a decision tie; at most "
            f"{STATES_APART_MAX:.0%} may, each at a tie)")
    if lock["tie_share"] > TIE_SHARE_MAX:
        raise AssertionError(f"{lock['tie_share']:.2%} of the fleet's states are decision ties, "
                             f"more than {TIE_SHARE_MAX:.0%}")
    apart = np.abs(d_card - d_cpu) > 1e-3
    untied = np.nonzero(apart & ~tied.numpy())[0]
    if untied.size:
        raise AssertionError(f"goals {untied.tolist()} end more than 1e-3 m apart on the card "
                             f"and the CPU without a decision tie")
    if apart.sum() > EXEMPT_GOALS_MAX * FLEET_GOALS:
        raise AssertionError(f"{int(apart.sum())} of {FLEET_GOALS} goals end more than 1e-3 m "
                             f"apart, more than {EXEMPT_GOALS_MAX:.0%}")
    fleet = {"card": card_sum, "cpu": cpu_sum, "card_call_s": card_s, "cpu_call_s": cpu_s,
             "fleet_steps_per_s": FLEET_STEPS / card_s,
             "rollout_steps_per_s": FLEET_GOALS * FLEET_STEPS / card_s,
             "goals_apart_1e-3": int(apart.sum()), "goals_parted_at_a_tie": int(tied.sum()),
             "states_apart_1e-4": int(differ.sum()), "states": int(differ.size),
             "largest_gap_within_1e-4": float(gaps[~differ].max()),
             "smallest_gap_apart": float(gaps[differ].min()) if differ.any() else None,
             "tie_share": lock["tie_share"],
             "first_split_steps": sorted(int(x) for x in first[first >= 0]),
             "max_final_dist_diff_m": float(np.abs(d_card - d_cpu).max())}
    print(f"phase 8 fleet on {card}: {FLEET_GOALS} rollouts x {FLEET_STEPS} steps in "
          f"{card_s:.3f} s ({fleet['rollout_steps_per_s']:.1f} rollout steps/s), CPU "
          f"{cpu_s:.3f} s; card {json.dumps(card_sum)}; CPU {json.dumps(cpu_sum)}; reached "
          f"{reached}, median {median} m; {int(apart.sum())} goals end > 1e-3 m apart, every "
          f"one parted at a decision tie ({int(tied.sum())} parted at one, steps "
          f"{fleet['first_split_steps']}); from the CPU's states {int(differ.sum())} of "
          f"{differ.size} step > {LOOP_TIE} apart, each at a tie (the others within "
          f"{fleet['largest_gap_within_1e-4']:.3g}, those apart by >= "
          f"{fleet['smallest_gap_apart']}); {lock['tie_share']:.4%} of the states are ties; "
          f"its profile of {FLEET_PROFILE_STEPS} steps runs in phase 14's fresh process",
          flush=True)

    # 2. the same on a mesh of the one card
    mesh_sum, mesh, mesh_s = _run_sim(argv + ["--mesh"])
    if ({k: v for k, v in mesh_sum.items() if k != "wall_s"}
            != {k: v for k, v in card_sum.items() if k != "wall_s"}
            or not torch.equal(mesh["dist"], on_card["dist"])):
        raise AssertionError(f"--mesh {mesh_sum} differs from the fleet {card_sum}")
    fleet["mesh"], fleet["mesh_call_s"] = mesh_sum, mesh_s
    print(f"phase 8 mesh: {json.dumps(mesh_sum)} in {mesh_s:.3f} s, equal to the fleet's",
          flush=True)

    # 3. SLAM in the loop, with the launch gates of phases 4 and 6
    _reset_counts()
    slam_sum, slam, slam_s = _run_sim(["--slam"])
    counts = _read_counts()
    n = slam_sum["steps"]
    if n != 30:
        raise AssertionError(f"SLAM in the loop ran {n} steps, want 30")
    _check_counts("SLAM in the loop", counts, n)
    _finite("the SLAM loop's trajectory, estimates or distance",
            [slam["traj"], slam["est"], slam["dist"]])
    ps = slam["pipeline"]
    _finite("the SLAM loop's last state", list(ps.map) + list(ps.matcher))
    step_ms = slam["step_ms"]
    loop = {"fleet": fleet, "slam": {
        **slam_sum, "call_s": slam_s, "median_step_ms": statistics.median(step_ms),
        "step_ms_min_max": [min(step_ms), max(step_ms)],
        "final_dist_m_unrounded": float(slam["dist"]),
        "est_final_mm_unrounded": slam["est"][-1].tolist(), "n_points": int(ps.map.n_points),
        "launches": counts, "launches_per_frame": {k: v / n for k, v in counts.items()}}}
    print(f"phase 8 SLAM in the loop on {card}: {json.dumps(loop['slam'])}", flush=True)

    # 4. the kernels at the loop's shapes
    kern = phase_loop_kernels(SlamConfig(**SLAM_LOOP))
    print(f"phase 8 kernels at the loop's shapes on {card}: {json.dumps(kern)}", flush=True)

    # 5. the emergency stop
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = stop.main()
    if rc != 0 or out.getvalue() != "stop sequence issued (10 control transfers)\n":
        raise AssertionError(f"stop exited {rc}: {out.getvalue()!r}")
    loop["stop"] = out.getvalue().strip()
    print(f"phase 8 stop: {loop['stop']}; phase {time.time() - t0:.2f} s", flush=True)
    return counts, loop, kern


def phase_parity_kernels() -> dict:
    """B2's pyramid_flat and B1's newton_track at the parity sequences'
    shapes (tools/parity's 240x320, depth 5, F = 192 lanes) and in their
    reference-exact mode, against their plain versions with phases 2 and
    3's tolerances, each timed by events and by graph replay beside its
    bound; returns both figures. The forward pass runs on the new frame's
    planes with no backward stack; the backward pass runs on the view ring
    (the matcher's stacked view pyramids, each lane's at a plane offset of
    its own) with references extracted at the forward pass's positions and
    no window cache. Lanes at budgets of 5, 3 and 1 level, 10 % inactive."""
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.io import sources
    from slam_robot_tpu_torch.ops import corners, patch, pyramid, tracker_fused
    from slam_robot_tpu_torch.ops.cuda import newton as nk
    from slam_robot_tpu_torch.tools import parity

    spec = parity.SEQUENCES["forward_yaw"]
    cfg = SlamConfig(**spec["cfg"])
    if cfg.bwd_window_cache or cfg.bwd_ref_from_window:
        raise AssertionError("the parity sequences are no longer in reference-exact mode")
    h0, w0, depth = cfg.image_height, cfg.image_width, cfg.pyramid_depth
    F, V = cfg.max_features, cfg.max_views
    src = sources.SyntheticSource(cfg, device="cuda", **spec["seq"])
    # the ring's V views are the sequence's frames 0..V-1 (both cameras); the
    # new frame is frame V
    grey = [pyramid.to_grey(torch.as_tensor(src.get(i % 2, i), device="cuda")).contiguous()
            for i in range(V + 1)]
    pyr = _pyramid_figures(grey[V], depth)

    kw = dict(threshold=cfg.track_threshold, max_iters=cfg.track_max_iters,
              iters_coarse=cfg.track_iters_coarse)
    views = [pyramid.build_pyramid(g, depth) for g in grey[:V]]
    new = pyramid.build_pyramid(grey[V], depth)
    dims = pyramid.level_dims(h0, w0, depth)
    gen = torch.Generator(device="cuda").manual_seed(9)
    off = (torch.randint(0, V, (F,), generator=gen, device="cuda") * depth).long()
    ring = pyramid.FlatPyramid(torch.cat([v.data for v in views]), None, None, depth_=depth,
                               offset=off)
    cpts, cval = corners.detect(grey[0], cfg.max_corners, cfg.corner_quality,
                                cfg.corner_min_dist)
    pts = cpts[cval]
    from_pt = pts[torch.arange(F, device="cuda") % pts.shape[0]]
    packed = tracker_fused.pack_stacks(tracker_fused.get_patch_stacks(ring, from_pt, 13))
    init = from_pt + 3.0 * (torch.rand((F, 2), generator=gen, device="cuda") - 0.5)
    draw = torch.rand((F,), generator=gen, device="cuda")
    lvls = torch.where(draw > 0.5, cfg.levels_unsure,
                       torch.where(draw > 0.2, cfg.levels_confident, 1)).to(torch.int32)
    active = torch.rand((F,), generator=gen, device="cuda") > 0.1
    wmask = patch.radial_mask(13, 15.0, device="cuda")

    fwd_args = (init, lvls, active, packed, wmask, dims)
    pos, ok = nk.newton_track(*fwd_args, planes=new.data, **kw)
    fstats = {}
    ppos, pok = nk.track_levels(_counting_solver(fstats), *fwd_args, planes=new.data, **kw)
    bwd_args = (from_pt, lvls, ok, tracker_fused._extract_packed(new, pos, 13), wmask, dims)
    bpos, bok = nk.newton_track(*bwd_args, planes=ring.data, offset=off, **kw)
    bstats = {}
    pbpos, pbok = nk.track_levels(_counting_solver(bstats), *bwd_args, planes=ring.data,
                                  offset=off, **kw)
    # every level's window cut where the plain loop cuts it, both directions
    n_org_diff = 0
    for args, src_kw, st in ((fwd_args, dict(planes=new.data), fstats),
                             (bwd_args, dict(planes=ring.data, offset=off), bstats)):
        orgs = nk.newton_track(*args, origins=True, **src_kw, **kw)[2]
        _, _, pwin = nk.track_levels(nk.newton_window_steps, *args, return_windows=True,
                                     **src_kw, **kw)
        n_org_diff += nk.origin_mismatches(new.data, dims, orgs,
                                           torch.stack([o for _, o in pwin], 1),
                                           st.pop("starts"))
    torch.cuda.synchronize()
    errs = {"forward": float((pos - ppos).abs().max()),
            "backward": float((bpos - pbpos).abs().max())}
    n_ok_diff = {d: int(((got != want) & ~_near_margin(at, w0, h0)).sum())
                 for d, got, want, at in (("forward", ok, pok, ppos),
                                          ("backward", bok, pbok, pbpos))}
    label = f"newton_track at the parity shapes (F={F}, {depth} levels, {h0}x{w0})"
    for d in errs:
        if not errs[d] <= 2e-3:
            raise AssertionError(f"{label}, {d}: pos max_abs_err {errs[d]}")
        if n_ok_diff[d]:
            raise AssertionError(f"{label}, {d}: ok disagrees on {n_ok_diff[d]} lanes")
    if n_org_diff:
        raise AssertionError(f"{label}: {n_org_diff} windows cut elsewhere than the plain loop")
    if not (int(ok.sum()) and int(bok.sum())):
        raise AssertionError(f"{label}: no lane converged ({int(ok.sum())} forward, "
                             f"{int(bok.sum())} backward)")
    track = {"shape": f"F={F}, {depth} levels, {h0}x{w0}, {V} views in the ring",
             "corners": int(pts.shape[0]), "max_abs_err": max(errs.values()),
             "pos_err": errs, "fwd_ok": int(ok.sum()), "bwd_ok": int(bok.sum()),
             "lanes_by_view": torch.bincount(off // depth, minlength=V).tolist()}
    calls = {"forward": lambda: nk.newton_track(*fwd_args, planes=new.data, **kw),
             "backward": lambda: nk.newton_track(*bwd_args, planes=ring.data, offset=off, **kw)}
    plain = {"forward": lambda: nk.newton_track_plain(*fwd_args, planes=new.data, **kw),
             "backward": lambda: nk.newton_track_plain(*bwd_args, planes=ring.data, offset=off,
                                                       **kw)}
    fb, ff = _track_work(F, depth, fstats, False)
    bb, bf = _track_work(F, depth, bstats, False)
    work = {"forward": ((fb, ff), fstats), "backward": ((bb + 8 * F, bf), bstats)}
    track.update(_direction_figures(calls, plain, work))
    return {"pyramid_flat": pyr, "newton_track": track}


def _start(name: str, argv: list, out_dir: Path, nice: int = 0) -> subprocess.Popen:
    """``python argv`` from the checkout's root in a process group of its
    own, its output to ``out_dir/NAME.log``, at ``nice`` (set before it
    starts a thread of its own: its threads inherit it)."""
    import os

    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{name}.log", "w") as f:
        proc = subprocess.Popen([sys.executable, *argv], stdout=f, stderr=subprocess.STDOUT,
                                cwd=Path(__file__).resolve().parent, start_new_session=True)
    if nice:
        os.setpriority(os.PRIO_PROCESS, proc.pid, nice)
    return proc


def _stop(procs: dict) -> None:
    """End every process of ``procs`` ({name: Popen}) that still runs, and
    what it started."""
    import os
    import signal

    for proc in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _wait(what: str, proc: subprocess.Popen, deadline: float) -> None:
    """Wait for ``proc`` until ``deadline`` (time.time()); fails past it."""
    try:
        proc.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what}: the process ran past its time limit") from None


def _start_parity(names, out_dir: Path) -> dict:
    """Each sequence of ``names`` replayed by the port's parity tool in a
    process of its own (``python -m slam_robot_tpu_torch.tools.parity --seq
    NAME --out F``), all at once; {name: process}."""
    procs = {}
    for name in names:
        (out_dir / f"{name}.json").unlink(missing_ok=True)
        procs[name] = _start(name, ["-m", "slam_robot_tpu_torch.tools.parity", "--seq", name,
                                    "--out", str(out_dir / f"{name}.json"), "--device", "cuda"],
                             out_dir, PARTS_NICE)
    return procs


def _parity_reports(procs: dict, out_dir: Path, deadline: float) -> dict:
    """The reports of :func:`_start_parity`'s processes by name. Fails on a
    process that leaves no report (its log's end in the message) or that
    runs past ``deadline``."""
    reports = {}
    for name, proc in procs.items():
        _wait(f"phase 9 {name}", proc, deadline)
        out = out_dir / f"{name}.json"
        if not out.exists():  # the tool writes its report after every draw
            tail = (out_dir / f"{name}.log").read_text()[-2000:]
            raise AssertionError(f"phase 9 {name}: the replay exited {proc.returncode} "
                                 f"with no report:\n{tail}")
        reports[name] = json.loads(out.read_text())["sequences"][0]
    return reports


# the phases that run_part runs in a process of its own, the lines of its
# output that the script prints as theirs, and its nice value
PARTS = {"knobs": "phase 10", "alt": "phase 12"}
PART_NICE = {"knobs": PARTS_NICE, "alt": 0}


def _write_part_inputs(frames, direct, serve_baseline: dict) -> None:
    """What run_part reads: the sweep's frames (phase 10 takes the first
    KNOB_FRAMES, phase 12 the first ALT_FRAMES), phase 4's state after the
    first RING_FRAMES frames (a utils/checkpoint file) and phase 6's
    synthetic run's summary."""
    import torch

    from slam_robot_tpu_torch.utils import checkpoint

    PARTS_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(torch.stack(frames).cpu(), PARTS_DIR / "frames.pt")
    checkpoint.save(direct, str(PARTS_DIR / "direct.pt"))
    (PARTS_DIR / "serve_baseline.json").write_text(json.dumps(
        {k: serve_baseline[k] for k in ("n_points", "n_obs")}))


def _start_part(name: str) -> subprocess.Popen:
    """``python chip_smoke.py --part NAME`` (:func:`run_part`)."""
    (PARTS_DIR / f"{name}.json").unlink(missing_ok=True)
    return _start(name, [str(Path(__file__).resolve()), "--part", name], PARTS_DIR,
                  PART_NICE[name])


def _part_result(name: str, proc: subprocess.Popen, deadline: float) -> tuple:
    """(kernel counts, summary) of :func:`run_part`'s process ``name``, its
    phase's lines printed; fails on an exit other than 0 (its log's end in
    the message) or past ``deadline``."""
    _wait(PARTS[name], proc, deadline)
    log = (PARTS_DIR / f"{name}.log").read_text()
    if proc.returncode != 0:
        raise AssertionError(f"{PARTS[name]}: its process exited {proc.returncode}:\n"
                             f"{log[-3000:]}")
    for line in log.splitlines():
        if line.startswith(PARTS[name]):
            print(line, flush=True)
    res = json.loads((PARTS_DIR / f"{name}.json").read_text())
    return res["counts"], res["summary"]


def run_part(name: str) -> int:
    """The child of :func:`_start_part`: phase 10 ("knobs") or phase 12
    ("alt") on the card from :func:`_write_part_inputs`' files, its gates
    as in the script's own process; writes (kernel counts, summary) to
    PARTS_DIR/NAME.json."""
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.ops.cuda import build
    from slam_robot_tpu_torch.utils import checkpoint

    card = _card_line()
    build.load_library()
    frames = list(torch.load(PARTS_DIR / "frames.pt", weights_only=True).cuda())
    if name == "knobs":
        counts, summary = phase_knobs(frames[:KNOB_FRAMES], card)
    else:
        direct = checkpoint.restore(pipeline.init(SlamConfig(), device="cuda"),
                                    str(PARTS_DIR / "direct.pt"), torch.device("cuda"))
        baseline = json.loads((PARTS_DIR / "serve_baseline.json").read_text())
        counts, summary = phase_alt(frames[:ALT_FRAMES], card, direct, baseline)
    _no_foreign_modules()
    (PARTS_DIR / f"{name}.json").write_text(json.dumps({"counts": counts, "summary": summary}))
    return 0


def _no_foreign_modules() -> None:
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "slam_robot_tpu", "tools"))
    if foreign:
        raise AssertionError(f"the port loaded JAX, the JAX package or its tools: {foreign}")


def phase_parity(card: str, procs: dict, t0: float):
    """Phase 9: the port's parity replay of the four sequences on the card
    (six draws), a process a sequence, all at once (``procs``, of
    :func:`_start_parity`, started at ``t0``). Returns (kernel counts, the
    phase's summary, the kernels at the sequences' shapes)."""
    from slam_robot_tpu_torch.tools import parity

    reports = _parity_reports(procs, PARTS_DIR, t0 + PARITY_TIMEOUT_S)
    counts = {"pyramid_flat": 0, "newton_track": 0, "sep5_reflect101": 0, "sweeps": 0}
    for name, spec in parity.SEQUENCES.items():
        rep = reports[name]
        n = spec["seq"]["n_frames"]
        for r in rep.get("per_seed", [rep]):
            label = f"{name} seed {r['seed']}" if "seed" in r else name
            r["launches_per_frame"] = {k: v / n for k, v in r["launches"].items()}
            verdict = "inside" if r["drift_ok"] else "OVER"
            print(f"phase 9 {label} on {card}: drift {r['ate_vs_golden_mm']} mm, gate "
                  f"{r['gate_mm']} mm ({verdict}); truth ATE {r['ate_pct_of_path']} %, cap "
                  f"{r['truth_gate_pct']} %; median {r['median_enabled_err_px']} px, golden + 0.1 "
                  f"= {r['golden_median_px'] + 0.1:.4f} px; n_obs {r['n_obs']}, n_points "
                  f"{r['n_points']}; wall {r['wall_s']:.2f} s, median step "
                  f"{r['median_step_ms']:.2f} ms; launches per frame "
                  f"{json.dumps(r['launches_per_frame'])}", flush=True)
            if not r["finite"]:
                raise AssertionError(f"phase 9 {label}: a NaN or Inf in the trajectory")
            if not r["cap_ok"]:
                raise AssertionError(f"phase 9 {label}: truth ATE {r['ate_pct_of_path']} % over "
                                     f"its cap {r['truth_gate_pct']} %")
            if not r["median_ok"]:
                raise AssertionError(f"phase 9 {label}: median {r['median_enabled_err_px']} px "
                                     f"over the golden's {r['golden_median_px']} + 0.1")
            _check_counts(f"phase 9 {label}", r["launches"], n)
            for k in counts:  # counted in the draw's own process
                counts[k] += r["launches"][k]
        if "median_truth_pct" in rep:
            print(f"phase 9 {name}: median truth ATE {rep['median_truth_pct']} % of path, bar "
                  f"{rep['median_gate_pct']} %", flush=True)
            if not rep["median_truth_pct"] <= rep["median_gate_pct"]:
                raise AssertionError(f"phase 9 {name}: the {len(rep['seeds'])}-seed median "
                                     f"{rep['median_truth_pct']} % is over its bar")
    per_draw = [r for rep in reports.values() for r in rep.get("per_seed", [rep])]
    inside = sum(r["drift_ok"] for r in per_draw)
    # the north star's reading, not a gate of this script: the goldens are
    # the JAX package's own float order on XLA:CPU
    print(f"parity drift: {inside} of {len(per_draw)} draws inside their gate", flush=True)
    summary = {"reports": reports, "drift_inside": inside, "draws": len(per_draw),
               "frames": sum(p["seq"]["n_frames"] * len(p.get("seeds", [0]))
                             for p in parity.SEQUENCES.values()),
               "launches": counts, "phase_s": time.time() - t0}
    print(f"phase 9 parity on {card}: {summary['frames']} frames in {summary['phase_s']:.2f} s, "
          f"launches {counts}", flush=True)
    kern = phase_parity_kernels()
    print(f"phase 9 kernels at the parity shapes on {card}: {json.dumps(kern)}", flush=True)
    return counts, summary, kern


# phase 10: every off-by-default knob of the step at once
ALL_KNOBS = dict(mid_frame_resolve=True, motion_model="constant_velocity", retry_mode="cycle",
                 adaptive_fwd_px=1.0, seed_depth_adaptive=True, drop_idle_frames=True,
                 clean_duplicates=True)


def _idle_pop_check(m) -> dict:
    """check_not_moving on ``m`` with its newest two frames moved onto the
    two before them (and marked no keyframe): two frames go, and the obs
    table and rings end as the CPU's plain run of the same call leaves them."""
    import torch

    from slam_robot_tpu_torch.models import localmap as lm

    n = int(m.n_frames)
    t = m.frame_trans.clone()
    t[n - 2:n] = t[n - 4:n - 2]
    kf = m.frame_keyframe.clone()
    kf[n - 2:n] = False
    idle = m._replace(frame_trans=t, frame_keyframe=kf)
    got = lm.check_not_moving(idle)
    want = lm.check_not_moving(lm.MapState(*[x.cpu() for x in idle]))
    if int(got.n_frames) != n - 2:
        raise AssertionError(f"check_not_moving left {int(got.n_frames)} of {n} frames")
    for f in ("n_frames", "n_obs", "obs_frame", "obs_point", "obs_px", "obs_err_valid",
              "point_obs", "point_obs_total", "ring_frame", "ring_disabled"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            raise AssertionError(f"check_not_moving: {f} differs from the CPU's")
    return {"frames_before": n, "frames_after": int(got.n_frames),
            "obs_removed": int(m.n_obs) - int(got.n_obs)}


def _duplicate_check(ps, matched_last, img, cfg) -> dict:
    """One matcher.track from ``ps`` on ``img`` (the image of the frame two
    back, whose pose the new frame starts from) with lane j a copy of lane i
    (stored matches, caches, point location), i and j the lowest and highest
    lanes that matched in the last step: exactly one of the pair is
    cleaned, the lower slot keeps its match and j's point is mismatched."""
    import torch

    from slam_robot_tpu_torch.device import KNOBS
    from slam_robot_tpu_torch.models import localmap as lm
    from slam_robot_tpu_torch.models import matcher

    ms, m = ps.matcher, ps.map
    fp = ms.feat_point.cpu()
    usable = lm.feature_usable(m.point_flags.cpu()[fp.clamp(min=0).long()])
    live = torch.nonzero(matched_last.cpu() & (fp >= 0) & usable)[:, 0]
    i, j = int(live[0]), int(live[-1])
    pi, pj = int(fp[i]), int(fp[j])
    copy = {}
    for f in ("feat_px", "feat_valid", "feat_refpack", "feat_refwin", "feat_reforg",
              "feat_fail", "feat_sharp"):
        copy[f] = getattr(ms, f).clone()
        copy[f][j] = copy[f][i]
    loc, unc = m.point_loc.clone(), m.point_uncertainty.clone()
    loc[pj], unc[pj] = loc[pi], unc[pi]
    m = m._replace(point_loc=loc, point_uncertainty=unc)
    n = int(m.n_frames)
    camera = ps.camera ^ 1
    m, fidx = lm.add_frame(m, camera, m.frame_quat[n - 2], m.frame_trans[n - 2])
    dup0 = KNOBS.counts.get("duplicates", 0)
    _, m2, met = matcher.track(ms._replace(**copy), m, img, fidx, camera, cfg)
    cleaned = int(KNOBS.counts["duplicates"] - dup0)
    matched = met["feat_matched"].cpu()
    flags = m2.point_flags.cpu()
    if not (cleaned >= 1 and bool(matched[i]) and not bool(matched[j])
            and flags[pj] & lm.MISMATCHED and not flags[pi] & lm.MISMATCHED):
        raise AssertionError(f"clean_duplicates on lanes {i}, {j}: cleaned {cleaned}, matched "
                             f"{bool(matched[i])}, {bool(matched[j])}, flags {int(flags[pi])}, "
                             f"{int(flags[pj])}")
    return {"lanes": [i, j], "cleaned": cleaned}


def phase_knobs(frames, card: str):
    """Phase 10: pipeline.step at SlamConfig() with all seven off-by-default
    knobs on, over ``frames`` and then their last camera pair three times
    more (a stationary stretch). Returns (kernel counts, the summary)."""
    import numpy as np
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.device import KNOBS, SYNCS
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.utils.benchscene import sweep_pose
    from slam_robot_tpu_torch.utils.dump import ate_aligned

    t0 = time.time()
    cfg = SlamConfig(**ALL_KNOBS)
    n_sweep = len(frames)
    order = list(range(n_sweep)) + [n_sweep - 2, n_sweep - 1] * 3
    ps = pipeline.init(cfg, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()
    KNOBS.reset()
    sync0 = SYNCS.n
    kept, step_ms = [], []
    resolved = kfs = dropped = 0
    canary_max = 0.0
    for i, src in enumerate(order):
        t1 = time.perf_counter()
        ps, met = pipeline.step(ps, frames[src], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t1))
        kept.append(src)
        del kept[int(ps.map.n_frames):]  # a pop takes its frames' truth poses
        resolved += int(met["resolve_fired"])
        kfs += int(met["is_keyframe"])
        dropped += int(met["fast_obs_dropped"] + met["slow_obs_dropped"]
                       + met["reproject_obs_dropped"])
        canary_max = max(canary_max, float(met["normalize_canary_px"]))
    counts = _read_counts()
    fired = KNOBS.read()
    syncs = (SYNCS.n - sync0) / len(order)
    _check_counts("phase 10", counts, len(order))
    _finite("phase 10's last state", list(ps.map) + list(ps.matcher))
    m = ps.map
    nf = int(m.n_frames)
    true_t = np.stack([sweep_pose(i)[1] for i in kept])
    est_t = m.frame_trans[:nf].cpu().numpy()
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    ate_pct = 100.0 * ate_aligned(est_t, true_t) / max(path, 1e-9)
    summary = {"frames": len(order), "frames_kept": nf, "keyframes": kfs,
               "resolve_fired_frames": resolved,
               "sharp_first_lanes": fired.get("sharp_first_lanes", 0),
               "cycle_sweeps": fired.get("cycle_sweeps", 0),
               "escalations": fired.get("escalations", 0),
               "constant_velocity_frames": fired.get("constant_velocity", 0),
               "adaptive_seed_keyframes": fired.get("adaptive_seeds", 0),
               "popped_frames": fired.get("popped_frames", 0),
               "duplicates_cleaned": fired.get("duplicates", 0),
               "n_points": int(m.n_points), "obs_dropped": dropped, "canary_max_px": canary_max,
               "ate_aligned_pct": ate_pct, "median_step_ms": statistics.median(step_ms),
               "host_syncs_per_frame": syncs, "launches": counts,
               "launches_per_frame": {k: v / len(order) for k, v in counts.items()}}
    print(f"phase 10 knobs on {card}: {json.dumps(summary)}", flush=True)
    for key in ("resolve_fired_frames", "sharp_first_lanes", "cycle_sweeps",
                "constant_velocity_frames", "adaptive_seed_keyframes"):
        if not summary[key]:
            raise AssertionError(f"phase 10: {key} is 0")
    if dropped:
        raise AssertionError(f"phase 10: {dropped} obs rows dropped by the fixed windows")
    if not canary_max < 0.1:
        raise AssertionError(f"phase 10: normalize canary {canary_max} px >= 0.1")
    if summary["n_points"] <= 200:
        raise AssertionError(f"phase 10: map too small: n_points {summary['n_points']}")
    if not ate_pct < 5.0:
        raise AssertionError(f"phase 10: aligned ATE {ate_pct:.2f} % of path >= 5 %")

    summary["idle_pop"] = _idle_pop_check(m)
    summary["duplicate_pair"] = _duplicate_check(ps, met["feat_matched"], frames[order[-2]], cfg)
    summary["phase_s"] = time.time() - t0
    print(f"phase 10 check_not_moving: {json.dumps(summary['idle_pop'])}, equal to the CPU's; "
          f"clean_duplicates: {json.dumps(summary['duplicate_pair'])}, lower slot kept; phase "
          f"{summary['phase_s']:.2f} s", flush=True)
    return counts, summary


# phase 11: the port's tools/bench_suite (configs 1, 2, 4 and 5) at full
# size, and tools/calibrate

# config 5's padded layout against the scatter one and the four-shard solve
# (float32 sums in another order): cost to this relative tolerance; the
# sharded frames within CG_TRANS_MM
CG_COST_RTOL = 1e-4
CG_TRANS_MM = 0.1
# config 5's poses barely move (ROADMAP §C): the JAX package's solve ends
# 0.01-0.03 % above its initial pose error at 200 and 1000 frames; the gate
# holds the port's ATE under the initial one by this factor
ATE_RISE_MAX = 1.001
# config 5 on the card against the port on the CPU: the cost and frames as
# the sharded solve (CG_COST_RTOL, CG_TRANS_MM), and the frame and point
# updates (solution - start) to this relative norm, which a frozen step
# (100 % off) or a step in another direction fails
CPU_UPDATE_RTOL = 1e-2


# config 1's traffic alternates its two cameras, 150 mm apart. Across them
# most lanes run their last level's iterations out without meeting the 1e-3
# px step threshold, and there the plain loop's own end moves with float
# order (ROADMAP C4). Such lanes, and only those, may pass phase 3's 2e-3 px
# tolerance against the plain loop: at most this share of the active lanes,
# and no more of them than float-order changes of the plain loop itself move
# past it in the same run
UNCONVERGED_OVER_MAX = 0.05


def _plain_witnesses(args, src: dict, kw: dict) -> dict:
    """The plain level loop's end positions (on the card, float32) under
    float-order changes of the same computation: the inputs in float64 on
    the card, in float32 on the CPU, and the starts moved by one ulp in each
    of the four sign patterns over x and y. ``src`` is the call's
    ``planes=`` or ``win_cache=`` argument. A nudge that moves a lane's
    start into another pixel at its first level (a start on a pixel
    boundary, as a corner's is) changes the taps, not the float order: such
    lanes keep the unnudged end under that nudge."""
    import torch

    from slam_robot_tpu_torch.ops.cuda import newton as nk

    pts, lvls, active, packed, wmask, dims = args

    def run(cast, start):
        pos = nk.track_levels(
            nk.newton_window_steps, cast(start), cast(lvls), cast(active), cast(packed),
            cast(wmask), dims, **{k: cast(v) if torch.is_tensor(v) else tuple(map(cast, v))
                                  for k, v in src.items()}, **kw)[0]
        return pos.to("cuda", torch.float32)

    def f64(t):
        return t.double() if t.is_floating_point() else t

    out = {"float64": run(f64, pts), "cpu": run(lambda t: t.cpu(), pts)}
    plain = run(lambda t: t, pts)
    scale = torch.pow(2.0, (lvls.to(pts.device) - 1).to(torch.float32))[:, None]
    for sx in (-1, 1):
        for sy in (-1, 1):
            toward = pts + 1e3 * torch.tensor([sx, sy], dtype=pts.dtype, device=pts.device)
            nudged = torch.nextafter(pts, toward)
            cell = (torch.floor(nudged / scale) == torch.floor(pts / scale)).all(1)
            out[f"ulp {sx:+d} {sy:+d}"] = torch.where(cell[:, None], run(lambda t: t, nudged),
                                                      plain)
    return out


def _max0(t) -> float:
    """The largest element of ``t``, 0 when it is empty."""
    return float(t.max()) if t.numel() else 0.0


def phase_cross_camera(cfg, frames) -> dict:
    """B1's newton_track against the plain level loop at config 1's shapes on
    its cross-camera pair (``frames``: camera 0's frame 0 and camera 1's
    frame 1), as phase_loop_kernels checks one camera's pair: positions to
    2e-3 px but for the lanes UNCONVERGED_OVER_MAX allows, ok equal away
    from the margin, the stack to 1e-5, every window cut where the plain
    loop cuts it. Returns the figures, with the plain loop's own spread
    under float-order changes (:func:`_plain_witnesses`)."""
    import torch

    from slam_robot_tpu_torch.ops import corners, patch, pyramid

    h0, w0, depth, F = cfg.image_height, cfg.image_width, cfg.pyramid_depth, cfg.max_features
    kw = dict(threshold=cfg.track_threshold, max_iters=cfg.track_max_iters,
              iters_coarse=cfg.track_iters_coarse)
    pa, pb = pyramid.build_pyramid(frames[0], depth), pyramid.build_pyramid(frames[1], depth)
    gpa = pa.data[0, pyramid.PAD:-pyramid.PAD, pyramid.PAD:-pyramid.PAD]
    cpts, cval = corners.detect(gpa, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
    dims = pyramid.level_dims(h0, w0, depth)
    gen = torch.Generator(device="cuda").manual_seed(8)
    r = _track_check(pa, pb, cpts[cval], cfg, F, gen, dims,
                     patch.radial_mask(13, 15.0, device="cuda"), kw)
    label = f"newton_track across config 1's cameras (F={F}, {depth} levels, {h0}x{w0})"
    if r["n_ok_diff"] or not r["stack_err"] <= 1e-5 or r["n_org_diff"]:
        raise AssertionError(f"{label}: ok differs on {r['n_ok_diff']} lanes, stack "
                             f"{r['stack_err']}, {r['n_org_diff']} windows cut elsewhere")
    out = {"shape": f"F={F}, {depth} levels, {h0}x{w0}, frames 0 and 1",
           "stack_err": r["stack_err"]}
    for name, args, src in (("forward", r["fwd_args"], {"planes": pb.data}),
                            ("backward", r["bwd_args"], {"win_cache": r["cache"]})):
        ln = r["lanes"][name]
        active, unconv = args[2].bool(), ln["unconverged"]
        over = ln["gap"] > 2e-3
        wit = _plain_witnesses(args, src, kw)
        spread = torch.stack([(p - ln["plain"]).abs().amax(1) for p in wit.values()]).amax(0)
        d = {"active": int(active.sum()), "unconverged": int(unconv.sum()),
             "over_tol": int(over.sum()), "over_tol_converged": int((over & ~unconv).sum()),
             "max_gap_converged": _max0(ln["gap"][active & ~unconv]),
             "max_gap_unconverged": _max0(ln["gap"][unconv]),
             "plain_over_tol": int((spread > 2e-3).sum()),
             "plain_spread_converged": _max0(spread[active & ~unconv]),
             "plain_spread_unconverged": _max0(spread[unconv]),
             "plain_over_tol_by_witness": {k: int(((p - ln["plain"]).abs().amax(1)
                                                   > 2e-3).sum()) for k, p in wit.items()},
             "over_tol_lanes": [{"lane": int(i), "gap": float(ln["gap"][i]),
                                 "plain_spread": float(spread[i])}
                                for i in torch.nonzero(over).flatten().tolist()]}
        out[name] = d
        if d["over_tol_converged"]:
            raise AssertionError(f"{label}, {name}: {d['over_tol_converged']} lanes that the "
                                 f"plain loop converges are over 2e-3 px: {json.dumps(d)}")
        if d["over_tol"] > UNCONVERGED_OVER_MAX * d["active"]:
            raise AssertionError(f"{label}, {name}: {d['over_tol']} of {d['active']} lanes "
                                 f"over 2e-3 px: {json.dumps(d)}")
        if d["over_tol"] > d["plain_over_tol"]:
            raise AssertionError(f"{label}, {name}: {d['over_tol']} lanes over 2e-3 px, where "
                                 f"float-order changes move the plain loop's end past it on "
                                 f"{d['plain_over_tol']}: {json.dumps(d)}")
    return out


def _suite(config: str, argv=()) -> tuple[list, dict, float, float]:
    """bench_suite.main for one config in-process: (its JSON lines, its
    results, wall s of the call, peak device GiB)."""
    import contextlib
    import io

    import torch

    from slam_robot_tpu_torch.tools import bench_suite

    out, res = io.StringIO(), {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench_suite.main(["--configs", config, *argv], results=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"bench_suite --configs {config} exited {rc}")
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    return lines, res, wall, torch.cuda.max_memory_allocated() / 2**30


def phase_suite(card: str):
    """Phase 11: bench_suite configs 1, 2, 4 and 5 on the card, at full size,
    and calibrate --synthetic 20, each with its gates. Returns (the kernel
    counts of config 1 and calibrate, the phase's summary, B1 and B2 at
    config 1's shapes)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from slam_robot_tpu_torch.device import SYNCS
    from slam_robot_tpu_torch.ops import ba_cg
    from slam_robot_tpu_torch.tools import bench_suite, calibrate

    t0 = time.time()
    summary = {}

    def report(key, lines, wall, peak):
        """Print a config's lines and its figures (the busy share of each
        line's timed work comes from phase 14's fresh process)."""
        for line in lines:
            print(json.dumps(line), flush=True)
        summary[key] = {"lines": lines, "call_s": wall, "peak_gib": peak}
        print(f"phase 11 config {key} on {card}: call {wall:.2f} s, peak {peak:.3f} GiB",
              flush=True)
        return {line["config"]: line for line in lines}

    # config 1: the step at 640x480 without BA, with phase 4's launch gates,
    # and B1 and B2 at its shapes against their plain versions
    _reset_counts()
    lines, res, wall, peak = _suite("1")
    counts = _read_counts()
    _check_counts("phase 11 config 1", counts, res["1"]["steps"])
    report("1", lines, wall, peak)
    cfg1 = res["1"]["cfg"]
    # one camera's frames 0 and 2, the pair phase 3 tracks across, and the
    # two cameras' frames 0 and 1, 150 mm apart, as config 1's steps track
    kern = phase_loop_kernels(cfg1, res["1"]["images"][0:3:2])
    cross = phase_cross_camera(cfg1, res["1"]["images"][0:2])
    summary["1"].update(launches=dict(counts), cross_camera=cross)
    print(f"phase 11 config 1 launches {counts}; kernels at its shapes on {card}: "
          f"{json.dumps(kern)}; newton_track across the cameras: {json.dumps(cross)}",
          flush=True)

    # config 2: window BA 10 x 500
    lines, res, wall, peak = _suite("2")
    by = report("2", lines, wall, peak)["2_window_ba_10x500"]["detail"]
    if not (math.isfinite(by["cost"]) and by["lm_iters"] > 0):
        raise AssertionError(f"config 2: cost {by['cost']}, lm_iters {by['lm_iters']}")

    # config 4: the fleet of 64 at goal seed 2, on the card and on the CPU
    lines, res, wall, peak = _suite("4")
    goals = res["4"]["goals"]
    by = report("4", lines, wall, peak)["4_closed_loop_64_rollouts"]["detail"]
    cpu_res = {}
    with contextlib.redirect_stdout(io.StringIO()):
        bench_suite.main(["--configs", "4", "--device", "cpu"], results=cpu_res)
    d_card, d_cpu = res["4"]["dist"].cpu().numpy(), cpu_res["4"]["dist"].numpy()
    reached = [int((d < 0.5).sum()) for d in (d_card, d_cpu)]
    fleet = {"reached_card": reached[0], "reached_cpu": reached[1]}
    if reached[0] != reached[1]:
        # goals whose reach differs must have parted at a decision tie,
        # within phase 8's caps
        lock = _fleet_lockstep(goals, 300)
        differ = (d_card < 0.5) != (d_cpu < 0.5)
        untied = np.nonzero(differ & ~lock["tied"].numpy())[0]
        fleet.update(goals_differ=int(differ.sum()), tie_share=lock["tie_share"])
        if (untied.size or differ.mean() > EXEMPT_GOALS_MAX
                or lock["tie_share"] > TIE_SHARE_MAX):
            raise AssertionError(f"config 4 reached {reached[0]} on the card and {reached[1]} "
                                 f"on the CPU: goals {untied.tolist()} without a decision tie, "
                                 f"tie share {lock['tie_share']:.2%}")
    summary["4"]["fleet"] = fleet
    print(f"phase 11 config 4: reached {reached[0]} of {by['rollouts']} on the card, "
          f"{reached[1]} on the CPU; {json.dumps(fleet)}", flush=True)

    # config 5: large-map CG at 10k frames / 500k points / 1M observations,
    # the four-shard solve, the multi-robot map
    lines, res, wall, peak = _suite("5")
    mr = res["5_multi_robot"]
    report("5", lines, wall, peak)
    r5, cfg5, args5 = res["5"]["result"], res["5"]["cfg"], res["5"]["args"]
    cost, cost0 = float(r5.cost), float(r5.cost0)
    ate, ate0 = res["5"]["ate_mm"], res["5"]["ate0_mm"]
    if not (math.isfinite(cost) and cost < cost0):
        raise AssertionError(f"config 5: cost {cost0} -> {cost}")
    if not ate <= ATE_RISE_MAX * ate0:
        raise AssertionError(f"config 5: ATE {ate} mm over {ATE_RISE_MAX} x its initial {ate0}")
    if not bool(r5.ok):
        raise AssertionError("config 5: ok is false (unsolvable, or the padded spill overflowed)")
    # no host read inside a solve: no counted read, and no synchronizing
    # CUDA call (sync debug mode raises on one)
    torch.cuda.synchronize()
    syncs0 = SYNCS.n
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ba_cg.solve(*args5, cfg=cfg5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if SYNCS.n != syncs0:
        raise AssertionError(f"config 5: {SYNCS.n - syncs0} host reads inside ba_cg.solve")
    repeat_equal = bool(torch.equal(again.cost, r5.cost)
                        and torch.equal(again.frame_trans, r5.frame_trans))
    # the scatter layout, timed twice, against the padded one
    scatter = []
    for _ in range(2):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        rs = ba_cg.solve(*args5, cfg=cfg5._replace(layout="scatter"))
        torch.cuda.synchronize()
        ts = time.perf_counter() - ts
        scatter.append({"wall_s": ts, "cost": float(rs.cost),
                        "gn_iters_per_s": cfg5.gn_iters / ts})
        if not abs(float(rs.cost) - cost) <= CG_COST_RTOL * cost:
            raise AssertionError(f"config 5: scatter cost {float(rs.cost)}, padded {cost}")
    shd = res["5_sharded"]["result"]
    dtrans = float((shd.frame_trans - r5.frame_trans).abs().max())
    if not (bool(shd.ok) and abs(float(shd.cost) - cost) <= CG_COST_RTOL * cost
            and dtrans <= CG_TRANS_MM):
        raise AssertionError(f"config 5 sharded: cost {float(shd.cost)} vs {cost}, frames "
                             f"{dtrans} mm apart, ok {bool(shd.ok)}")
    # the card's solve against the port's on the CPU at the same size: the
    # cost, the frames, and the frame and point updates (the frames move
    # little, ROADMAP C3, so a frozen or wrong step is caught by its update)
    tc = time.perf_counter()
    rc5 = ba_cg.solve(*(t.cpu() for t in args5), cfg=cfg5)
    cpu_s = time.perf_counter() - tc
    start = {"frame_trans": args5[1].cpu(), "point_loc": args5[4].cpu()}
    upd = {}
    for name, before in start.items():
        d_cpu = getattr(rc5, name) - before
        d_card = getattr(r5, name).cpu() - before
        upd[name] = {"cpu_norm": float(d_cpu.norm()), "card_norm": float(d_card.norm()),
                     "rel_diff": float((d_card - d_cpu).norm() / d_cpu.norm())}
    cpu_trans = float((rc5.frame_trans - r5.frame_trans.cpu()).abs().max())
    cpu5 = {"cpu_s": cpu_s, "cost": float(rc5.cost), "frames_apart_mm": cpu_trans, **upd}
    if not (bool(rc5.ok) and abs(float(rc5.cost) - cost) <= CG_COST_RTOL * cost
            and cpu_trans <= CG_TRANS_MM
            and all(u["rel_diff"] <= CPU_UPDATE_RTOL for u in upd.values())):
        raise AssertionError(f"config 5 against the CPU: {json.dumps(cpu5)}, card cost {cost}")
    if not mr["point_err_mm"] < mr["point_err0_mm"]:
        raise AssertionError(f"config 5 multi-robot: point error {mr['point_err0_mm']} -> "
                             f"{mr['point_err_mm']} mm")
    prob = res["5"]["problem"]
    ok = prob["obs_ok"]
    seen = torch.zeros(prob["point_loc"].shape[0], dtype=torch.int32, device="cuda").index_add_(
        0, torch.where(ok, prob["obs_point"].long(), 0), ok.to(torch.int32))
    summary["5"].update(
        gn_iters_per_s=cfg5.gn_iters / res["5"]["wall_s"], ate_mm=ate, ate0_mm=ate0,
        cost=cost, cost0=cost0, repeat_equal=repeat_equal, scatter=scatter, cpu=cpu5,
        sharded_frames_apart_mm=dtrans, valid_obs=int(ok.sum()),
        points_seen_1_2_3=[int((seen >= n).sum()) for n in (1, 2, 3)],
        point_err_mm=[mr["point_err0_mm"], mr["point_err_mm"]])
    print(f"phase 11 config 5 on {card}: {summary['5']['gn_iters_per_s']:.3f} GN iters/s "
          f"(padded), scatter {[round(x['gn_iters_per_s'], 3) for x in scatter]}, padded "
          f"repeats bit for bit: {repeat_equal}; cost {cost0} -> {cost}; ATE {ate0} -> {ate} mm; "
          f"no host read in the solve; sharded frames {dtrans} mm apart; against the CPU "
          f"{json.dumps(cpu5)}; multi-robot point "
          f"error {mr['point_err0_mm']:.3f} -> {mr['point_err_mm']:.3f} mm; "
          f"{summary['5']['valid_obs']} valid observations, points seen 1/2/3+ times "
          f"{summary['5']['points_seen_1_2_3']}", flush=True)
    del res, prob, args5, r5, again, rs, shd, seen, ok, rc5, start

    # calibrate --synthetic 20 at 640x480, with phase 4's launch gates
    _reset_counts()
    out, cres = io.StringIO(), {}
    tc = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main(["--synthetic", "20"], results=cres)
    cal_s = time.perf_counter() - tc
    cal_counts = _read_counts()
    print(out.getvalue().rstrip(), flush=True)
    if rc != 0:
        raise AssertionError(f"calibrate exited {rc}")
    _check_counts("phase 11 calibrate", cal_counts, 20)
    k = cres["solved_k"]
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"calibrate: solved k not finite: {k.tolist()}")
    if not cres["reproj_px"] < cres["reproj0_px"]:
        raise AssertionError(f"calibrate: reprojection {cres['reproj0_px']} -> "
                             f"{cres['reproj_px']} px")
    summary["calibrate"] = {"call_s": cal_s, "reproj_px": [cres["reproj0_px"], cres["reproj_px"]],
                            "iters": int(cres["result"].iters), "solved_k": k.tolist(),
                            "launches": cal_counts}
    counts = {name: counts[name] + cal_counts[name] for name in counts}
    summary["phase_s"] = time.time() - t0
    print(f"phase 11 calibrate on {card}: {json.dumps(summary['calibrate'])}; phase "
          f"{summary['phase_s']:.2f} s", flush=True)
    return counts, summary, kern


def _alt_track_pair(ps, frame, cfg) -> dict:
    """One matcher.track for the frame after ``ps`` with ``cfg``'s tracker,
    on the card and on the host's CPU from the same state: the matched masks
    over the candidate lanes (live after the drop) and the positions of
    lanes matched on both."""
    import torch

    from slam_robot_tpu_torch.models import localmap as lm
    from slam_robot_tpu_torch.models import matcher

    def run(state, img):
        m = state.map
        n = int(m.n_frames)
        camera = state.camera ^ 1
        m, fidx = lm.add_frame(m, camera, m.frame_quat[n - 2], m.frame_trans[n - 2])
        t0 = time.perf_counter()
        _, _, met = matcher.track(state.matcher, m, img, fidx, camera, cfg)
        if img.is_cuda:
            torch.cuda.synchronize()
        return met, time.perf_counter() - t0

    card, card_s = run(ps, frame)
    cpu, cpu_s = run(_map_state(ps, lambda t: t.cpu()), frame.cpu())
    cand = cpu["feat_point"] >= 0
    if not torch.equal(card["feat_point"].cpu(), cpu["feat_point"]):
        raise AssertionError("the card and the CPU dropped different lanes")
    m_card, m_cpu = card["feat_matched"].cpu(), cpu["feat_matched"]
    agree = float((m_card == m_cpu)[cand].float().mean())
    both = m_card & m_cpu
    d = (card["feat_px"].cpu() - cpu["feat_px"]).abs().amax(-1)
    within = float((d[both] <= ALT_PX).float().mean()) if both.any() else 0.0
    worst = torch.argsort(torch.where(both, d, torch.full_like(d, -1.0)), descending=True,
                          stable=True)[:5]
    return {"candidates": int(cand.sum()), "matched_card": int(m_card.sum()),
            "matched_cpu": int(m_cpu.sum()), "mask_agree": agree,
            "lanes_apart": torch.nonzero(m_card != m_cpu)[:, 0].tolist(),
            "px_within_share": within, "px_max": float(d[both].max()) if both.any() else 0.0,
            "worst_lanes": [[int(i), float(d[i])] for i in worst if both[i]],
            "card_s": card_s, "cpu_s": cpu_s}


def _graph_check(ps, frame, track_fn) -> dict:
    """tracker.track_bidirectional on the card (a CUDA graph's replay)
    against the same pass run eagerly, from ``ps``'s newest view into
    ``frame``, every lane live there active, at 6 levels: equal bit for
    bit."""
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.ops import patch, tracker
    from slam_robot_tpu_torch.ops.pyramid import FlatPyramid, build_pyramid

    cfg = SlamConfig()
    ms = ps.matcher
    V, L = ms.view_pyr.shape[:2]
    vi = torch.argsort(-ms.view_frame, stable=True)[:1]
    ring = FlatPyramid(ms.view_pyr.reshape((V * L,) + ms.view_pyr.shape[2:]), None, None, L,
                       offset=vi[0].long() * L)
    new = build_pyramid(frame, L, cfg.blur_sigma0, cfg.blur_sigma_down)
    from_pt = ms.feat_px.index_select(1, vi)[:, 0]
    active = (ms.feat_point >= 0) & ms.feat_valid.index_select(1, vi)[:, 0]
    lvls = torch.full_like(ms.feat_point, L)
    w = patch.radial_mask(cfg.patch_size, cfg.mask_bias, device="cuda")
    kw = dict(threshold=cfg.track_threshold, max_iters=cfg.track_max_iters,
              roundtrip_px=cfg.roundtrip_px)
    K = from_pt.shape[0]
    t0 = time.perf_counter()
    got = tracker.track_bidirectional(ring, new, from_pt, from_pt, lvls, w, active=active,
                                      track_fn=track_fn, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = tracker.BIDIRECTIONAL_GRAPHS.fn(
        ring.data, tracker.lane_offsets(ring, K, "cuda"), new.data,
        tracker.lane_offsets(new, K, "cuda"), from_pt, from_pt, lvls, active, w, depth_from=L,
        depth_to=L, min_variance=1e-5, fn=track_fn, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"active": int(active.sum()), "ok": int(got[1].sum()),
            "equal": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
            "graph_ms": 1000 * (t1 - t0), "eager_ms": 1000 * (t2 - t1)}


def _brute_pair(frames) -> dict:
    """brute.track_feature on 256 seeded lanes from frame 0 to frame 2 (one
    camera), on the card and on the host's CPU."""
    import numpy as np
    import torch

    from slam_robot_tpu_torch.ops import brute, tracker
    from slam_robot_tpu_torch.ops.pyramid import build_pyramid

    rng = np.random.default_rng(12)
    h, w = frames[0].shape[:2]
    pts = torch.as_tensor(rng.uniform([24, 24], [w - 24, h - 24], size=(256, 2)),
                          dtype=torch.float32)
    lvls = torch.as_tensor(rng.choice([3, 6], size=256), dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        pa, pb = (build_pyramid(frames[i].to(dev)) for i in (0, 2))
        t0 = time.perf_counter()
        p, ok = brute.track_feature(pb, tracker.get_patch_stack(pa, pts.to(dev)), pts.to(dev),
                                    lvls.to(dev), sad_threshold=BRUTE_SAD)
        out[dev] = (p.cpu(), ok.cpu(), time.perf_counter() - t0)
    d = (out["cuda"][0] - out["cpu"][0]).abs().amax(-1)
    return {"lanes": 256, "ok_card": int(out["cuda"][1].sum()),
            "ok_equal": bool(torch.equal(out["cuda"][1], out["cpu"][1])),
            "px_within_share": float((d <= BRUTE_PX).float().mean()), "px_max": float(d.max()),
            "card_s": out["cuda"][2], "cpu_s": out["cpu"][2]}


def _native_io(frames, direct) -> dict:
    """(d): the native library on the card's host: the YUYV conversions
    against their formulas, the ring's delivery rate, 16 bench frames fed
    through the ring into pipeline.step against the state from feeding them
    directly, and V4L2Source on /dev/video0."""
    import os

    import numpy as np
    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.io import native
    from slam_robot_tpu_torch.io.sources import V4L2Source
    from slam_robot_tpu_torch.models import pipeline

    if not native.available():
        raise AssertionError("io/native: the library route does not run on the card's host")
    h, w = frames[0].shape[:2]
    yuyv = np.random.default_rng(8).integers(0, 256, size=2 * w * h, dtype=np.uint8)
    q = yuyv.reshape(-1, 4).astype(np.int32)
    y = np.stack([q[:, 0], q[:, 2]], 1)
    cb = ((q[:, 1] - 128) * 454) >> 8
    cg = ((q[:, 1] - 128) * 88 + (q[:, 3] - 128) * 183) >> 8
    cr = ((q[:, 3] - 128) * 359) >> 8
    bgr = np.clip(np.stack([y + cb[:, None], y - cg[:, None], y + cr[:, None]], -1), 0, 255)
    if not np.array_equal(native.yuyv_to_bgr(yuyv, w, h), bgr.astype(np.uint8).reshape(h, w, 3)):
        raise AssertionError("yuyv_to_bgr differs from the integer formula")
    # the library's grey is luma * float32(1/255) (the numpy route divides)
    grey = yuyv.reshape(-1, 2)[:, 0].astype(np.float32) * np.float32(1 / 255)
    if not np.array_equal(native.yuyv_to_grey(yuyv, w, h), grey.reshape(h, w)):
        raise AssertionError("yuyv_to_grey differs from luma * float32(1/255)")

    host = [f.cpu().numpy() for f in frames]
    it = iter(host)
    t0 = time.perf_counter()
    with native.FrameRing((h, w), capacity=4, fill=lambda: next(it, None)) as ring:
        n = 0
        while ring.next()[0] is not None:
            n += 1
    ring_fps = n / (time.perf_counter() - t0)

    cfg = SlamConfig()
    ps = pipeline.init(cfg, device="cuda")
    it = iter(host[:RING_FRAMES])
    _reset_counts()
    with native.FrameRing((h, w), capacity=4, fill=lambda: next(it, None)) as ring:
        while True:
            img, fid = ring.next()
            if img is None:
                break
            ps, _ = pipeline.step(ps, torch.as_tensor(img, device="cuda"), cfg)
            ps = pipeline.maybe_polish(ps, fid, cfg)
    counts = _read_counts()
    _check_counts("phase 12 ring feed", counts, RING_FRAMES)
    same = {f: bool(torch.equal(getattr(ps.map, f), getattr(direct.map, f)))
            for f in ("frame_trans", "point_loc")}
    all_equal = all(torch.equal(a, b) for a, b in zip(_state_leaves(ps), _state_leaves(direct)))
    if not all(same.values()):
        raise AssertionError(f"the ring-fed map differs from the directly fed one: {same}")
    cam_init = V4L2Source("/dev/video0").init()
    if not os.path.exists("/dev/video0") and cam_init:
        raise AssertionError("V4L2Source.init() is True with no /dev/video0")
    return {"library": native.library_path(), "conversions_exact": True,
            "ring_frames_per_s": ring_fps, "ring_frames": n, "ring_feed_equal": same,
            "ring_feed_state_equal": all_equal, "v4l2_video0_init": cam_init,
            "launches": counts}


def _sof_size(data: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG's SOF0 segment."""
    i = 2
    while data[i + 1] != 0xC0:
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return int.from_bytes(data[i + 5:i + 7], "big"), int.from_bytes(data[i + 7:i + 9], "big")


def _view_client(port: int, live: bool, out: dict, done) -> None:
    """Read the live view while a run goes on: /, three /stream parts,
    /points and one /point?id=N (the per-frame loop's inspector), then
    /status until it carries frame, matches and points or the run ends."""
    import http.client

    def get(path):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        c.close()
        return r.status, r.getheader("Content-Type"), body

    try:
        deadline = time.time() + 300
        while True:
            try:
                out["page"] = get("/")
                break
            except OSError:
                if done.is_set() or time.time() > deadline:
                    raise
                time.sleep(0.05)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/stream")
        r = c.getresponse()
        parts = []
        for _ in range(3):
            if b"--frame" not in r.fp.readline() or b"image/jpeg" not in r.fp.readline():
                raise AssertionError("a /stream part without its boundary or type")
            n = int(r.fp.readline().split(b":")[1])
            r.fp.readline()
            parts.append(r.fp.read(n))
            r.fp.readline()  # the CRLF after each part
        c.close()
        out["parts"] = parts
        if not live:
            out["points"] = get("/points")
            pts = json.loads(out["points"][2])
            if pts:
                out["point"] = get(f"/point?id={pts[0][0]}")
        while True:
            out["status"] = get("/status")
            if {"frame", "matches", "points"} <= set(json.loads(out["status"][2])):
                break
            if done.is_set():
                break
            time.sleep(0.1)
    except Exception as e:  # handed to the phase, which fails on it
        out["error"] = repr(e)


def _serve_runs(baseline: dict) -> dict:
    """(e): run_replay --synthetic SERVE_FRAMES --serve PORT --view-every 1
    on the card, per frame and --live, each with a client reading during
    the run and PIL out of reach; the summary as ``baseline``'s (the same
    run without --serve, phase 6) in n_points and n_obs."""
    res = {}
    counts = {"pyramid_flat": 0, "newton_track": 0, "sep5_reflect101": 0, "sweeps": 0}
    # serve with PIL out of reach, whether or not the host has it: an import
    # of PIL raises ImportError while the runs go on
    hidden = {m: sys.modules.pop(m) for m in list(sys.modules) if m.split(".")[0] == "PIL"}
    sys.modules["PIL"] = None
    try:
        _serve_modes(baseline, res, counts)
    finally:
        del sys.modules["PIL"]
        sys.modules.update(hidden)
    res["launches"] = counts
    return res


def _serve_modes(baseline: dict, res: dict, counts: dict) -> None:
    """The runs of :func:`_serve_runs`: a line each in ``res``, their
    launches added to ``counts``."""
    import contextlib
    import io
    import socket
    import threading

    import torch

    from slam_robot_tpu_torch import run_replay

    for mode in ("frame", "live"):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        got, done = {}, threading.Event()
        client = threading.Thread(target=_view_client, args=(port, mode == "live", got, done),
                                  daemon=True)
        client.start()
        _reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_replay.main(["--synthetic", str(SERVE_FRAMES), "--serve", str(port),
                                  "--view-every", "1", "--device", "cuda", "--quiet"]
                                 + (["--live"] if mode == "live" else []))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        done.set()
        client.join(timeout=120)
        text = out.getvalue()
        if rc != 0 or client.is_alive() or "error" in got:
            raise AssertionError(f"serve {mode}: rc {rc}, client alive {client.is_alive()}, "
                                 f"{got.get('error')}: {text[-1500:]}")
        launches = _read_counts()
        _check_counts(f"phase 12 serve {mode}", launches, SERVE_FRAMES)
        for k, v in launches.items():
            counts[k] += v
        summary = json.loads(text.strip().splitlines()[-1])
        page, status = got["page"], got["status"]
        if page[0] != 200 or page[1] != "text/html" or b"slam_robot_tpu" not in page[2]:
            raise AssertionError(f"serve {mode}: / gave {page[:2]}")
        st = json.loads(status[2])
        if status[1] != "application/json" or not {"frame", "matches", "points"} <= set(st):
            raise AssertionError(f"serve {mode}: /status gave {status[1]} {st}")
        sizes = [_sof_size(p) for p in got["parts"]]
        if not all(p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9" for p in got["parts"]) \
                or sizes != [(480, 640)] * 3:
            raise AssertionError(f"serve {mode}: /stream parts are not 480x640 JPEGs: {sizes}")
        line = {"call_s": call_s, "status": st, "stream_part_bytes": [len(p) for p in got["parts"]],
                "n_points": summary["n_points"], "n_obs": summary["n_obs"], "launches": launches}
        if mode == "frame":
            pts = json.loads(got["points"][2])
            point = got.get("point")
            if not pts or point is None or point[0] != 200 or point[1] != "image/jpeg" \
                    or point[2][:2] != b"\xff\xd8":
                raise AssertionError(f"serve frame: /points {len(pts)} points, /point "
                                     f"{point[:2] if point else None}")
            line.update(points_served=len(pts), point_jpeg_bytes=len(point[2]))
        if (summary["n_points"], summary["n_obs"]) != (baseline["n_points"], baseline["n_obs"]):
            raise AssertionError(f"serve {mode}: summary {summary} differs from the run "
                                 f"without --serve {baseline}")
        res[mode] = line


def phase_alt(frames, card: str, direct, serve_baseline: dict):
    """Phase 12: the alternative trackers at full width, the native host
    I/O and the live view. Returns (kernel counts, summary)."""
    import importlib.util

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.utils import jpeg
    from slam_robot_tpu_torch.utils.debug_draw import draw_debug

    t_phase = time.time()
    summary = {"frames": len(frames)}
    counts = {"pyramid_flat": 0, "newton_track": 0, "sep5_reflect101": 0, "sweeps": 0}

    def add(c):
        for k, v in c.items():
            counts[k] += v

    # (a), (b): the step with each alternative tracker over the sweep
    kept = None
    for kind, kw in (("lanes", {"tracker_impl": "lanes"}), ("klt", {"tracker_kind": "klt"})):
        cfg = SlamConfig(**kw)
        ps, f, keep = _drive_sweep(cfg, frames, keep=(ALT_STATE_FRAME,) if kind == "lanes" else ())
        c = f["launches"]
        add(c)
        print(f"phase 12 ({'a' if kind == 'lanes' else 'b'}) {kind} on {card}: {_sweep_line(f)}",
              flush=True)
        if c["pyramid_flat"] != 2 * len(frames) or c["newton_track"] or c["sweeps"] \
                or c["sep5_reflect101"]:
            raise AssertionError(f"{kind}: launches {c}: want 2 pyramid_flat a frame, "
                                 f"no newton_track, no sep5")
        _gate_sweep(f"phase 12 {kind}", f, ALT_MIN_POINTS[kind][len(frames)])
        summary[kind] = f
        kept = keep.get(ALT_STATE_FRAME, kept)
        del ps

    # (c): the alternative trackers on one state, card against the host's CPU
    _reset_counts()
    pair = {}
    for kind, kw in (("lanes", {"tracker_impl": "lanes"}), ("klt", {"tracker_kind": "klt"})):
        r = _alt_track_pair(kept, frames[ALT_STATE_FRAME + 1], SlamConfig(**kw))
        pair[kind] = r
        if r["mask_agree"] < ALT_MASK_AGREE or r["px_within_share"] < ALT_PX_SHARE:
            raise AssertionError(f"{kind} card against CPU: {json.dumps(r)}")
    from slam_robot_tpu_torch.ops import klt, tracker

    graphs = {kind: _graph_check(kept, frames[ALT_STATE_FRAME + 1], fn)
              for kind, fn in (("lanes", tracker.track_feature), ("klt", klt.track_feature))}
    pair["graph_against_eager"] = graphs
    pair["graphs"] = {"captures": tracker.BIDIRECTIONAL_GRAPHS.captures,
                      "replays": tracker.BIDIRECTIONAL_GRAPHS.replays}
    if not all(g["equal"] for g in graphs.values()):
        raise AssertionError(f"a graph replay differs from the eager pass: {graphs}")
    pair["brute"] = br = _brute_pair(frames)
    if not br["ok_equal"] or br["px_within_share"] < BRUTE_PX_SHARE:
        raise AssertionError(f"brute card against CPU: {json.dumps(br)}")
    c = _read_counts()
    add(c)
    summary["card_vs_cpu"] = pair
    print(f"phase 12 (c) card against the host's CPU on frame {ALT_STATE_FRAME + 1}'s state: "
          f"{json.dumps(pair)}; launches {c}", flush=True)

    # (d): native host I/O
    summary["native"] = nat = _native_io(frames, direct)
    add(nat["launches"])
    print(f"phase 12 (d) native I/O: {json.dumps(nat)}", flush=True)

    # (e): the live view, with the encoder's time a 640x480 overlay
    summary["serve"] = srv = _serve_runs(serve_baseline)
    add(srv["launches"])
    overlay = draw_debug(direct.map, frames[RING_FRAMES - 1].cpu().numpy())
    enc_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        data = jpeg.encode(overlay, 85)
        enc_ms.append(1000.0 * (time.perf_counter() - t0))
    srv["encode_ms_640x480"] = statistics.median(enc_ms)
    srv["encode_bytes"] = len(data)
    srv["pil_installed_on_host"] = importlib.util.find_spec("PIL") is not None
    srv["served_with_pil_blocked"] = True
    print(f"phase 12 (e) live view on {card}: {json.dumps(srv)}", flush=True)
    summary["phase_s"] = time.time() - t_phase
    summary["launches"] = counts
    print(f"phase 12 wall {summary['phase_s']:.1f} s; launches {counts}", flush=True)
    return counts, summary


def _states_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(_state_leaves(a), _state_leaves(b),
                                                 strict=True))


def phase_bench(start, card: str):
    """Phase 13: the port's bench.run at SlamConfig() for seed 0, its warm
    going on from phase 4's state after frame MAIN_FRAMES - 1. Returns
    (kernel counts over the phase, summary)."""
    import numpy as np
    import torch

    from slam_robot_tpu_torch import SlamConfig, bench
    from slam_robot_tpu_torch.tools import probe_errfresh, probe_seed1
    from slam_robot_tpu_torch.utils.benchscene import sweep_pose

    t_phase = time.time()
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    line = bench.run(SlamConfig(), n_warm=BENCH_WARM, n_timed=BENCH_TIMED, seeds=(0,),
                     device="cuda", start=(start, MAIN_FRAMES), results=res)
    counts = _read_counts()
    d = line["detail"]
    scan, lw = res["scan_window"], res["live_window"]
    first, *reps = res["scan_states"]
    # the bench workload's diagnostics on the scan's final map
    m = first.map
    nf = int(m.n_frames)
    true_t = np.stack([sweep_pose(i)[1] for i in range(nf)])
    diagnostics = {"errfresh": probe_errfresh.audit(m, SlamConfig()),
                   "gauge": probe_seed1.gauge(m.frame_trans[:nf].cpu().numpy(), true_t)}
    summary = {
        "fps": line["value"], "scan_step_ms": d["scan_step_ms"],
        "scan_step_ms_reps": d["scan_step_ms_reps"], "eager_step_ms": d["eager_step_ms"],
        "live_step_ms": d["live_step_ms"], "scan_compile_s": d["scan_compile_s"],
        "compile_s": d["compile_s"],
        "timed_per_frame": {k: v / scan["frames"] for k, v in scan.items() if k != "frames"},
        "live_per_frame": {k: v / lw["frames"] for k, v in lw.items() if k != "frames"},
        "n_points": d["n_points"], "n_obs": d["n_obs"], "ate_mm": d["ate_mm"],
        "ate_pct_of_path": d["ate_pct_of_path"],
        "ate_pct_aligned": d["ate_pct_aligned_per_seed"][0],
        "median_enabled_err_px": d["median_enabled_err_px"], "err_split": d["err_split"],
        "obs_dropped_total": d["obs_dropped_total"], "live_obs_dropped": d["live_obs_dropped"],
        "live_canary_max_px": d["live_canary_max_px"],
        "reps_equal": all(_states_equal(r, reps[0]) for r in reps[1:]),
        "first_pass_equal_reps": _states_equal(first, reps[0]),
        "live_equal_scan": _states_equal(res["live_state"], first),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
        "diagnostics": diagnostics, "line": line,
    }
    print(f"phase 13 bench on {card}: {summary['fps']} fps; scan {d['scan_step_ms']} ms a "
          f"frame (reps {d['scan_step_ms_reps']}), eager {d['eager_step_ms']}, live "
          f"{d['live_step_ms']}; timed window a frame {json.dumps(summary['timed_per_frame'])}; "
          f"n_points {d['n_points']}, n_obs {d['n_obs']}, ATE {d['ate_mm']} mm = "
          f"{d['ate_pct_of_path']} % raw, {summary['ate_pct_aligned']} % aligned; err split "
          f"{json.dumps(d['err_split'])}; dropped {d['obs_dropped_total']} + "
          f"{d['live_obs_dropped']} live, canary max {d['live_canary_max_px']} px; reps equal "
          f"{summary['reps_equal']}, live equal scan {summary['live_equal_scan']}; peak "
          f"{summary['peak_gib']:.3f} GiB; diagnostics {json.dumps(diagnostics)}", flush=True)
    _check_counts("phase 13 timed scan", scan, scan["frames"])
    _check_counts("phase 13 live", lw, lw["frames"])
    for name, ps in [("warm", res["warm_state"]), ("live", res["live_state"])] + [
            (f"scan pass {i}", s) for i, s in enumerate(res["scan_states"])]:
        _finite(f"phase 13's {name} state", _state_leaves(ps))
    if d["obs_dropped_total"] or d["live_obs_dropped"]:
        raise AssertionError(f"phase 13: obs rows dropped: {d['obs_dropped_total']} scan, "
                             f"{d['live_obs_dropped']} live")
    if not d["live_canary_max_px"] < 0.1:
        raise AssertionError(f"phase 13: normalize canary {d['live_canary_max_px']} px >= 0.1")
    if d["n_points"] <= 300:
        raise AssertionError(f"phase 13: map too small: n_points {d['n_points']}")
    if not summary["ate_pct_aligned"] <= 5.0:
        raise AssertionError(f"phase 13: aligned ATE {summary['ate_pct_aligned']} % of path > 5 %")
    if not summary["reps_equal"]:
        raise AssertionError("phase 13: the timed scan passes end in different states")
    if not summary["live_equal_scan"]:
        raise AssertionError("phase 13: the live segment's final state differs from the scan's")
    summary["phase_s"] = time.time() - t_phase
    return counts, summary, res["warm_state"]


# phase 14: the profiling tools from phase 13's warm state, cut to size
# (the script's time limit): frames probe_live runs a variant,
# profile_scan times, profile_trace traces (and exports)
LIVE_FRAMES, SCAN_FRAMES, TRACE_FRAMES = 2, 8, 1
# seconds phase 14's fresh processes (profile_trace --job) may take together
JOB_TIMEOUT_S = 600


def _numbers(x, path="") -> list:
    """(path, value) of every number in a nest of dicts and lists."""
    if isinstance(x, dict):
        return [n for k, v in x.items() for n in _numbers(v, f"{path}.{k}")]
    if isinstance(x, (list, tuple)):
        return [n for i, v in enumerate(x) for n in _numbers(v, f"{path}[{i}]")]
    ok = isinstance(x, (int, float)) and not isinstance(x, bool)
    return [(path, x)] if ok else []


# What phase 14 gates of a profile's device time: that it is not
# over-counted, on the profiled pass's own events and on the clock of their
# own time stamps (CUPTI's on the card; profile_trace.device_time), with no
# allowance: (a) on each stream the summed time of its operations at most
# the stream's span from its first start to its last end (a stream runs one
# operation at a time), (b) every operation of the run inside the run's
# window between the capture's markers (profile_trace.traced: the last lead
# marker's end, the tail marker's start). The host's clock is no yardstick
# for (b): at config 5 a device span ran 10.5 ms (0.87 %) past the same
# run's wall on the host's clock, beyond what the run could hold, so the two
# clocks part within a run; the host's wall is printed beside it. A busy
# share holds the profiled pass's device time against an unprofiled pass's
# wall: at config 5 the device is saturated and that wall moves by ~2 % from
# run to run, so the share landed on either side of 100 % by host noise.
# The share stays a printed figure, beside the limit it was once gated by:
# 100 % plus CUPTI_NS_PER_OP a device operation for the stamps' cost
CUPTI_NS_PER_OP = 200


def _gate_profile(name: str, p: dict) -> None:
    """A profile's device time not over-counted (the invariants (a) and (b)
    above, on ``p["device_time"]``), its capture complete
    (``_gate_capture``), and in the trace B1's and B2's launches (where the
    run made any) equal to the port's counters. Prints the invariants, the
    host's wall and the busy share against the unprofiled wall first."""
    t = p["device_time"]
    old_limit = 1.0 + CUPTI_NS_PER_OP * 1e-6 * p["device_ops"] / p["units"] / p["wall_ms"]
    window = t["window"]
    inside = window is not None and t["streams"] and \
        window[0] <= t["first_ns"] and t["last_ns"] <= window[1]
    streams = {k: [s["ops"], s["busy_ns"], s["span_ns"]] for k, s in t["streams"].items()}
    print(f"phase 14 {name} device time: by stream [ops, busy ns, span ns] "
          f"{json.dumps(streams)}; operations [{t['first_ns']}, {t['last_ns']}] inside the "
          f"markers' window {window}: {bool(inside)} (span {t['span_ns']} ns, window "
          f"{t['window_ns']} ns on the device's clock, the run's wall {t['run_ns']} ns on the "
          f"host's); busy share against the unprofiled wall {p['busy_share']:.6f} (not gated; "
          f"the stamps' limit {old_limit:.6f})", flush=True)
    for stream, s in t["streams"].items():
        if not s["busy_ns"] <= s["span_ns"]:
            raise AssertionError(f"{name}: stream {stream}'s operations sum to {s['busy_ns']} ns "
                                 f"over its span of {s['span_ns']} ns: device time counted twice")
    if not inside:
        raise AssertionError(f"{name}: the run's operations [{t['first_ns']}, {t['last_ns']}] "
                             f"are not inside its markers' window {window} on the device's clock")
    _gate_capture(name, p["audit"])
    if p["traced_launches"] != p["counted_launches"]:
        rows = {k: v for k, v in p["counts"].items() if "track" in k or "pyramid" in k}
        raise AssertionError(f"{name}: launches in the trace {p['traced_launches']} differ "
                             f"from the port's counters {p['counted_launches']}; rows "
                             f"named track or pyramid: {rows}")


def _gate_export(shortfall: dict | None, spans: dict, audit: dict | None = None) -> None:
    """The exported trace (the detail pass, host events too): B1's and B2's
    rows equal to the port's counters over that pass (``shortfall``,
    {kernel: [rows, counted]} from trace_detail), each row in the span that
    launched it (``spans``: {category: {span: rows}}), and, with
    trace_detail's ``audit``, no launch whose kernel the trace lost."""
    if shortfall is None or set(shortfall) != {"newton_track", "pyramid_flat"} \
            or any(rows != counted for rows, counted in shortfall.values()):
        raise AssertionError(f"trace_detail: B1/B2 rows in the exported trace differ from the "
                             f"port's counters over the exported pass: {shortfall}")
    if set(spans.get("newton_track", {})) != {"track_sweep"} \
            or set(spans.get("pyramid_flat", {})) != {"pyramid"}:
        raise AssertionError(f"trace_detail: B1/B2 rows missing or outside their spans: {spans}")
    if audit is not None and audit["lost_launches"]:
        raise AssertionError(f"trace_detail: {audit['lost_launches']} of "
                             f"{audit['kernel_launches']} launches in the exported trace lost "
                             f"their kernel: {json.dumps(audit)}")


def _busy_lines(busy: dict, card: str) -> dict:
    """The busy shares that phase 14's fresh process took for phases 8 and
    11 (``bench_suite.busy_works``' lines, config 5's from profile_cg's
    padded solve), each capture audited: phase 11's lines printed as they
    come, phase 8's fleet a step. Returns {"suite": {line: figures},
    "fleet": phase 8's profile}."""
    for line, figures in busy.items():
        _gate_capture(f"the busy share of {line}", figures["audit"])
    suite = {line: figures for line, figures in busy.items() if line != "fleet"}
    for line, figures in suite.items():
        print(f"phase 11 line {line} on {card} (busy share in phase 14's fresh process): "
              f"{json.dumps(figures)}", flush=True)
    f, n = busy["fleet"], FLEET_PROFILE_STEPS
    fleet = {"steps": n, "launches_per_step": f["kernel_launches"] / n,
             "device_busy_ms_per_step": f["device_busy_ms"] / n,
             "wall_ms_per_step": f["wall_ms"] / n, "device_busy_share": f["busy_share"],
             "audit": f["audit"], "retakes": f["retakes"]}
    print(f"phase 8 fleet on {card} (profile in phase 14's fresh process): profile of {n} steps: "
          f"{json.dumps(fleet)}", flush=True)
    return {"suite": suite, "fleet": fleet}


def phase_profilers(warm, card: str):
    """Phase 14: the port's nine profiling tools (slam_robot_tpu_torch/tools,
    ports of the JAX package's tools/profile_*.py, probe_live.py and
    trace_detail.py) on the card, from phase 13's warm state where a tool
    takes the bench's state. Returns (kernel counts over the phase,
    summary)."""
    import contextlib
    import io
    from pathlib import Path

    import torch

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.tools import (probe_live, profile_scan, profile_step,
                                            profile_tpu, profile_trace, profile_tracker)
    from slam_robot_tpu_torch.utils.benchscene import make_frames

    t_phase = time.time()
    dev = torch.device("cuda")
    cfg = SlamConfig()
    frames = make_frames(cfg, SCAN_FRAMES, device=dev, start=BENCH_WARM)  # 96-103
    summary = {}
    times = {}
    _reset_counts()

    def tool(name, fn):
        """Run one tool, its printed lines kept; fail on a non-finite number."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = fn(lambda s: print(s))
        times[name] = time.perf_counter() - t0
        for line in out.getvalue().strip().splitlines():
            print(f"phase 14 {name}: {line}", flush=True)
        bad = [(k, v) for k, v in _numbers(res) if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"phase 14 {name}: non-finite numbers {bad[:5]}")
        summary[name] = res
        return res

    tool("profile_tpu", lambda emit: profile_tpu.run(cfg, dev, n_max=1, emit=emit))
    tool("profile_step", lambda emit: profile_step.run(warm, frames[0], cfg, dev, n_max=1,
                                                       emit=emit))
    tool("profile_tracker", lambda emit: profile_tracker.run(dev, cfg.max_features,
                                                             cfg.patch_size, emit=emit))
    live = tool("probe_live", lambda emit: probe_live.probe(
        warm, frames[:LIVE_FRAMES], cfg,
        ("rtt",) + probe_live.STEPPING + ("bigargs",), passes=0, emit=emit))
    if not all(live["states_equal_eager"].values()) or \
            set(live["states_equal_eager"]) != set(probe_live.STEPPING):
        raise AssertionError(f"probe_live: a variant's final state differs from eager's: "
                             f"{live['states_equal_eager']}")
    # profile_scan's first pass stands as its time (reps=0); the fresh
    # process's trace then makes none of its own
    tool("profile_scan", lambda emit: [
        profile_scan.run_variant(name, cfg, frames, 0, dev, run_slam, start=warm, reps=0,
                                 emit=emit)
        for name, run_slam in (("default", True), ("noslam", False))])
    # the profiled passes in a fresh process, then the config-5 tools in a
    # second one (ROADMAP C6): the job goes under the checkout's build/,
    # phase 13's warm state with it, and so do phase 8's fleet profile and
    # phase 11's busy shares (config 5's from profile_cg's padded solve)
    job_dir = str(Path(__file__).resolve().parent / "build" / "profile14")
    profile_trace.write_job(job_dir, warm, torch.stack(frames[:TRACE_FRAMES]), cfg, top=15,
                            cg={"layouts": ["scatter", "padded"], "gn_iters": 5, "cg_iters": 20,
                                "top": 10, "small": False, "shards": [1, 2, 4, 8]},
                            busy={"small": False, "steps": FLEET_PROFILE_STEPS,
                                  "fleet_goals": FLEET_GOALS})
    t_job = time.perf_counter()
    job = profile_trace.run_job(job_dir, dev, JOB_TIMEOUT_S)
    times["fresh processes"] = time.perf_counter() - t_job
    # every capture of the two processes, in order (ROADMAP C6): the
    # process, its session's index there, the tool, the seconds and the
    # kernel launches of the process before it, whether trace_detail's
    # reader ran, and the capture's launches and lost_at
    for c in job["captures"]:
        print(f"phase 14 capture: {json.dumps(c)}", flush=True)
    retakes = {k: r["figures"]["retakes"] for k, r in job["tools"].items()
               if "retakes" in r["figures"]}
    retakes["export"] = job["tools"]["profile_trace"]["figures"]["trace_retakes"]
    retakes.update({f"busy {k}": f["retakes"] for k, f in job["busy"].items()})
    print(f"phase 14 fresh processes: {times['fresh processes']:.1f} s (by part "
          f"{json.dumps({k: round(v, 1) for k, v in job['processes'].items()})}); tools "
          f"{json.dumps({k: round(r['s'], 1) for k, r in job['tools'].items()})}; busy shares "
          f"{job['busy_s']:.1f} s; captures taken again (a lost kernel) {json.dumps(retakes)}",
          flush=True)

    def replayed(r):
        def fn(emit):
            for line in r["lines"]:
                emit(line)
            return r["figures"]
        return fn

    for name, r in job["tools"].items():  # a profile's figures only once they pass its gates
        if name in ("profile_trace", "profile_cg scatter", "profile_cg padded"):
            _gate_profile(name, r["figures"])
        tool(name, replayed(r))
        times[name] = r["s"]
    busy = _busy_lines(job["busy"], card)
    times["busy shares"] = job["busy_s"]
    p = summary["profile_trace"]
    want = {"pyramid_flat": 2 * TRACE_FRAMES}
    if p["counted_launches"]["pyramid_flat"] != want["pyramid_flat"] \
            or not p["counted_launches"]["newton_track"]:
        raise AssertionError(f"profile_trace: the traced pass launched "
                             f"{p['counted_launches']}: want {want} and newton_track > 0")

    td = job["detail"]
    rows = td["rows"]
    bad = [(k, v) for k, v in _numbers(td) if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"phase 14 trace_detail: non-finite numbers {bad[:5]}")
    by_cat, spans = {}, {}
    for r in rows:
        by_cat[r["cat"]] = by_cat.get(r["cat"], 0) + r["occ"]
        for k, v in r["spans"].items():
            spans.setdefault(r["cat"], {}).setdefault(k, 0)
            spans[r["cat"]][k] += v
    # the exported trace (the detail pass, host events too): B1's and B2's
    # rows equal to the port's counters, each in the span that launched it;
    # the audit says which launches lost their kernel and how the device's
    # time stamps sit against the host's
    print(f"phase 14 trace_detail: B1/B2 rows against the counters over the exported pass "
          f"{json.dumps(td['shortfall'])}; launches {json.dumps(td['audit'])}", flush=True)
    _gate_export(td["shortfall"], spans, td["audit"])
    for r in rows[:10]:
        print(f"phase 14 trace_detail: {r['occ']} x {r['name'][:100]} [{r['cat']}] "
              f"{r['us'] / p['trace_units']:.1f} us/frame, spans {r['spans']}", flush=True)
    summary["trace_detail"] = {"rows": len(rows), "top": rows[:10], "occ_by_category": by_cat,
                               "spans_by_category": spans, "shortfall": td["shortfall"],
                               "audit": td["audit"]}

    for r in summary["profile_cg_sharded"]["validation"]:
        if not (r["ok"] and r["cost_rel_err"] <= CG_COST_RTOL
                and r["trans_max_diff_mm"] <= CG_TRANS_MM):
            raise AssertionError(f"profile_cg_sharded: {json.dumps(r)} misses cost rtol "
                                 f"{CG_COST_RTOL} or {CG_TRANS_MM} mm")
    counts = _read_counts()
    for k, v in job["launches"].items():  # the fresh process's
        if k in counts:
            counts[k] += v
    summary["tool_s"] = times
    summary["phase_s"] = time.time() - t_phase
    summary["launches"] = counts
    print(f"phase 14 tools on {card}: {json.dumps(times)}; launches {counts}; "
          f"phase {summary['phase_s']:.1f} s", flush=True)
    return counts, summary, busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="K",
                    help="after the main path, profile K more frames of the sweep")
    ap.add_argument("--out", default="build/profile", help="directory for profile tables")
    ap.add_argument("--part", choices=sorted(PARTS), help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase 0: torch sees no CUDA device")
    if args.part:
        return run_part(args.part)
    card = _card_line()
    print(f"phase 0 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from slam_robot_tpu_torch.ops.cuda import build

    t0 = time.time()
    lib_path = build.build(verbose=True)
    build.load_library()
    print(f"phase 1 build: {time.time() - t0:.2f} s ({lib_path.name})", flush=True)

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.utils.benchscene import make_frames

    n_render = MAIN_FRAMES + args.profile
    t0 = time.time()
    frames = make_frames(SlamConfig(), n_render, device="cuda")
    torch.cuda.synchronize()
    print(f"rendered {n_render} bench frames in {time.time() - t0:.2f} s", flush=True)

    t_run = time.time()

    def took(phase: str) -> None:
        print(f"{phase} done at {time.time() - t_run:.1f} s", flush=True)

    part_frames = frames[:max(KNOB_FRAMES, ALT_FRAMES)]
    sep5 = phase_blur(frames[0])
    entries = [phase_pyramid(frames[0])]
    took("phase 2")
    newton_level = phase_newton(frames)
    entries.append(phase_track(frames))
    took("phase 3")
    counts, summary, ps, direct16 = phase_main(frames[:MAIN_FRAMES])
    took("phase 4")
    if args.profile:
        summary["profile"] = phase_profile(ps, frames, MAIN_FRAMES, args.out)
        took("phase 5")
    del frames
    replay_counts, runs = phase_replay(card)
    took("phase 6")
    for e in entries:  # the main path's kernels: phases 4 and 6 (8 below)
        e["launches"] = counts[e["name"]] + replay_counts[e["name"]]
    # newton_level is one level of newton_track's entry point: its phase 3
    # figures go with newton_track's entry
    entries[1]["newton_level"] = newton_level
    probe_entries, probes, sep5["launches"] = phase_probes()
    took("phase 7")
    # phases 9, 10 and 12 in processes of their own, all at once, beside
    # phases 8 and 11 here; phase 9's kernels are timed once they have ended
    from slam_robot_tpu_torch.tools import parity

    _write_part_inputs(part_frames, direct16, runs["synthetic"]["summary"])
    del part_frames, direct16
    t_parts = time.time()
    procs = {}
    try:
        parity_procs = _start_parity(list(parity.SEQUENCES), PARTS_DIR)
        procs.update(parity_procs)
        procs.update({name: _start_part(name) for name in PARTS})
        loop_counts, loop, loop_kernels = phase_loop(card)
        took("phase 8")
        suite_counts, suite, suite_kernels = phase_suite(card)
        took("phase 11")
        deadline = t_parts + PARTS_TIMEOUT_S
        for name in PARTS:
            _wait(PARTS[name], procs[name], deadline)
        parity_counts, parity_sum, parity_kernels = phase_parity(card, parity_procs, t_parts)
        took("phase 9")
        knob_counts, knobs = _part_result("knobs", procs["knobs"], deadline)
        took("phase 10")
        alt_counts, alt = _part_result("alt", procs["alt"], deadline)
        took("phase 12")
    finally:
        _stop(procs)
    bench_counts, bench_sum, warm = phase_bench(ps, card)
    del ps
    took("phase 13")
    tool_counts, tools, busy = phase_profilers(warm, card)
    del warm
    for line, figures in busy["suite"].items():  # by bench_suite config
        suite[line.split("_")[0]].setdefault("profile", {})[line] = figures
    loop["fleet"]["profile"] = busy["fleet"]
    took("phase 14")
    for e in entries:  # the main path's kernels: phases 4, 6 and 8-14
        e["launches"] += (loop_counts[e["name"]] + parity_counts[e["name"]]
                          + knob_counts[e["name"]] + suite_counts[e["name"]]
                          + alt_counts[e["name"]] + bench_counts[e["name"]]
                          + tool_counts[e["name"]])
        e["loop_shapes"] = loop_kernels[e["name"]]
        e["parity_shapes"] = parity_kernels[e["name"]]
        e["suite_shapes"] = suite_kernels[e["name"]]
        e["max_abs_err"] = max(e["max_abs_err"], loop_kernels[e["name"]]["max_abs_err"],
                               parity_kernels[e["name"]]["max_abs_err"],
                               suite_kernels[e["name"]]["max_abs_err"])
    sep5["path"] = "phase 7: probe2's reference, pyramid.blur and pyramid.pyr_down"
    entries += [sep5] + probe_entries
    _no_foreign_modules()
    print(json.dumps({"main_path": summary, "replay": runs, "probes": probes,
                      "closed_loop": loop, "parity": parity_sum, "knobs": knobs,
                      "bench_suite": suite, "alt_trackers_io_view": alt, "bench": bench_sum,
                      "profilers": tools}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
