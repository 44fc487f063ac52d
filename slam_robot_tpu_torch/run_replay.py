"""End-to-end replay driver: the reference's main() as a host loop around
the port's SLAM step (main.cpp:421-664 rebuilt, flags included).

Counterpart of ``slam_robot_tpu/run_replay.py``. Usage:

    python -m slam_robot_tpu_torch.run_replay --load DIR        # npy/PNG replay
    python -m slam_robot_tpu_torch.run_replay --synthetic 60    # rendered world
    python -m slam_robot_tpu_torch.run_replay --video a.avi b.avi
    ... --save DIR            record the frames (PNG)
    ... --dump /tmp/z         gnuplot map dump
    ... --no-slam             tracking only
    ... --device cpu          run on the CPU (default: the CUDA card)
    ... --serve 8089          serve the overlay live at http://HOST:8089/

Prints one status line per frame (the reference's frame banner with the
per-solve BriefReport analog and TIMER) and a JSON summary at exit
(cumulative BA iterations and final error, main.cpp:654-656).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# BA termination-reason short names (ops/ba.TERM_*), the per-solve Ceres
# BriefReport analog (slam.cpp:510-518)
TERM_NAMES = {0: "-", 1: "ftol", 2: "xtol", 3: "stall", 4: "cap"}

# live loop: frames per ring read on the host
RING = 8


def _scalars(metrics: dict) -> dict:
    """The 0-d metrics as Python values, read in one counted host sync."""
    from slam_robot_tpu_torch.device import host

    keys = [k for k, v in metrics.items() if v.dim() == 0]
    vals = host(torch.stack([metrics[k].to(torch.float64) for k in keys]))
    out = {}
    for k, v in zip(keys, vals):
        dt = metrics[k].dtype
        out[k] = bool(v) if dt == torch.bool else (float(v) if dt.is_floating_point else int(v))
    return out


def _save_png(arr: np.ndarray, path: str) -> None:
    from slam_robot_tpu_torch.io.sources import _require

    _require("PIL", "writing PNG images")
    from PIL import Image

    Image.fromarray(arr).save(path)


def _summary(n_done: int, wall: float, ps) -> dict:
    return {
        "frames": n_done,
        "wall_s": round(wall, 3),
        "fps": round(n_done / max(wall, 1e-9), 2),
        "iterations": int(ps.total_ba_iters),
        "error": float(ps.last_error),
        "n_points": int(ps.map.n_points),
        "n_obs": int(ps.map.n_obs),
    }


def _live_points(metrics: dict) -> list:
    """(point id, x, y) of this frame's matched lanes: the live view's click
    targets."""
    ids = metrics["feat_point"].cpu().numpy()
    pxs = metrics["feat_px"].cpu().numpy()
    sel = metrics["feat_matched"].cpu().numpy() & (ids >= 0)
    return list(zip(ids[sel].tolist(), pxs[sel, 0].tolist(), pxs[sel, 1].tolist()))


def _live_loop(args, cfg, src, ps, run_slam, rec, device, view=None) -> int:
    """The live robot loop (main.cpp:503-645 cadence): the step carries a
    f32[RING, LIVE_WIDTH] telemetry ring on the device
    (``pipeline.step_live_ring``), which the loop reads on the host once
    every RING frames (``device.host``, one counted sync), so frame lines
    print up to RING frames late. The stop guards act on the ring's rows
    and land as late: slow BA window failed, obs-window truncation dropped
    participating rows, normalize invariance canary > 0.1 px (the
    reference's every-frame CHECK, main.cpp:602-605). With ``view`` the
    overlay is published every --view-every frames with the last status
    the ring has reported."""
    from slam_robot_tpu_torch.device import host
    from slam_robot_tpu_torch.io import sources
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.utils import dump as dump_util

    t_start = time.time()
    n_done = 0
    stop = False
    ring = torch.zeros((RING, pipeline.LIVE_WIDTH), dtype=torch.float32, device=device)
    metas = []
    last_t0 = None
    last_status = {}
    ix = pipeline.LIVE_IDX

    def report(meta, v):
        nonlocal stop
        fid, cam, dt = meta
        if run_slam and v[ix["slow_ok"]] < 0.5:
            print("slow BA window failed; stopping (main.cpp:591-594)")
            stop = True
        drops = (int(v[ix["fast_obs_dropped"]]) + int(v[ix["slow_obs_dropped"]])
                 + int(v[ix["reproject_obs_dropped"]]))
        canary = float(v[ix["normalize_canary_px"]])
        if run_slam and drops > 0:
            print(f"frame {fid}: obs-window truncation dropped {drops} "
                  f"participating rows; stopping (silent-drop guard)")
            stop = True
        if run_slam and canary > 0.1:
            print(f"frame {fid}: normalize invariance canary "
                  f"{canary:.3f}px > 0.1; stopping (main.cpp:602-605)")
            stop = True
        last_status.update(
            frame=fid, cam=cam, matches=int(v[ix["n_matches"]]),
            keyframe=bool(v[ix["is_keyframe"]] > 0.5), points=int(v[ix["n_points"]]),
            err=round(float(v[ix["mean_reproj_err"]]), 3),
            ba_iters=f"{int(v[ix['fast_iters']])}+{int(v[ix['slow_iters']])}",
            obs_dropped=drops, canary_px=round(canary, 4))
        if not args.quiet:
            print(
                f"frame {fid:4d} cam {cam}: "
                f"matches {int(v[ix['n_matches']]):3d} "
                f"{'KF' if v[ix['is_keyframe']] > 0.5 else '  '} "
                f"added {int(v[ix['n_added']]):3d} "
                f"pts {int(v[ix['n_points']]):4d} "
                f"err {float(v[ix['mean_reproj_err']]):6.3f} "
                f"ba {int(v[ix['fast_iters']])}+{int(v[ix['slow_iters']])} "
                f"TIMER: {dt:.3f}s"
            )

    def drain():
        nonlocal metas
        rows = host(ring)
        for meta, v in zip(metas, rows[-len(metas):]):
            report(meta, v)
        metas = []

    for cam, fid, img in sources.prefetch(src):
        if (args.max_frames and fid >= args.max_frames) or stop:
            break
        t0 = time.time()
        if rec is not None:
            rec.save(fid, img)
        ps, ring = pipeline.step_live_ring(ps, ring, torch.as_tensor(img, device=device),
                                           cfg, run_slam)
        ps = pipeline.maybe_polish(ps, fid, cfg, run_slam)
        n_done += 1
        dt = 0.0 if last_t0 is None else t0 - last_t0
        last_t0 = t0
        metas.append((fid, cam, dt))
        if len(metas) == RING:
            drain()
        if (args.view_dir or view) and fid % max(args.view_every, 1) == 0:
            from slam_robot_tpu_torch.utils.debug_draw import draw_debug

            overlay = draw_debug(ps.map, img)
            if args.view_dir:
                _save_png(overlay, os.path.join(args.view_dir, f"frame_{fid:05d}.png"))
            if view:
                view.publish(overlay, last_status)
    if metas:
        drain()

    wall = time.time() - t_start
    if rec is not None:
        rec.close()
    if args.dump:
        dump_util.dump_map(ps.map, args.dump)
    print(json.dumps(_summary(n_done, wall, ps)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--load", default="", help="replay frames from directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic rendered frames")
    ap.add_argument("--video", nargs="+", default=None, metavar="FILE",
                    help="replay video file(s); two files form the fake "
                         "alternating-stereo rig (main.cpp:456-460)")
    ap.add_argument("--save", default="", help="record frames to directory (PNG)")
    ap.add_argument("--dump", default="", help="write /tmp/z-style map dump")
    ap.add_argument("--no-slam", action="store_true", help="tracking only")
    ap.add_argument("--final-ba", action="store_true",
                    help="run one full bundle adjustment over all frames at "
                         "the end (collapses windowed-BA drift)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--live", action="store_true",
                    help="live robot loop mode: per-frame telemetry packed "
                         "into a device-side ring read on the host once "
                         "every 8 frames; prints a reduced frame line (up "
                         "to 8 frames late); incompatible with "
                         "--debug-numerics / --patch-history")
    ap.add_argument("--debug-numerics", action="store_true",
                    help="run each step under float guards (a NaN made by "
                         "any operation, integer division by zero; the "
                         "SURVEY §5 sanitizer analog) and fail fast")
    ap.add_argument("--patch-history", default="", metavar="DIR",
                    help="accumulate per-point patch histories (the "
                         "reference's hover inspector data, matcher.cpp:"
                         "260-265) and write strips for the most-tracked "
                         "points to DIR")
    ap.add_argument("--view-dir", default="", metavar="DIR",
                    help="write the DrawDebug overlay (main.cpp:609-638) to "
                         "DIR/frame_%%05d.png every --view-every frames")
    ap.add_argument("--view-every", type=int, default=5,
                    help="overlay dump cadence for --view-dir (default 5)")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="serve the DrawDebug overlay live at http://HOST:PORT/ "
                         "(MJPEG stream, status line, per-point patch inspector; "
                         "the reference's GUI loop analog, main.cpp:609-638) "
                         "every --view-every frames; works with and without --live")
    args = ap.parse_args(argv)

    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.io import sources
    from slam_robot_tpu_torch.io.recorder import Recorder
    from slam_robot_tpu_torch.models import pipeline

    device = default_device(args.device)
    cfg = SlamConfig(image_width=args.width, image_height=args.height)

    if args.load:
        src = sources.FileSource(args.load)
    elif args.video and len(args.video) >= 2:
        src = sources.DuoSource(sources.VideoSource(args.video[0]),
                                sources.VideoSource(args.video[1]))
    elif args.video:
        src = sources.VideoSource(args.video[0])
    elif args.synthetic:
        src = sources.SyntheticSource(cfg, n_frames=args.synthetic, device=device)
    else:
        print("need --load DIR, --video FILE [FILE] or --synthetic N", file=sys.stderr)
        return 1
    if not src.init():
        print("source init failed", file=sys.stderr)
        return 1

    if args.live and (args.debug_numerics or args.patch_history):
        print("--live is incompatible with --debug-numerics/--patch-history",
              file=sys.stderr)
        return 1

    rec = Recorder(args.save) if args.save else None
    phist = None
    if args.patch_history:
        from slam_robot_tpu_torch.utils.patch_history import PatchHistory

        phist = PatchHistory(size=cfg.patch_size)

    ps = pipeline.init(cfg, device=device)
    run_slam = not args.no_slam

    if args.view_dir:
        os.makedirs(args.view_dir, exist_ok=True)

    view = None
    if args.serve:
        from slam_robot_tpu_torch.utils.liveview import LiveView

        view = LiveView(port=args.serve).start()
        # the per-point click inspector (main.cpp:158-267) needs the
        # per-frame match arrays, which only the per-frame loop reads
        if not args.live:
            if phist is None:
                from slam_robot_tpu_torch.utils.patch_history import PatchHistory

                phist = PatchHistory(size=cfg.patch_size)
            view.patch_history = phist
        print(f"live view: http://0.0.0.0:{view.port}/")
    try:
        if args.live:
            return _live_loop(args, cfg, src, ps, run_slam, rec, device, view)
        return _frame_loop(args, cfg, src, ps, run_slam, rec, device, phist, view)
    finally:
        if view is not None:
            view.stop()


def _frame_loop(args, cfg, src, ps, run_slam, rec, device, phist, view) -> int:
    """The per-frame loop: every frame's metrics read on the host, a frame
    line each, and the overlay, status and matched points published to
    ``view`` every --view-every frames."""
    from slam_robot_tpu_torch.io import sources
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.utils import dump as dump_util

    t_start = time.time()
    n_done = 0
    for cam, fid, img in sources.prefetch(src):
        if args.max_frames and fid >= args.max_frames:
            break
        t0 = time.time()
        if rec is not None:
            rec.save(fid, img)
        img_t = torch.as_tensor(img, device=device)
        if args.debug_numerics:
            err_chk, (ps, metrics) = pipeline.checked_step(ps, img_t, cfg, run_slam)
            err_chk.throw()
        else:
            ps, metrics = pipeline.step(ps, img_t, cfg, run_slam)
        ps = pipeline.maybe_polish(ps, fid, cfg, run_slam)
        publish = (args.view_dir or view) and fid % max(args.view_every, 1) == 0
        if phist is not None:
            phist.update(img, metrics["feat_point"], metrics["feat_px"],
                         metrics["feat_matched"])
        live_points = _live_points(metrics) if view and publish else None
        metrics = _scalars(metrics)
        if publish:
            from slam_robot_tpu_torch.utils.debug_draw import draw_debug

            overlay = draw_debug(ps.map, img)
            if args.view_dir:
                _save_png(overlay, os.path.join(args.view_dir, f"frame_{fid:05d}.png"))
            if view:
                view.publish(overlay, {
                    "frame": fid, "cam": cam, "matches": metrics["n_matches"],
                    "keyframe": bool(metrics["is_keyframe"]),
                    "points": metrics["n_points"],
                    "err": round(metrics["mean_reproj_err"], 3),
                }, points=live_points)
        dt = time.time() - t0
        n_done += 1
        if not args.quiet:
            if run_slam:
                ba_rep = (
                    f"ba {metrics['fast_iters']}"
                    f"({TERM_NAMES.get(metrics['fast_term'], '?')} "
                    f"{metrics['fast_cost0']:.1f}->{metrics['ba_cost']:.1f})"
                    f"+{metrics['slow_iters']}"
                    f"({TERM_NAMES.get(metrics['slow_term'], '?')})"
                )
            else:
                ba_rep = "ba -"
            print(
                f"frame {fid:4d} cam {cam}: matches {metrics['n_matches']:3d} "
                f"{'KF' if metrics['is_keyframe'] else '  '} "
                f"added {metrics['n_added']:3d} pts {metrics['n_points']:4d} "
                f"err {metrics['mean_reproj_err']:6.3f} "
                f"{ba_rep} "
                f"drift {metrics['normalize_err_drift']:.4f} "
                f"TIMER: {dt:.3f}s"
            )
        if run_slam and not metrics["slow_ok"]:
            print("slow BA window failed; stopping (main.cpp:591-594)")
            break

    wall = time.time() - t_start
    if rec is not None:
        rec.close()

    if args.final_ba and run_slam:
        from slam_robot_tpu_torch.models import localmap as lm
        from slam_robot_tpu_torch.models import slam as slam_mod

        m, res = slam_mod.solve_all_frames(ps.map, cfg.ba_range, cfg=cfg)
        m = lm.normalize(m)
        m, final_err = lm.reproject(m)
        ps = ps._replace(map=m)
        print(f"final full BA: {int(res.iters)} iters, "
              f"mean reproj err {float(final_err):.3f}px")

    if args.dump:
        dump_util.dump_map(ps.map, args.dump)

    if phist is not None and args.patch_history:
        os.makedirs(args.patch_history, exist_ok=True)
        for pid in phist.top_ids(8):
            strip = phist.strip(pid)
            if strip is None:
                continue
            u8 = np.clip(strip * 255.0, 0, 255).astype(np.uint8)
            _save_png(u8, os.path.join(args.patch_history, f"point_{pid:04d}.png"))
        print(f"patch histories: {len(phist.hist)} points -> {args.patch_history}")

    print(json.dumps(_summary(n_done, wall, ps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
