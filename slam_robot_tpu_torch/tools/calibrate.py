"""Camera intrinsics calibration: the SolveCameras flow (main.cpp:269-328).

Port of ``tools/calibrate.py``: replays a sequence through the SLAM step,
then runs full bundle adjustment with the camera intrinsics free
(CameraStabilization regularizers active) and prints the initial and the
solved k rows in the original's format.

    python -m slam_robot_tpu_torch.tools.calibrate --synthetic 20 [--device cpu]
    python -m slam_robot_tpu_torch.tools.calibrate --load DIR

``--device`` (default ``cuda``, the card) replaces the original's
``--platform``; without a card the tool raises unless it is given ``cpu``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, results: dict | None = None) -> int:
    """Run the flow and print k before and after. ``results``, when given,
    receives the replayed map before the reset (``map``), the
    ``initial_k`` and ``solved_k`` tensors, the solve's ``result``, and the
    reprojection error before (``reproj0_px``) and after (``reproj_px``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--load", default="", help="replay frames from directory")
    ap.add_argument("--synthetic", type=int, default=20, help="synthetic frames to replay")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)

    import torch

    from slam_robot_tpu_torch.config import SlamConfig
    from slam_robot_tpu_torch.device import default_device
    from slam_robot_tpu_torch.io import sources
    from slam_robot_tpu_torch.models import localmap as lm
    from slam_robot_tpu_torch.models import pipeline, slam

    device = default_device(args.device)
    cfg = SlamConfig(image_width=args.width, image_height=args.height)
    src = (sources.FileSource(args.load) if args.load
           else sources.SyntheticSource(cfg, n_frames=args.synthetic, device=device))
    src.init()

    ps = pipeline.init(cfg, device=device)
    for cam, fid, img in sources.prefetch(src):
        ps, _ = pipeline.step(ps, torch.as_tensor(img, device=device), cfg)

    m = ps.map

    def print_k(m, label):
        print(f"k1 k2 k3 fx fy cx cy   ({label})")
        for c in range(cfg.num_cameras):
            k = m.cam_k[c].cpu().numpy()
            print(" " + ", ".join(f"{v:9.5f}" for v in k))

    print_k(m, "initial")
    _, err0 = lm.reproject(m)
    replayed = m
    # Reset() then full BA with intrinsics free (main.cpp:276-283)
    m = lm.reset_cameras(m)
    m, res = slam.solve_all_frames(m, 2.0, solve_cameras=True, cfg=cfg)
    m, err = lm.reproject(m)
    print_k(m, f"solved, {int(res.iters)} iters, reproj {float(err):.3f}px")
    if results is not None:
        results.update(map=replayed, initial_k=replayed.cam_k, solved_k=m.cam_k, result=res,
                       reproj0_px=float(err0), reproj_px=float(err))
    return 0


if __name__ == "__main__":
    sys.exit(main())
