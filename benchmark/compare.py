"""The comparison that decides ``correct``: what the timed solves returned
against the plain reference's solve of the same tables.

The numbers, each with its limit from the cell's workload file:

- ``cost0_rel``: |cost0 - reference's| / reference's, the cost at the start:
  residuals, cheirality and the Cauchy loss over every row.
- ``cost_rel``: the same for the cost at the end, over every solve of the
  window (each reads its cost back).
- ``px_gap``: the widest gap, in pixels, between where a row's point lands
  in its camera under the solve's final frames and points and under the
  reference's, over every row that the reference's answer keeps in front
  of its camera (``z >= cheirality_eps * w``, the solver's own rule): the
  Jacobians, the sums on both sides, the Schur product, the CG loop and the
  update, as each shows in the answer. Taken in pixels because a
  homogeneous point's scale and a far point's depth are all but free in
  the solve; both sides pick them by rounding. A row whose point the
  answer puts behind the camera is one the solve no longer uses, and its
  "pixel" is a division by a negative depth: a two-view point that the
  solve sends towards infinity (w -> 0) lands there on both sides, at
  places that rounding decides.
- ``not_ok``: solves whose ``ok`` is false; the limit is 0.

A number passes where it is at most its limit; NaN passes nothing.
"""

from __future__ import annotations

import torch

from benchmark.reference import geometry as geo

NAMES = ("cost0_rel", "cost_rel", "px_gap", "not_ok")
BLOCK_ROWS = 1 << 20


def relative(value: float, ref: float) -> float:
    return abs(value - ref) / abs(ref)


def projections(tables: dict, answer: dict, rows: slice) -> tuple:
    """float64 (pixels, camera-space points) of rows ``rows`` under an
    answer's frames and points."""
    f = tables["obs_frame"][rows].long()
    p = tables["obs_point"][rows].long()
    k = tables["cam_k"].double()[tables["frame_cam"].long()[f]]
    R = geo.rotation_matrix(answer["frame_quat"].double())[f]
    X = answer["point_loc"].double()[p]
    pc = geo.to_camera(R, answer["frame_trans"].double()[f], X, geo.Precision())
    return geo.pixel(pc, k), pc, X


def px_gap(tables: dict, got: dict, ref: dict, cheirality_eps: float) -> float:
    """The widest pixel gap between two answers over every ``ok`` row that
    the reference's answer keeps in front of its camera."""
    O = tables["obs_frame"].shape[0]
    worst = torch.zeros((), dtype=torch.float64, device=tables["obs_frame"].device)
    for b in range(0, O, BLOCK_ROWS):
        rows = slice(b, b + BLOCK_ROWS)
        a = projections(tables, got, rows)[0]
        r, pc, X = projections(tables, ref, rows)
        kept = tables["obs_ok"][rows] & (pc[:, 2] >= cheirality_eps * X[:, 3])
        gap = torch.where(kept, torch.linalg.norm(a - r, dim=-1), 0.0)
        # a NaN anywhere is the widest gap
        worst = torch.maximum(worst, torch.where(torch.isnan(gap), torch.inf, gap).max())
    return float(worst)


def check(tables: dict, ref: dict, costs: list, oks: list, sampled: dict, limits: dict,
          cheirality_eps: float) -> tuple[dict, int]:
    """The window's numbers against ``limits``: ``costs`` and ``oks`` as read
    back after each solve, ``sampled`` the full answers of the sampled
    solves by index (``frame_quat``, ``frame_trans``, ``point_loc``,
    ``cost0``). Returns ({name: {"value", "limit", "pass"}} in ``NAMES``
    order, the number of solves whose own answer fails a limit)."""
    ref_cost, ref_cost0 = float(ref["cost"]), float(ref["cost0"])
    per_solve = {i: {"cost_rel": relative(c, ref_cost), "not_ok": float(ok != ref["ok"])}
                 for i, (c, ok) in enumerate(zip(costs, oks))}
    for i, s in sampled.items():
        per_solve[i]["cost0_rel"] = relative(float(s["cost0"]), ref_cost0)
        per_solve[i]["px_gap"] = px_gap(tables, s, ref, cheirality_eps)
    out = {}
    for name in NAMES:
        vals = [v[name] for v in per_solve.values() if name in v]
        # NaN is the worst reading and passes nothing
        value = sum(vals) if name == "not_ok" else max(vals, key=lambda x: (x != x, x))
        out[name] = {"value": value, "limit": limits[name], "pass": bool(value <= limits[name])}
    failed = sum(1 for v in per_solve.values()
                 if not all(v[n] <= limits[n] for n in v))
    return out, failed
