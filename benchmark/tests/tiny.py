"""Cells of the benchmark at a size that a CPU test run holds: the files'
configuration with fewer cameras, points and rows, everything else as
committed (solver, traffic, limits, metrics)."""

from __future__ import annotations

from benchmark import spec

SIZES = {"ladybug1723.full": (40, 2000, 9000), "venice1778.full": (40, 2000, 10500)}


def tiny_cell(name: str) -> dict:
    cell = spec.load_cell(name)
    C, P, O = SIZES[name]
    cell["config"].update(cameras=C, points=P, observations=O)
    cell["config"]["assumed"]["track_length"]["cap"] = 16
    return cell


def tiny_config(name: str) -> dict:
    return tiny_cell(name)["config"]
