"""The least time a large-map solve needs on a card: its bytes and
operations counted from the problem's sizes and trip counts alone.

A solve of O observation rows, P points, W frame slots and C cameras with
``gn_iters`` Gauss-Newton steps of ``cg_iters`` CG iterations each, counted
as the algorithm needs it and not as any program lays it out: every input
byte read once and every output byte written once, for each pass over the
rows; the padded, sorted or spilled copies that a program makes are its own
and are not counted. float32 and int32 take 4 bytes, a bool 1.

Per row (``ROW_*``): the table (frame, point, pixel, ok: 17 bytes); the
Jacobian blocks a linearization writes and every Schur product reads
(a frame's 2x6, a point's 2x4 and the weight: 84 bytes); the two indices a
product needs beside them (8 bytes). Per point: its homogeneous location
(16), its 4x4 block (64), its gradient (16). Per frame: quaternion and
translation (28), its 6x6 block (144), its gradient and a CG vector (24).

Terms of one solve:

- ``cost``: the cost at the start and at the end: the table and the state
  read, 2 passes.
- ``linearize`` (each GN step): the table and the state read; the Jacobian
  blocks, the point blocks and gradients and the frame blocks and gradients
  written.
- ``products`` (each GN step, ``cg_iters`` + 2: one a CG iteration, one for
  the right-hand side, one for the back-substitution): the Jacobian blocks,
  the indices, the points' inverse blocks and a frame vector read, a frame
  vector written (the back-substitution writes the point steps instead).
- ``update`` (each GN step): the state and the steps read, the state written.

Operations, float32 (``OPS_*``): a residual with its Cauchy term 40 a row;
the Jacobians 130 and the blocks and gradients 300 a row; a Schur product
84 a row, 32 a point (the 4x4 inverse times a vector), 72 a frame (the damped
6x6 block times a vector); the damping and the 4x4 inverse 200 a point.
"""

from __future__ import annotations

ROW_TABLE, ROW_JAC, ROW_IDX = 17, 84, 8
POINT_STATE, POINT_BLOCK, POINT_GRAD = 16, 64, 16
FRAME_STATE, FRAME_BLOCK, FRAME_VEC = 28, 144, 24
OPS_RESIDUAL, OPS_JACOBIAN, OPS_BLOCKS = 40, 130, 300
OPS_PRODUCT_ROW, OPS_PRODUCT_POINT, OPS_PRODUCT_FRAME = 84, 32, 72
OPS_POINT_INVERSE = 200

# published peaks of a card, by torch.cuda.get_device_name(): HBM bytes/s,
# float32 operations/s outside the tensor cores (NVIDIA's H100 SXM data
# sheet, at the full 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}


def solve_terms(O: int, P: int, W: int, C: int, gn_iters: int, cg_iters: int) -> dict:
    """{term: (bytes, operations)} of one solve, each over the whole solve."""
    state = C * FRAME_STATE + P * POINT_STATE
    cost = (2 * (O * ROW_TABLE + state), 2 * O * OPS_RESIDUAL)
    linearize = (O * (ROW_TABLE + ROW_JAC) + state + P * (POINT_BLOCK + POINT_GRAD)
                 + W * (FRAME_BLOCK + FRAME_VEC),
                 O * (OPS_RESIDUAL + OPS_JACOBIAN + OPS_BLOCKS) + P * OPS_POINT_INVERSE)
    n_products = cg_iters + 2
    product = (O * (ROW_JAC + ROW_IDX) + P * POINT_BLOCK + W * (FRAME_BLOCK + 2 * FRAME_VEC),
               O * OPS_PRODUCT_ROW + P * OPS_PRODUCT_POINT + W * OPS_PRODUCT_FRAME)
    update = (2 * state + W * FRAME_VEC + P * POINT_STATE, C * 40 + P * 4)
    return {
        "cost": cost,
        "linearize": tuple(gn_iters * v for v in linearize),
        "products": tuple(gn_iters * n_products * v for v in product),
        "update": tuple(gn_iters * v for v in update),
    }


def least_seconds(terms: dict, device_name: str) -> float | None:
    """The larger of bytes over the card's bandwidth and operations over its
    float32 rate, for ``terms`` (:func:`solve_terms`); None for a card whose
    peaks the table lacks."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    n_bytes = sum(b for b, _ in terms.values())
    n_ops = sum(o for _, o in terms.values())
    return max(n_bytes / peak["bytes_per_s"], n_ops / peak["flops_per_s"])
