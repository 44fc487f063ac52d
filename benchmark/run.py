"""Run one cell of ``BENCHMARK.json`` on the CUDA card and print its result.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from this module's first line to the window's start):
the imports, the cell's inputs drawn on the card from ``--seed``, and a warm
solve of every shape the window uses. Then the measured window, the check
of what it produced against the plain reference (after the window's peak
memory is read), and one JSON line on standard output, the last: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit; the same numbers are the
last lines on standard error. With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones, each read by
``metrics/<name>.py``.

Exits 2 without a result where torch sees no CUDA card or fewer than the
cell's chips, and 3 where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

# caches of anything the program builds stay in the checkout, at fixed paths
CACHE = spec.CHECKOUT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

import torch  # noqa: E402

from benchmark import trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_robot_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole (the port's name only begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device: str,
             t0: float) -> dict:
    """The run: set-up, window, check. Returns the result's fields and the
    run's record (``record``) that the metric readers read."""
    dev = torch.device(device)
    stages = {"imports": time.perf_counter() - t0}
    drv = spec.driver(cell).Driver(cell, seed, dev)
    stages["inputs"] = time.perf_counter() - t0 - sum(stages.values())
    drv.warm()
    stages["warm"] = time.perf_counter() - t0 - sum(stages.values())
    rec = {"sizes": drv.sizes, "setup_stages": stages, "setup_s": time.perf_counter() - t0}
    if traced:
        window, rec["trace"], rec["retakes"] = trace.captured_window(
            lambda: drv.window(seconds))
        if rec["trace"] is None:
            raise RuntimeError("every capture of the window lost its markers")
    else:
        window = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec.update({k: v for k, v in window.items() if k != "sampled"})
    checks, failed = drv.check(window, cell["limits"])
    rec["device_kind"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    device_fields = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": rec["device_kind"], "count": cell["chips"],
                     "memory_peak_bytes": peak}
    if traced:
        device_fields["busy_s"] = rec["trace"]["busy_ns"] / 1e9
        device_fields["window_s"] = rec["trace"]["window_ns"] / 1e9
    metrics = {}
    for m in cell["per_layer" if traced else "end_to_end"]:
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(c["pass"] for c in checks.values()), "attempted": window["attempted"],
           "failed": failed, "metrics": metrics, "device": device_fields}
    if traced:
        top = sorted(rec["trace"]["by_category_ns"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v / 1e9] for k, v in top],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return {"result": out, "record": rec, "summary": drv.summary(rec)}


def main(argv=None, device: str | None = None) -> int:
    """``device`` given skips the look for a card (the tests' CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    torch.set_num_threads(1)
    got = run_cell(cell, a.seed, a.seconds, bool(a.trace), device, T0)
    out, rec = got["result"], got["record"]
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 3
    print(f"cell {a.workload} seed {a.seed} on {out['device']['kind']} "
          f"({power_limit() if device == 'cuda' else 'cpu'}): {got['summary']}; set-up "
          f"{rec['setup_s']:.6f} s { {k: round(v, 6) for k, v in rec['setup_stages'].items()} }; "
          f"retakes {rec.get('retakes', 0)}", flush=True)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
