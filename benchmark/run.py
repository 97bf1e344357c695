"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the result's metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read from the same window and a
profiler trace of a few more steps. The last line of standard output
is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with --trace 1 `breakdown`, and last `checks`: each number
compared with its limit); the last lines of standard error give the
same checks. Exits non-zero, with no result, without enough CUDA
devices, on any failure, or if the JAX package or JAX was loaded.
"""

import time

T_PROC = time.perf_counter()  # noqa: E402  (set-up starts here)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the top-level names the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lookoncetohear_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_proc: float) -> dict:
    """One run of `cell` on `device` by the loop of its traffic's kind
    (`harness/<kind>.py`); returns the result object."""
    import torch

    from benchmark.harness.cell import reader, work

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cell.loop.run(cell, seed, seconds, trace, device, t_proc)
    values = dict(out["e2e"], setup_s=out["setup_s"])
    metrics = {}
    if trace:
        ctx = dict(out["ctx"], cell=cell, trace=out["trace"], work=work,
                   least_s=lambda ops, nbytes: max(
                       ops / cell.peak_flops, nbytes / cell.peak_bytes_s))
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the {cell.traffic['kind']} loop "
                                   f"gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks = {name: {"value": v, "limit": cell.limits[name]["limit"]}
              for name, v in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and out["failed"] == 0
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        tr = out["trace"]
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness.cell import load_cell
    cell = load_cell(Path.cwd() / "BENCHMARK.json", args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROC)
    gc.collect()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
