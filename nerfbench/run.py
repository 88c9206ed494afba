"""Run one cell of the benchmark once and print its result line.

    python3 -m nerfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. The cell
names a configuration (``nerfbench/configs/<config>.json``, whose
``backbone`` flag names the module ``nerfbench/backbones/<backbone>.py``
that holds what the harness needs of that network) and a traffic
mix (``nerfbench/traffic/<traffic>.json``, whose ``kind`` names the driver
in ``nerfbench/kinds/`` and whose ``scene`` names a file in
``nerfbench/scenes/``); its limits are ``nerfbench/limits/<cell>.json`` and
each per-layer metric is read by ``nerfbench/metrics/<metric>.py``.

Set-up (``setup_s``, from the start of this module) builds the scene, the
weights and the port's evaluator on the card and warms every shape the
window uses. With ``--trace 0`` the window runs for ``--seconds`` and the
cell's end-to-end metrics are printed; with ``--trace 1`` a fixed amount of
the same work runs under the profiler and the per-layer metrics are
printed. Either way the program's outputs are then compared with the plain
reference in ``nerfbench/reference/``: each number compared is printed
beside its limit as the last lines of standard error and under ``checks``,
the last key of the result line. Exits non-zero, printing no result, where
no card is present, where the cell asks for more cards than there are, or
where JAX, its libraries or the JAX package were loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "nerfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerfool_tpu")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(root, "BENCHMARK.json")


def load_cell(name, root=ROOT, bench=None):
    from nerfbench.session import Cell

    bench = bench or benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    config = {c["name"]: c for c in bench["configs"]}[work["config"]]
    here = os.path.join(root, "nerfbench")
    traffic = _json(here, "traffic", f"{work['traffic']}.json")
    return Cell(name=name, config=_json(root, config["file"]),
                traffic=traffic,
                scene=_json(here, "scenes", f"{traffic['scene']}.json"),
                limits=_json(here, "limits", f"{name}.json"))


def cell_metrics(bench, name):
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    applies = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in moved]
    return e2e, layer


def reader(metric, here=HERE):
    """The ``read(traced)`` function of a per-layer metric."""
    path = os.path.join(here, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "nerfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell, seed, seconds, trace, device, bench, t0=T0):
    """One run of ``cell``. :return: (result dict, checks)"""
    import torch

    from nerfbench.trace import breakdown, by_operator, capture
    from nerfbench.window import run_window

    cuda = torch.device(device).type == "cuda"
    kind = importlib.import_module(
        f"nerfbench.kinds.{cell.traffic['kind']}").SESSION
    session = kind(cell, seed, device)
    session.sync()
    setup_s = time.perf_counter() - t0
    print("setup " + ", ".join(f"{k} {v:.2f} s" for k, v in dict(
        imports=setup_s - sum(session.phases.values()),
        **session.phases).items()), file=sys.stderr)
    e2e, layer = cell_metrics(bench, cell.name)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1}
    result = {}
    if trace:
        units = int(cell.traffic["trace_units"])
        _, tr = capture(lambda: [session.unit_of_work(i)
                                 for i in range(units)], device)
        traced = session.traced_context(tr, units)
        metrics = {}
        for m in layer:
            value = reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
        print("device s by operator: " + "; ".join(
            f"{op} {sec:.4f}" for op, sec in by_operator(tr)),
            file=sys.stderr)
        attempted = units
    else:
        window_s, ms = run_window(session.unit_of_work, seconds, device)
        got = dict(session.end_to_end(window_s, ms), setup_s=setup_s)
        metrics = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                   for m in e2e}
        attempted = len(ms)
        print("unit ms " + " ".join(f"{x:.2f}" for x in ms), file=sys.stderr)
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    prog = session.program_readings()
    session.free_program()
    t_ref = time.perf_counter()
    numbers = session.judge(prog)
    print(f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    checks = {k: {"value": numbers[k], "limit": lim["limit"]}
              for k, lim in cell.limits["checks"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev, **result,
              "checks": checks}
    return result, numbers


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    bench = benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[a.workload]
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    cell = load_cell(a.workload, bench=bench)
    result, _ = run(cell, a.seed, a.seconds, a.trace, "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
