"""The readings that a cell's limits are set from, many seeds in one
process on the card.

    python3 -m nerfbench.study --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--faults] [--witness] [--out FILE]

For every seed it builds the cell as a run does, drives the timed path
(an attack cell's checked steps, a render cell's frame of the test view
``i mod n``), and compares the program with the reference: the lower
readings. For each control seed it also puts the reference computed on
the TF32 tensor cores in the program's place (the control: the nearest
precision below the configuration's f32). ``--faults`` reads, on the
control seeds, the faults the cell can have, planted in the reference put
in the program's place (an attack step over half its rays, the mean taken
over the rest) or in the program's output (a frame with one chunk's
answers replaced by the next chunk's; with a fine level, the fine level's
last chunk replaced by the rays just before it). ``--witness`` compares the
reference with itself, its feature net run in two batches of views (a
second f32 rounding of the same function). One JSON line per seed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from nerfbench import run as bench_run


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _planted(frame, pick, rows, levels):
    """A frame's readings at ``pick`` with the answers of ``rows`` (a
    slice) of ``levels`` replaced by as many rays' answers after them, or
    before them where none follow."""
    out = {}
    for lv, got in frame.items():
        out[lv] = {}
        for q, x in got.items():
            if lv in levels:
                x = x.clone()
                n = rows.stop - rows.start
                src = (slice(rows.stop, rows.stop + n)
                       if rows.stop + n <= len(x)
                       else slice(rows.start - n, rows.start))
                x[rows] = x[src]
            out[lv][q] = x[pick]
    return out


def study_seed(cell, seed, index, control, faults, witness=False,
               device="cuda"):
    kind = importlib.import_module(
        f"nerfbench.kinds.{cell.traffic['kind']}").SESSION
    t0 = time.perf_counter()
    s = kind(cell, seed, device)
    if s.unit == "frame":
        s.unit_of_work(index % len(s.rig.views))
    s.sync()
    t_prog = time.perf_counter() - t0
    prog = s.program_readings()
    bad = {}
    if faults and s.unit == "frame":
        frame, pick, chunk = s.frames[0][1], s.picked[0], s.chunk
        bad["fault_answer_altered"] = _planted(
            frame, pick, slice(0, chunk), set(frame))
        if "fine" in frame:
            n = len(frame["fine"]["rgb"])
            bad["fault_fine_last_chunk"] = _planted(
                frame, pick, slice(n - (n % chunk or chunk), n), {"fine"})
    s.free_program()
    t0 = time.perf_counter()
    rec = {"seed": seed, "program_s": t_prog, "lower": s.judge(prog)}
    s.sync()
    rec["reference_s"] = time.perf_counter() - t0
    if control:
        rec["control"] = s.judge(s.reference_readings(tf32=True))
    if witness:
        rec["reference_two_batches"] = s.judge(
            s.reference_readings(feature_batches=2))
    if faults and s.unit == "iteration":
        full = s.sels
        s.sels = [sel[:len(sel) // 2] for sel in full]
        half = s.reference_readings()
        s.sels = full
        bad["fault_half_batch"] = half
    for name, readings in bad.items():
        rec[name] = s.judge(readings)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--witness", action="store_true")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = bench_run.load_cell(a.workload)
    for i, seed in enumerate(a.seeds):
        rec = study_seed(cell, seed, i, seed in a.control_seeds,
                         a.faults and seed in a.control_seeds, a.witness)
        rec["workload"] = a.workload
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
