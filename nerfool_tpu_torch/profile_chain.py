"""Where the bf16 whole-chain kernel (K2, ``csrc/gnt_chain.cu``) spends its
time on the card.

    python -m nerfool_tpu_torch.profile_chain

Builds the source a second time with ``-DGNT_CHAIN_STAMPS``: in that build
thread 0 of block 0 adds the clocks it spends in each stage of the chain to
a counter (a warp owns 16 samples through every stage, so one thread's
clocks are its warp's). One launch on seeded random weights and inputs at
the shape of a bf16 GNT render's chunk (4096 rays, 10 views, 192 samples,
depth 8) is timed with CUDA events in the plain build and in the stamped one,
both through the wrapper's own launch (``chain.launch_chain``); printed are the card's name and power limit, both times, the
stamped launch's clocks by stage, and, where the toolkit's ``cuobjdump`` is
on the machine, the instruction mix of the plain build's bf16 kernel: its
totals and, for every loop of 60 to 1500 instructions (the inner loops), its
size and its counts of ``HMMA`` (tensor-core), load, local-memory (spill)
and ``MUFU`` instructions.
"""
from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess

import torch

from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.ops import build, chain

STAGES = ("entry", "view attention", "view feed-forward", "q_fc",
          "K, V and the barriers", "ray attention", "ray feed-forward",
          "output")
STAMP_FLAGS = ("-DGNT_CHAIN_STAMPS",)
# a bf16 GNT render's chunk at the published widths (ci = 32 features + rgb)
RAYS, VIEWS, SAMPLES, DEPTH, CI, SEED = 4096, 10, 192, 8, 35, 0


def operands(net):
    """bf16 chain operands on the card: features ~ N(0, 1), ~10% of the
    views masked."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    v, r, s = VIEWS, RAYS, SAMPLES
    n = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    mask = (torch.rand(v, r, s, 1, device="cuda", generator=g) > 0.1).float()
    merged, emb = chain.chain_inputs(net, n(v, r, s, CI), 0.1 * n(v, r, s, 4),
                                     mask, n(r, s, 3), n(r, 3))
    return merged.bfloat16(), emb.bfloat16()


def launch_ms(lib, net, merged, emb, reps):
    """ms per launch of ``lib``'s bf16 kernel, after one warm-up launch."""
    chain.launch_chain(lib, net, merged, emb)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        chain.launch_chain(lib, net, merged, emb)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def instruction_mix(path, kernel="gnt_chain_bf16_kernel"):
    """Print the SASS instruction mix of ``kernel`` in the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as err:
        print(f"no instruction mix: {err}")
        return
    body = next(f for f in sass.split("Function : ") if kernel in f[:300])
    ins = [(int(a, 16), op.split(".")[0], rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)([^;]*);", body)]
    count = lambda rows: collections.Counter(op for _, op, _ in rows)
    total = count(ins)
    print(f"{kernel}: {len(ins)} instructions; "
          + ", ".join(f"{op} {n}" for op, n in total.most_common(12)))
    loops = set()
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            loops.add((int(target.group(1), 16), addr))
    print("inner loops (60 to 1500 instructions):")
    for lo, hi in sorted(loops):
        rows = [i for i in ins if lo <= i[0] <= hi]
        c = count(rows)
        if 60 <= len(rows) <= 1500:
            print(f"  {lo:#08x}-{hi:#08x}: {len(rows):5d} instructions, HMMA "
                  f"{c['HMMA']}, LDG {c['LDG']}, LDS {c['LDS']}, local "
                  f"loads {c['LDL']} stores {c['STL']}, MUFU {c['MUFU']}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_chain measures the card: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    net = create_model(backbone="gnt", trans_depth=DEPTH, seed=SEED,
                       device="cuda").net_coarse
    with torch.no_grad():
        merged, emb = operands(net)
        plain = chain.build()
        stamped = chain.bind(build.load_library("gnt_chain", STAMP_FLAGS))
        print(f"V={VIEWS} R={RAYS} S={SAMPLES} depth {DEPTH}, bf16: "
              f"{launch_ms(plain, net, merged, emb, 5):.3f} ms per launch; "
              f"{chain.bf16_kernel_resources(VIEWS, SAMPLES, CI)}")
        ms = launch_ms(stamped, net, merged, emb, 2)
        stamped.gnt_chain_stage_cycles(None, 1)
        one = launch_ms(stamped, net, merged, emb, 1)
        cycles = (ctypes.c_ulonglong * len(STAGES))()
        stamped.gnt_chain_stage_cycles(cycles, 0)
    # launch_ms warms up once more: the counters hold two launches
    total = sum(cycles)
    print(f"stamped build: {ms:.3f} ms per launch ({one:.3f} for the counted "
          f"ones); clocks of block 0's first warp by stage, "
          f"{total / 2:.0f} per launch:")
    for name, c in zip(STAGES, cycles):
        print(f"  {name:24s} {100 * c / total:5.1f}%")
    instruction_mix(build.library_path("gnt_chain"))


if __name__ == "__main__":
    main()
