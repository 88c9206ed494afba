"""The measured window: a unit of work (an attack iteration, a frame) run
again and again for a fixed time, with a CUDA event recorded on the stream
after each unit, so that each unit's time is read from the device's
timeline without a synchronize inside the window.
"""
from __future__ import annotations

import time

import torch

# how many units the host may run ahead of the device: it waits on the
# event of the unit this many back, which leaves the queue full
LEAD = 2


def run_window(unit, seconds, device):
    """Call ``unit(i)`` for i = 0, 1, ... until ``seconds`` of host time
    have passed, the host at most ``LEAD`` units ahead of the device. The
    window ends when the device has finished every unit enqueued.

    :return: (window seconds on the host clock, each unit's ms between
        consecutive events)
    """
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        first = torch.cuda.Event(enable_timing=True)
        first.record()
    marks = []
    t0 = time.perf_counter()
    while True:
        unit(len(marks))
        if cuda:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            marks.append(mark)
            if len(marks) > LEAD:
                marks[-1 - LEAD].synchronize()
        else:
            marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
        ms = [first.elapsed_time(marks[0])] + [
            a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        window = time.perf_counter() - t0
        ms = [1e3 * (b - a) for a, b in zip([t0] + marks, marks)]
    return window, ms
