"""Host ms per attack iteration in which the host waited for the card
inside an ``attack.step`` span: the spans, the host operators and the
device's copies on one clock.

Two kinds of wait are read. A synchronizing runtime call made outside any
operator (``torch.cuda.synchronize``, an event's ``synchronize``) is in the
trace's host events itself. One made inside an operator is not: the trace
keeps the operator (``aten::copy_``, ``aten::_local_scalar_dense``), and the
copy between the card and host memory it launched (``Memcpy HtoD``,
``Memcpy DtoH``). Such an operator waited when the copy ended on the card
while the operator still ran on the host: PyTorch synchronizes the stream
after a copy from pageable memory, so the operator returns only once the
card has drained the work queued before it.
"""
from nerfbench.spans import named

BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(traced):
    recs = named(traced, "attack.step")
    if recs is None:
        return None
    steps = [(r.begin_ns, r.end_ns) for r in recs]
    inside = lambda s, e: any(b <= s and e <= f for b, f in steps)
    waits = {h for h in traced.trace.host_ops
             if h[0] in BLOCKING_CALLS and inside(h[1], h[2])}
    for name, _, end, op in traced.trace.device:
        if op is not None and name.startswith(HOST_COPIES):
            # the innermost operator of that name running when it ended
            held = [h for h in traced.trace.host_ops
                    if h[0] == op and h[1] <= end < h[2]
                    and inside(h[1], h[2])]
            if held:
                waits.add(max(held, key=lambda h: h[1]))
    return sum(e - s for _, s, e in waits) / 1e6 / traced.units
