"""The share of the window in which the device waits on a graph replay's
launch: the idle gaps that an op of a graph body ends (a
``fractencode_mark_begin`` to its ``fractencode_mark_end``: work that only
``utils/graphs.py``'s ``graph.replay()`` issues), the gap before the body's
first op included.  Each gap is put down to the device op that ends it, on the
device's own clock, and not by where the port's host spans fall: kineto aligns
the host's clock with the device's only to about a millisecond.  Read from the
port's device marks (``utils/profiling.py``); none without them."""
from codec_bench import arith
from codec_bench.trace import short


def waits(device, start: float, end: float) -> list:
    """(seconds, name, kind, whether in a graph body) of each idle gap of
    [start, end] and the device op that ends it, in order; the gap that no op
    ends (the window's last) is left out."""
    ending, body = {}, False
    for name, kind, b, e in sorted(device, key=lambda op: (op[2], op[3])):
        mark = short(name) if "fractencode_mark_" in name else None
        body = body or mark == "fractencode_mark_begin"
        ending.setdefault(b, (name, kind, body))
        body = body and mark != "fractencode_mark_end"
    return [(e - b, *ending[e])
            for b, e in arith.gaps(((b, e) for *_, b, e in device), start, end) if e in ending]


def read(ctx):
    tr = ctx.trace
    if ctx.kind != "encode" or tr.window_s <= 0 or not any(
            "fractencode_mark_begin" in name for name, *_ in tr.device):
        return None
    return sum(t for t, *_, body in waits(tr.device, tr.start, tr.end) if body) / tr.window_s
