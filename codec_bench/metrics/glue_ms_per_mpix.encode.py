"""Device ms per megapixel outside every graph body (a ``begin`` mark to its
``end`` mark), host copies left out (``copy_ms_per_mpix.encode`` has them):
the replays' input fills, the batch forms' row copies, the clones of a
replay's outputs.  Read from the port's device marks (``utils/profiling.py``);
none without them."""
from codec_bench.trace import is_host_copy, short

# each mark's stage: the device work after it, up to the next mark, on the one
# stream (None: outside every graph body)
STAGES = {"fractencode_mark_begin": "inputs", "fractencode_mark_inputs": "inputs",
          "fractencode_mark_prep": "prep", "fractencode_mark_search": "search",
          "fractencode_mark_post": "post", "fractencode_mark_end": None}


def stage_seconds(device) -> list:
    """(stage, seconds) of each device op that is neither a mark nor a
    host copy, in stream order."""
    stage, out = None, []
    for name, kind, b, e in sorted(device, key=lambda op: (op[2], op[3])):
        if kind == "kernel" and short(name) in STAGES:
            stage = STAGES[short(name)]
        elif not is_host_copy(name, kind):
            out.append((stage, e - b))
    return out


def read(ctx):
    if ctx.kind != "encode" or ctx.mpix <= 0 or not any(
            short(name) == "fractencode_mark_begin" for name, *_ in ctx.trace.device):
        return None
    return 1e3 * sum(t for stage, t in stage_seconds(ctx.trace.device)
                     if stage is None) / ctx.mpix
