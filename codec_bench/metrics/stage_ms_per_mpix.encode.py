"""Device ms per megapixel in the encode's kernels other than the search
kernels: the inputs, prep, post and the quadtree's selection."""
from codec_bench.trace import is_search


def read(ctx):
    if ctx.kind != "encode":
        return None
    return ctx.ms_per_mpix(lambda name, kind: kind == "kernel" and not is_search(name, kind))
