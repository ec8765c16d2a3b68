"""Device ms per megapixel in the decode's kernels (the decoder step's
gathers, s*v + o, clamp and floor, at both scales)."""


def read(ctx):
    if ctx.kind != "decode":
        return None
    return ctx.ms_per_mpix(lambda name, kind: kind == "kernel")
