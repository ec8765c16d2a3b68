"""The share of the window in which no device operation runs."""


def read(ctx):
    return ctx.idle_share() if ctx.kind == "decode" else None
