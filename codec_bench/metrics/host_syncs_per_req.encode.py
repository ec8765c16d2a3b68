"""Host syncs a request, as torch's sync debug mode reports them."""


def read(ctx):
    return ctx.syncs / ctx.requests if ctx.kind == "encode" and ctx.requests else None
