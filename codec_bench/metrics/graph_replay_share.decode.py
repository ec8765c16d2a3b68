"""Replays over all calls that ``utils.graphs`` counted in the window."""


def read(ctx):
    return ctx.replay_share() if ctx.kind == "decode" else None
