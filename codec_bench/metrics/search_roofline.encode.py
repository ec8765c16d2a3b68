"""The search kernels' share of their roofline (%): the least time the card
could take for the window's searches (``arith.bound_s`` of each search's
needed pairs and bytes, summed) over the device time of every search launch
(K1, K2 and its reduce, K3; the counted route's untaken launch included).
The needed pairs are the same-class pairs of the configuration's classes:
with ``use_classifier`` off, every range against every column (rows x
columns, the dense search K3 makes; its bytes unmasked)."""
from codec_bench.trace import is_search


def read(ctx):
    t = ctx.trace.seconds(is_search)
    if ctx.kind != "encode" or t <= 0 or ctx.search_bound_s <= 0:
        return None
    return 100.0 * ctx.search_bound_s / t
