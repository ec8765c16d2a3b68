"""Device ms per megapixel of host-to-device and device-to-host memcpys: the
plane's upload and the results' copy back."""
from codec_bench.trace import is_host_copy


def read(ctx):
    return ctx.ms_per_mpix(is_host_copy) if ctx.kind == "encode" else None
