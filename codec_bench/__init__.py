"""The benchmark of the PyTorch and CUDA port (``fractencode_tpu_torch``): one
command runs one cell of ``BENCHMARK.json`` once (``python3 -m
codec_bench.run``); ``reference/`` is the plain reference its check holds
the port's outputs against."""
