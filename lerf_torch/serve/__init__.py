"""Serving runtime: pipelined streaming over the async predictor forms
(:mod:`lerf_torch.serve.engine`) and the HTTP daemon
(:mod:`lerf_torch.serve.httpd`, CLI ``python -m lerf_torch.cli.serve``);
the port of ``lerf_tpu.serve``."""
from .engine import stream_upscale, stream_warp
from .httpd import make_server

__all__ = ["stream_warp", "stream_upscale", "make_server"]
