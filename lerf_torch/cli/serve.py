"""Serving daemon: one long-lived process holds a predictor and serves it
over HTTP (the port of ``lerf_tpu/cli/serve.py``).

    # LUT form, on the CUDA card
    python -m lerf_torch.cli.serve -e models/lerf-g --port 8008

    # network form
    python -m lerf_torch.cli.serve -e models/lerf-g --form net --twoStage \\
        --outC 3 --port 8008

    # on the CPU (tests)
    python -m lerf_torch.cli.serve -e models/lerf-g --port 8008 \\
        --platform cpu

    curl -X POST --data-binary @in.png \\
        'http://127.0.0.1:8008/v1/upscale?scale=2.5' > out.png
    curl -X POST --data-binary @in.png \\
        'http://127.0.0.1:8008/v1/warp?matrix=1,0,0,0,1,0,0,0,1&outSize=512x512' \\
        > warped.png

Endpoints and the concurrency model: :mod:`lerf_torch.serve.httpd`.
"""
from __future__ import annotations

import dataclasses
import sys

from ..config import parse_config
from ..serve import make_server
from .upscale import UpscaleConfig, build_predictor

__all__ = ["ServeConfig", "main"]


@dataclasses.dataclass
class ServeConfig(UpscaleConfig):
    host: str = "127.0.0.1"
    port: int = 8008
    geometry: str = "host"       # host | device (warp_device_async)


def main(argv=None, *, serve_forever: bool = True):
    cfg = parse_config(ServeConfig, argv)
    pred = build_predictor(cfg)
    server = make_server(pred, host=cfg.host, port=cfg.port,
                         granularity=cfg.bucket, geometry=cfg.geometry)
    print(f"lerf-torch {cfg.form} daemon on "
          f"http://{cfg.host}:{server.server_address[1]} "
          f"(device={pred.device}, bucket={cfg.bucket}, "
          f"geometry={cfg.geometry})", flush=True)
    if serve_forever:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    return server


if __name__ == "__main__":
    main(sys.argv[1:])
