"""Serve an artifact of the PyTorch port over HTTP, stdlib only (the
counterpart of scripts/serve_model.py, with the same protocol).

    python scripts/export_model_torch.py --params <cfg> --what encode \
        --out exports/encode.pt2
    python scripts/serve_model_torch.py --artifact exports/encode.pt2 \
        --port 8787 [--cpu]

The artifact may be a video model's (SAViDiffusion: clips [B, T, H, W,
3]) or an image model's (SADiffusion: images [B, H, W, 3]); the server
reads the shapes from its header.

Protocol (numpy .npz both ways):

    GET  /health   -> {"status": "ok", "surface": ..., "device": ...,
                       "meta": ..., "args": [...]}
    POST /predict  body: npz with arrays named arg0..argN
                   reply: npz with arrays named out0..outM

Client:

    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.savez(buf, arg0=video)   # or images
    req = urllib.request.Request("http://host:8787/predict",
                                 buf.getvalue(), method="POST")
    out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
    slots, masks = out["out0"], out["out1"]

Each argument is checked against the artifact's header (a wrong name,
shape or dtype is a 400 that says which); a failure while running is a
structured 500. A bf16 output (the slots of a `use_bf16` model) is sent
as float32, which numpy can hold. It runs the artifact on the CUDA card
(replayed from CUDA graphs) unless `--cpu` is given; the artifact must
have been exported for that device. Single-threaded: one card, one
queue; concurrency belongs in processes behind a load balancer.
"""

import argparse
import io
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _to_numpy(t):
    import torch
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def make_handler(call, header):
    expect = header["args"]

    class Handler(BaseHTTPRequestHandler):

        def log_message(self, fmt, *args):  # quiet; stdout is the app log
            pass

        def _reply(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/health":
                return self._reply(404, b'{"error": "not found"}')
            body = json.dumps({"status": "ok", "surface": header["surface"],
                               "device": header["device"],
                               "meta": header["meta"],
                               "args": expect}).encode()
            self._reply(200, body)

        def do_POST(self):
            if self.path != "/predict":
                return self._reply(404, b'{"error": "not found"}')
            n = int(self.headers.get("Content-Length", 0))
            try:
                data = np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
                args = []
                for i, spec in enumerate(expect):
                    a = data[f"arg{i}"]
                    if list(a.shape) != spec["shape"] or \
                            str(a.dtype) != spec["dtype"]:
                        raise ValueError(
                            f"arg{i}: got {a.shape}/{a.dtype}, artifact "
                            f"wants {spec['shape']}/{spec['dtype']}")
                    args.append(a)
            except (KeyError, ValueError, OSError) as e:
                return self._reply(
                    400, json.dumps({"error": str(e)}).encode())
            try:
                outs = call(*args)
            except Exception as e:  # a failure while running (device, out
                # of memory, ...) -> a structured 500, not a dropped
                # connection; the server keeps serving
                return self._reply(
                    500, json.dumps({"error": f"{type(e).__name__}: "
                                              f"{e}"}).encode())
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            buf = io.BytesIO()
            np.savez(buf, **{f"out{i}": _to_numpy(o)
                             for i, o in enumerate(outs)})
            self._reply(200, buf.getvalue(), "application/octet-stream")

    return Handler


def make_server(artifact, port=0, host="127.0.0.1", device=None):
    """-> HTTPServer ready for serve_forever(); port 0 picks a free one.
    `device`: the artifact's own by default."""
    from slotdiffusion_tpu_torch.serving import load_artifact

    call, header = load_artifact(artifact, device)
    return HTTPServer((host, port), make_handler(call, header))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--artifact", required=True)
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--cpu", action="store_true",
                        help="serve a CPU artifact on the CPU")
    args = parser.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to serve a CPU "
                         "artifact on the CPU")
    device = "cpu" if args.cpu else "cuda"
    srv = make_server(args.artifact, args.port, args.host, device)
    print(f"serving {args.artifact} on http://{args.host}:"
          f"{srv.server_port} ({device})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
