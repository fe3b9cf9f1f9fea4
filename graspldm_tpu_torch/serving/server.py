"""HTTP grasp-generation service over the PyTorch/CUDA pipelines.

Counterpart of :mod:`graspldm_tpu.serving.server`. ``GraspServer`` and its
handler are copies of the JAX package's (stdlib only; that copy is
unreachable without JAX); :func:`make_batch_generate_from_parts` is rewritten
for torch. A ``ThreadingHTTPServer`` accepts JSON requests, hands each
object's cloud to the :class:`DynamicBatcher`, and returns world-frame
grasp transforms. The models and their packed kernel weights stay resident
on the device.

API:
  * ``POST /v1/generate`` — body ``{"points": [[x, y, z], ...],
    "num_grasps": int}`` -> ``{"grasps": [G, 4, 4], "grasp_tmrp": [G, 6],
    "confidence": [G], "qualities": [G, nq]?, "num_grasps": G}``.
  * ``GET /healthz`` — liveness.
  * ``GET /v1/stats`` — batcher counters + latency percentiles.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .batcher import DynamicBatcher

__all__ = ["make_batch_generate_from_parts", "GraspServer"]

MAX_REQUEST_POINTS = 200_000
MAX_BODY_BYTES = 32 * 1024 * 1024


def make_batch_generate_from_parts(
    vae,
    ddm=None,
    diffusion=None,
    *,
    device,
    num_grasps: int = 64,
    num_inference_steps: int = 100,
    sampler: str = "ddim",
    seed: int = 0,
) -> Callable[[np.ndarray, Optional[np.ndarray]], Dict]:
    """Build the batcher's compute callable from model parts.

    LDM mode when ``ddm`` is given, VAE-prior mode otherwise. The models
    move to ``device`` (a CUDA device runs the kernels, the CPU their plain
    versions) and their kernel weights are packed once here;
    normalization (per-object centering) runs in the request path, so the
    host hands over raw metric points. Class-conditioned serving is not
    ported yet: a ``cls`` field is refused.
    """
    from ..inference.pipeline import ldm_generate, pack_generation_weights, vae_generate
    from ..utils.normalization import normalize_pc_and_grasps

    if ddm is not None and diffusion is None:
        raise ValueError("LDM serving needs the diffusion process")
    device = torch.device(device)
    vae = vae.to(device).eval()
    if ddm is not None:
        ddm = ddm.to(device).eval()
    weights = pack_generation_weights(vae, ddm, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    lock = threading.Lock()  # the batcher's worker is single, but guard anyway

    def batch_generate(pcs: np.ndarray, cls: Optional[np.ndarray]) -> Dict:
        if cls is not None:
            raise ValueError(
                "this model is not class-conditioned; drop the 'cls' field"
            )
        with lock, torch.no_grad():
            pc = torch.as_tensor(pcs, dtype=torch.float32, device=device)
            dummy = torch.zeros((pc.shape[0], 1, 6), device=device)
            pc_n, _, meta = normalize_pc_and_grasps(pc, dummy)
            if ddm is None:
                out = vae_generate(vae, pc_n, num_grasps, generator, meta=meta,
                                   weights=weights)
            else:
                out = ldm_generate(
                    vae, ddm, diffusion, pc_n, num_grasps, generator,
                    num_inference_steps=num_inference_steps, sampler=sampler,
                    meta=meta, weights=weights,
                )
            return {k: v.float().cpu().numpy() for k, v in out.items()}

    return batch_generate


class _Handler(BaseHTTPRequestHandler):
    server_version = "graspldm-tpu-torch/1.0"
    batcher: DynamicBatcher = None  # type: ignore[assignment]
    info: Dict = {}
    request_timeout_s: float = 120.0

    # quiet by default; the CLI flips this on with --verbose
    log_enabled = False

    def log_message(self, fmt, *args):  # noqa: D102
        if self.log_enabled:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._reply(200, {"ok": True, **self.info})
        elif self.path == "/v1/stats":
            self._reply(200, self.batcher.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0 or length > MAX_BODY_BYTES:
                raise ValueError(f"bad Content-Length {length}")
            req = json.loads(self.rfile.read(length))
            points = np.asarray(req["points"], np.float32)
            if points.ndim != 2 or points.shape[1] != 3:
                raise ValueError(f"points must be [N, 3], got {points.shape}")
            if not 1 <= points.shape[0] <= MAX_REQUEST_POINTS:
                raise ValueError(
                    f"points count must be in [1, {MAX_REQUEST_POINTS}]"
                )
            max_g = self.info.get("num_grasps", 64)
            num_grasps = int(req.get("num_grasps", max_g))
            if not 1 <= num_grasps <= max_g:
                raise ValueError(f"num_grasps must be in [1, {max_g}]")
            cls = req.get("cls")
            cls = float(cls) if cls is not None else None
        except Exception as e:  # malformed request
            self._reply(400, {"error": str(e)})
            return
        try:
            # submit() raises ValueError for caller errors (pc shape /
            # finiteness / cls-vs-model compatibility → 400) and
            # RuntimeError when the batcher is closed — a server-state
            # condition, not a caller error, hence 503
            fut = self.batcher.submit(points, num_grasps, cls_cond=cls)
        except ValueError as e:
            self._reply(400, {"error": str(e)})
            return
        except RuntimeError as e:
            self._reply(503, {"error": str(e)})
            return
        try:
            res = fut.result(timeout=self.request_timeout_s)
        except Exception as e:  # model/validation error surfaced per request
            self._reply(500, {"error": str(e)})
            return
        payload = {
            k: np.asarray(v, np.float64).tolist()
            for k, v in res.items()
            if k in ("grasps", "grasp_tmrp", "confidence", "qualities")
        }
        payload["num_grasps"] = num_grasps
        self._reply(200, payload)


class GraspServer:
    """Threaded HTTP server bound to a :class:`DynamicBatcher`."""

    def __init__(
        self,
        batcher: DynamicBatcher,
        host: str = "127.0.0.1",
        port: int = 8421,
        info: Optional[Dict] = None,
        verbose: bool = False,
        request_timeout_s: float = 120.0,
    ):
        handler = type(
            "BoundHandler",
            (_Handler,),
            {
                "batcher": batcher,
                "info": dict(info or {}),
                "log_enabled": verbose,
                "request_timeout_s": request_timeout_s,
            },
        )
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.batcher = batcher
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self.httpd.server_address

    def start_background(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="graspldm-http", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.batcher.close()
