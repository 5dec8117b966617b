"""Serving front end: micro-batched ROMP / BEV inference over TCP, on one
GPU (counterpart of `romp_tpu/serve.py`).

- **Micro-batching** (`MicroBatcher`): concurrent requests are coalesced
  into one device batch, padded to a small set of batch sizes (1, 2, 4, ...
  max_batch). A lone request ships after `window_ms`; a burst fills the
  batch at once. While the two-deep in-flight queue is full the dispatcher
  keeps coalescing (an early dispatch would only block), so realized
  batches approach max_batch exactly when the device is the bottleneck.
- **Double buffering**: dispatch and result fetch run on separate threads.
  `run_batch` copies the padded uint8 batch into pinned memory, uploads it
  without blocking, queues the pipeline under `torch.inference_mode()` and
  starts the copy of every output into pinned memory behind an event;
  `fetch` waits on that batch's event only. So the card computes batch k+1
  while batch k's results cross to the host. The pinned buffers are
  allocated per batch, from PyTorch's caching host allocator (cheap after
  the first batches of each size): a batch's buffers live until its
  results' numpy views are dropped, so a later batch never overwrites
  results that a connection thread still reads.
- **Transport**: length-prefixed JSON header + raw image bytes in, npz
  bytes out, as the JAX server's (`InferenceClient` is its client).

Only the dispatcher thread calls the pipeline (`precision_flags` sets
process-wide torch flags; `inference_mode` is per thread). `precompile`
runs the same path on the caller's thread before the port opens. The crowd
route submits its windows through the batcher from the connection thread.

Not carried over: the JAX server's `mesh=` / `--mesh_devices` (SPMD serving
over a TPU slice's data axis); on one GPU they mean nothing.

Usage:
    python -m romp_tpu_torch.serve --port 8011 [--GPU 0] [--model bev]
        [--model_path ... --smpl_path ...] [--act_dtype bfloat16]
        [--precompile]
    # --GPU -1 serves on the CPU; without a card the default --GPU 0 raises
    from romp_tpu_torch.serve import InferenceClient
    res = InferenceClient("127.0.0.1", 8011).infer(bgr_image)
"""
from __future__ import annotations

import argparse
import io
import json
import os.path as osp
import queue
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class Overloaded(RuntimeError):
    """Admission queue full — shed load at the edge."""


def _pad_sizes(max_batch: int, multiple: int = 1) -> List[int]:
    """Padded batch sizes: multiple, 2x, 4x, ... max_batch (each warmed up
    once by `precompile`). `multiple` > 1 keeps every size divisible by it."""
    assert max_batch % multiple == 0, (max_batch, multiple)
    sizes = []
    b = multiple
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


class MicroBatcher:
    """Coalesces single-item requests into device batches.

    run_batch: (images (B, S, S, 3) uint8) -> handle     [async dispatch]
    fetch:     handle -> dict of np arrays, leading (B,)  [blocking]

    Two stages so the device computes the next batch while the previous
    batch's results are in flight back to the host.
    """

    def __init__(self, run_batch: Callable, fetch: Callable,
                 max_batch: int = 8, window_ms: float = 2.0,
                 input_size: int = 512, batch_multiple: int = 1,
                 max_queue: int = 256):
        self.run_batch = run_batch
        self.fetch = fetch
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.input_size = input_size
        self.sizes = _pad_sizes(max_batch, batch_multiple)
        # bounded admission queue = backpressure: a flood of requests gets
        # an immediate Overloaded error instead of unbounded host memory
        # growth (each queued image is S*S*3 bytes)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self.batches_run = 0
        self.items_run = 0
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True)
        self._dispatcher.start()
        self._collector.start()

    def submit(self, image: np.ndarray) -> "Future":
        """image: (S, S, 3) uint8, already preprocessed to the model size.

        Raises Overloaded when the admission queue is full (shed load at
        the edge rather than queueing unboundedly)."""
        fut: Future = Future()
        try:
            self._q.put_nowait((image, fut))
        except queue.Full:
            raise Overloaded(
                f"admission queue full ({self._q.maxsize} pending)")
        return fut

    def precompile(self) -> None:
        """Warm up every padded batch size (zero batches through the real
        path: the first builds the CUDA kernels, and cuDNN picks its
        algorithms for each shape), so no live request pays for it. Call
        before the port opens to traffic."""
        S = self.input_size
        for b in self.sizes:
            handle = self.run_batch(np.zeros((b, S, S, 3), np.uint8))
            self.fetch(handle)

    def close(self):
        self._stop.set()
        try:
            self._q.put(None, timeout=5)   # wake dispatcher
        except queue.Full:
            pass                           # dispatcher dead; join times out
        self._dispatcher.join(timeout=5)
        # fail anything still queued so no waiter blocks forever
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("batcher closed"))
        self._inflight.put(None)   # wake collector (after in-flight items)
        self._collector.join(timeout=5)

    # ---- internals ----
    def _take_batch(self) -> Optional[List]:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.window_s
        poll = max(self.window_s, 5e-4)
        while len(batch) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                # Base window expired. If the device pipeline is full, an
                # early dispatch would only sit blocked in _inflight.put —
                # keep coalescing instead (adaptive window: realized
                # batches grow toward max_batch exactly when the device is
                # the bottleneck; light load keeps the low-latency base
                # window because _inflight has free slots).
                if not self._inflight.full():
                    break
                timeout = poll
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                continue   # re-check deadline/pipeline state
            if item is None:
                return batch   # close() during fill: run what we have
            batch.append(item)
        return batch

    def _dispatch_loop(self):
        S = self.input_size
        while True:
            # a batch returned mid-close still gets dispatched — its
            # futures must resolve; the stop flag is honored at the top of
            # the next take (as a consumed None sentinel) or below.
            batch = self._take_batch()
            if batch is None:
                break
            n = len(batch)
            padded = next(s for s in self.sizes if s >= n)
            images = np.zeros((padded, S, S, 3), np.uint8)
            for i, (img, _) in enumerate(batch):
                images[i] = img
            try:
                handle = self.run_batch(images)
            except Exception as exc:   # build/dispatch failure
                for _, fut in batch:
                    fut.set_exception(exc)
                continue
            self.batches_run += 1
            self.items_run += n
            self._inflight.put((handle, batch))
            if self._stop.is_set():
                break              # close() raced the fill; batch dispatched

    def _collect_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                break
            handle, batch = item
            try:
                out = self.fetch(handle)
            except Exception as exc:
                for _, fut in batch:
                    fut.set_exception(exc)
                continue
            for i, (_, fut) in enumerate(batch):
                fut.set_result({k: v[i] for k, v in out.items()})


class _Handle:
    """One dispatched batch: its pinned upload buffer (alive until the
    upload is done), its outputs' pinned host copies and the event after
    them (None on the CPU, where the outputs are the results)."""

    def __init__(self, staging, outputs: Dict[str, torch.Tensor], event):
        self.staging = staging
        self.outputs = outputs
        self.event = event


def _device_service(infer: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                    device: torch.device, flags: Callable, max_batch: int,
                    window_ms: float, input_size: int) -> MicroBatcher:
    """A MicroBatcher whose run_batch / fetch drive `infer` (images on the
    device -> dict of device tensors) on `device` under `flags()` (the
    pipeline's precision flags)."""

    def run_batch(images: np.ndarray) -> _Handle:
        if device.type != "cuda":
            with torch.inference_mode(), flags():
                return _Handle(None, infer(torch.from_numpy(images)), None)
        with torch.cuda.device(device):
            staging = torch.empty(images.shape, dtype=torch.uint8,
                                  pin_memory=True)
            staging.numpy()[...] = images
            with torch.inference_mode(), flags():
                out = infer(staging.to(device, non_blocking=True))
                host = {}
                for k, v in out.items():
                    host[k] = torch.empty(v.shape, dtype=v.dtype,
                                          pin_memory=True)
                    host[k].copy_(v, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return _Handle(staging, host, event)

    def fetch(handle: _Handle) -> Dict[str, np.ndarray]:
        if handle.event is not None:
            handle.event.synchronize()
        return {k: v.numpy() for k, v in handle.outputs.items()}

    return MicroBatcher(run_batch, fetch, max_batch=max_batch,
                        window_ms=window_ms, input_size=input_size)


def make_romp_service(params, smpl, cfg, max_batch: int = 8,
                      window_ms: float = 2.0, device="cuda") -> MicroBatcher:
    """MicroBatcher over `RompPipeline` (romp_pipeline.romp_inference) on
    `device` (the card unless the caller passes another).

    params: a torch-layout state dict; smpl: a SmplModel; cfg: RompConfig.
    The service expects preprocessed (S, S, 3) uint8 RGB inputs (the square
    pad/resize runs on the caller's connection thread, so image decode and
    preprocessing parallelize across clients while the device stays on
    dense batches)."""
    from romp_tpu_torch.pipeline.romp_pipeline import (
        RompPipeline, precision_flags, romp_inference,
    )

    pipe = RompPipeline(params, smpl, cfg, device)
    return _device_service(
        lambda images: romp_inference(pipe.net, pipe.smpl, images, pipe.cfg),
        pipe.device, lambda: precision_flags(pipe.cfg), max_batch, window_ms,
        cfg.input_size)


def make_bev_service(params, smpl_adult, smpl_baby, cfg, max_batch: int = 8,
                     window_ms: float = 2.0, device="cuda") -> MicroBatcher:
    """MicroBatcher over `BevPipeline` (bev_pipeline.bev_inference): all-age
    SMPL+A serving with 3D (x, y, depth) localization. Same batching as
    make_romp_service."""
    from romp_tpu_torch.pipeline.bev_pipeline import (
        BevPipeline, bev_inference,
    )
    from romp_tpu_torch.pipeline.romp_pipeline import precision_flags

    pipe = BevPipeline(params, smpl_adult, smpl_baby, cfg, device)
    return _device_service(
        lambda images: bev_inference(pipe.net, pipe.smpl_adult,
                                     pipe.smpl_baby, images, pipe.cfg),
        pipe.device, lambda: precision_flags(pipe.cfg), max_batch, window_ms,
        cfg.input_size)


# ---------------------------------------------------------------- transport

def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _send_msg(sock: socket.socket, header: Dict, payload: bytes = b""):
    h = json.dumps(header).encode()
    sock.sendall(struct.pack(">II", len(h), len(payload)) + h + payload)


MAX_HEADER_BYTES = 1 << 20      # 1 MB of JSON header
MAX_PAYLOAD_BYTES = 1 << 28     # 256 MB image/result payload


def _recv_msg(sock: socket.socket):
    hlen, plen = struct.unpack(">II", _read_exact(sock, 8))
    if hlen > MAX_HEADER_BYTES or plen > MAX_PAYLOAD_BYTES:
        raise ConnectionError(
            f"oversized message (header {hlen}, payload {plen} bytes)")
    header = json.loads(_read_exact(sock, hlen))
    payload = _read_exact(sock, plen) if plen else b""
    return header, payload


def _upcast(res: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """fp16-transferred results widened to f32 on the host."""
    return {k: np.asarray(v, np.float32) if v.dtype == np.float16 else v
            for k, v in res.items()}


class InferenceServer:
    """Threaded TCP server wrapping a MicroBatcher.

    Request : header {"shape": [H, W, 3], "dtype": "uint8"} + raw bytes
              (a BGR image of any size — preprocessing runs server-side on
              the connection thread).
    Response: header {"ok": true, "npz_bytes": N} + npz payload of the
              valid-person results (mask-filtered, pj2d/verts mapped to
              the original image frame), or {"ok": false, "error": ...}.
    """

    def __init__(self, batcher: MicroBatcher, host: str = "127.0.0.1",
                 port: int = 0, crowd_settings=None):
        # crowd_settings (BEV batchers only): namespace with overlap_ratio /
        # nms_thresh / relative_scale_thresh / input_size. When set, images
        # with aspect >= 2 route through the sliding-window crowd pipeline
        # (the reference's `bev/main.py:139` long-image mode) — the windows
        # are submitted as ordinary requests, so they micro-batch together
        # (and with other clients' traffic) on the same device batches.
        self.batcher = batcher
        self.crowd_settings = crowd_settings
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        header, payload = _recv_msg(self.request)
                        if header.get("cmd") == "stats":
                            b = outer.batcher
                            _send_msg(self.request, {
                                "ok": True,
                                "batches_run": b.batches_run,
                                "items_run": b.items_run,
                                "avg_batch": round(
                                    b.items_run / max(1, b.batches_run), 2),
                                "batch_sizes": b.sizes,
                                "queue_depth": b._q.qsize(),
                            })
                            continue
                        t0 = time.perf_counter()
                        try:
                            result = outer._infer(header, payload)
                            bio = io.BytesIO()
                            np.savez(bio, **result)
                            out = bio.getvalue()
                            _send_msg(self.request,
                                      {"ok": True,
                                       "latency_ms": round(
                                           (time.perf_counter() - t0) * 1e3,
                                           2)},
                                      out)
                        except Exception as exc:  # noqa: BLE001 — to client
                            _send_msg(self.request,
                                      {"ok": False, "error": str(exc)})
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _infer(self, header: Dict, payload: bytes) -> Dict[str, np.ndarray]:
        from romp_tpu_torch.ops.projection import (
            convert_to_org_image_coords_np,
        )
        from romp_tpu_torch.pipeline.video import filter_valid
        from romp_tpu_torch.utils.io import img_preprocess

        shape = tuple(header["shape"])
        img = np.frombuffer(payload, np.uint8).reshape(shape)
        if (self.crowd_settings is not None
                and img.shape[1] / img.shape[0] >= 2):
            return self._infer_crowd(img)
        image, pad_info = img_preprocess(
            img, input_size=self.batcher.input_size)
        image = np.clip(image[0], 0, 255).astype(np.uint8)
        # generous bound: the first request of a padded batch size that was
        # not warmed up builds the kernels (tens of seconds with nvcc)
        res = _upcast(self.batcher.submit(image).result(timeout=900))
        # batcher results are per-image (K, ...); filter_valid wants (B, K)
        res = filter_valid({k: v[None] for k, v in res.items()})
        if "pj2d" in res:
            res["pj2d_org"] = convert_to_org_image_coords_np(
                res["pj2d"], pad_info)
        if "verts_camed" in res:
            res["verts_camed_org"] = convert_to_org_image_coords_np(
                res["verts_camed"], pad_info)
        return res

    def _infer_crowd(self, img_bgr: np.ndarray) -> Dict[str, np.ndarray]:
        from romp_tpu_torch.ops.projection import (
            convert_to_org_image_coords_np,
        )
        from romp_tpu_torch.pipeline.crowd import process_long_image

        def pipe(batch):
            # the windows go through the batcher (never the pipeline on
            # this thread); process_long_image reads tensors back
            crops = np.asarray(batch)
            futs = [self.batcher.submit(
                np.clip(c, 0, 255).astype(np.uint8)) for c in crops]
            res = [_upcast(f.result(timeout=900)) for f in futs]
            return {k: torch.from_numpy(np.stack([r[k] for r in res]))
                    for k in res[0]}

        out = process_long_image(pipe, img_bgr[..., ::-1],
                                 self.crowd_settings)
        if out is None:
            return {}
        pad_info = out.pop("pad_info")
        if "pj2d" in out:
            out["pj2d_org"] = convert_to_org_image_coords_np(
                out["pj2d"], pad_info)
        if "verts_camed" in out:
            out["verts_camed_org"] = convert_to_org_image_coords_np(
                out["verts_camed"], pad_info)
        return out

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self.batcher.close()


class InferenceClient:
    """Minimal blocking client for InferenceServer.

    timeout: per-socket-op seconds (None = block forever). The first
    request of a padded batch size pays the server's warm-up (the kernel
    build, cuDNN's algorithm choice) unless it ran with --precompile."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8011,
                 timeout: Optional[float] = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def infer(self, bgr_image: np.ndarray) -> Dict[str, np.ndarray]:
        img = np.ascontiguousarray(bgr_image, np.uint8)
        _send_msg(self._sock, {"shape": list(img.shape), "dtype": "uint8"},
                  img.tobytes())
        header, payload = _recv_msg(self._sock)
        if not header.get("ok"):
            raise RuntimeError(header.get("error", "inference failed"))
        data = np.load(io.BytesIO(payload))
        return {k: data[k] for k in data.files}

    def stats(self) -> Dict:
        """Server-side batching counters (capacity planning)."""
        _send_msg(self._sock, {"cmd": "stats"})
        header, _ = _recv_msg(self._sock)
        if not header.get("ok"):
            raise RuntimeError(header.get("error", "stats failed"))
        return {k: v for k, v in header.items() if k != "ok"}

    def close(self):
        self._sock.close()


def serve_args(input_args=None) -> argparse.Namespace:
    """The server's flags: the JAX server's, less --mesh_devices, plus the
    port's --GPU (0 = cuda:0, the default; -1 = the CPU)."""
    from romp_tpu_torch.cli.common import DEFAULT_HOME

    ap = argparse.ArgumentParser("romp_tpu_torch.serve")
    ap.add_argument("--model", default="romp", choices=("romp", "bev"))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8011)
    ap.add_argument("--GPU", type=int, default=0,
                    help="CUDA device index; -1 serves on the CPU")
    ap.add_argument("--model_path", default="")
    ap.add_argument("--smpl_path", default="")
    ap.add_argument("--smil_path", default=osp.join(DEFAULT_HOME,
                                                    "smil_packed_info.pth"))
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--window_ms", type=float, default=2.0)
    ap.add_argument("--fetch_person", type=int, default=8,
                    help="top-K person slots fetched per image (0 = all; "
                         "romp only)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--act_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="bfloat16: bf16 activations between layers (the "
                         "low-memory inference mode; needs compute_dtype "
                         "bfloat16)")
    ap.add_argument("--precompile", action="store_true",
                    help="warm up every padded batch size before opening "
                         "the port (no live request pays the kernel build)")
    ap.add_argument("--crowd", action="store_true",
                    help="BEV only: route aspect>=2 panoramas through the "
                         "sliding-window crowd pipeline (windows "
                         "micro-batch with regular traffic)")
    return ap.parse_args(input_args)


def build_server(args: argparse.Namespace) -> InferenceServer:
    """The device, the weights (a missing file falls back to a seeded
    random init, as the CLIs do), the service and, with --precompile, its
    warm-up; then the server, listening."""
    from romp_tpu_torch.cli.common import (
        DEFAULT_HOME, device_from_flag, load_checkpoint_flexible,
        load_smpl_assets_flexible,
    )
    from romp_tpu_torch.smpl.body_model import SmplModel

    device = device_from_flag(args.GPU)
    crowd_settings = None
    if args.model == "bev":
        from romp_tpu_torch.cli.bev import LONG_CONF_DICT
        from romp_tpu_torch.models.bev import init_bev_params
        from romp_tpu_torch.pipeline.bev_pipeline import BevConfig

        params = load_checkpoint_flexible(
            args.model_path or osp.join(DEFAULT_HOME, "BEV.pth"),
            init_bev_params)
        adult = load_smpl_assets_flexible(
            args.smpl_path or osp.join(DEFAULT_HOME, "SMPLA_NEUTRAL.pth"),
            num_betas=11)
        baby = load_smpl_assets_flexible(args.smil_path, num_betas=10,
                                         seed=1)
        conf = LONG_CONF_DICT[1]
        cfg = BevConfig(compute_dtype=args.compute_dtype,
                        act_dtype=args.act_dtype, transfer_dtype="float16",
                        conf_thresh=conf[0] if args.crowd else 0.1)
        if args.crowd:
            crowd_settings = argparse.Namespace(
                overlap_ratio=conf[3], nms_thresh=conf[1],
                relative_scale_thresh=conf[2], input_size=cfg.input_size)
        batcher = make_bev_service(
            params, SmplModel(adult), SmplModel(baby), cfg,
            max_batch=args.max_batch, window_ms=args.window_ms,
            device=device)
    else:
        from romp_tpu_torch.models.romp import init_romp_params
        from romp_tpu_torch.pipeline.romp_pipeline import RompConfig

        params = load_checkpoint_flexible(
            args.model_path or osp.join(DEFAULT_HOME, "ROMP.pkl"),
            init_romp_params)
        assets = load_smpl_assets_flexible(
            args.smpl_path or osp.join(DEFAULT_HOME, "SMPL_NEUTRAL.pth"),
            num_betas=10)
        cfg = RompConfig(compute_dtype=args.compute_dtype,
                         act_dtype=args.act_dtype,
                         transfer_dtype="float16",
                         fetch_slots=args.fetch_person)
        batcher = make_romp_service(
            params, SmplModel(assets), cfg, max_batch=args.max_batch,
            window_ms=args.window_ms, device=device)
    if args.precompile:
        print(f"precompiling batch sizes {batcher.sizes} ...", flush=True)
        batcher.precompile()
    return InferenceServer(batcher, host=args.host, port=args.port,
                           crowd_settings=crowd_settings)


def main(input_args=None):
    args = serve_args(input_args)
    server = build_server(args)
    print(f"serving {args.model.upper()} on tcp://{args.host}:{server.port} "
          f"(max_batch={args.max_batch}, window={args.window_ms}ms)",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
