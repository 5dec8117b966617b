"""Socket-based remote visualization: stream SMPL results to live clients.

Parity: the reference's TCP visualization server / Blender live-mocap bridge
(`romp/lib/visualization/socket_utils.py:75-226`,
`romp/exports/blender_mocap.py:19-161`): the inference process pushes
per-frame SMPL params over TCP; a client (e.g. a Blender addon driving an
armature) consumes them. Protocol: 4-byte big-endian length + JSON payload
{"poses": [[72]...], "betas": [[10|11]...], "trans": [[3]...],
"track_ids": [...], "frame_id": int}.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, List, Optional

import numpy as np


def _send_msg(conn: socket.socket, payload: dict) -> None:
    raw = json.dumps(payload).encode()
    conn.sendall(struct.pack(">I", len(raw)) + raw)


def _recv_msg(conn: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = conn.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    n = struct.unpack(">I", hdr)[0]
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return json.loads(buf.decode())


class ResultsServer:
    """Accepts any number of clients; broadcast() pushes frame results."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9999):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._clients.append(conn)

    def broadcast(self, results: Dict[str, np.ndarray],
                  frame_id: int = 0) -> int:
        payload = {"frame_id": int(frame_id)}
        for key, out_key in (("smpl_thetas", "poses"),
                             ("smpl_betas", "betas"),
                             ("cam_trans", "trans"),
                             ("track_ids", "track_ids")):
            if key in results:
                payload[out_key] = np.asarray(results[key]).tolist()
        sent = 0
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    _send_msg(c, payload)
                    alive.append(c)
                    sent += 1
                except OSError:
                    c.close()
            self._clients = alive
        return sent

    def close(self):
        """Stop accepting, close every client and the listening socket,
        and wait (up to 5 s) for the accept thread to end. The shutdown
        wakes the thread out of `accept()`: closing alone leaves it
        blocked there with the socket still listening on the port."""
        self._stop = True
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients.clear()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:   # not connected on some platforms: close does it
            pass
        self._srv.close()
        self._thread.join(5.0)


class ResultsClient:
    """Blocking consumer (what a Blender addon would run)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9999,
                 timeout: float = 10.0):
        self._conn = socket.create_connection((host, port), timeout=timeout)
        self._conn.settimeout(timeout)

    def receive(self) -> Optional[dict]:
        return _recv_msg(self._conn)

    def close(self):
        self._conn.close()


def main(argv=None):
    """Headless viewer client (counterpart of the reference's
    `vis_platform/vis_server.py` + `scripts/launch_vis_server.sh`, which
    opened an Open3D window): connects to a streaming CLI
    (`romp ... --socket_stream`), prints a per-frame summary, and can dump
    the received sequence to an npz for offline viewing with
    `vis/world_view.py`."""
    import argparse

    ap = argparse.ArgumentParser(description="romp_tpu results viewer client")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9999)
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until the stream closes)")
    ap.add_argument("--save", default=None,
                    help="write received frames to this .npz")
    args = ap.parse_args(argv)

    cli = ResultsClient(host=args.host, port=args.port, timeout=60.0)
    frames = []
    try:
        n = 0
        while args.frames <= 0 or n < args.frames:
            msg = cli.receive()
            if msg is None:
                break
            n += 1
            n_people = len(msg.get("poses", []))
            ids = msg.get("track_ids")
            print(f"frame {msg.get('frame_id', n)}: {n_people} people"
                  + (f" ids={ids}" if ids is not None else ""))
            if args.save:
                frames.append(msg)
    finally:
        cli.close()
    if args.save and frames:
        packed = {f"frame_{i:06d}": json.dumps(m) for i, m in
                  enumerate(frames)}
        np.savez_compressed(args.save, **packed)
        print(f"saved {len(frames)} frames to {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
