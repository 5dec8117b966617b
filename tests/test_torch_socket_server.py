"""The port's results server (`romp_tpu_torch/vis/socket_server.py`) on the
CPU: streaming to a client, and closing that frees its port."""
import socket
import time

import numpy as np

from romp_tpu_torch.vis.socket_server import ResultsClient, ResultsServer


def test_close_ends_accept_thread_and_frees_port():
    """After close() the accept thread has ended and a new listening socket
    binds the same port with SO_REUSEADDR, as the server sets it (while
    the old socket still listened, that bind failed: EADDRINUSE)."""
    srv = ResultsServer(port=0)
    port = srv.port
    srv.close()
    assert not srv._thread.is_alive()
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        probe.bind(("127.0.0.1", port))
        probe.listen(1)
    finally:
        probe.close()


def test_broadcast_reaches_client_then_close():
    """A connected client receives a broadcast frame; close() then ends
    the accept thread with the client still connected."""
    srv = ResultsServer(port=0)
    cli = ResultsClient(port=srv.port, timeout=10.0)
    try:
        for _ in range(200):   # until the accept thread registers it
            if srv.broadcast({"cam_trans": np.zeros((1, 3))}, 7):
                break
            time.sleep(0.01)
        msg = cli.receive()
        assert msg["frame_id"] == 7 and msg["trans"] == [[0.0, 0.0, 0.0]]
    finally:
        srv.close()
        cli.close()
    assert not srv._thread.is_alive()
