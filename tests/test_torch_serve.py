"""The port's serving front end (`romp_tpu_torch/serve.py`) on the CPU: the
micro-batcher's semantics, TCP end to end over the tiny ROMP and BEV
services, the CLI (`python -m romp_tpu_torch.serve --GPU -1`), and one
image through the port's server and the JAX package's on the same weights.
A twin of tests/test_serve.py, less its SPMD mesh test (the port serves
one GPU)."""
import argparse
import os
import os.path as osp
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu_torch.serve import (
    InferenceClient, InferenceServer, MicroBatcher, Overloaded, _pad_sizes,
    _recv_msg, _send_msg, build_server, make_bev_service, make_romp_service,
    serve_args,
)

torch.set_num_threads(2)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SIZE = 64
TINY = "hrnet32_tiny"


def test_pad_sizes():
    assert _pad_sizes(8) == [1, 2, 4, 8]
    assert _pad_sizes(6) == [1, 2, 4, 6]
    assert _pad_sizes(1) == [1]


def test_microbatcher_routes_results_and_pads():
    """Results come back to the right futures; batches are padded to the
    warmed sizes; padded rows never leak into responses."""
    seen_batches = []

    def run_batch(images):
        seen_batches.append(images.shape[0])
        return {"sum": images.reshape(images.shape[0], -1).sum(1)}

    mb = MicroBatcher(run_batch, fetch=lambda h: h, max_batch=4,
                      window_ms=30.0, input_size=8)
    try:
        imgs = [np.full((8, 8, 3), i + 1, np.uint8) for i in range(3)]
        futs = [mb.submit(im) for im in imgs]
        res = [f.result(timeout=10) for f in futs]
        for i, r in enumerate(res):
            assert r["sum"] == (i + 1) * 8 * 8 * 3
        assert mb.batches_run == 1 and seen_batches == [4]
        assert mb.items_run == 3
    finally:
        mb.close()


def test_precompile_touches_every_padded_size():
    sizes_seen = []

    def run_batch(images):
        sizes_seen.append(images.shape[0])
        return {"n": np.arange(images.shape[0])}

    mb = MicroBatcher(run_batch, fetch=lambda h: h, max_batch=8,
                      window_ms=1.0, input_size=4)
    try:
        mb.precompile()
        assert sizes_seen == [1, 2, 4, 8]
    finally:
        mb.close()


def test_microbatcher_exception_propagates():
    def run_batch(images):
        raise RuntimeError("boom")

    mb = MicroBatcher(run_batch, fetch=lambda h: h, max_batch=2,
                      window_ms=1.0, input_size=4)
    try:
        fut = mb.submit(np.zeros((4, 4, 3), np.uint8))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=10)
    finally:
        mb.close()


def test_backpressure_sheds_load():
    """submit raises Overloaded once the admission queue fills."""
    gate = threading.Event()
    taken = threading.Event()

    def run_batch(images):
        taken.set()
        gate.wait(timeout=10)
        return {"n": np.arange(images.shape[0])}

    mb = MicroBatcher(run_batch, fetch=lambda h: h, max_batch=1,
                      window_ms=0.1, input_size=4, max_queue=2)
    try:
        img = np.zeros((4, 4, 3), np.uint8)
        futs = [mb.submit(img)]          # taken by the dispatcher, blocks
        assert taken.wait(timeout=10)
        futs += [mb.submit(img), mb.submit(img)]   # fills the queue (2)
        with pytest.raises(Overloaded):
            mb.submit(img)
        gate.set()
        for f in futs:
            f.result(timeout=10)
    finally:
        gate.set()
        mb.close()


def test_close_mid_fill_still_resolves_future():
    """close() while the dispatcher is filling a batch must not strand the
    already-submitted request: it gets dispatched, never hung."""
    def run_batch(images):
        return {"n": np.arange(images.shape[0])}

    mb = MicroBatcher(run_batch, fetch=lambda h: h, max_batch=4,
                      window_ms=2000.0, input_size=4)
    fut = mb.submit(np.zeros((4, 4, 3), np.uint8))
    deadline = time.time() + 10
    while mb._q.qsize() and time.time() < deadline:
        time.sleep(0.01)         # the dispatcher took it: inside the window
    mb.close()
    assert fut.result(timeout=5) is not None


def test_microbatcher_double_buffer_overlap():
    """While batch k's fetch blocks, batch k+1 must still be dispatched
    (dispatch and collect run on separate threads)."""
    dispatched = []
    release = threading.Event()

    def run_batch(images):
        dispatched.append(time.perf_counter())
        return images.shape[0]

    def fetch(handle):
        release.wait(timeout=10)       # a slow device-to-host copy
        return {"n": np.arange(handle)}

    mb = MicroBatcher(run_batch, fetch, max_batch=1, window_ms=0.1,
                      input_size=4)
    try:
        f1 = mb.submit(np.zeros((4, 4, 3), np.uint8))
        f2 = mb.submit(np.zeros((4, 4, 3), np.uint8))
        deadline = time.time() + 10
        while len(dispatched) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert len(dispatched) == 2
        release.set()
        f1.result(timeout=10), f2.result(timeout=10)
    finally:
        release.set()
        mb.close()


def _wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "condition not reached"
        time.sleep(0.002)


def test_adaptive_window_grows_batches_under_overload():
    """With the in-flight queue full (the collector blocked in fetch on an
    Event, two batches queued behind it), the dispatcher keeps coalescing
    past its base window, so the next batch fills to max_batch though its
    requests arrive one window apart; a lone request on an idle pipeline
    ships alone on the base window. Driven by Events, not wall-clock
    thresholds."""
    gate = threading.Event()
    sizes = []

    def run_batch(images):
        sizes.append(images.shape[0])
        return images.shape[0]

    def fetch(handle):
        gate.wait(timeout=30)            # a stalled device
        return {"n": np.arange(handle)}

    mb = MicroBatcher(run_batch, fetch, max_batch=8, window_ms=1.0,
                      input_size=4)
    img = np.zeros((4, 4, 3), np.uint8)
    try:
        futs = []
        # one batch in the collector's fetch, then two in the in-flight
        # queue, each dispatched alone on an idle-enough pipeline
        for i in range(3):
            futs.append(mb.submit(img))
            _wait_for(lambda: len(sizes) == i + 1
                      and mb._inflight.qsize() == i)
        assert mb._inflight.full() and sizes == [1, 1, 1]
        for _ in range(8):
            futs.append(mb.submit(img))
            time.sleep(0.005)            # five base windows apart
        _wait_for(lambda: mb._q.qsize() == 0)
        gate.set()
        for f in futs:
            f.result(timeout=30)
        assert sizes == [1, 1, 1, 8] and mb.items_run == 11
    finally:
        gate.set()
        mb.close()

    mb2 = MicroBatcher(run_batch, lambda h: {"n": np.arange(h)},
                       max_batch=8, window_ms=1.0, input_size=4)
    try:
        mb2.submit(img).result(timeout=10)
        assert mb2.batches_run == 1 and mb2.items_run == 1
    finally:
        mb2.close()


def _tiny_romp_params(seed=0):
    from romp_tpu_torch.models.romp import init_romp_params

    return init_romp_params(torch.Generator().manual_seed(seed), TINY)


def _smpl(seed=0, num_betas=10):
    from romp_tpu_torch.smpl.assets import synthetic_assets
    from romp_tpu_torch.smpl.body_model import SmplModel

    return SmplModel(synthetic_assets(seed=seed, num_betas=num_betas))


@pytest.fixture(scope="module")
def romp_server():
    from romp_tpu_torch.pipeline.romp_pipeline import RompConfig

    cfg = RompConfig(input_size=SIZE, max_person=4, conf_thresh=-1e9,
                     fetch_slots=2, transfer_dtype="float16", backbone=TINY)
    batcher = make_romp_service(_tiny_romp_params(), _smpl(), cfg,
                                max_batch=4, window_ms=5.0, device="cpu")
    server = InferenceServer(batcher)
    yield server
    server.close()


def test_serve_end_to_end_concurrent_clients(romp_server):
    """Four concurrent clients with differently-sized images all get valid
    per-person results mapped back to their own image frames."""
    results = {}
    errors = []

    def client(i):
        try:
            c = InferenceClient(port=romp_server.port)
            rng = np.random.RandomState(i)
            img = (rng.rand(40 + 8 * i, 64, 3) * 255).astype(np.uint8)
            res = c.infer(img)
            c.close()
            results[i] = res
        except Exception as exc:  # noqa: BLE001 — surfaced via `errors`
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert set(results) == {0, 1, 2, 3}
    for res in results.values():
        # conf_thresh=-inf -> fetch_slots=2 persons survive per image
        assert res["cam"].shape[0] == 2
        assert "pj2d_org" in res and np.isfinite(res["pj2d_org"]).all()
        assert res["verts"].shape[1:] == (6890, 3)
        assert res["verts"].dtype == np.float32     # fp16 upcast on the host
    assert romp_server.batcher.items_run >= 4
    assert romp_server.batcher.batches_run <= 4


def test_stats_command(romp_server):
    c = InferenceClient(port=romp_server.port)
    img = (np.random.RandomState(1).rand(32, 48, 3) * 255).astype(np.uint8)
    c.infer(img)
    s = c.stats()
    c.close()
    assert s["items_run"] >= 1 and s["batches_run"] >= 1
    assert s["avg_batch"] >= 1.0 and s["batch_sizes"] == [1, 2, 4]


def test_serve_error_reporting(romp_server):
    """A malformed request yields an error response, not a hung socket."""
    sock = socket.create_connection(("127.0.0.1", romp_server.port))
    # payload size doesn't match the declared shape -> reshape error
    _send_msg(sock, {"shape": [10, 10, 3], "dtype": "uint8"}, b"\0" * 50)
    header, _ = _recv_msg(sock)
    assert header["ok"] is False and "error" in header
    sock.close()


def _tiny_bev_service(max_batch, **cfg_kw):
    from romp_tpu_torch.models.bev import init_bev_params
    from romp_tpu_torch.pipeline.bev_pipeline import BevConfig

    params = init_bev_params(torch.Generator().manual_seed(0), SIZE, TINY)
    cfg = BevConfig(input_size=SIZE, max_person=4, conf_thresh=-1e9,
                    backbone=TINY, **cfg_kw)
    return make_bev_service(params, _smpl(0, 11), _smpl(1, 10), cfg,
                            max_batch=max_batch, window_ms=5.0,
                            device="cpu")


def test_bev_service_end_to_end():
    """BEV serving: the micro-batched SMPL+A pipeline behind the same
    server."""
    server = InferenceServer(_tiny_bev_service(2))
    try:
        c = InferenceClient(port=server.port)
        img = (np.random.RandomState(0).rand(48, 64, 3) * 255
               ).astype(np.uint8)
        res = c.infer(img)
        c.close()
        assert "verts" in res and res["verts"].shape[1:] == (6890, 3)
        assert np.isfinite(res["cam_trans"]).all()
    finally:
        server.close()


def test_bev_crowd_serving_routes_panoramas():
    """aspect>=2 images route through the sliding-window crowd pipeline;
    the windows are served as ordinary micro-batched requests."""
    batcher = _tiny_bev_service(4)
    crowd = argparse.Namespace(overlap_ratio=0.46, nms_thresh=20.0,
                               relative_scale_thresh=1.5, input_size=SIZE)
    server = InferenceServer(batcher, crowd_settings=crowd)
    try:
        c = InferenceClient(port=server.port)
        rng = np.random.RandomState(0)
        pano = (rng.rand(40, 160, 3) * 255).astype(np.uint8)  # aspect 4
        res = c.infer(pano)
        c.close()
        assert batcher.items_run >= 2     # the windows, one item each
        if res:        # random init may prune everything; shape-check if not
            assert res["cam"].ndim == 2 and res["cam"].shape[1] == 3
            assert np.isfinite(res["pj2d_org"]).all()
    finally:
        server.close()


@pytest.mark.parametrize("model", ["romp", "bev"])
def test_bf16_act_service_on_cpu(model):
    """act_dtype=bfloat16 through the service (tiny nets, CPU): finite
    results of the pipeline's shapes."""
    if model == "romp":
        from romp_tpu_torch.pipeline.romp_pipeline import RompConfig

        cfg = RompConfig(input_size=SIZE, max_person=4, conf_thresh=-1e9,
                         backbone=TINY, compute_dtype="bfloat16",
                         act_dtype="bfloat16", fuse_chains=True)
        batcher = make_romp_service(_tiny_romp_params(), _smpl(), cfg,
                                    max_batch=2, device="cpu")
    else:
        batcher = _tiny_bev_service(2, compute_dtype="bfloat16",
                                    act_dtype="bfloat16")
    try:
        res = batcher.submit(np.zeros((SIZE, SIZE, 3), np.uint8)).result(
            timeout=120)
        assert res["verts"].shape == (4, 6890, 3)
        assert all(np.isfinite(np.asarray(v, np.float32)).all()
                   for v in res.values())
    finally:
        batcher.close()


def test_server_matches_jax_server_on_same_weights():
    """One image through the port's ROMP server and through the JAX
    package's (`romp_tpu.serve.make_romp_service`) on the same weights (the
    JAX init carried across by the weight bridge), f32: the same result
    keys, the same detections (as sets of centers; the threshold sits in
    the widest gap of JAX's top center peaks, so that summation order
    cannot move a peak across it), and each detection's values within 1e-3
    of the largest magnitude of that output (f32 summation order through
    SMPL and the projections; verts are in metres)."""
    from romp_tpu.models import layers as jlayers
    from romp_tpu.models.romp import init_romp_params as jinit
    from romp_tpu.models.romp import romp_forward
    from romp_tpu.ops.centermap import nms_heatmap
    from romp_tpu.pipeline.romp_pipeline import RompConfig as JaxConfig
    from romp_tpu.serve import InferenceServer as JaxServer
    from romp_tpu.serve import make_romp_service as jax_service
    from romp_tpu.smpl.assets import synthetic_assets
    from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
    from romp_tpu_torch.pipeline.romp_pipeline import RompConfig
    from romp_tpu_torch.smpl.body_model import SmplModel
    from romp_tpu_torch.utils.checkpoint import state_dict_from_jax
    from romp_tpu_torch.utils.io import img_preprocess

    jp = dict(jinit(jax.random.PRNGKey(0), input_size=SIZE, backbone=TINY))
    # as test_torch_romp.py: the random heads' last convs scaled to a
    # trained net's output scale, so that cam scale 1.1**s stays finite
    for key in ("final_layers.1.2.weight", "final_layers.1.2.bias",
                "final_layers.3.2.weight", "final_layers.3.2.bias"):
        jp[key] = jp[key] * 0.01
    sd = state_dict_from_jax({k: np.asarray(v) for k, v in jp.items()})
    img = (np.random.RandomState(5).rand(56, 64, 3) * 255).astype(np.uint8)
    square, _ = img_preprocess(img, input_size=SIZE)
    square = np.clip(square, 0, 255).astype(np.uint8).astype(np.float32)
    center = romp_forward(jlayers.ParamStore(jp), jnp.asarray(square),
                          backbone=TINY)[0]
    vals = np.sort(np.asarray(nms_heatmap(center[..., 0])).reshape(-1))[::-1]
    k = int(np.argmax(vals[1:8] - vals[2:9])) + 1
    cfg_kw = dict(input_size=SIZE, max_person=8, backbone=TINY,
                  conf_thresh=float(0.5 * (vals[k] + vals[k + 1])))
    assets = synthetic_assets(seed=0)
    servers = [
        JaxServer(jax_service(jp, JaxSmpl.from_assets(assets),
                              JaxConfig(**cfg_kw), max_batch=1)),
        InferenceServer(make_romp_service(sd, SmplModel(assets),
                                          RompConfig(**cfg_kw), max_batch=1,
                                          device="cpu"))]
    try:
        res = []
        for server in servers:
            c = InferenceClient(port=server.port)
            res.append(c.infer(img))
            c.close()
    finally:
        for server in servers:
            server.close()
    jres, tres = res
    assert set(jres) == set(tres)
    jc = {tuple(c): i for i, c in enumerate(jres["centers"].tolist())}
    tc = {tuple(c): i for i, c in enumerate(tres["centers"].tolist())}
    assert len(jc) == k + 1 and set(jc) == set(tc)
    for key in sorted(jres):
        ref = np.stack([jres[key][jc[c]] for c in jc]).astype(np.float64)
        got = np.stack([tres[key][tc[c]] for c in jc]).astype(np.float64)
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert np.abs(got - ref).max() <= 1e-3 * scale, key


def test_main_without_gpu_flag_asks_for_the_card():
    """No --GPU flag means cuda:0; without a card that raises (no CPU
    fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda:0 exists")
    with pytest.raises(RuntimeError, match="--GPU -1"):
        build_server(serve_args([]))


@pytest.mark.parametrize("model", ["romp", "bev"])
def test_serve_cli_on_cpu(model, tmp_path):
    """`python -m romp_tpu_torch.serve --GPU -1` at full width (HRNet-W32
    at 512x512; random init and synthetic SMPL, the missing-file
    fallbacks): it listens on a free port, answers one request, and stops
    when terminated."""
    cmd = [sys.executable, "-m", "romp_tpu_torch.serve", "--GPU", "-1",
           "--model", model, "--port", "0", "--max_batch", "1",
           "--model_path", str(tmp_path / "missing.pth"),
           "--smpl_path", str(tmp_path / "missing_smpl.pth"),
           "--smil_path", str(tmp_path / "missing_smil.pth")]
    err = open(tmp_path / "stderr.txt", "w")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=err, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        line = proc.stdout.readline()
        m = re.search(r"tcp://127\.0\.0\.1:(\d+)", line)
        assert m, (line, (tmp_path / "stderr.txt").read_text())
        c = InferenceClient(port=int(m.group(1)), timeout=300)
        img = (np.random.RandomState(2).rand(96, 80, 3) * 255).astype(
            np.uint8)
        res = c.infer(img)
        c.close()
        assert res["verts"].shape[1:] == (6890, 3)
        assert np.isfinite(res["pj2d_org"]).all()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        err.close()
