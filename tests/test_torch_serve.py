"""The port's serving path against the JAX package's: the payload decoder,
the engine's event stream, a full session over each package's server, run
control, the session registry, and the kept divergence (the port's session
exports only after its backend has drained; ROADMAP Queue 3).

Scenes: ``tests/oracle.py`` at 48x64, as ``tests/test_serve.py`` runs them.
Tolerances: decoded pixels exactly (both are float32 of the same uint8);
poses 2e-4 (``tests/test_torch_slam_e2e.py``: each solve agrees to about
1e-5 and the warm starts chain the frames); a keyframe event's points
within 1e-3 m where they lie within a few metres (0.1 mm rounding on both
sides, plus the pose tolerance times the scene's depth), and further out
within 1e-3 m plus the pose tolerance times their distance (the plane
scene's grazing pixels land hundreds of metres away); its colours exactly;
the point counts equal except for pixels whose mean confidence lies within
1e-5 of the threshold, which the two packages' sums may put on either side
(counted, at most 1 %).
"""

import asyncio
import base64
import io
import json
import threading
import time
import urllib.request

import cv2
import numpy as np
import pytest
import torch
import websockets
import websockets.asyncio.server as ws_server

from mast3r_slam_tpu.config import load_config as jload_config
from mast3r_slam_tpu.serve import server as jserver
from mast3r_slam_tpu.slam.pipeline import SLAM as JSLAM
from mast3r_slam_tpu_torch.config import load_config
from mast3r_slam_tpu_torch.data.png import encode_png
from mast3r_slam_tpu_torch.eval.export import load_ply
from mast3r_slam_tpu_torch.eval.trajectory import load_traj_tum
from mast3r_slam_tpu_torch.serve import broadcast, server, ws
from mast3r_slam_tpu_torch.slam.pipeline import SLAM

import torch_jpeg_encoders as enc
from oracle import OracleDataset, OracleModel, PlaneScene, arc_trajectory
from test_torch_common import CPU, TorchOracleModel

HW = (48, 64)
N_FRAMES = 6
POSE_ATOL = 2e-4
POINT_ATOL = 1e-3
CONF_BAND = 1e-5


# ---------------------------------------------------------------------------
# payload decoding
# ---------------------------------------------------------------------------

def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([128 + 90 * np.sin(x / 6.0), 128 + 90 * np.cos(y / 4.0),
                       (2 * x + 3 * y) % 256], -1)
    return np.clip(smooth + rng.normal(0, 12, smooth.shape), 0, 255).astype(np.uint8)


_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
PAYLOADS = ([("png", None, None, 0, (48, 64)), ("png", None, None, 0, (37, 53)),
             ("png-gray", None, None, 0, (37, 53))]
            + [("jpeg", q, s, 0, (48, 64)) for q in (50, 90, 100) for s in _SAMPLING]
            + [("jpeg", 90, "420", 0, (37, 53)), ("jpeg", 75, "420", 2, (48, 64)),
               ("jpeg", 75, "444", 1, (37, 53)), ("jpeg-gray", 90, None, 0, (37, 53))]
            + [("jpeg-progressive", q, s, r, hw) for q, s, r, hw in (
                (90, "420", 0, (48, 64)), (75, "422", 2, (37, 53)), (100, "444", 1, (37, 53)))]
            + [("jpeg-gray-progressive", 90, None, 2, (37, 53))]
            + [("jpeg-arithmetic", q, s, r, hw) for q, s, r, hw in (
                (90, "420", 0, (48, 64)), (75, "422", 2, (37, 53)), (95, "444", 1, (37, 53)))]
            + [("jpeg-arithmetic-progressive", q, s, r, hw) for q, s, r, hw in (
                (90, "420", 2, (48, 64)), (80, "444", 0, (37, 53)))]
            + [("jpeg-gray-arithmetic", 90, None, 1, (37, 53)),
               ("jpeg-lossless-rgb", None, None, 2, (37, 53))])


def _encode(kind, quality, sampling, restart, hw, seed=0):
    rgb = _image(*hw, seed)
    bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    if kind == "png":
        ok, buf = cv2.imencode(".png", bgr)
    elif kind == "png-gray":
        ok, buf = cv2.imencode(".png", rgb[..., 0])
    elif "arithmetic" in kind:  # the test-side QM encoder: cv2 writes no SOF9/SOF10
        return base64.b64encode(enc.arithmetic_jpeg(
            rgb[..., 1] if "gray" in kind else rgb, quality=quality, sampling=sampling or "444",
            progressive=kind.endswith("progressive"), restart=restart)).decode()
    elif kind == "jpeg-lossless-rgb":  # three lossless components: cv2 reads them as RGB
        return base64.b64encode(enc.lossless_jpeg([rgb[..., k] for k in range(3)], predictor=4,
                                                  restart_rows=restart)).decode()
    elif kind.startswith("jpeg-gray"):
        ok, buf = cv2.imencode(".jpg", rgb[..., 1], [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                     cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                                                     cv2.IMWRITE_JPEG_PROGRESSIVE,
                                                     int(kind.endswith("progressive"))])
    else:
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling],
                                             cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                                             cv2.IMWRITE_JPEG_PROGRESSIVE,
                                             int(kind.endswith("progressive"))])
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


@pytest.mark.parametrize("kind,quality,sampling,restart,hw", PAYLOADS,
                         ids=[f"{k}-{q}-{s}-rst{r}-{h}x{w}" for k, q, s, r, (h, w) in PAYLOADS])
def test_decode_image_payload_equals_the_jax_package(kind, quality, sampling, restart, hw):
    data = _encode(kind, quality, sampling, restart, hw)
    got = server.decode_image_payload(data)
    want = jserver.decode_image_payload(data)  # cv2.imdecode
    assert got.dtype == np.float32 and got.shape == want.shape == hw + (3,)
    np.testing.assert_array_equal(got, want)


def _prefixes(data):
    """Each prefix of a progressive stream's scans, ended with an EOI."""
    at, out = 0, []
    while (at := data.find(b"\xff\xda", at + 2)) >= 0:
        if at > data.index(b"\xff\xda"):
            out.append(data[:at] + b"\xff\xd9")
    return out + [data]


PROGRESSIVE = [(s, r, hw) for s in _SAMPLING for r in (0, 2) for hw in ((1, 1), (37, 53))]


@pytest.mark.parametrize("sampling,restart,hw", PROGRESSIVE,
                         ids=[f"{s}-rst{r}-{h}x{w}" for s, r, (h, w) in PROGRESSIVE])
def test_partial_progressive_payloads_equal_the_jax_package(sampling, restart, hw):
    """A client on a thin link sends the first scans of a progressive frame:
    each prefix of cv2's script (libjpeg-turbo smooths its blocks), and a
    CMYK frame, decode as the JAX server's ``cv2.imdecode`` does."""
    data = base64.b64decode(_encode("jpeg-progressive", 80, sampling, restart, hw))
    prefixes = _prefixes(data)
    assert len(prefixes) == 10
    for cut in prefixes:
        payload = base64.b64encode(cut).decode()
        np.testing.assert_array_equal(server.decode_image_payload(payload),
                                      jserver.decode_image_payload(payload))
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_image(*hw, 3)).convert("CMYK").save(buf, "JPEG", progressive=True)
    for cut in _prefixes(buf.getvalue()):
        payload = base64.b64encode(cut).decode()
        np.testing.assert_array_equal(server.decode_image_payload(payload),
                                      jserver.decode_image_payload(payload))


def test_decode_image_payload_refuses_what_it_cannot_read():
    rgb = cv2.cvtColor(_image(48, 64, 1), cv2.COLOR_RGB2BGR)
    ok, prog = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    prog = prog.tobytes()
    # SOF10, once refused (Queue 1 item 13c): read as arithmetic-coded, as cv2 reads it
    arith = base64.b64encode(prog.replace(b"\xff\xc2", b"\xff\xca", 1)).decode()
    np.testing.assert_array_equal(server.decode_image_payload(arith),
                                  jserver.decode_image_payload(arith))
    # a gray lossless frame: cv2's IMREAD_COLOR returns nothing, the JAX
    # server fails on it and the port refuses it
    lossless = base64.b64encode(enc.lossless_jpeg(_image(37, 53, 3)[..., 0])).decode()
    with pytest.raises(cv2.error):
        jserver.decode_image_payload(lossless)
    with pytest.raises(ValueError, match="colour read of a one-component lossless JPEG"):
        server.decode_image_payload(lossless)
    # a partial script, once refused (Queue 1 item 13b): smoothed as cv2 smooths it
    first_scan = prog[:prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)] + b"\xff\xd9"
    payload = base64.b64encode(first_scan).decode()
    np.testing.assert_array_equal(server.decode_image_payload(payload),
                                  jserver.decode_image_payload(payload))
    ok, buf = cv2.imencode(".jpg", rgb)
    for cut in (len(buf) // 2, len(buf) - 40):
        with pytest.raises(ValueError):
            server.decode_image_payload(base64.b64encode(buf.tobytes()[:cut]).decode())
    png = encode_png(_image(8, 8, 2))
    with pytest.raises(ValueError):
        server.decode_image_payload(base64.b64encode(png[:60]).decode())
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        server.decode_image_payload(base64.b64encode(b"GIF89a....").decode())


# ---------------------------------------------------------------------------
# the engine's event stream
# ---------------------------------------------------------------------------

def _configs(pipeline):
    jcfg, cfg = jload_config("base"), load_config("base")
    for c in (jcfg, cfg):
        c["single_thread"] = True
        c["engine"]["keyframe_buffer"] = 32
        c["engine"]["edge_buffer"] = 32
        c["engine"]["pipeline"] = pipeline
    return jcfg, cfg


@pytest.fixture(scope="module", params=[0, 1], ids=["sequential", "pipeline1"])
def event_runs(request):
    n = 5
    gt = arc_trajectory(n, radius=0.6, max_angle=2.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    jcfg, cfg = _configs(request.param)
    jevents, tevents = [], []
    jslam = JSLAM(oracle, jcfg, HW)
    jslam.on_event = jevents.append
    jres = jslam.run(OracleDataset(n, HW), verbose=False)
    tslam = SLAM(TorchOracleModel(oracle), cfg, HW, device=CPU)
    tslam.on_event = tevents.append
    tres = tslam.run(OracleDataset(n, HW), verbose=False)
    tslam.close()
    return jevents, tevents, jres, tres, n


def _key(e):
    return (e["type"], e["frame_id"], e.get("keyframe_index"), e.get("mode"))


def test_event_sequences_are_the_jax_packages(event_runs):
    jevents, tevents, jres, tres, n = event_runs
    assert [_key(e) for e in tevents] == [_key(e) for e in jevents]
    assert sum(e["type"] == "pose_update" for e in tevents) == n
    assert sum(e["type"] == "new_keyframe" for e in tevents) == tres.n_keyframes >= 3


def test_pose_updates_within_tolerance(event_runs):
    jevents, tevents, *_ = event_runs
    for je, te in zip(jevents, tevents):
        np.testing.assert_allclose(te["pose"], je["pose"], rtol=0, atol=POSE_ATOL)
        if te["type"] == "pose_update":
            assert te["timestamp"] == je["timestamp"]


def test_keyframe_events_points_and_colours(event_runs):
    jevents, tevents, *_ = event_runs
    for je, te in zip(jevents, tevents):
        if te["type"] != "new_keyframe":
            continue
        jp, tp = np.asarray(je["points"]), np.asarray(te["points"])
        assert len(te["colors"]) == len(tp) > 100 and tp.shape[1] == 3
        # the same pixels pass the threshold up to those within CONF_BAND of
        # it (the oracle's confidences are far from 1 + 1e-6: none is near)
        assert len(tp) == len(jp), (len(tp), len(jp))
        dist = np.linalg.norm(jp, axis=1)
        err = np.abs(tp - jp).max(axis=1)
        assert (err <= POINT_ATOL + POSE_ATOL * dist).all(), err.max()
        assert err[dist < 5.0].max() <= POINT_ATOL
        np.testing.assert_array_equal(te["colors"], je["colors"])


def test_confidence_threshold_filters_the_points():
    """A RunControl threshold inside the confidences' range drops points as
    the JAX engine does; the counts differ only within CONF_BAND of it."""
    gt = arc_trajectory(3, radius=0.6, max_angle=2.5)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    jcfg, cfg = _configs(0)
    out = {}
    for name, slam in (("jax", JSLAM(oracle, jcfg, HW)),
                       ("port", SLAM(TorchOracleModel(oracle), cfg, HW, device=CPU))):
        events = []
        control = broadcast.RunControl()
        slam.on_event, slam.control = events.append, control
        slam.process_frame(0, "0", OracleModel.image_for_frame(0, HW))
        C = np.asarray(slam.keyframes.C[0]).reshape(-1) if name == "jax" else \
            slam.keyframes.C[0].reshape(-1).numpy()
        control.update({"conf_threshold": float(np.median(C))})
        slam._emit_keyframe(0, slam.keyframes.get_frame(0))
        kfs = [e for e in events if e["type"] == "new_keyframe"]
        out[name] = (len(kfs[0]["points"]), len(kfs[-1]["points"]), C, control.conf_threshold)
    (j_all, j_cut, jC, jt), (t_all, t_cut, tC, tt) = out["jax"], out["port"]
    assert t_all == j_all == HW[0] * HW[1]
    near = int(np.sum(np.abs(tC - tt) <= CONF_BAND))
    assert near <= 0.01 * HW[0] * HW[1]
    assert abs(t_cut - j_cut) <= near and t_cut < t_all


def test_a_failing_sink_does_not_stop_tracking(capsys):
    _, cfg = _configs(0)
    gt = arc_trajectory(4, radius=0.6, max_angle=2.5)
    slam = SLAM(TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002)), cfg, HW,
                device=CPU)

    def sink(event):
        raise RuntimeError("viewer gone")

    slam.on_event = sink
    res = slam.run(OracleDataset(4, HW), verbose=False)
    assert len(res.frame_timestamps) == 4
    assert "event sink failed" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# run control
# ---------------------------------------------------------------------------

def test_runcontrol_pause_step_terminate():
    c = broadcast.RunControl()
    assert c.proceed()
    c.update({"paused": True})
    done = []
    t = threading.Thread(target=lambda: done.append(c.proceed()))
    t.start()
    time.sleep(0.1)
    assert not done  # blocked while paused
    c.update({"step": True})  # one step releases one frame
    t.join(timeout=5)
    assert done == [True] and not t.is_alive()
    t2 = threading.Thread(target=lambda: done.append(c.proceed()))
    t2.start()
    time.sleep(0.1)
    assert len(done) == 1  # still paused after the step
    c.update({"terminate": True})
    t2.join(timeout=5)
    assert done == [True, False] and not t2.is_alive()
    c2 = broadcast.RunControl()
    c2.update({"conf_threshold": 3.25})
    assert c2.conf_threshold == 3.25


@pytest.mark.parametrize("pipeline", [0, 1])
def test_run_stops_on_terminate(pipeline):
    """A terminate mid-run ends it early with a result; the prefetcher is
    drained (no thread left behind)."""
    n = 30
    gt = arc_trajectory(n, radius=0.6, max_angle=2.5)
    _, cfg = _configs(pipeline)
    cfg["engine"]["keyframe_buffer"] = 64
    slam = SLAM(TorchOracleModel(OracleModel(PlaneScene(HW), gt, noise=0.002)), cfg, HW,
                device=CPU)
    control = broadcast.RunControl()
    slam.control = control
    real_log = slam._log

    def log_and_stop(ts, frame):
        real_log(ts, frame)
        if len(slam.frame_log) >= 5:
            control.update({"terminate": True})

    slam._log = log_and_stop
    before = threading.active_count()
    res = slam.run(OracleDataset(n, HW), verbose=False)
    assert 5 <= len(res.frame_timestamps) < n
    assert threading.active_count() == before


def test_broadcaster_replays_then_streams_and_takes_control():
    b = broadcast.EventBroadcaster(port=0).start()
    try:
        kf = {"type": "new_keyframe", "keyframe_index": 0, "frame_id": 0,
              "pose": [0.0] * 7 + [1.0], "points": [[0.0, 0.0, 1.0]], "colors": [[1, 2, 3]]}
        b.push(kf)  # before any viewer: history
        b.push({"type": "pose_update", "frame_id": 0, "pose": [0.0] * 8})  # not replayed

        async def viewer():
            async with ws.connect(f"ws://127.0.0.1:{b.bound_port}") as sock:
                assert json.loads(await asyncio.wait_for(sock.recv(), 60)) == kf
                b.push({"type": "pose_update", "frame_id": 1, "pose": [0.0] * 8})
                live = json.loads(await asyncio.wait_for(sock.recv(), 60))
                assert live["type"] == "pose_update" and live["frame_id"] == 1
                await sock.send(json.dumps({"type": "control", "paused": True,
                                            "conf_threshold": 2.5}))
                await sock.send("not json")  # ignored
                await sock.send(json.dumps({"type": "control", "paused": False,
                                            "step": True}))
                await asyncio.sleep(0.2)

        asyncio.run(viewer())
        deadline = time.time() + 10
        while time.time() < deadline and b.control.conf_threshold != 2.5:
            time.sleep(0.05)
        assert b.control.conf_threshold == 2.5 and b.control.paused is False
        assert b.control._steps == 1
    finally:
        b.stop()
    assert not b._thread.is_alive()


def test_a_push_during_the_replay_reaches_the_viewer():
    """A push from the engine's thread while a viewer's replay is read is
    neither lost nor sent twice: the port registers the viewer under the
    history's lock, so the push lands after the replay, live.  (The JAX
    broadcaster sends the history and then registers the viewer, and such
    a push is lost: ROADMAP Queue 3, the replay/live race, not carried
    over.)  The push is made to fall inside the replay by the history
    itself, which starts it on another thread when the handler reads it."""
    b = broadcast.EventBroadcaster(port=0).start()
    first = {"type": "new_keyframe", "keyframe_index": 0}
    during = {"type": "new_keyframe", "keyframe_index": 1}
    pushers = []

    class PushDuringReplay(list):
        def __iter__(self):
            if not pushers:
                pushers.append(threading.Thread(target=b.push, args=(during,)))
                pushers[0].start()
                time.sleep(0.3)  # the pusher waits for the history's lock, or is lost
            return super().__iter__()

    try:
        b.push(first)
        b._history = PushDuringReplay(b._history)

        async def viewer():
            async with ws.connect(f"ws://127.0.0.1:{b.bound_port}") as sock:
                got = [json.loads(await asyncio.wait_for(sock.recv(), 60)) for _ in range(2)]
                b.push({"type": "pose_update", "frame_id": 2})
                got.append(json.loads(await asyncio.wait_for(sock.recv(), 60)))
                return got

        got = asyncio.run(viewer())
        assert got == [first, during, {"type": "pose_update", "frame_id": 2}]
        assert [json.loads(p) for p in b._history] == [first, during]
    finally:
        for t in pushers:
            t.join(10)
        b.stop()


def test_broadcaster_history_limit_and_a_taken_port():
    b = broadcast.EventBroadcaster(port=0, history_limit=3).start()
    try:
        for k in range(5):
            b.push({"type": "new_keyframe", "keyframe_index": k})
        assert [json.loads(p)["keyframe_index"] for p in b._history] == [2, 3, 4]
        with pytest.raises(RuntimeError, match="failed to start"):
            broadcast.EventBroadcaster(port=b.bound_port).start()
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _oracle_factories(threaded=False):
    gt = arc_trajectory(N_FRAMES, radius=0.6, max_angle=2.0)
    oracle = OracleModel(PlaneScene(HW), gt, noise=0.002)
    jcfg, cfg = _configs(0)
    if threaded:
        cfg["single_thread"] = False
    return ((lambda raw_hw: JSLAM(oracle, jcfg, HW)),
            (lambda raw_hw: SLAM(TorchOracleModel(oracle), cfg, HW, device=CPU)))


def _frame_b64(i):
    rgb = (OracleModel.image_for_frame(i, HW) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(rgb)).decode()


def _http_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode())


async def _session(port, connect, frames):
    """GET /, /connect, the session's stream of frames, its events."""
    loop = asyncio.get_running_loop()
    base = f"http://127.0.0.1:{port}"
    assert "message" in await loop.run_in_executor(None, _http_json, base + "/")
    sid = (await loop.run_in_executor(None, _http_json, base + "/connect"))["sessionId"]
    async with connect(f"ws://127.0.0.1:{port}/ws/{sid}") as sock:
        ready = json.loads(await sock.recv())
        assert ready == {"type": "ready", "session_id": sid}
        for data in frames:
            await sock.send(json.dumps({"type": "frame", "data": data}))
        listing = await loop.run_in_executor(None, _http_json, base + "/active_sessions")
        assert [s["session_id"] for s in listing["sessions"]] == [sid]
        await sock.send(json.dumps({"type": "close"}))
        events = []
        while not events or events[-1]["type"] != "shutdown_complete":
            events.append(json.loads(await asyncio.wait_for(sock.recv(), 120)))
    return sid, events


def test_full_session_equals_the_jax_servers(tmp_path):
    jfactory, tfactory = _oracle_factories()
    frames = [_frame_b64(i) for i in range(N_FRAMES)]
    jsrv = jserver.SlamServer(jfactory, output_dir=tmp_path / "jax")
    tsrv = server.SlamServer(tfactory, host="127.0.0.1", port=0, output_dir=tmp_path / "port")

    async def both():
        async with ws_server.serve(jsrv.handle, "127.0.0.1", 0,
                                   process_request=jsrv.process_request) as js:
            jout = await _session(js.sockets[0].getsockname()[1], websockets.connect, frames)
        await tsrv.listen()
        try:
            tout = await _session(tsrv.bound_port, ws.connect, frames)
        finally:
            await tsrv.aclose()
        return jout, tout

    (jsid, jev), (tsid, tev) = asyncio.run(both())
    assert [e["type"] for e in tev] == [e["type"] for e in jev]
    assert tev[-1] == {**jev[-1]} and tev[-1]["n_frames"] == N_FRAMES
    assert sum(e["type"] == "pose_update" for e in tev) == N_FRAMES
    saved = {e["type"]: e["path"] for e in tev if e["type"].endswith("_saved")}
    assert saved == {"trajectory_saved": str(tmp_path / "port" / f"{tsid}.txt"),
                     "reconstruction_saved": str(tmp_path / "port" / f"{tsid}.ply")}
    t_p, p_p, q_p = load_traj_tum(tmp_path / "port" / f"{tsid}.txt")
    t_j, p_j, q_j = load_traj_tum(tmp_path / "jax" / f"{jsid}.txt")
    np.testing.assert_array_equal(t_p, t_j)
    np.testing.assert_allclose(p_p, p_j, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(q_p, q_j, rtol=0, atol=POSE_ATOL)
    pts_p, col_p = load_ply(tmp_path / "port" / f"{tsid}.ply")
    pts_j, col_j = load_ply(tmp_path / "jax" / f"{jsid}.ply")
    assert len(pts_p) == len(pts_j) > 0 and len(col_p) == len(pts_p)


def test_bad_frames_are_answered_and_dropped(tmp_path):
    _, tfactory = _oracle_factories()
    srv = server.SlamServer(tfactory, host="127.0.0.1", port=0)

    async def run():
        await srv.listen()
        try:
            async with ws.connect(f"ws://127.0.0.1:{srv.bound_port}/ws") as sock:
                assert json.loads(await sock.recv())["type"] == "ready"
                await sock.send(json.dumps({"type": "frame", "data": "bm90IGFuIGltYWdl"}))
                err = json.loads(await sock.recv())
                await sock.send("{not json")
                err2 = json.loads(await sock.recv())
                await sock.send(json.dumps({"type": "frame", "data": _frame_b64(0)}))
                await sock.send(json.dumps({"type": "close"}))
                events = []
                while not events or events[-1]["type"] != "shutdown_complete":
                    events.append(json.loads(await asyncio.wait_for(sock.recv(), 60)))
            return err, err2, events
        finally:
            await srv.aclose()

    err, err2, events = asyncio.run(run())
    assert err["type"] == err2["type"] == "error" and "frame dropped" in err["message"]
    assert events[-1]["n_frames"] == 1


def test_http_front_answers_and_refuses():
    srv = server.SlamServer(lambda hw: None, host="127.0.0.1", port=0)

    async def run():
        await srv.listen()
        loop = asyncio.get_running_loop()
        base = f"http://127.0.0.1:{srv.bound_port}"
        try:
            root = await loop.run_in_executor(None, _http_json, base + "/")
            listing = await loop.run_in_executor(None, _http_json, base + "/active_sessions")
            codes = []
            for path in ("/nowhere", "/ws/abc"):  # 404; /ws without an upgrade: 426
                try:
                    await loop.run_in_executor(None, _http_json, base + path)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
            return root, listing, codes
        finally:
            await srv.aclose()

    root, listing, codes = asyncio.run(run())
    assert root == {"message": "mast3r-slam-tpu-torch serving"}
    assert listing == {"active_sessions_count": 0, "sessions": []}
    assert codes == [404, 426]


def test_reap_idle_sessions():
    _, tfactory = _oracle_factories()
    srv = server.SlamServer(tfactory, idle_timeout=5.0)
    s = server.SlamSession(srv.slam_factory)
    srv.sessions[s.session_id] = s
    s.start()
    s.last_activity = time.time() - 60.0
    assert srv.reap_idle_sessions() == [s.session_id]
    assert s.session_id not in srv.sessions and srv.reaped == [(s.session_id, False)]
    assert not s.thread.is_alive() and not s.wedged


def test_a_wedged_session_is_abandoned_and_marked():
    release = threading.Event()

    def stuck_factory(raw_hw):
        release.wait(30)
        raise RuntimeError("never built")

    s = server.SlamSession(stuck_factory)
    s.start()
    s.submit_frame(np.zeros((4, 4, 3), np.float32))
    time.sleep(0.1)
    assert s.terminate(timeout=0.2) is False
    assert s.wedged and not s.running
    release.set()
    s.thread.join(10)
    assert not s.thread.is_alive()


class _GatedEngine:
    """A stand-in engine whose ``process_frame`` waits for ``gate``: the
    session's engine thread blocks inside a frame while frames queue up."""

    def __init__(self, gate):
        self.gate = gate
        self.done = []
        self.on_event = None
        self.keyframes = []
        self.backend_errors = []
        self.graph = type("Graph", (), {"resolve_pending_verdicts": lambda self: None})()

    def process_frame(self, fid, ts, rgb, last_T_WC=None):
        self.gate.wait(30)
        self.done.append(fid)
        return type("Frame", (), {"T_WC": None})()

    def join_backend(self):
        pass

    def close(self):
        pass


def _full_session(max_queue=8):
    """A session whose engine is blocked inside frame 0 with ``max_queue``
    frames queued behind it."""
    gate = threading.Event()
    engines = []
    s = server.SlamSession(lambda hw: engines.append(_GatedEngine(gate)) or engines[-1],
                           max_queue=max_queue)
    s.start()
    s.submit_frame(np.zeros((4, 4, 3), np.float32))
    deadline = time.time() + 10
    while not engines and time.time() < deadline:  # the engine took frame 0
        time.sleep(0.01)
    for _ in range(max_queue):
        s.submit_frame(np.zeros((4, 4, 3), np.float32))
    assert engines and s.frame_q.full() and s.frame_q.qsize() == max_queue
    return s, gate, engines[0]


def test_close_and_terminate_return_with_a_blocked_engine_and_a_full_queue():
    """ROADMAP Queue 3 item 14, not carried over from the JAX session (whose
    ``close`` is a blocking put): with the engine blocked in a frame and 8
    frames queued, ``close()`` returns at once, ``terminate(timeout)``
    returns False within its timeout and marks the session wedged, and the
    reaper's pass over it completes, and so does the next."""
    s, gate, engine = _full_session()
    t0 = time.perf_counter()
    s.close()
    assert time.perf_counter() - t0 < 1.0
    t0 = time.perf_counter()
    assert s.terminate(timeout=0.5) is False
    assert time.perf_counter() - t0 < 0.5 + 1.0
    assert s.wedged and not s.running
    events = []
    while True:
        events.append(s.event_q.get(timeout=1))
        if events[-1] is None:
            break
    assert events[-2]["type"] == "error" and "wedged" in events[-2]["message"]

    srv = server.SlamServer(lambda hw: None, idle_timeout=5.0)
    r, rgate, _ = _full_session()
    srv.sessions[r.session_id] = r
    r.last_activity = time.time() - 60.0
    t0 = time.perf_counter()
    assert srv.reap_idle_sessions() == [r.session_id]  # terminate's own 10 s bound
    assert time.perf_counter() - t0 < 10.0 + 1.0
    assert srv.reaped == [(r.session_id, True)] and not srv.sessions
    assert srv.reap_idle_sessions() == []
    for g, sess in ((gate, s), (rgate, r)):  # released, the engines skip the queued frames
        g.set()
        sess.thread.join(10)
        assert not sess.thread.is_alive()
    assert engine.done == [0]


def test_an_ordinary_close_finishes_the_queued_frames():
    """``close`` with a full queue behind a busy engine: every queued frame
    is still processed, in order, before ``shutdown_complete``."""
    s, gate, engine = _full_session()
    s.close()
    gate.set()
    s.thread.join(10)
    assert not s.thread.is_alive() and not s.wedged
    assert engine.done == list(range(9))
    events = []
    while not events or events[-1] is not None:
        events.append(s.event_q.get(timeout=1))
    assert events[-2] == {"type": "shutdown_complete", "n_keyframes": 0, "n_frames": 9}


def test_close_wakes_an_idle_engine():
    """``close`` on an empty queue: the engine waiting for a frame ends the
    session at once."""
    gate = threading.Event()
    gate.set()
    s = server.SlamSession(lambda hw: _GatedEngine(gate))
    s.start()
    s.submit_frame(np.zeros((4, 4, 3), np.float32))
    while s.slam is None or s.frame_q.qsize():
        time.sleep(0.01)
    s.close()
    s.thread.join(5)
    assert not s.thread.is_alive() and s.slam.done == [0]


def test_connect_ids_are_unique():
    srv = server.SlamServer(lambda hw: None)
    a = srv.connect_info()["sessionId"]
    b = srv.connect_info()["sessionId"]
    assert a != b and {a, b} <= srv.pending_ids


def test_a_full_queue_drops_the_oldest_frame():
    s = server.SlamSession(lambda hw: None, max_queue=2)
    for i in range(4):
        s.submit_frame(np.full((2, 2, 3), i, np.float32))
    ids = [s.frame_q.get_nowait()[0] for _ in range(2)]
    assert ids == [2, 3] and s._frame_counter == 4


def test_the_session_exports_after_its_backend_drains(tmp_path):
    """The kept divergence: under a threaded backend (``single_thread:
    False``, the base default) the port's session waits for every queued
    backend task before it exports, then stops the worker thread."""
    _, tfactory = _oracle_factories(threaded=True)
    seen = {}

    def slow_factory(raw_hw):
        slam = tfactory(raw_hw)
        real = slam._backend_update_impl

        def slow(kf_idx, capture=None):
            time.sleep(0.1)
            real(kf_idx, capture)
            seen.setdefault("done", []).append(kf_idx)

        slam._backend_update_impl = slow
        return slam

    s = server.SlamSession(slow_factory, output_dir=tmp_path)
    real_export = s._export

    def export(slam):
        seen["at_export"] = (slam._tasks.unfinished_tasks, list(seen.get("done", [])),
                             len(slam.keyframes))
        real_export(slam)

    s._export = export
    s.start()
    for i in range(N_FRAMES):
        s.submit_frame(OracleModel.image_for_frame(i, HW))
    s.close()
    s.thread.join(120)
    assert not s.thread.is_alive()
    pending, done, n_kf = seen["at_export"]
    assert pending == 0 and n_kf >= 2 and len(done) == n_kf - 1
    assert s.slam._worker is None  # closed after the export
    events = []
    while not s.event_q.empty():
        events.append(s.event_q.get())
    assert [e["type"] for e in events[-4:-1]] == ["trajectory_saved", "reconstruction_saved",
                                                   "shutdown_complete"]


def test_default_factory_sizes_the_engine_from_the_first_frame(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.default_slam_factory()
    cfg = load_config("base")
    cfg["single_thread"] = True
    cfg["engine"]["resize"] = 64
    make = server.default_slam_factory(cfg=cfg, preset="tiny", device=CPU)
    slam = make((480, 640))
    try:
        assert slam.img_hw == (48, 64) and slam.device.type == "cpu"
    finally:
        slam.close()
