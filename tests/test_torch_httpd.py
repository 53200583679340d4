"""The port's HTTP daemon (``lerf_torch.serve.httpd``) and ``cli.serve``:
the counterparts of ``tests/test_httpd.py``, plus the port's daemon
against lerf_tpu's on the same requests.

npy in → npy out must equal the port's in-process predictor exactly;
concurrent clients must each get their own frame; the error codes (400,
404, 413, 500 on a live keep-alive connection) are lerf_tpu's.  Against
lerf_tpu's daemon (flat table layout) on the same npy request: the mask
exactly and the uint8 frame but for .5 rounding ties of the port's
float32 twin.  Torch runs on one thread.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_async import sr_twin
from test_torch_warp import count_ties
from test_torch_warp_serving import (IN_SZ, OUT_SZ, lut_pair, net_pair,
                                     plain_frame)

from lerf_tpu.serve import make_server as jax_make_server

from lerf_torch.convert import bank_from_arrays
from lerf_torch.lut.io import save_lut_bank
from lerf_torch.serve import make_server

MAT = np.array([[1.1, 0.02, 3.0], [0.01, 0.95, -2.0], [1e-4, 2e-5, 1.0]])
MAT_Q = ",".join(repr(float(v)) for v in MAT.ravel())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for this module (the CPU twins' many small ops
    stall under the test workers' load otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def start(pred, **kwargs):
    server = make_server(pred, port=0, **kwargs)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def served():
    pred = lut_pair()[1]
    server, base = start(pred)
    yield pred, base
    server.shutdown()


def _post(url, body, ctype="application/x-npy"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=600)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post_npy(url, img):
    resp = _post(url, _npy(img))
    return resp, np.load(io.BytesIO(resp.read()), allow_pickle=False)


def image(seed, shape=IN_SZ):
    return np.random.RandomState(seed).randint(0, 256, shape + (3,),
                                               dtype=np.uint8)


def test_healthz(served):
    _, base = served
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        info = json.loads(resp.read())
    assert info["ok"] and info["form"] == "LutPredictor"
    assert info["backend"] == "cpu"
    with urllib.request.urlopen(base + "/", timeout=60) as resp:
        assert b"/v1/upscale" in resp.read()


def test_upscale_npy_bit_exact(served):
    pred, base = served
    img = image(21)
    resp, got = _post_npy(base + "/v1/upscale?scale=1.5x2.0", img)
    assert resp.headers["Content-Type"] == "application/x-npy"
    np.testing.assert_array_equal(got, pred.upscale_dynamic(img, 1.5, 2.0))


def test_upscale_downscale_aa(served):
    pred, base = served
    img = image(22)
    _, got = _post_npy(base + "/v1/upscale?scale=0.5", img)
    np.testing.assert_array_equal(got, pred.upscale_dynamic(img, 0.5, 0.5))


def test_upscale_png_round_trip(served):
    from PIL import Image

    pred, base = served
    img = image(22)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    resp = _post(base + "/v1/upscale?scale=1.5x2.0", buf.getvalue(),
                 ctype="image/png")
    assert resp.headers["Content-Type"] == "image/png"
    got = np.array(Image.open(io.BytesIO(resp.read())).convert("RGB"))
    np.testing.assert_array_equal(got, pred.upscale_dynamic(img, 1.5, 2.0))


def test_warp_npz_bit_exact(served):
    pred, base = served
    img = image(23)
    resp = _post(f"{base}/v1/warp?matrix={MAT_Q}"
                 f"&outSize={OUT_SZ[0]}x{OUT_SZ[1]}&format=npz", _npy(img))
    pack = np.load(io.BytesIO(resp.read()), allow_pickle=False)
    want_out, want_mask = pred.warp_dynamic(img, MAT, OUT_SZ)
    np.testing.assert_array_equal(pack["out"], want_out)
    np.testing.assert_array_equal(pack["mask"], want_mask)


def test_warp_npy_masked_with_coverage_header(served):
    pred, base = served
    img = image(24)
    resp, got = _post_npy(
        f"{base}/v1/warp?matrix={MAT_Q}&outSize={OUT_SZ[0]}x{OUT_SZ[1]}",
        img)
    want_out, mask = pred.warp_dynamic(img, MAT, OUT_SZ)
    np.testing.assert_array_equal(
        got, want_out * mask.astype(want_out.dtype)[..., None])
    assert abs(float(resp.headers["X-Lerf-Mask-Coverage"])
               - mask.mean()) < 1e-5


def test_concurrent_clients_get_their_own_frames(served):
    pred, base = served
    imgs = [image(25 + i) for i in range(4)]
    want = [pred.upscale_dynamic(im, 1.5, 2.0) for im in imgs]
    got = [None] * len(imgs)

    def worker(i):
        _, got[i] = _post_npy(base + "/v1/upscale?scale=1.5x2.0", imgs[i])

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(len(imgs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_healthz_latency_stats_accumulate(served):
    """After requests were served (the tests above, in file order),
    /healthz reports the latency percentiles of each request part."""
    _, base = served
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        info = json.loads(resp.read())
    assert info["served"] >= 1
    assert info["total"]["n"] >= 1
    assert info["total"]["p50_ms"] >= info["dispatch"]["p50_ms"] >= 0
    assert info["total"]["p99_ms"] >= info["total"]["p50_ms"]
    assert info["decode"]["n"] >= 1 and info["encode"]["n"] >= 1


def test_max_inflight_one_still_correct_under_concurrency():
    pred = lut_pair()[1]
    server, base = start(pred, max_inflight=1)
    imgs = [image(30 + i) for i in range(3)]
    want = [pred.upscale_dynamic(im, 1.5, 2.0) for im in imgs]
    got = [None] * len(imgs)

    def worker(i):
        _, got[i] = _post_npy(base + "/v1/upscale?scale=1.5x2.0", imgs[i])

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(len(imgs))]
    try:
        for th in ts:
            th.start()
        for th in ts:
            th.join()
    finally:
        server.shutdown()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_net_form_daemon_bit_exact():
    pred = net_pair()[1]
    server, base = start(pred)
    img = image(31)
    try:
        _, got = _post_npy(base + "/v1/upscale?scale=1.5x2.0", img)
    finally:
        server.shutdown()
    np.testing.assert_array_equal(got, pred.upscale_dynamic(img, 1.5, 2.0))


def test_bad_requests_return_400(served):
    _, base = served
    body = _npy(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/warp?matrix=1,2,3&outSize=8x8", body)
    assert ei.value.code == 400
    eye = ",".join(str(v) for v in np.eye(3).ravel())
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{base}/v1/warp?matrix={eye}", body)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/upscale?scale=2",
              _npy(np.zeros((8, 8), np.float32)))
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/nope", body)
    assert ei.value.code == 404


def test_malformed_bodies_return_400(served):
    pred, base = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/upscale?scale=2", b"\x89PNG but not really",
              ctype="image/png")
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/upscale?scale=2", b"\x93NUMPY garbage here")
    assert ei.value.code == 400
    img = image(40)
    _, got = _post_npy(base + "/v1/upscale?scale=1.5x2.0", img)
    np.testing.assert_array_equal(got, pred.upscale_dynamic(img, 1.5, 2.0))


def test_oversized_body_413():
    pred = lut_pair()[1]
    server, base = start(pred, max_body_bytes=1024)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/upscale?scale=2",
                  _npy(np.zeros((64, 64, 3), np.uint8)))
        assert ei.value.code == 413
        assert "limit" in json.loads(ei.value.read())["error"]
        small = image(41, (8, 8))
        _, got = _post_npy(base + "/v1/upscale?scale=2", small)
        np.testing.assert_array_equal(got, pred.upscale_dynamic(small, 2, 2))
    finally:
        server.shutdown()


def test_unexpected_error_500_keepalive_survives():
    import http.client

    class Boom:
        """Delegates to a real predictor, fails on scale_h == 7."""

        def __init__(self, inner):
            self._inner = inner

        def upscale_dynamic_async(self, img, sh, sw, granularity=0):
            if sh == 7:
                raise RuntimeError("synthetic device fault")
            return self._inner.upscale_dynamic_async(
                img, sh, sw, granularity=granularity)

    inner = lut_pair()[1]
    server, _ = start(Boom(inner))
    img = image(42, (8, 8))
    conn = http.client.HTTPConnection(
        "127.0.0.1", server.server_address[1], timeout=600)
    try:
        conn.request("POST", "/v1/upscale?scale=7", _npy(img),
                     {"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        assert resp.status == 500
        assert "RuntimeError" in json.loads(resp.read())["error"]
        conn.request("POST", "/v1/upscale?scale=2", _npy(img),
                     {"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = np.load(io.BytesIO(resp.read()), allow_pickle=False)
        np.testing.assert_array_equal(got, inner.upscale_dynamic(img, 2, 2))
    finally:
        conn.close()
        server.shutdown()


def test_upscale_batch_npy_bit_exact(served):
    pred, base = served
    imgs = np.stack([image(50 + b, (12, 15)) for b in range(3)])
    resp = _post(base + "/v1/upscale_batch?scale=2", _npy(imgs))
    got = np.load(io.BytesIO(resp.read()), allow_pickle=False)
    np.testing.assert_array_equal(got, pred.upscale_batch(imgs, 2, 2))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/upscale_batch?scale=2", _npy(imgs[0]))
    assert ei.value.code == 400


def test_warp_batch_npz_bit_exact(served):
    pred, base = served
    imgs = np.stack([image(51 + b) for b in range(2)])
    mats = np.stack([MAT, MAT + np.diag([0.05, -0.03, 0.0])])
    buf = io.BytesIO()
    np.savez(buf, imgs=imgs, matrices=mats)
    resp = _post(base + "/v1/warp_batch?outSize=20x26", buf.getvalue(),
                 ctype="application/x-npz")
    with np.load(io.BytesIO(resp.read()), allow_pickle=False) as pack:
        got_out, got_mask = pack["out"], pack["mask"]
    want_out, want_mask = pred.warp_batch(imgs, mats, (20, 26))
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_mask, want_mask)


def test_warp_batch_matrices_mismatch_400(served):
    _, base = served
    buf = io.BytesIO()
    np.savez(buf, imgs=np.zeros((2, 8, 10, 3), np.uint8),
             matrices=np.stack([np.eye(3)] * 5))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/warp_batch?outSize=8x10", buf.getvalue(),
              ctype="application/x-npz")
    assert ei.value.code == 400
    assert "matrices" in json.loads(ei.value.read())["error"]


def test_batch_wrong_container_types_400(served):
    _, base = served
    imgs = np.zeros((2, 8, 10, 3), np.uint8)
    npz = io.BytesIO()
    np.savez(npz, imgs=imgs, matrices=np.eye(3))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/upscale_batch?scale=2", npz.getvalue())
    assert ei.value.code == 400
    assert "npy" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/warp_batch?outSize=8x10", _npy(imgs),
              ctype="application/x-npz")
    assert ei.value.code == 400
    assert "npz" in json.loads(ei.value.read())["error"]


def test_serve_cli_builds_daemon(tmp_path):
    """``cli.serve`` wires config → predictor → server without serving
    forever; ``--platform cpu`` puts the predictor on the CPU."""
    from lerf_torch.cli import serve as serve_cli

    b = lut_pair()[0].bank
    exp = tmp_path / "exp"
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(exp), lut_name="LUTft")
    server = serve_cli.main(["-e", str(exp), "--port", "0", "--bucket",
                             "16", "--geometry", "device", "--platform",
                             "cpu"], serve_forever=False)
    state = server.lerf_state
    assert state.granularity == 16 and state.geometry == "device"
    assert state.pred.device.type == "cpu"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["granularity"] == 16
        img = image(60)
        _, got = _post_npy(base + "/v1/upscale?scale=2", img)
        np.testing.assert_array_equal(got, lut_pair()[1].upscale(img, 2, 2))
    finally:
        server.shutdown()


def test_bad_geometry_rejected_at_startup():
    with pytest.raises(ValueError, match="geometry"):
        make_server(lut_pair()[1], port=0, geometry="devcie")


def test_warp_device_geometry_daemon():
    pred = lut_pair()[1]
    server, base = start(pred, geometry="device")
    img = image(33)
    try:
        resp = _post(f"{base}/v1/warp?matrix={MAT_Q}&outSize=20x26"
                     f"&format=npz", _npy(img))
        with np.load(io.BytesIO(resp.read()), allow_pickle=False) as z:
            got_out, got_mask = z["out"], z["mask"]
    finally:
        server.shutdown()
    want_out, want_mask = pred.warp_device(img, MAT, (20, 26))
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_mask, want_mask)


def test_npy_responses_equal_lerf_tpu_daemon():
    """The same npy requests to both daemons: upscale and warp (npz) equal
    but for .5 ties of the port's float32 twin, the mask exactly."""
    jax_pred, port = lut_pair()
    ours, base = start(port)
    theirs = jax_make_server(jax_pred, port=0)
    threading.Thread(target=theirs.serve_forever, daemon=True).start()
    jbase = f"http://127.0.0.1:{theirs.server_address[1]}"
    img = image(70)
    try:
        url = "/v1/upscale?scale=1.5x2.0"
        _, got = _post_npy(base + url, img)
        _, want = _post_npy(jbase + url, img)
        out, feat, hyper = port.upscale(img, 1.5, 2.0, return_aux=True)
        np.testing.assert_array_equal(got, out)
        count_ties(got, want, sr_twin(feat, hyper, (1.5, 2.0), False))
        url = (f"/v1/warp?matrix={MAT_Q}&outSize={OUT_SZ[0]}x{OUT_SZ[1]}"
               "&format=npz")
        packs = [np.load(io.BytesIO(_post(b + url, _npy(img)).read()),
                         allow_pickle=False) for b in (base, jbase)]
        np.testing.assert_array_equal(packs[0]["mask"], packs[1]["mask"])
        _, _, feat, hyper = port.warp(img, MAT, OUT_SZ, return_aux=True)
        count_ties(packs[0]["out"], packs[1]["out"],
                   plain_frame(feat, hyper, MAT, False))
    finally:
        ours.shutdown()
        theirs.shutdown()
