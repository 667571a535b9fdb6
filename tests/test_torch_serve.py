"""Port serving layer against the JAX serving layer, on the CPU.

The six endpoints of ``causalvae_tpu_torch.serve.endpoints.vae_endpoints``
are held to ``causalvae_tpu.serve.endpoints.vae_endpoints`` on the same small
CausalViTVAE (same weights via ``from_jax_variables``, same numpy inputs),
max|Δ| <= 1e-4 * max|ref| + 1e-5. Then the engine (coalescing, padding,
stats, inference mode in its worker), the HTTP front end, and the CLI smoke.
"""

import threading

import numpy as np
import pytest
import torch

from causalvae_tpu.serve.endpoints import vae_endpoints as jax_endpoints

from causalvae_tpu_torch.serve import http as H
from causalvae_tpu_torch.serve.endpoints import BoundEndpoint, endpoint_arg_specs, vae_endpoints
from causalvae_tpu_torch.serve.engine import BatchingEngine

from torch_port_helpers import SMALL, close, inputs, small_causal_pair


@pytest.fixture(scope="module")
def served():
    jm, v, pm = small_causal_pair(seed=0)
    return jax_endpoints(jm, v), vae_endpoints(pm), pm


def _args(name, b=2):
    x, m, t = inputs(b, seed=6)
    z = np.random.default_rng(8).standard_normal((b, SMALL["z_dim"])).astype(np.float32)
    return {"encode": (x, m, t), "decode": (m, z), "predict_m": (t,),
            "reconstruct": (x, m, t), "do_t": (x, m, t), "uncertainty": (t,)}[name]


@pytest.mark.parametrize("name", ["encode", "decode", "predict_m", "reconstruct",
                                  "do_t", "uncertainty"])
def test_endpoint_matches_jax(served, name):
    jeps, peps, _ = served
    args = _args(name)
    want = jeps[name](*args)
    with torch.inference_mode():
        got = peps[name](*(torch.from_numpy(a) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


def test_endpoint_set_and_specs(served):
    _, peps, pm = served
    assert sorted(peps) == ["decode", "do_t", "encode", "predict_m",
                            "reconstruct", "uncertainty"]
    assert all(isinstance(ep, BoundEndpoint) and ep.model is pm for ep in peps.values())
    specs = endpoint_arg_specs(pm)
    assert specs["encode"] == ((64, 96, 1), (12,), (19,))
    assert specs["decode"] == ((12,), (SMALL["z_dim"],))


def test_do_t_shape(served):
    _, peps, _ = served
    with torch.inference_mode():
        grid = peps["do_t"](*(torch.from_numpy(a) for a in _args("do_t", b=3)))
    assert grid.shape == (3, 19, 64, 96, 1)
    assert torch.isfinite(grid).all()


def test_engine_batches_and_pads(served):
    _, peps, _ = served
    x, m, t = inputs(3, seed=10)
    with torch.inference_mode():
        want = peps["reconstruct"](*(torch.from_numpy(a) for a in (x, m, t))).numpy()
    with BatchingEngine(peps, buckets=(1, 4)) as eng:
        got = eng.infer("reconstruct", x, m, t)
        assert eng.stats == {"launches": 1, "rows": 3, "padded_rows": 1}
    assert isinstance(got, np.ndarray)
    close(got, want)


def test_engine_oversized_request_is_chunked(served):
    _, peps, _ = served
    _, _, t = inputs(5, seed=11)
    with BatchingEngine(peps, buckets=(2,)) as eng:  # chunks 2 + 2 + (1 -> 2)
        mu, sigma = eng.infer("uncertainty", t)
        assert eng.stats == {"launches": 3, "rows": 5, "padded_rows": 1}
    with torch.inference_mode():
        wmu, wsig = peps["uncertainty"](torch.from_numpy(t))
    close(mu, wmu)
    close(sigma, wsig)


def test_engine_coalesces_concurrent_submits(served):
    """Single-row requests from many threads land in few padded launches,
    each caller gets its own row back, and the stats add up."""
    _, peps, _ = served
    _, _, t = inputs(12, seed=12)
    with torch.inference_mode():
        want = peps["predict_m"](torch.from_numpy(t)).numpy()
    results = [None] * 12
    with BatchingEngine(peps, buckets=(1, 2, 4, 8), max_delay_s=0.05) as eng:
        barrier = threading.Barrier(12)

        def client(i):
            barrier.wait()
            results[i] = eng.infer("predict_m", t[i:i + 1])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = dict(eng.stats)
    assert stats["rows"] == 12
    assert stats["launches"] < 12  # coalesced
    assert stats["padded_rows"] >= 0
    for i in range(12):
        close(results[i], want[i:i + 1])


def test_engine_mixed_endpoints_stash_and_serve(served):
    _, peps, _ = served
    x, m, t = inputs(4, seed=13)
    with BatchingEngine(peps, buckets=(1, 2, 4), max_delay_s=0.05) as eng:
        futs = []
        for i in range(4):
            futs.append(("predict_m", i, eng.submit("predict_m", t[i:i + 1])))
            futs.append(("encode", i, eng.submit("encode", x[i:i + 1], m[i:i + 1], t[i:i + 1])))
        outs = [(n, i, f.result(timeout=120)) for n, i, f in futs]
        assert eng.stats["rows"] == 8
    with torch.inference_mode():
        want_m = peps["predict_m"](torch.from_numpy(t)).numpy()
        want_mu, _ = peps["encode"](*(torch.from_numpy(a) for a in (x, m, t)))
    for name, i, out in outs:
        if name == "predict_m":
            close(out, want_m[i:i + 1])
        else:
            close(out[0], want_mu[i:i + 1].numpy())


def test_engine_worker_runs_in_inference_mode(served):
    """torch.inference_mode() is thread-local: the engine enters it in its
    own worker thread, so endpoints run without autograd there."""
    _, _, pm = served
    seen = {}

    def probe(mdl, t):
        seen["inference"] = torch.is_inference_mode_enabled()
        out = mdl.predict_m(t)
        seen["requires_grad"] = out.requires_grad
        return out

    assert not torch.is_inference_mode_enabled()
    with BatchingEngine({"probe": BoundEndpoint(probe, pm)}, buckets=(1,)) as eng:
        eng.infer("probe", np.eye(19, dtype=np.float32)[:1])
    assert seen == {"inference": True, "requires_grad": False}


def test_engine_errors_reach_the_caller(served):
    _, peps, _ = served
    with BatchingEngine(peps, buckets=(1,)) as eng:
        with pytest.raises(KeyError):
            eng.submit("nope", np.zeros((1, 19), np.float32))
        with pytest.raises(RuntimeError):  # wrong width fails in the model
            eng.infer("predict_m", np.zeros((1, 5), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("predict_m", np.zeros((1, 19), np.float32))


def test_http_roundtrip_on_ephemeral_port(served):
    import http.client
    import json

    _, peps, _ = served
    x, m, t = inputs(2, seed=14)
    with torch.inference_mode():
        want = peps["reconstruct"](*(torch.from_numpy(a) for a in (x, m, t))).numpy()
        want_u = peps["uncertainty"](torch.from_numpy(t))
    eng = BatchingEngine(peps, buckets=(1, 2))
    srv = H.serve(eng, port=0, background=True)
    port = srv.server_address[1]
    try:
        (rec,) = H.request_npz("127.0.0.1", port, "reconstruct", [x, m, t])
        close(rec, want)
        mu, sigma = H.request_npz("127.0.0.1", port, "uncertainty", [t])
        close(mu, want_u[0])
        close(sigma, want_u[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/v1/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["status"] == "ok" and "do_t" in health["endpoints"]
        with pytest.raises(RuntimeError, match="HTTP 404"):
            H.request_npz("127.0.0.1", port, "nope", [t])
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def test_cli_serve_vessel_smoke(capsys):
    from causalvae_tpu_torch.cli.main import main

    main(["serve", "vessel", "--smoke", "--device", "cpu", "--img-hw", "64", "96",
          "--buckets", "1", "4"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    import json

    res = json.loads(line)
    assert res["smoke"] == "ok"
    assert res["predict_m_shape"] == [3, 12]
    assert res["reconstruct_shape"] == [1, 64, 96, 1]
    assert res["engine_stats"]["rows"] == 4
