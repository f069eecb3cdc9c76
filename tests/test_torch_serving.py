"""The port's micro-batching pricing service held against ``pde_tpu``.

The same requests go through both packages in float64 (the JAX side under
``jax_enable_x64``).  Gates: prices, deltas and vegas at 1e-10 absolute
(the same corrected Gauss-Legendre rule; reverse-mode against JAX's
``value_and_grad``).  The batching properties of the reference's tests
hold on the port: padding is inert, concurrent callers are coalesced, one
bad request fails its caller and not the dispatch thread.  Greeks are
reverse mode, so they stay right on the server's thread while another
thread runs ``jacfwd``, whose levels are per process.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from pde_tpu import serving as jsv
from pde_tpu_torch import serving as tsv
from pde_tpu_torch.calibrate.sabr import SABRCalibrator
from pde_tpu_torch.models import heston, sabr

CPU = dict(device="cpu", dtype=torch.float64)
GATE = dict(rtol=0.0, atol=1e-10)
PARAMS = (2.0, 0.04, 0.3, -0.7, 0.04)


def _requests(n=5, greeks=False):
    return [tsv.PricingRequest(strike=90.0 + 4 * i, maturity=0.5 + 0.1 * i, spot=100.0,
                               params=PARAMS, rate=0.05, dividend=0.02,
                               is_call=(i % 2 == 0), want_greeks=greeks)
            for i in range(n)]


def _seeded_requests(n, seed):
    """Requests each under its own Heston vector, calls and puts, Greeks on
    every third."""
    rng = np.random.default_rng(seed)
    return [tsv.PricingRequest(
        strike=float(rng.uniform(70.0, 130.0)), maturity=float(rng.uniform(0.05, 2.0)),
        spot=float(rng.uniform(90.0, 110.0)),
        params=(float(rng.uniform(1.0, 3.0)), float(rng.uniform(0.02, 0.08)),
                float(rng.uniform(0.2, 0.6)), float(rng.uniform(-0.8, -0.2)),
                float(rng.uniform(0.02, 0.08))),
        rate=float(rng.uniform(0.0, 0.06)), dividend=float(rng.uniform(0.0, 0.03)),
        is_call=bool(i % 2), want_greeks=(i % 3 == 0)) for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    """One reference pricer per bucket set, compiled once for the module."""
    return {8: jsv.BatchPricer(buckets=(8,)), 70: jsv.BatchPricer(buckets=(70,))}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.price, w.price, **GATE)
        assert (g.delta is None) == (w.delta is None) and (g.vega is None) == (w.vega is None)
        if w.delta is not None:
            np.testing.assert_allclose(g.delta, w.delta, **GATE)
            np.testing.assert_allclose(g.vega, w.vega, **GATE)


def _to_jax(reqs):
    return [jsv.PricingRequest(**dataclasses.asdict(r)) for r in reqs]


@pytest.mark.parametrize("n, bucket", [(5, 8), (8, 8), (70, 70)])
def test_batch_matches_the_reference(reference, n, bucket):
    """Bucket 8, full and padded, and a custom bucket of exactly 70
    requests: the pricer's (n_points + 6) = 70 nodes, where (B,)-shaped
    parameter fields would broadcast along the nodes and misprice without
    an error."""
    reqs = _seeded_requests(n, seed=n)
    got = tsv.BatchPricer(buckets=(bucket,), **CPU).price(reqs)
    _same(got, reference[bucket].price(_to_jax(reqs)))


def test_parity_with_direct_pricer_and_inert_padding():
    pricer = tsv.BatchPricer(buckets=(8, 32), **CPU)
    reqs = _requests(5)
    res = pricer.price(reqs)
    p = heston.HestonParams(*PARAMS)
    for r, out in zip(reqs, res):
        direct = float(heston.price_carr_madan_gl(
            p, torch.tensor(r.strike, dtype=torch.float64), r.maturity, r.spot, r.rate,
            r.dividend, r.is_call))
        assert out.price == pytest.approx(direct, abs=1e-12)
        assert out.delta is None


def test_bucket_choice_does_not_change_prices():
    pricer = tsv.BatchPricer(buckets=(8, 32), **CPU)
    reqs = _requests(20)
    assert pricer.price([reqs[0]])[0].price == pytest.approx(pricer.price(reqs)[0].price,
                                                             abs=1e-12)


def test_greeks_match_finite_differences():
    pricer = tsv.BatchPricer(buckets=(8,), **CPU)
    req = _requests(1, greeks=True)[0]
    out = pricer.price([req])[0]
    p = heston.HestonParams(*PARAMS)

    def price_at(spot, v0=PARAMS[4]):
        return float(heston.price_carr_madan_gl(
            p._replace(v0=v0), torch.tensor(req.strike, dtype=torch.float64), req.maturity,
            spot, req.rate, req.dividend, req.is_call))

    eps = 1e-4
    assert out.delta == pytest.approx((price_at(100.0 + eps) - price_at(100.0 - eps))
                                      / (2 * eps), rel=1e-6)
    dv0 = (price_at(100.0, PARAMS[4] + eps) - price_at(100.0, PARAMS[4] - eps)) / (2 * eps)
    assert out.vega == pytest.approx(dv0 * 2.0 * np.sqrt(PARAMS[4]), rel=1e-6)
    assert out.vega > 0.0


def test_mixed_models_in_one_batch():
    pricer = tsv.BatchPricer(buckets=(8,), **CPU)
    alt = (3.0, 0.09, 0.5, -0.5, 0.09)
    res = pricer.price([tsv.PricingRequest(100.0, 1.0, 100.0, PARAMS, rate=0.05),
                        tsv.PricingRequest(100.0, 1.0, 100.0, alt, rate=0.05)])
    assert abs(res[0].price - res[1].price) > 1e-3


def test_empty_batch_and_async_handle():
    pricer = tsv.BatchPricer(buckets=(8,), **CPU)
    assert pricer.price([]) == []
    handle = pricer.price_async(_requests(3, greeks=True))
    assert handle[1].shape == (3, 8) and handle[1].dtype == torch.float64
    assert [r.to_dict() for r in tsv.BatchPricer.finalize(handle)] == [
        r.to_dict() for r in pricer.price(_requests(3, greeks=True))]


def test_float32_batch_stays_near_float64():
    reqs = _seeded_requests(32, seed=3)
    f64 = tsv.BatchPricer(buckets=(32,), **CPU).price(reqs)
    f32 = tsv.BatchPricer(buckets=(32,), device="cpu", dtype=torch.float32).price(reqs)
    np.testing.assert_allclose([r.price for r in f32], [r.price for r in f64],
                               rtol=1e-4, atol=1e-5)


BAD = {
    "short_params": dict(params=(1.0, 2.0)),
    "nan_param": dict(params=(2.0, 0.04, float("nan"), -0.7, 0.04)),
    "inf_rate": dict(rate=float("inf")),
    "zero_strike": dict(strike=0.0),
    "negative_spot": dict(spot=-1.0),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_validate_rejects_as_the_reference(name):
    req = dataclasses.replace(_requests(1)[0], **BAD[name])
    with pytest.raises(ValueError) as want:
        jsv.BatchPricer.validate(jsv.PricingRequest(**dataclasses.asdict(req)))
    with pytest.raises(ValueError) as got:
        tsv.BatchPricer(buckets=(8,), **CPU).price([req])
    assert str(got.value) == str(want.value)


# --- the reference's TestMicroBatchingServer on the port ------------------

def test_concurrent_callers_are_coalesced():
    srv = tsv.MicroBatchingServer(tsv.BatchPricer(buckets=(8, 32), **CPU), max_wait_ms=50.0)
    reqs = _requests(5)
    expected = tsv.BatchPricer(buckets=(8, 32), **CPU).price(reqs)
    with srv:
        out = [f.result(timeout=60.0) for f in [srv.submit(r) for r in reqs * 4]]
    assert srv.stats.requests == 20 and srv.stats.batches <= 3
    assert srv.stats.to_dict()["mean_batch_size"] == round(srv.stats.mean_batch, 2)
    for got, want in zip(out, expected * 4):
        assert got.price == pytest.approx(want.price, abs=1e-12)


def test_bad_request_fails_its_caller_not_the_server():
    srv = tsv.MicroBatchingServer(tsv.BatchPricer(buckets=(8,), **CPU), max_wait_ms=1.0)
    with srv:
        bad = tsv.PricingRequest(100.0, 1.0, 100.0, params=(1.0, 2.0))
        with pytest.raises(ValueError):
            srv.submit(bad).result(timeout=60.0)
        assert srv.submit(_requests(1)[0]).result(timeout=60.0).price > 0.0
        assert srv.stats.errors >= 1


def test_stop_fails_queued_stragglers():
    srv = tsv.MicroBatchingServer(tsv.BatchPricer(buckets=(8,), **CPU))
    srv.start()
    srv._running = False  # freeze dispatch before it can drain
    srv._thread.join(timeout=5.0)
    srv._thread = None
    srv._running = True  # allow submit
    fut_ok = srv.submit(_requests(1)[0])
    srv._running = False
    srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut_ok.result(timeout=1.0)


def test_submit_before_start_raises():
    with pytest.raises(RuntimeError):
        tsv.MicroBatchingServer(tsv.BatchPricer(buckets=(8,), **CPU)).submit(_requests(1)[0])


def test_server_greeks_while_another_thread_runs_jacfwd():
    """The dispatch thread prices Greeks by reverse mode while the main
    thread fits a SABR smile by an LM whose Jacobian is ``jacfwd``: the
    Greeks equal the pricer's own, and the fit recovers its truth."""
    reqs = [dataclasses.replace(r, want_greeks=True) for r in _seeded_requests(8, seed=11)]
    pricer = tsv.BatchPricer(buckets=(8,), **CPU)
    want = pricer.price(reqs)
    strikes = np.linspace(80.0, 120.0, 11)
    truth = sabr.SABRParams(0.25, 0.5, -0.35, 0.45)
    vols = sabr.implied_volatilities(torch.as_tensor(strikes), 103.0, 1.0, truth).numpy()

    results, done = [], threading.Event()

    def client():
        while not done.wait(0.002):
            results.append([f.result(timeout=60.0) for f in [srv.submit(r) for r in reqs]])

    srv = tsv.MicroBatchingServer(pricer, max_wait_ms=0.5)
    with srv:
        worker = threading.Thread(target=client)
        worker.start()
        try:
            params, rmse = SABRCalibrator(beta=0.5, **CPU).calibrate_single_maturity(
                strikes, vols, 103.0, 1.0)
        finally:
            done.set()
            worker.join(timeout=60.0)
    assert len(results) > 1 and srv.stats.errors == 0
    for got in results:
        _same(got, want)
    assert rmse < 1e-10
    np.testing.assert_allclose([float(params.alpha), float(params.rho), float(params.nu)],
                               [truth.alpha, truth.rho, truth.nu], rtol=1e-8)


# --- the reference's TestPricingAPI on the port ---------------------------

def test_http_roundtrip():
    pytest.importorskip("aiohttp")
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    srv = tsv.MicroBatchingServer(tsv.BatchPricer(buckets=(8,), **CPU), max_wait_ms=1.0)
    srv.start()

    async def scenario():
        app = tsv.create_pricing_api(srv)
        assert app[tsv.pricing_server_key()] is srv
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/health")
            assert r.status == 200 and (await r.json())["running"]
            r = await client.post("/price", json={"requests": [
                {"strike": 100.0, "maturity": 1.0, "spot": 100.0, "params": list(PARAMS),
                 "rate": 0.05},
                {"strike": 110.0, "maturity": 1.0, "spot": 100.0, "params": list(PARAMS),
                 "rate": 0.05, "want_greeks": True},
            ]})
            assert r.status == 200
            body = await r.json()
            assert len(body["results"]) == 2 and body["results"][0]["price"] > 0
            assert "delta" in body["results"][1] and "vega" in body["results"][1]
            r = await client.post("/price", json={"nope": 1})
            assert r.status == 400
            r = await client.get("/stats")
            assert (await r.json())["requests"] >= 2

    try:
        asyncio.run(scenario())
    finally:
        srv.stop()
