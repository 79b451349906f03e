"""The port's observability surface (consensus_overlord_tpu_torch/obs) on
the CPU, held against the JAX package's obs/: the metric registry's
/metrics body against prometheus_client's after the same observations
(families, types, help, label sets, buckets and values), and the causal
commit tracer, the telemetry sampler, the anomaly detector, the
straggler detector and the fleet aggregator fed the same event or sample
sequences (made from a numpy seed).  Then what only the port has: the
torch.profiler capture session, the straggler feed of a one-device
profiler, and the transport-neutral RPC middleware.  Tolerance: none
(the same arithmetic on the same inputs)."""

import asyncio
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

import consensus_overlord_tpu.compile_cache as ref_cc
import consensus_overlord_tpu_torch.compile_cache as port_cc
from consensus_overlord_tpu.core import types as ref_types
from consensus_overlord_tpu.obs import anomaly as ref_anomaly
from consensus_overlord_tpu.obs import causal as ref_causal
from consensus_overlord_tpu.obs import fleet as ref_fleet
from consensus_overlord_tpu.obs import flightrec as ref_flightrec
from consensus_overlord_tpu.obs import metrics as ref_metrics
from consensus_overlord_tpu.obs import prof as ref_prof
from consensus_overlord_tpu.obs import telemetry as ref_telemetry
from consensus_overlord_tpu_torch.core import types as port_types
from consensus_overlord_tpu_torch.obs import anomaly, causal, fleet
from consensus_overlord_tpu_torch.obs import flightrec, logctx, metrics
from consensus_overlord_tpu_torch.obs import prof, telemetry
from consensus_overlord_tpu_torch.service.pb import pb2
from consensus_overlord_tpu_torch.service.rpc import (
    HEALTH_SERVICE, LoopbackTransport, RetryClient, RpcError,
    generic_handler)

LABEL_VALUES = ["a", 'quo"te', "new\nline", "back\\slash", "cuda:0"]


def _families(body: bytes) -> dict:
    """{name: (type, help, {(sample, labels): value})}; the `_created`
    samples carry wall-clock times, so only their label sets count."""
    out = {}
    for fam in text_string_to_metric_families(body.decode()):
        samples = {}
        for s in fam.samples:
            key = (s.name, tuple(sorted(s.labels.items())))
            samples[key] = None if s.name.endswith("_created") else s.value
        out[fam.name] = (fam.type, fam.documentation, samples)
    return out


def _observe(port_fam, ref_fam, rng):
    """The same seeded observations on a family of each package."""
    labelnames = port_fam._labelnames
    assert list(labelnames) == list(ref_fam._labelnames)
    bounds = getattr(port_fam, "_bounds", ())
    for _ in range(int(rng.integers(0, 4))):
        labels = {n: LABEL_VALUES[int(rng.integers(len(LABEL_VALUES)))]
                  for n in labelnames}
        p = port_fam.labels(**labels) if labels else port_fam
        r = ref_fam.labels(**labels) if labels else ref_fam
        if port_fam.type == "histogram":
            for _ in range(int(rng.integers(1, 6))):
                # bucket bounds themselves (le is inclusive) and between
                v = (float(bounds[int(rng.integers(len(bounds) - 1))])
                     if rng.random() < 0.4 else float(rng.exponential(50)))
                p.observe(v)
                r.observe(v)
        elif port_fam.type == "counter":
            v = float(rng.integers(1, 9)) / 4
            p.inc(v)
            r.inc(v)
        else:
            v = float(rng.normal(0, 10))
            p.set(v)
            r.set(v)


def test_metrics_body_matches_prometheus_client():
    rng = np.random.default_rng(11)
    port, ref = metrics.Metrics(), ref_metrics.Metrics()
    families = {name: fam for name, fam in vars(port).items()
                if isinstance(fam, metrics._Family)}
    assert len(families) >= 40
    for name, fam in families.items():
        _observe(fam, getattr(ref, name), rng)
    got = _families(port.registry.render())
    want = _families(ref_metrics.generate_latest(ref.registry))
    assert set(got) == set(want)
    for name in want:
        gtype, ghelp, gsamples = got[name]
        wtype, whelp, wsamples = want[name]
        assert (gtype, ghelp) == (wtype, whelp), name
        assert set(gsamples) == set(wsamples), name
        if not name.startswith("compile_cache"):  # each package's cache
            assert gsamples == wsamples, name
    snap = metrics.snapshot(port.registry, "consensus_")
    assert snap == ref_metrics.snapshot(ref.registry, "consensus_")


def test_metrics_exporter_serves_metrics_statusz_and_loopback_debug():
    import urllib.request

    m = metrics.Metrics()
    m.committed_heights.inc(3)
    m.add_status_source("consensus", lambda: {"height": 7})
    m.add_status_source("broken", lambda: 1 / 0)
    m.add_debug_handler("/debug/profile", lambda q: {"rounds": q["rounds"]})
    port = m.start_exporter(0, addr="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            assert r.headers["Content-Type"] == metrics.CONTENT_TYPE_LATEST
            assert b"consensus_committed_heights_total 3.0" in r.read()
        with urllib.request.urlopen(f"{base}/statusz", timeout=5) as r:
            doc = json.loads(r.read())
        assert doc["consensus"] == {"height": 7}
        assert "ZeroDivisionError" in doc["broken"]["error"]
        with urllib.request.urlopen(f"{base}/debug/profile?rounds=2",
                                    timeout=5) as r:
            assert json.loads(r.read()) == {"rounds": "2"}
    finally:
        m.stop_exporter()


def test_compile_cache_gauges_read_the_build_cache(monkeypatch):
    monkeypatch.setattr(port_cc, "_STATS", {"hits": 5, "misses": 2})
    body = metrics.Metrics().registry.render()
    assert b"compile_cache_hits 5.0" in body
    assert b"compile_cache_misses 2.0" in body


# -- the causal commit tracer ---------------------------------------------------


def _tracer_events(rng, nodes=3, heights=6):
    """A seeded engine event sequence for the commit tracer."""
    events, t = [], 100.0
    for h in range(1, heights + 1):
        for n in range(nodes):
            t += float(rng.exponential(0.01))
            events.append(("enter", n, h, t))
        rnd = int(rng.integers(0, 2))
        for n in range(nodes):
            t += float(rng.exponential(0.02))
            if n == 0:
                events.append(("prop_sent", n, h, rnd, t))
            else:
                env = None if rng.random() < 0.3 else (
                    t - 0.02, t - 0.015, t - 0.01 if rng.random() < 0.5
                    else 0.0, t, bool(rng.random() < 0.5))
                events.append(("recv_prop", n, h, rnd, t, env))
            events.append(("vote_sent", n, h, rnd, t))
            events.append(("wal", n, h, float(rng.exponential(0.002))))
        t += float(rng.exponential(0.05))
        events.append(("quorum", 0, h, rnd, t, int(rng.integers(2, 4))))
        events.append(("aggregate", 0, h, float(rng.exponential(0.01)),
                       int(rng.integers(1, 99))))
        for n in range(1, nodes):
            t += float(rng.exponential(0.01))
            events.append(("recv_qc", n, h, rnd, t))
            events.append(("qc_verify", n, h, float(rng.exponential(0.02)),
                           None if rng.random() < 0.5 else 7))
        t += float(rng.exponential(0.01))
        events.append(("commit", 0, h, t))
        for n in range(1, nodes):
            t += float(rng.exponential(0.005))
            events.append(("settled", n, h, t))
    return events


def _replay(tracer, types, events):
    node = [bytes([i + 1]) * 8 for i in range(8)]
    for ev in events:
        kind, n, h = ev[0], node[ev[1]], ev[2]
        if kind == "enter":
            tracer.on_enter_height(n, h, ev[3])
        elif kind == "prop_sent":
            tracer.on_proposal_sent(n, h, ev[3], n, ev[4])
        elif kind == "recv_prop":
            msg = types.SignedProposal(
                types.Proposal(height=h, round=ev[3], content=b"blk",
                               block_hash=b"\x11" * 32, lock=None,
                               proposer=node[0]), signature=b"\x00" * 96)
            tracer.on_recv(n, msg, ev[4], ev[5])
        elif kind == "vote_sent":
            tracer.on_vote_sent(n, h, ev[3], types.VoteType.PREVOTE, n,
                                ev[4])
        elif kind == "wal":
            tracer.on_wal_save(n, h, ev[3])
        elif kind == "quorum":
            tracer.on_quorum(n, types.VoteType.PRECOMMIT, h, ev[3], ev[4],
                             ev[5])
        elif kind == "aggregate":
            tracer.on_aggregate(n, h, ev[3], round_id=ev[4])
        elif kind == "recv_qc":
            qc = types.AggregatedVote(
                signature=types.AggregatedSignature(b"\x00" * 96, b"\x07"),
                vote_type=types.VoteType.PRECOMMIT, height=h, round=ev[3],
                block_hash=b"\x11" * 32, leader=node[0])
            tracer.on_recv(n, qc, ev[4], None)
        elif kind == "qc_verify":
            tracer.on_qc_verify(n, h, ev[3], round_id=ev[4])
        elif kind == "commit":
            tracer.on_commit(n, h, ev[3])
        else:
            tracer.on_height_settled(n, h, ev[3])


class _Spans:
    def __init__(self):
        self.spans = []

    def report(self, span):
        self.spans.append((span.trace_id, span.operation, span.duration_us,
                           sorted(span.tags.items()), span.parent_span_id == 0))


def test_commit_tracer_matches_the_reference():
    events = _tracer_events(np.random.default_rng(5))
    port_m, ref_m = metrics.Metrics(), ref_metrics.Metrics()
    port_x, ref_x = _Spans(), _Spans()
    port = causal.CommitTracer(metrics=port_m, exporter=port_x)
    ref = ref_causal.CommitTracer(metrics=ref_m, exporter=ref_x)
    _replay(port, port_types, events)
    _replay(ref, ref_types, events)
    assert [t.as_dict() for t in port.completed] == \
        [t.as_dict() for t in ref.completed]
    assert len(port.completed) == 18
    assert port.summary() == ref.summary() and port.statusz() == \
        ref.statusz()
    assert port.drift_ratio(min_samples=2) == ref.drift_ratio(min_samples=2)
    assert port.to_perfetto() == ref.to_perfetto()
    assert [s[1:] for s in port_x.spans] == [s[1:] for s in ref_x.spans]
    assert [s[0] for s in port_x.spans] == [s[0] for s in ref_x.spans]
    assert metrics.snapshot(port_m.registry, "consensus_commit") == \
        ref_metrics.snapshot(ref_m.registry, "consensus_commit")


# -- telemetry, anomaly, fleet --------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 2.0
        return self.t


def test_telemetry_sampler_matches_the_reference(monkeypatch, tmp_path):
    rng = np.random.default_rng(3)
    for mod in (telemetry, ref_telemetry):
        monkeypatch.setattr(mod, "time", _Clock())
        monkeypatch.setattr(mod, "rss_bytes", iter(
            int(x) for x in 1e8 + np.arange(64) * 4096).__next__)
    for cc in (port_cc, ref_cc):
        monkeypatch.setattr(cc, "stats", lambda: {"hits": 3, "misses": 1})
    packages = []
    for m_mod, p_mod, f_mod, mod in (
            (metrics, prof, flightrec, telemetry),
            (ref_metrics, ref_prof, ref_flightrec, ref_telemetry)):
        m = m_mod.Metrics()
        profiler = p_mod.DeviceProfiler(m)
        recorder = f_mod.FlightRecorder(8)
        wal = iter(range(4096, 1 << 20, 512))
        sampler = mod.TelemetrySampler(
            metrics=m, interval_s=1.0, window=16,
            out_path=str(tmp_path / f"{mod.__name__}.jsonl"),
            wal_size_fn=lambda wal=wal: next(wal),
            recorders_fn=lambda r=recorder: [r],
            breaker_status_fn=lambda: {"state": "closed"},
            profiler=profiler)
        packages.append((m, profiler, recorder, sampler))
    docs = ([], [])
    for step in range(12):
        draws = [(float(rng.exponential(0.01)), int(rng.integers(1, 5)),
                  float(rng.uniform(0.2, 1.0))) for _ in range(3)]
        for i, (m, profiler, recorder, sampler) in enumerate(packages):
            for secs, heights, occ in draws:
                profiler.observe_stage("verify_batch", "readback", secs)
                profiler.occupancy(int(occ * 64), 64)
                m.committed_heights.inc(heights)
                recorder.record("enter_round", height=step)
            docs[i].append(sampler.sample_now())
    assert docs[0] == docs[1]
    assert docs[0][-1]["counters"]["consensus_committed_heights_total"] > 0
    trends = [s.trend() for *_, s in packages]
    assert [t.pop("out_path").rsplit(os.sep, 1)[1] for t in trends] == [
        "consensus_overlord_tpu_torch.obs.telemetry.jsonl",
        "consensus_overlord_tpu.obs.telemetry.jsonl"]
    assert trends[0] == trends[1]
    assert telemetry.drift_check(trends[0]) == \
        ref_telemetry.drift_check(trends[1])
    assert telemetry.drift_check(trends[0], {
        "max_wal_growth_bytes_per_s": 1.0}) != []


def _anomaly_docs(rng):
    docs, sheds = [], 0.0
    for i in range(40):
        occ = 0.9 + float(rng.normal(0, 0.01)) if i != 25 else 0.1
        mean = 0.01 + float(rng.normal(0, 0.0005)) if i != 30 else 0.5
        sheds += float(rng.integers(0, 2)) if i != 35 else 400.0
        docs.append({"occupancy": occ,
                     "stage_means_s": {"verify_batch/readback": mean},
                     "counters": {"frontier_admission_sheds_total": sheds}})
    return docs


def test_anomaly_detector_matches_the_reference():
    docs = _anomaly_docs(np.random.default_rng(9))
    flags = [0, 1, 2, 2, 3, 4, 5] + [5] * 40  # the straggler's count
    dets = []
    for det_mod, m_mod, f_mod in ((anomaly, metrics, flightrec),
                                  (ref_anomaly, ref_metrics, ref_flightrec)):
        straggler = SimpleNamespace(flag_count=iter(flags).__next__,
                                    flagged_devices=lambda: ["cuda:1"])
        m, rec = m_mod.Metrics(), f_mod.FlightRecorder(64)
        det = det_mod.AnomalyDetector(metrics=m, recorder=rec,
                                      straggler=straggler)
        for doc in docs:
            det.observe_sample(doc)
        dets.append((det, m, rec))
    (port, pm, prec), (ref, rm, rrec) = dets

    def strip(doc):
        return {**doc, "recent": [{k: v for k, v in a.items() if k != "ts"}
                                  for a in doc["recent"]]}

    assert strip(port.statusz()) == strip(ref.statusz())
    assert port.alert_count() == ref.alert_count() >= 4
    assert {k for k in port.statusz()["by_kind"]} >= {
        "occupancy_collapse", "stage_time_spike", "shed_storm",
        "straggler_persistence"}
    assert metrics.snapshot(pm.registry, "obs_alerts") == \
        ref_metrics.snapshot(rm.registry, "obs_alerts")
    assert [e["kind"] for e in prec.tail()] == [e["kind"] for e in rrec.tail()]


def test_straggler_detector_and_fleet_match_the_reference():
    rng = np.random.default_rng(4)
    samples = [(f"cuda:{d}", stage,
                0.004 * float(rng.uniform(0.8, 1.2)) * (3.0 if d == 2
                                                        else 1.0),
                int(rng.integers(1, 50)))
               for _ in range(30) for d in range(4)
               for stage in ("readback", "partial_reduce")]
    out = []
    for mod, m_mod in ((fleet, metrics), (ref_fleet, ref_metrics)):
        m = m_mod.Metrics()
        det = mod.StragglerDetector(metrics=m, ratio=1.5)
        got = [det.observe(d, s, secs, round_id=r)
               for d, s, secs, r in samples]
        doc = det.statusz()
        doc["last_flag"] = {k: v for k, v in (doc["last_flag"] or {}).items()
                            if k != "ts"}
        trend = {"samples": 3, "span_s": 4.0, "rss_delta_bytes": 10,
                 "last": {"rss_bytes": 5, "occupancy": 0.5}}
        agg = mod.FleetAggregator("local", lambda: trend,
                                  peers=("127.0.0.1:1",), timeout_s=0.2)
        out.append((got, doc, det.flag_count(), det.flagged_devices(),
                    metrics.snapshot(m.registry, "mesh_straggler")
                    if mod is fleet else
                    ref_metrics.snapshot(m.registry, "mesh_straggler"),
                    agg.statusz()))
    assert out[0] == out[1]
    assert out[0][3] == ["cuda:2"]


# -- the port's own pieces ------------------------------------------------------


def test_one_device_profiler_feeds_its_readbacks_to_the_straggler():
    seen = []
    p = prof.DeviceProfiler(metrics.Metrics())
    p.set_devices([SimpleNamespace(type="cpu", index=None)])
    p.attach_straggler(SimpleNamespace(
        observe=lambda d, s, secs, round_id=None: seen.append((d, s, secs))))
    p.observe_stage("verify_aggregated", "readback", 0.25)
    p.observe_stage("verify_aggregated", "dispatch", 0.5)
    assert seen == [("cpu:0", "readback", 0.25)]
    assert p.summary()["device_stages"] == {
        "cpu:0/readback": {"count": 1, "total_s": 0.25, "last_s": 0.25}}


def test_profile_session_captures_rounds_with_torch_profiler(tmp_path):
    s = prof.ProfileSession(str(tmp_path), every_n_rounds=5)
    assert set(s.status()) == set(ref_prof.ProfileSession().status())
    for r in range(5):
        s.on_round(1, r)  # the 5th round entry opens a capture
    assert s.status()["captures"] == 1 and s.active
    assert s.request(1) == {"ok": True, "rounds": 1, "dir": str(tmp_path)}
    s.on_round(2, 0)  # closes it, and opens the requested one
    assert s.status()["captures"] == 2 and s.active
    s.on_round(2, 1)
    assert not s.active and s.stop() is None
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and any(d.startswith("req_h2") for d in dirs)
    for d in dirs:
        with open(tmp_path / d / "trace.json") as f:
            assert "traceEvents" in json.load(f)
    off = prof.ProfileSession(None)
    off.on_round(1, 0)
    assert off.request(1)["ok"] is False and not off.status()["available"]


def test_trace_context_and_rpc_metrics_ride_the_loopback_transport():
    """A traced caller's traceparent reaches the handler's contextvars
    (not the caller's own: a fresh context), the exporter records the
    server span under the caller's span, and RpcMetrics counts the real
    status codes, abort included."""
    seen, spans = [], []

    class _Health:
        async def check(self, request, context):
            seen.append((logctx.trace_context.get(),
                         logctx.span_context.get()))
            if request.service == "bad":
                await context.abort("INVALID_ARGUMENT", "no such service")
            return pb2.HealthCheckResponse(
                status=pb2.HealthCheckResponse.SERVING)

    async def main():
        tr = LoopbackTransport()
        m = metrics.Metrics()
        server, port = tr.server(
            (generic_handler("Health", HEALTH_SERVICE, _Health()),),
            interceptors=[logctx.TraceContext(SimpleNamespace(
                report=spans.append)), m.interceptor()])
        await server.start()
        client = RetryClient(f"localhost:{port}", "Health", HEALTH_SERVICE,
                             retries=1, transport=tr)
        tid = "ab" * 16
        logctx.trace_context.set(tid)
        logctx.span_context.set("cd" * 8)
        await client.call("Check", pb2.HealthCheckRequest(service=""))
        with pytest.raises(RpcError) as err:
            await client.call("Check", pb2.HealthCheckRequest(service="bad"))
        assert err.value.code == "INVALID_ARGUMENT"
        await server.stop()
        return m

    m = asyncio.run(main())
    assert [t for t, _ in seen] == ["ab" * 16] * 2
    assert all(s and s != "cd" * 8 for _, s in seen)
    assert [sp.parent_span_id for sp in spans] == [int("cd" * 8, 16)] * 2
    snap = metrics.snapshot(m.registry, "grpc_server_handled")
    path = "/consensus_overlord_tpu.Health/Check"
    assert snap[f"grpc_server_handled_total{{code=OK,method={path}}}"] == 1
    assert snap[f"grpc_server_handled_total{{code=INVALID_ARGUMENT,"
                f"method={path}}}"] == 1
    untraced = logctx.TraceContext()
    inner = object()
    assert untraced.wrap("/x", (), inner) is inner


def test_engine_binds_its_span_into_the_trace_context():
    import contextvars

    from consensus_overlord_tpu_torch.engine.smr import Engine

    eng = Engine.__new__(Engine)
    eng.tracer, eng._trace_id = object(), 0x1234

    def bind():
        eng._bind_span_ctx(0xBEEF)
        return logctx.trace_context.get(), logctx.span_context.get()

    assert contextvars.Context().run(bind) == (f"{0x1234:032x}",
                                               f"{0xBEEF:016x}")
    assert logctx.trace_context.get() == "-"


@pytest.mark.parametrize("name", ["TraceContextInterceptor",
                                  "MetricsInterceptor"])
def test_grpc_interceptors_are_built_on_first_use(name):
    import grpc

    mod = logctx if name.startswith("Trace") else metrics
    cls = getattr(mod, name)
    assert issubclass(cls, grpc.aio.ServerInterceptor)
    inst = cls(metrics.Metrics()) if mod is metrics else cls(exporter=None)
    assert hasattr(inst, "wrap") and hasattr(inst, "intercept_service")
