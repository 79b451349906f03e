"""Hot-path metric surface + combined /metrics + /statusz HTTP exporter.

The reference's only metrics are a per-RPC latency middleware and an
exporter task (reference src/main.rs:248-260; bucket defaults
src/config.rs:43-45 — values are milliseconds, 0.25..500).  That leaves
the device north-star path dark: the batching frontier's shape (linger
misconfiguration shows up as small batches), the device dispatch
pipeline (a remote PJRT link makes every phase latency-critical), and
the engine's round/WAL cadence.  `Metrics` covers all of them; every
instrument is optional at each call site (None = zero overhead) so
bench.py's measured path stays untouched unless a registry is attached.

Metric families (all per-`Metrics`, each owns its CollectorRegistry so
multiple nodes can live in one test process):

  RPC        grpc_server_handling_ms{method}, grpc_server_handled_total
             {method,code} — code is the REAL gRPC status (context.code()
             after aborts/set_code), not a binary OK/ERROR
  frontier   frontier_batch_size, frontier_queue_wait_ms,
             frontier_batch_occupancy (real/padded lanes),
             frontier_padded_lanes_total,
             frontier_verify_failures_total{msg_type},
             frontier_flush_reason_total{reason} — why each batch left
             the frontier (linger expired vs max-batch hit vs shutdown
             drain), the key to reading the queue-wait histogram
  tenancy    frontier_admission_sheds_total{tenant} — requests shed to
             the host oracle at a full tenant queue (exact verdicts),
             frontier_tenant_queue_wait_ms{tenant,lane} — per-tenant
             queue wait split critical/gossip,
             frontier_tenant_lanes_total{tenant} /
             frontier_tenant_share{tenant} — each tenant's share of the
             composed device batches (crypto/tenancy.py SharedFrontier)
  device     crypto_dispatch_ms{phase} — host-side phase split:
             prep (parse/pad/RLC draw), dispatch (kernel enqueue),
             readback (device round-trip), pairing (host pairing check)
  profile    crypto_device_stage_seconds{stage,op} — the per-call staged
             round profile (obs/prof.py DeviceProfiler): the
             parse/dispatch/readback/pairing split per device op
             (verify_batch / aggregate / verify_aggregated), in SECONDS
             (device stages span 100 us sim calls to minute-long cold
             compiles); crypto_device_batch_occupancy — gauge, real
             lanes / padded lanes of the LAST device batch;
             sharded_partial_reduce_seconds / sharded_allgather_seconds
             — the mesh verify round split into per-device local work
             vs ICI combine (sampled probe, tpu_provider
             profile_sharded_stages); mesh_devices / device_kind{kind}
             — the device set a provider dispatches to;
             device_last_dispatch_seconds{device} — per-device shard
             readback latency (skew across a v4-8 slice)
  fleet      sharded_device_stage_seconds{device,stage} — per-device
             mesh stage attribution (the shard-fetch machinery
             generalized to every stage); mesh_straggler_total
             {device,stage} — rolling-median straggler flags
             (obs/fleet.py StragglerDetector); obs_alerts_total{kind}
             — EWMA/z-score anomaly alerts over the telemetry series
             (obs/anomaly.py AnomalyDetector)
  engine     consensus_round_duration_ms, consensus_view_changes_total
             {reason}, consensus_chokes_sent_total,
             consensus_committed_heights_total,
             consensus_byzantine_rejections_total{reason} — adversarial
             messages the guards turned away (forged QC sigs, tampered
             bitmaps, equivocating proposals, replays, non-validators);
             consensus_commit_latency_seconds{stage} — commit latency
             exactly partitioned into critical-path stages by the
             causal tracer (obs/causal.py)
  sim        sim_router_tick_batch{shard} — messages coalesced per
             delivery pass of the sharded sim fabric's per-shard pump
             (sim/router.py); the batch factor IS the task-churn
             reduction vs the flat task-per-message router;
             sim_router_delivery_wait_seconds{shard} — admission-to-
             delivery wait per message (injected delay + tick
             quantization + pump backlog: a drifting tail means the
             pump can't keep up with the fleet's offered load)
  wal        wal_append_ms, wal_fsync_ms, wal_corruptions_total
  degraded   crypto_device_failures_total{path},
             crypto_host_fallbacks_total{path},
             crypto_pairing_host_fallbacks_total — pairing checks that
             fell back to the host oracle after a device pairing
             failure (0 on the happy path),
             crypto_breaker_transitions_total{to}, crypto_breaker_open
             — the device circuit breaker + host-oracle fallback
             (crypto/breaker.py; frontier re-verify)
  compile    compile_cache_hits / compile_cache_misses — gauges read from
             compile_cache.stats() (the kernel build cache) at scrape

The exporter serves `/metrics` (Prometheus text), and `/statusz` +
`/debug/vars` (JSON assembled from registered status sources: current
height/round/leader, frontier stats, flight-recorder tail) from one
HTTP server on `metrics_port`.

The port's own copy of consensus_overlord_tpu/obs/metrics.py, without
`prometheus_client` and `grpc`: the families live in a small registry of
this module's own (Counter, Gauge with `set_function`, Histogram, each
with labels) that renders the Prometheus text format 0.0.4 as
prometheus_client does, under the reference's names, help strings,
types, label names and bucket bounds.  The RPC middleware (`RpcMetrics`)
is transport-neutral; `MetricsInterceptor`, its grpc.aio form, is built
on first use.  The `compile_cache_*` gauges read the hit and miss counts
of the port's kernel build cache (compile_cache.py).
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


# -- the registry ----------------------------------------------------------------


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float


def _go_float(value) -> str:
    """A sample value or bucket bound as the Prometheus client writes it
    (Go's float formatting: exponents from 1e+07 up)."""
    d = float(value)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


class CollectorRegistry:
    """The families of one metric surface, in registration order."""

    def __init__(self):
        self._families: List["_Family"] = []
        self._names: set = set()

    def register(self, family: "_Family") -> None:
        if family.name in self._names:
            raise ValueError(f"duplicate metric family {family.name!r}")
        self._names.add(family.name)
        self._families.append(family)

    def collect(self) -> List["_Family"]:
        return list(self._families)

    def render(self) -> bytes:
        """The Prometheus text format 0.0.4 (prometheus_client's
        generate_latest): HELP and TYPE per family, its samples with
        labels sorted by name, then its `_created` samples as a gauge."""
        out: List[str] = []
        for fam in self._families:
            mname = fam.name + "_total" if fam.type == "counter" \
                else fam.name
            doc = _escape_help(fam.documentation)
            out.append(f"# HELP {mname} {doc}\n# TYPE {mname} {fam.type}\n")
            created: List[str] = []
            for s in fam.samples():
                line = _sample_line(s)
                if s.name == fam.name + "_created":
                    created.append(line)
                else:
                    out.append(line)
            if created:
                out.append(f"# HELP {fam.name}_created {doc}\n"
                           f"# TYPE {fam.name}_created gauge\n")
                out.extend(created)
        return "".join(out).encode()


def _sample_line(s: Sample) -> str:
    labels = ""
    if s.labels:
        labels = "{" + ",".join(f'{k}="{_escape_label(v)}"'
                                for k, v in sorted(s.labels.items())) + "}"
    return f"{s.name}{labels} {_go_float(s.value)}\n"


class _Family:
    """A metric family: one child per label-value tuple (the one
    unlabeled child exists from the start, labeled ones on first use)."""

    type = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None):
        self.name = name
        self.documentation = documentation
        self._labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[tuple, object] = {}
        if not self._labelnames:
            self._default = self._child(())
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def _child(self, values: tuple):
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def labels(self, *values, **kwargs):
        if not self._labelnames:
            raise ValueError(f"{self.name} has no labels")
        if kwargs:
            if values or set(kwargs) != set(self._labelnames):
                raise ValueError(f"{self.name}: labels are "
                                 f"{self._labelnames}")
            values = tuple(kwargs[n] for n in self._labelnames)
        if len(values) != len(self._labelnames):
            raise ValueError(f"{self.name}: labels are {self._labelnames}")
        return self._child(tuple(str(v) for v in values))

    def samples(self) -> List[Sample]:
        with self._lock:
            children = list(self._children.items())
        out: List[Sample] = []
        for values, child in children:
            labels = dict(zip(self._labelnames, values))
            out.extend(child.samples(self.name, labels))
        return out


class _Value:
    """A counter's or gauge's child."""

    def __init__(self, counter: bool):
        self._counter = counter
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()
        self._created = time.time()

    def inc(self, amount: float = 1.0) -> None:
        if self._counter and amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def get(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def samples(self, name: str, labels: dict) -> List[Sample]:
        if self._counter:
            return [Sample(name + "_total", labels, self.get()),
                    Sample(name + "_created", labels, self._created)]
        return [Sample(name, labels, self.get())]


class Counter(_Family):
    type = "counter"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry=None):
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _Value(counter=True)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)


class Gauge(_Family):
    type = "gauge"

    def _new_child(self):
        return _Value(counter=False)

    def set(self, value: float) -> None:
        self._default.set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default.set_function(fn)

    def get(self) -> float:
        return self._default.get()


class _Buckets:
    """A histogram's child: per-bucket counts and the sum."""

    def __init__(self, bounds: tuple):
        self._bounds = bounds
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._lock = threading.Lock()
        self._created = time.time()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def samples(self, name: str, labels: dict) -> List[Sample]:
        with self._lock:
            counts, total = list(self._counts), self._sum
        out, acc = [], 0
        for bound, n in zip(self._bounds, counts):
            acc += n
            out.append(Sample(name + "_bucket",
                              {**labels, "le": _go_float(bound)}, acc))
        out.append(Sample(name + "_count", labels, acc))
        out.append(Sample(name + "_sum", labels, total))
        out.append(Sample(name + "_created", labels, self._created))
        return out


class Histogram(_Family):
    type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 buckets: Sequence[float] = (), registry=None):
        if "le" in labelnames:
            raise ValueError("'le' is a histogram's own label")
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self._bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _Buckets(self._bounds)

    def observe(self, value: float) -> None:
        self._default.observe(value)


#: reference src/config.rs:43-45 (milliseconds)
DEFAULT_BUCKETS = (0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0, 25.0, 50.0,
                   75.0, 100.0, 250.0, 500.0)
#: Device dispatch phases reach seconds on a remote PJRT link and minutes
#: on a cold jit compile — the RPC buckets top out far too low.
DEVICE_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  500.0, 1000.0, 2500.0, 10000.0, 60000.0, 300000.0)
#: Round durations span sub-ms (sim fleets) to tens of seconds (view
#: changes backing off under partition).
ROUND_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)
#: Real-lane fraction of a padded device batch (1.0 = the batch exactly
#: filled its pad rung).
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
#: Sim fabric delivery-pass sizes: 1 = no coalescing (task-per-message
#: parity), the top rungs are 1000-validator broadcast storms landing in
#: one tick.
TICK_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                      4096)
#: Device stage durations in SECONDS: sim-provider stages run ~100 us,
#: a real readback over a remote PJRT link ~150 ms, a cold jit compile
#: minutes — one family must hold all three.
STAGE_SECONDS_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                         10.0, 60.0, 300.0)


class Metrics:
    """One node's metric surface: RPC latency, frontier/device hot path,
    engine round cadence, WAL latency, compile-cache hit rate."""

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        self.registry = CollectorRegistry()
        buckets = tuple(buckets or DEFAULT_BUCKETS)
        self.rpc_latency_ms = Histogram(
            "grpc_server_handling_ms",
            "gRPC request handling latency (ms)",
            ["method"], buckets=buckets, registry=self.registry)
        self.rpc_total = Counter(
            "grpc_server_handled_total",
            "gRPC requests handled", ["method", "code"],
            registry=self.registry)

        # -- frontier (crypto/frontier.py) --------------------------------
        self.frontier_batch_size = Histogram(
            "frontier_batch_size",
            "Signature-verification batch sizes at the frontier",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048),
            registry=self.registry)
        self.frontier_queue_wait_ms = Histogram(
            "frontier_queue_wait_ms",
            "Time a verify request waits at the frontier before its "
            "batch result resolves (linger + dispatch + readback)",
            buckets=DEVICE_BUCKETS, registry=self.registry)
        self.frontier_occupancy = Histogram(
            "frontier_batch_occupancy",
            "Real lanes / padded lanes per flushed device batch",
            buckets=OCCUPANCY_BUCKETS, registry=self.registry)
        self.frontier_padded_lanes = Counter(
            "frontier_padded_lanes_total",
            "Padding lanes dispatched to the device (wasted MSM work)",
            registry=self.registry)
        self.frontier_verify_failures = Counter(
            "frontier_verify_failures_total",
            "Signatures rejected at the frontier, by message type",
            ["msg_type"], registry=self.registry)
        self.frontier_flush_reason = Counter(
            "frontier_flush_reason_total",
            "Frontier batch flushes by trigger (linger = the linger "
            "window expired, max_batch = the batch hit its size cap, "
            "shutdown = close() drained the pending queue)",
            ["reason"], registry=self.registry)

        # -- multi-tenant frontier (crypto/tenancy.py) --------------------
        self.frontier_admission_sheds = Counter(
            "frontier_admission_sheds_total",
            "Verify requests shed to the host-oracle path because the "
            "tenant's pending queue hit its bound (exact verdicts — "
            "shedding costs device batching, never correctness)",
            ["tenant"], registry=self.registry)
        self.frontier_tenant_queue_wait_ms = Histogram(
            "frontier_tenant_queue_wait_ms",
            "Per-tenant frontier queue wait, split by priority class "
            "(lane=critical: proposal-path verifies, drained first; "
            "lane=gossip: vote/choke verifies)",
            ["tenant", "lane"], buckets=DEVICE_BUCKETS,
            registry=self.registry)
        self.frontier_tenant_lanes = Counter(
            "frontier_tenant_lanes_total",
            "Device-batch lanes filled by each tenant's requests (the "
            "tenant's cumulative occupancy share of the chip)",
            ["tenant"], registry=self.registry)
        self.frontier_tenant_share = Gauge(
            "frontier_tenant_share",
            "Tenant's fraction of the last composed device batch "
            "(DWRR fairness at a glance; compare against weights)",
            ["tenant"], registry=self.registry)

        # -- device dispatch (crypto/cuda_provider.py + frontier) ---------
        self.crypto_dispatch_ms = Histogram(
            "crypto_dispatch_ms",
            "Host-side device-path phase latency "
            "(prep/dispatch/readback/pairing)",
            ["phase"], buckets=DEVICE_BUCKETS, registry=self.registry)

        # -- device profiling (obs/prof.py DeviceProfiler) ----------------
        self.device_stage_seconds = Histogram(
            "crypto_device_stage_seconds",
            "Staged per-call device-op profile: parse / dispatch / "
            "readback / pairing per op (seconds)",
            ["stage", "op"], buckets=STAGE_SECONDS_BUCKETS,
            registry=self.registry)
        self.device_batch_occupancy = Gauge(
            "crypto_device_batch_occupancy",
            "Real lanes / padded lanes of the last device batch "
            "dispatched (in (0, 1]; low = linger/max_batch mis-tuned)",
            registry=self.registry)
        self.sharded_partial_reduce_seconds = Histogram(
            "sharded_partial_reduce_seconds",
            "Per-device local stage of the mesh verify round (validate "
            "+ partial MSM reduce, no collective) — sampled probe",
            buckets=STAGE_SECONDS_BUCKETS, registry=self.registry)
        self.sharded_allgather_seconds = Histogram(
            "sharded_allgather_seconds",
            "Cross-device combine stage of the mesh verify round "
            "(all-gather of partials over ICI + replicated finish) — "
            "sampled probe",
            buckets=STAGE_SECONDS_BUCKETS, registry=self.registry)
        self.sharded_pairing_partial_seconds = Histogram(
            "sharded_pairing_partial_seconds",
            "Per-device local stage of the mesh pairing (sharded Miller "
            "loops + local Fq12 tree product, no collective) — sampled "
            "probe",
            buckets=STAGE_SECONDS_BUCKETS, registry=self.registry)
        self.sharded_pairing_combine_seconds = Histogram(
            "sharded_pairing_combine_seconds",
            "Cross-device combine stage of the mesh pairing (all-gather "
            "of the D Fq12 partials over ICI + replicated combine tree; "
            "final exponentiation excluded) — sampled probe",
            buckets=STAGE_SECONDS_BUCKETS, registry=self.registry)
        self.mesh_devices = Gauge(
            "mesh_devices",
            "Devices in the crypto provider's dispatch mesh (1 = "
            "single-chip kernels)", registry=self.registry)
        self.device_kind = Gauge(
            "device_kind",
            "1 per device platform/kind present in the mesh",
            ["kind"], registry=self.registry)
        self.device_last_dispatch_seconds = Gauge(
            "device_last_dispatch_seconds",
            "Per-device shard-fetch latency of the last profiled "
            "sharded dispatch, measured after the result completed "
            "(each gauge is one device's D2H path; a straggling chip "
            "is the outlier)", ["device"], registry=self.registry)

        # -- fleet observability (obs/fleet.py + obs/anomaly.py) ----------
        self.sharded_device_stage_seconds = Histogram(
            "sharded_device_stage_seconds",
            "Per-device stage timing of a mesh dispatch (the shard-"
            "fetch machinery generalized to every stage: readback on "
            "the hot path, partial_reduce / pairing_partial on the "
            "sharded probe) — the per-chip attribution the aggregate "
            "stage histograms lack",
            ["device", "stage"], buckets=STAGE_SECONDS_BUCKETS,
            registry=self.registry)
        self.mesh_straggler_total = Counter(
            "mesh_straggler_total",
            "Straggler flags: a device whose rolling-median stage time "
            "exceeded the mesh median by the configured ratio "
            "(obs/fleet.py StragglerDetector)",
            ["device", "stage"], registry=self.registry)
        self.obs_alerts_total = Counter(
            "obs_alerts_total",
            "Anomaly alerts raised over the telemetry series, by kind "
            "(occupancy_collapse / stage_time_spike / shed_storm / "
            "straggler_persistence / ladder_step_down — obs/anomaly.py)",
            ["kind"], registry=self.registry)

        # -- mesh resilience (parallel/supervisor.py) ---------------------
        self.mesh_ladder_transitions = Counter(
            "mesh_ladder_transitions_total",
            "MeshSupervisor escalation-ladder transitions (full_mesh / "
            "sub_mesh / single_chip / host_oracle), by edge and reason "
            "(the failing path + exception type on the way down, "
            "'probe' on the way back up)",
            ["from", "to", "reason"], registry=self.registry)
        self.mesh_quarantined_devices = Gauge(
            "mesh_quarantined_devices",
            "Mesh lanes currently quarantined by the supervisor "
            "(excluded from the rebuilt sub-mesh kernel set)",
            registry=self.registry)

        # -- engine (engine/smr.py) ---------------------------------------
        self.round_duration_ms = Histogram(
            "consensus_round_duration_ms",
            "Wall-clock per consensus round (entry to exit)",
            buckets=ROUND_BUCKETS, registry=self.registry)
        self.view_changes = Counter(
            "consensus_view_changes_total",
            "View changes, by trigger", ["reason"], registry=self.registry)
        self.chokes_sent = Counter(
            "consensus_chokes_sent_total",
            "SignedChoke broadcasts by this node", registry=self.registry)
        self.committed_heights = Counter(
            "consensus_committed_heights_total",
            "Heights committed by this node", registry=self.registry)
        self.byzantine_rejections = Counter(
            "consensus_byzantine_rejections_total",
            "Adversarial messages rejected by the engine, by reason "
            "(bad_qc_sig, bad_bitmap, subquorum, equivocation, replay, "
            "non_validator, bad_sig)",
            ["reason"], registry=self.registry)
        self.commit_latency_seconds = Histogram(
            "consensus_commit_latency_seconds",
            "Commit latency attributed to critical-path stages by the "
            "causal tracer (obs/causal.py): per committed height the "
            "enter-height -> commit interval is exactly partitioned "
            "into proposal_propagation / router_queue_wait / trunk_hop "
            "/ quorum_tail / qc_verify / wal_fsync / commit, plus one "
            "'total' observation",
            ["stage"], buckets=STAGE_SECONDS_BUCKETS,
            registry=self.registry)

        # -- sim fabric (sim/router.py) -----------------------------------
        self.sim_router_tick_batch = Histogram(
            "sim_router_tick_batch",
            "Messages coalesced into one delivery pass of a sim fabric "
            "shard pump (the task-churn reduction factor vs "
            "task-per-message delivery)",
            ["shard"], buckets=TICK_BATCH_BUCKETS, registry=self.registry)
        self.sim_router_delivery_wait_seconds = Histogram(
            "sim_router_delivery_wait_seconds",
            "Admission-to-delivery wait per sim fabric message "
            "(injected delay + tick quantization + pump backlog)",
            ["shard"], buckets=STAGE_SECONDS_BUCKETS,
            registry=self.registry)

        # -- WAL (engine/wal.py) ------------------------------------------
        self.wal_append_ms = Histogram(
            "wal_append_ms", "WAL save latency, end to end (ms)",
            buckets=buckets, registry=self.registry)
        self.wal_fsync_ms = Histogram(
            "wal_fsync_ms", "WAL fsync portion of a save (ms)",
            buckets=buckets, registry=self.registry)
        self.wal_corruptions = Counter(
            "wal_corruptions_total",
            "Corrupt/torn WAL files quarantined at load",
            registry=self.registry)

        # -- degraded mode (crypto/breaker.py + frontier fallback) --------
        self.device_failures = Counter(
            "crypto_device_failures_total",
            "Device dispatch/readback failures, by provider path",
            ["path"], registry=self.registry)
        self.host_fallbacks = Counter(
            "crypto_host_fallbacks_total",
            "Batches re-routed to the host oracle (degraded mode), by "
            "provider path", ["path"], registry=self.registry)
        self.pairing_host_fallbacks = Counter(
            "crypto_pairing_host_fallbacks_total",
            "Pairing checks that fell back to the host oracle after a "
            "device pairing dispatch/readback failure (0 on the happy "
            "path once the pairing is device-resident)",
            registry=self.registry)
        self.breaker_transitions = Counter(
            "crypto_breaker_transitions_total",
            "Device circuit-breaker state transitions", ["to"],
            registry=self.registry)
        self.breaker_open = Gauge(
            "crypto_breaker_open",
            "1 while the device circuit breaker is open (all crypto on "
            "the host oracle)", registry=self.registry)

        # -- compile cache (compile_cache.py) -----------------------------
        # Gauges read the module-level counts at scrape time: the kernel
        # build cache's lookups (ops/kernels.py), process-wide.  Help
        # strings are the reference's.
        from .. import compile_cache as _cc
        hits = Gauge("compile_cache_hits",
                     "Persistent XLA compile-cache hits (process-wide)",
                     registry=self.registry)
        hits.set_function(lambda: _cc.stats()["hits"])
        misses = Gauge("compile_cache_misses",
                       "Persistent XLA compile-cache misses (process-wide)",
                       registry=self.registry)
        misses.set_function(lambda: _cc.stats()["misses"])

        self._exporter: Optional[ThreadingHTTPServer] = None
        self._exporter_thread: Optional[threading.Thread] = None
        #: /statusz sources: name → zero-arg callable returning something
        #: JSON-encodable.  Registered by service/main.py (engine state,
        #: frontier stats, flight-recorder tail).
        self._status_sources: Dict[str, Callable[[], object]] = {}
        #: /debug/* action endpoints: path → fn(query_params) returning
        #: something JSON-encodable.  Loopback-gated like /statusz (they
        #: mutate process state — e.g. /debug/profile starts a
        #: trace capture).  Registered by service/main.py.
        self._debug_handlers: Dict[str, Callable[[dict], object]] = {}

    def interceptor(self) -> "RpcMetrics":
        """The RPC timing middleware (either transport)."""
        return RpcMetrics(self)

    # -- statusz -----------------------------------------------------------

    def add_status_source(self, name: str,
                          fn: Callable[[], object]) -> None:
        """Register a /statusz section.  `fn` runs on the exporter's HTTP
        thread at request time — it must be cheap and thread-safe."""
        self._status_sources[name] = fn

    def add_debug_handler(self, path: str,
                          fn: Callable[[dict], object]) -> None:
        """Register a loopback-only /debug action endpoint.  `fn`
        receives the query parameters ({name: last_value}) on the
        exporter's HTTP thread and returns a JSON-encodable reply —
        e.g. /debug/profile?rounds=N triggers a torch.profiler capture
        (obs/prof.py ProfileSession.request)."""
        self._debug_handlers[path] = fn

    def statusz(self) -> dict:
        """Assemble the /statusz document.  A failing source reports its
        error instead of taking the endpoint down."""
        doc: dict = {"ts": time.time()}
        for name, fn in list(self._status_sources.items()):
            try:
                doc[name] = fn()
            except Exception as e:  # noqa: BLE001 — degrade per-section
                doc[name] = {"error": repr(e)}
        return doc

    # -- exporter ----------------------------------------------------------

    def start_exporter(self, port: int, addr: str = "0.0.0.0",
                       statusz_public: bool = False) -> int:
        """Serve /metrics (Prometheus text) and /statusz + /debug/vars
        (JSON) on `port` (0 = OS-assigned); returns the bound port.  The
        reference's run_metrics_exporter analog (src/main.rs:249-251),
        extended with the status endpoint.

        statusz_public=False (default): /statusz answers loopback
        clients only — it exposes live consensus position, lock state,
        and the flight-recorder tail, reconnaissance-grade detail an
        adversary could time attacks with, while /metrics stays
        fleet-scrapeable like the reference's exporter."""
        metrics = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path, _, query = self.path.partition("?")
                if path in ("/statusz", "/debug/vars"):
                    if not statusz_public and not _loopback(
                            self.client_address[0]):
                        self.send_error(403, "statusz is loopback-only "
                                        "(set statusz_public to expose)")
                        return
                    body = json.dumps(metrics.statusz(),
                                      default=repr).encode()
                    ctype = "application/json"
                elif path in metrics._debug_handlers:
                    # Action endpoints mutate process state (e.g. start
                    # a profiler trace): never remotely triggerable, even
                    # with a public statusz.
                    if not _loopback(self.client_address[0]):
                        self.send_error(403, "debug endpoints are "
                                        "loopback-only")
                        return
                    params = {k: vs[-1] for k, vs
                              in urllib.parse.parse_qs(query).items()}
                    try:
                        reply = metrics._debug_handlers[path](params)
                    except Exception as e:  # noqa: BLE001 — degrade
                        reply = {"ok": False, "error": repr(e)}
                    body = json.dumps(reply, default=repr).encode()
                    ctype = "application/json"
                elif path in ("/", "/metrics"):
                    body = metrics.registry.render()
                    ctype = CONTENT_TYPE_LATEST
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                pass

        server = ThreadingHTTPServer((addr, port), _Handler)
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="obs-exporter", daemon=True)
        thread.start()
        self._exporter = server
        self._exporter_thread = thread
        return server.server_address[1]

    def stop_exporter(self) -> None:
        if self._exporter is not None:
            self._exporter.shutdown()
            self._exporter.server_close()
            self._exporter = None
            self._exporter_thread = None


def _loopback(host: str) -> bool:
    """Is the peer address a loopback interface?  (IPv4-mapped IPv6
    included — ThreadingHTTPServer reports it for v6 dual-stack binds.)"""
    return host in ("127.0.0.1", "::1") or host.startswith("127.") \
        or host == "::ffff:127.0.0.1"


def snapshot(registry: CollectorRegistry, prefix: str = "") -> dict:
    """Flatten a registry into {sample_name[{labels}]: value} — counters
    and gauges as floats, histograms as their _bucket/_count/_sum
    samples.  Used by sim/run.py and scripts/bench_round.py to carry the
    scraped batch-shape data in their JSON output."""
    out: dict = {}
    for family in registry.collect():
        if prefix and not family.name.startswith(prefix):
            continue
        for s in family.samples():
            if s.name.endswith("_created"):
                continue  # creation wall-clock: pure diff noise in ledgers
            labels = ",".join(f"{k}={v}" for k, v in sorted(s.labels.items()))
            key = f"{s.name}{{{labels}}}" if labels else s.name
            out[key] = s.value
    return out


class RpcMetrics:
    """Times every unary RPC into the latency histogram — the tower
    MiddlewareLayer analog (reference src/main.rs:253-256).  The handled
    counter records the REAL status code: whatever the handler set via
    abort() (read back off the context), OK on a clean return,
    CANCELLED/UNKNOWN on cancellation or an unexpected raise.
    Transport-neutral server middleware (service/rpc.py)."""

    def __init__(self, metrics: Metrics):
        self._m = metrics

    def wrap(self, method: str, metadata, inner):
        metrics = self._m

        async def timed(request, context):
            t0 = time.perf_counter()
            failure = None
            try:
                return await inner(request, context)
            except BaseException as e:
                failure = e
                raise
            finally:
                code = None
                try:
                    code = context.code()  # abort() records it here
                except Exception:  # noqa: BLE001 — introspection only
                    pass
                if code is None:
                    if failure is None:
                        code = "OK"
                    elif isinstance(failure, asyncio.CancelledError):
                        code = "CANCELLED"
                    else:
                        code = getattr(failure, "code", None)
                        if not isinstance(code, str):
                            code = "UNKNOWN"
                label = getattr(code, "name", None) or str(code)
                metrics.rpc_latency_ms.labels(method=method).observe(
                    (time.perf_counter() - t0) * 1000.0)
                metrics.rpc_total.labels(method=method, code=label).inc()

        return timed


def __getattr__(name):
    if name == "MetricsInterceptor":
        from ..service.rpc import grpc_interceptor_class

        cls = grpc_interceptor_class(RpcMetrics, name)
        globals()[name] = cls
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
