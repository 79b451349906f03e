"""Process bootstrap: CLI + startup orchestration + graceful shutdown —
the reference's main.rs (src/main.rs:25-62 CLI, 165-297 run()).

Startup sequence (mirrors src/main.rs:165-297):

  1. load config, init logging/metrics
  2. bind + start the gRPC server (ConsensusService / NetworkMsgHandler /
     Health, with metrics + trace-context interceptors)
  3. registration retry loop: block until the network service accepts
     register_network_msg_handler, retrying every server_retry_interval
     (src/main.rs:186-207) — the service is self-healing against a late
     network sibling
  4. reconfiguration-wait task: ping_controller() every tick until the
     controller supplies a configuration, then start the engine
     (src/main.rs:213-246)
  5. serve until SIGINT/SIGTERM, then stop engine + server cleanly

One deviation from the reference: the server binds *before* network
registration so an OS-assigned port (consensus_port = 0, used by tests)
can be registered with its real value.  With a fixed port the observable
order matches the reference's gates.

CLI: `python -m consensus_overlord_tpu_torch.service.main run -c
config.toml -p private_key [--device {cuda,cpu}]` (reference
README.md:34-43).

The port's own copy of consensus_overlord_tpu/service/main.py.  A runtime
serves and dials on a transport (service/rpc.py): None is the gRPC wire,
which needs the `grpcio` package; the CLI exits non-zero, naming it,
where `grpc` cannot be imported.  `--device cuda` (the default) needs a
visible card: there is no quiet move to the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import Optional

from .. import __version__
from ..crypto.provider import load_private_key
from ..obs.flightrec import FlightRecorder
from ..obs.logctx import TraceContext, init_logging
from ..obs.metrics import Metrics
from ..obs.tracing import JaegerExporter
from .config import ConsensusConfig
from .consensus import Consensus
from .rpc import Code, GrpcTransport
from .server import ConsensusServer, HealthServer, build_server

logger = logging.getLogger("consensus_overlord_tpu_torch.main")


class ServiceRuntime:
    """The assembled, running consensus microservice process.

    device: where a "cuda" crypto backend runs (the card unless the
    caller asks for "cpu").  transport: the RPC transport every server
    and client of this runtime uses; None = the gRPC wire."""

    def __init__(self, config: ConsensusConfig, private_key: int,
                 host: str = "[::]", device: str = "cuda",
                 transport=None):
        self.config = config
        self._private_key = private_key
        self._host = host
        self._device = device
        self.transport = transport if transport is not None \
            else GrpcTransport()
        # Must precede any handler/client construction: method paths are
        # baked in at build time (reference mesh join, src/main.rs:64-73).
        from .rpc import set_proto_compat
        set_proto_compat(config.proto_compat)
        self.metrics = (Metrics(config.metrics_buckets)
                        if config.enable_metrics else None)
        self.recorder = (FlightRecorder(config.flight_recorder_capacity)
                         if config.flight_recorder_capacity > 0 else None)
        # Jaeger span export when the config names an agent (reference
        # src/main.rs:173-175, example/config.toml:14); spans still get
        # context-propagated without it.
        lc = config.log_config
        self.tracer = (JaegerExporter(lc.agent_endpoint,
                                      lc.service_name or "consensus")
                       if lc is not None and lc.agent_endpoint else None)
        # Causal commit tracer (obs/causal.py): per-height critical-path
        # attribution.  Its Jaeger spans ride the same exporter as the
        # engine's — trace ids derive from the height, so every
        # validator's spans for one height join one cross-node trace.
        from ..obs.causal import CommitTracer
        self.causal = CommitTracer(metrics=self.metrics,
                                   exporter=self.tracer)
        self.consensus: Optional[Consensus] = None
        self.sampler = None
        self.straggler = None
        self.anomaly = None
        self.fleet = None
        self.health: Optional[HealthServer] = None
        self.bound_port: Optional[int] = None
        self.metrics_port: Optional[int] = None
        self._server = None
        self._tasks: list = []
        self._stopped = asyncio.Event()

    async def start(self) -> int:
        """Bring the service up; returns the bound consensus port."""
        cfg = self.config
        self.consensus = Consensus(cfg, self._private_key,
                                   tracer=self.tracer,
                                   metrics=self.metrics,
                                   recorder=self.recorder,
                                   causal=self.causal,
                                   transport=self.transport,
                                   device=self._device)
        # Liveness-aware health: NOT_SERVING once the engine's height
        # stalls past the config window (grpc-health-probe in the Docker
        # HEALTHCHECK then fails and the orchestrator restarts us).
        self.health = HealthServer(
            engine=self.consensus.engine,
            stall_window_s=cfg.health_stall_window_s)
        if self.metrics is not None:
            # /statusz sections: live engine position, frontier batch
            # shape, and the flight-recorder tail (newest last).
            engine = self.consensus.engine
            frontier = self.consensus.frontier
            self.metrics.add_status_source("version", lambda: __version__)
            self.metrics.add_status_source("consensus", engine.status)
            self.metrics.add_status_source("health", self.health.status)
            # Causal commit decomposition: rolling commit-latency
            # p50/p99 + critical-path stage shares (obs/causal.py).
            self.metrics.add_status_source("commits", self.causal.statusz)
            # Degraded-mode visibility: breaker state + host-fallback
            # counts, when the provider has a device path to degrade.
            degraded = getattr(self.consensus.crypto, "degraded_status",
                               None)
            if degraded is not None:
                self.metrics.add_status_source("crypto", degraded)
            self.metrics.add_status_source(
                "frontier", lambda: {
                    "requests": frontier.stats.requests,
                    "batches": frontier.stats.batches,
                    "mean_batch": frontier.stats.mean_batch,
                    "max_batch": frontier.stats.max_batch,
                    "failures": frontier.stats.failures,
                    "sheds": frontier.stats.sheds,
                })
            # Per-tenant frontier view (crypto/tenancy.py): queue depth,
            # sheds, occupancy share, p50 queue waits by priority class.
            # One section even single-tenant — the "default" entry is
            # where the bounded-queue shed counters live.
            self.metrics.add_status_source(
                "tenants", frontier.tenants_status)
            if self.recorder is not None:
                recorder = self.recorder
                tail_n = cfg.statusz_tail
                self.metrics.add_status_source(
                    "flightrec", lambda: recorder.tail(tail_n))
            # Device profiling: the staged-round profile ring + mesh
            # gauges, the capture session's state, and the loopback-only
            # /debug/profile?rounds=N trigger (obs/prof.py).
            profiler = self.consensus.profiler
            session = self.consensus.profile_session
            if profiler is not None:
                self.metrics.add_status_source(
                    "profile", lambda: {**profiler.statusz(),
                                        "session": session.status()})
                self.metrics.add_debug_handler(
                    "/debug/profile",
                    lambda q: session.request(int(q.get("rounds", "1"))))
            # Fleet observability (obs/fleet.py + obs/anomaly.py):
            # straggler detection over the per-device stage samples,
            # anomaly alerting over the telemetry series, and the
            # cross-host trend merge — the /statusz "mesh" / "alerts" /
            # "fleet" sections.
            if profiler is not None and cfg.straggler_ratio > 0:
                from ..obs.fleet import StragglerDetector

                self.straggler = StragglerDetector(
                    metrics=self.metrics, recorder=self.recorder,
                    ratio=cfg.straggler_ratio)
                profiler.attach_straggler(self.straggler)
                self.metrics.add_status_source(
                    "mesh", self.straggler.statusz)
            from ..obs.anomaly import AnomalyDetector

            self.anomaly = AnomalyDetector(
                metrics=self.metrics, recorder=self.recorder,
                straggler=self.straggler)
            self.metrics.add_status_source("alerts", self.anomaly.statusz)
            # Mesh resilience: feed a supervisor's ladder the fleet
            # signals and serve it as the /statusz "ladder" section (None
            # on the port: no MeshSupervisor yet, ROADMAP item 14).
            supervisor = self.consensus.supervisor
            if supervisor is not None:
                supervisor.straggler = self.straggler
                supervisor.anomaly = self.anomaly
                self.metrics.add_status_source(
                    "ladder", supervisor.statusz)
        # Soak telemetry: periodic drift snapshots (WAL size, ring
        # churn, RSS, compile-cache ratio, breaker state) into a
        # bounded window; /statusz "trend" serves the deltas so an
        # operator reads drift live instead of post-mortem.  Gated on
        # the sampling knob ALONE (the config contract: <= 0 disables)
        # — with metrics off the counter/occupancy columns are simply
        # absent, but the JSONL sink and ring still run.
        if cfg.telemetry_sample_every_s > 0:
            from ..obs.telemetry import TelemetrySampler, wal_size_bytes

            wal = self.consensus.wal
            recorder = self.recorder
            self.sampler = TelemetrySampler(
                metrics=self.metrics,
                interval_s=cfg.telemetry_sample_every_s,
                out_path=cfg.telemetry_jsonl_path,
                window=cfg.telemetry_window,
                wal_size_fn=lambda: wal_size_bytes(wal),
                recorders_fn=lambda: ([recorder] if recorder else []),
                breaker_status_fn=getattr(self.consensus.crypto,
                                          "degraded_status", None),
                profiler=self.consensus.profiler)
            if self.anomaly is not None:
                self.sampler.add_observer(self.anomaly.observe_sample)
            self.sampler.start()
            if self.metrics is not None:
                self.metrics.add_status_source("trend", self.sampler.trend)
                # Cross-host aggregation: this host's trend + every
                # configured peer's, merged into the "fleet" section
                # (peers empty = the single-process degenerate mode).
                from ..obs.fleet import FleetAggregator

                self.fleet = FleetAggregator(
                    cfg.fleet_host_name, self.sampler.trend,
                    peers=cfg.fleet_peers)
                self.metrics.add_status_source("fleet", self.fleet.statusz)
        interceptors = [TraceContext(exporter=self.tracer)]
        if self.metrics is not None:
            interceptors.append(self.metrics.interceptor())
        self._server, self.bound_port = build_server(
            ConsensusServer(self.consensus), port=cfg.consensus_port,
            interceptors=interceptors, host=self._host,
            compat=cfg.proto_compat, health=self.health,
            transport=self.transport)
        await self._server.start()
        logger.info("%s server on port %d", self.transport.name,
                    self.bound_port)

        # Registration retry loop (reference src/main.rs:186-207).
        while True:
            try:
                code = await self.consensus.network.\
                    register_network_msg_handler(
                        "consensus", "localhost", self.bound_port)
                if code == Code.SUCCESS:
                    break
                logger.warning("network registration status %d", code)
            except Exception as e:  # noqa: BLE001
                logger.warning("network not ready (%s); retrying", e)
            await asyncio.sleep(cfg.server_retry_interval)
        logger.info("registered with network service")

        if self.metrics is not None:
            self.metrics_port = self.metrics.start_exporter(
                cfg.metrics_port, statusz_public=cfg.statusz_public)
            logger.info("metrics exporter on port %d", self.metrics_port)

        self._tasks.append(asyncio.get_running_loop().create_task(
            self._reconfig_wait_then_run()))
        return self.bound_port

    async def _reconfig_wait_then_run(self) -> None:
        """Poll ping_controller until a configuration lands, then run the
        engine (reference src/main.rs:213-246)."""
        consensus = self.consensus
        while consensus.reconfigure is None:
            await consensus.ping_controller()
            if consensus.reconfigure is not None:
                break
            logger.info("waiting for reconfiguration")
            await asyncio.sleep(self.config.server_retry_interval)
        logger.info("start consensus run")
        await consensus.run()

    async def stop(self, grace: float = 2.0) -> None:
        if self.consensus is not None:
            self.consensus.stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks.clear()
        if self._server is not None:
            await self._server.stop(grace)
            self._server = None
        if self.consensus is not None:
            await self.consensus.close()
        if self.sampler is not None:
            self.sampler.stop()
            self.sampler = None
        if self.metrics is not None:
            self.metrics.stop_exporter()
        if self.tracer is not None:
            self.tracer.close()
        self._stopped.set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()


async def run_service(config: ConsensusConfig, private_key: int,
                      device: str = "cuda", transport=None) -> None:
    """Run until SIGINT/SIGTERM (the graceful_shutdown hook,
    reference src/main.rs:167, 272)."""
    runtime = ServiceRuntime(config, private_key, device=device,
                             transport=transport)
    shutdown = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, shutdown.set)
        except NotImplementedError:  # pragma: no cover — non-Unix
            pass
    await runtime.start()
    await shutdown.wait()
    logger.info("shutdown signal received")
    await runtime.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="consensus",
        description=f"consensus_overlord_tpu_torch {__version__} — the "
                    "consensus microservice on an NVIDIA GPU (service "
                    "surface of cita-cloud/consensus_overlord)")
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="run the consensus service")
    run_p.add_argument("-c", "--config", default="config.toml",
                       help="TOML config path (default: config.toml)")
    run_p.add_argument("-p", "--private_key_path", default="private_key",
                       help="hex private-key file (default: private_key)")
    run_p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the cuda crypto backend runs (default: "
                            "cuda; cpu runs each kernel's plain version)")
    args = parser.parse_args(argv)

    if args.command == "run":
        config = ConsensusConfig.load(args.config)
        init_logging(config.log_config)
        private_key = load_private_key(args.private_key_path)
        try:
            transport = GrpcTransport()
        except ImportError as e:
            print(f"consensus: the service listens on gRPC, which needs "
                  f"the grpcio package ({e})", file=sys.stderr)
            return 3
        if (args.device == "cuda" and config.crypto_backend == "cuda"
                and not _cuda_available()):
            print("consensus: --device cuda but no CUDA device is visible "
                  "(pass --device cpu to run the plain kernels)",
                  file=sys.stderr)
            return 3
        asyncio.run(run_service(config, private_key, device=args.device,
                                transport=transport))
        return 0
    return 2


def _cuda_available() -> bool:
    import torch  # noqa: PLC0415

    return torch.cuda.is_available()


if __name__ == "__main__":
    sys.exit(main())
