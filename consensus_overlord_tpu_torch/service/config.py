"""Service configuration: the `[consensus_overlord]` TOML section.

Field names, defaults, and section scoping mirror the reference's config
surface (reference src/config.rs:18-56; example/config.toml), so a
reference deployment's config file drops in unchanged.  Extra
`crypto_backend` / frontier fields configure the device machinery.

The port's own copy of consensus_overlord_tpu/service/config.py.  Its
crypto backends are "cuda" (CudaBlsCrypto on the card, the default) and
"cpu" (the host oracle CpuBlsCrypto); the multi-device mesh (ROADMAP
item 14) and the G2 table MSM (item 11) are not ported, and asking for
either raises at load.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: dict construction still works
    tomllib = None

DEFAULT_METRICS_BUCKETS = [
    0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0, 25.0, 50.0, 75.0, 100.0,
    250.0, 500.0,
]  # reference src/config.rs:43-45


@dataclass
class LogConfig:
    """Nested log settings (reference README.md:58-63)."""

    max_level: str = "info"
    filter: str = "info"
    service_name: str = "consensus"
    rolling_file_path: Optional[str] = None
    agent_endpoint: Optional[str] = None


@dataclass
class ConsensusConfig:
    network_port: int = 50000            # src/config.rs:22 default shape
    consensus_port: int = 50001
    controller_port: int = 50004
    server_retry_interval: int = 1       # seconds (src/config.rs:39)
    wal_path: str = "overlord_wal"       # src/config.rs:40
    enable_metrics: bool = True
    metrics_port: int = 60001
    metrics_buckets: List[float] = field(
        default_factory=lambda: list(DEFAULT_METRICS_BUCKETS))
    domain: str = ""
    log_config: LogConfig = field(default_factory=LogConfig)

    # Device-framework extensions (absent from the reference).
    crypto_backend: str = "cuda"         # "cuda" | "cpu"
    frontier_max_batch: int = 1024
    frontier_linger_ms: float = 2.0
    #: Frontier pending-queue bound (crypto/tenancy.py): verify
    #: requests arriving while this many are already queued shed to the
    #: provider's host-oracle verify path (exact verdicts, counted in
    #: frontier_admission_sheds_total) instead of growing the queue
    #: without limit under a stalled device.  Sized generously (8× the
    #: default max_batch) so a healthy device never sheds.
    frontier_max_pending: int = 8192
    #: Multi-tenant frontier knobs (crypto/tenancy.py SharedFrontier).
    #: The defaults reproduce single-tenant behavior exactly: one
    #: tenant ("default") at weight 1 owns every composed batch, the
    #: queue bound inherits frontier_max_pending (tenant_queue_bound=0
    #: means "inherit"), and priority lanes only reorder WITHIN this
    #: node's own traffic (proposals before votes in one flush).
    tenant_weight: int = 1
    tenant_queue_bound: int = 0
    tenant_priority_lanes: bool = True
    #: Device-resident pairing (crypto/cuda_provider.py): "auto" runs the
    #: Miller loop + shared final exponentiation on the card for a CUDA
    #: device and keeps the host oracle on the CPU;
    #: "on"/"off" force it.  The host oracle stays the breaker-guarded
    #: fallback either way.
    device_pairing: str = "auto"
    #: Crypto dispatch mesh: "off" keeps the single-card kernel set.
    #: The reference's "local" and "global" meshes shard lanes over
    #: several devices; the port has no mesh yet (ROADMAP item 14), so
    #: any other value raises.
    mesh: str = "off"
    #: Serve the verify relation's G2 MSM from per-pubkey precomputed
    #: window tables; not ported (ROADMAP item 11), so True raises.
    g2_table_msm: bool = False
    #: Dispatch watchdog (crypto/cuda_provider.py): deadline in seconds
    #: for each blocking device call, scaled up by batch rung — a
    #: wedged collective becomes a DispatchTimeout breaker failure with
    #: an exact host re-verify instead of blocking the frontier worker
    #: forever.  <= 0 disables the watchdog (unbounded waits).
    dispatch_deadline_s: float = 30.0
    #: Mesh supervisor (parallel/supervisor.py): consecutive device
    #: failures before the escalation ladder steps down one rung
    #: (full mesh -> survivor sub-mesh -> single chip -> host oracle).
    supervisor_step_threshold: int = 3
    #: Consecutive clean dispatches (past the cooldown dwell) before the
    #: supervisor probes one rung back up.
    supervisor_probe_successes: int = 8
    #: Minimum dwell after a step-down before any promotion probe; also
    #: the host_oracle rung's probe-dispatch cadence.
    supervisor_probe_cooldown_s: float = 5.0
    #: Engine flight recorder (obs/flightrec.py): ring capacity in
    #: events; 0 disables recording entirely.
    flight_recorder_capacity: int = 512
    #: Liveness window for the gRPC Health service: once the running
    #: engine's height has not advanced for this many seconds, Health
    #: answers NOT_SERVING (grpc-health-probe → Docker restarts the
    #: container).  <= 0 restores the reference's unconditional SERVING
    #: (src/health_check.rs:29-35).  Size it to several block intervals
    #: plus worst-case view-change backoff.
    health_stall_window_s: float = 60.0
    #: Events served in the /statusz flight-recorder tail (bounded so a
    #: scrape never ships the whole ring).
    statusz_tail: int = 64
    #: torch.profiler captures (obs/prof.py ProfileSession): directory
    #: trace subdirs land in.  None/"" disables capture entirely —
    #: profile_every_n_rounds and /debug/profile then no-op.  The
    #: staged round profiles (crypto_device_stage_seconds + the
    #: /statusz "profile" ring) are independent of this and always on
    #: when metrics are.
    profile_dir: Optional[str] = None
    #: Capture a one-round trace at every Nth consensus round
    #: (0 = only explicit /debug/profile?rounds=N triggers).
    profile_every_n_rounds: int = 0
    #: Per-call records kept in the device-profile ring (served under
    #: /statusz "profile"; bounded like the flight recorder).
    profile_ring_capacity: int = 256
    #: Soak telemetry (obs/telemetry.py TelemetrySampler): snapshot the
    #: process drift axes (WAL size, flight-recorder churn, RSS,
    #: compile-cache ratio, breaker state, occupancy) every N seconds
    #: into a bounded window served as the /statusz "trend" section.
    #: <= 0 disables the sampler entirely.
    telemetry_sample_every_s: float = 30.0
    #: Optional JSONL sink for the telemetry time series (one sample
    #: per line, size-bounded) — the long-soak post-mortem artifact.
    #: None/"" keeps samples in memory only.
    telemetry_jsonl_path: Optional[str] = None
    #: Samples retained in the in-memory window (the /statusz trend
    #: span: window * sample_every seconds of history).
    telemetry_window: int = 512
    #: /statusz + /debug/vars answer loopback clients only unless this is
    #: set: they expose live consensus position and the flight-recorder
    #: tail, which is reconnaissance material on a routable host.
    #: /metrics stays reachable either way (fleet Prometheus scrapes).
    statusz_public: bool = False
    #: Straggler detection (obs/fleet.py StragglerDetector): flag a
    #: device whose rolling-median stage time exceeds the mesh median
    #: by this ratio; served under /statusz "mesh".  <= 0 disables the
    #: detector entirely.
    straggler_ratio: float = 1.5
    #: Cross-host telemetry aggregation (obs/fleet.py FleetAggregator):
    #: peer metrics endpoints ("host:port") whose /statusz trend blocks
    #: host 0 merges into the /statusz "fleet" section.  Empty = the
    #: single-process degenerate mode (the section still renders, over
    #: this host's trend alone).
    fleet_peers: tuple = ()
    #: This host's row label in the "fleet" section.
    fleet_host_name: str = "local"
    #: gRPC method-path namespace: "native" serves/dials
    #: consensus_overlord_tpu.* paths; "cita_cloud" uses the reference
    #: mesh's cita_cloud_proto package names (src/main.rs:64-73) so this
    #: node can register with a reference network/controller pair.
    proto_compat: str = "native"         # "native" | "cita_cloud"

    def __post_init__(self) -> None:
        """Validate the frontier/tenancy knobs at construction — a bad
        value should fail the process at config load, not deadlock the
        frontier at the first saturated flush."""
        if self.frontier_max_batch < 1:
            raise ValueError(
                f"frontier_max_batch must be >= 1, got "
                f"{self.frontier_max_batch}")
        if self.frontier_linger_ms < 0:
            raise ValueError(
                f"frontier_linger_ms must be >= 0, got "
                f"{self.frontier_linger_ms}")
        if self.frontier_max_pending < self.frontier_max_batch:
            raise ValueError(
                f"frontier_max_pending ({self.frontier_max_pending}) must "
                f"be >= frontier_max_batch ({self.frontier_max_batch}) — "
                "a bound below one batch sheds traffic a single flush "
                "could have carried")
        if self.tenant_weight < 1:
            raise ValueError(
                f"tenant_weight must be >= 1, got {self.tenant_weight}")
        if self.tenant_queue_bound < 0:
            raise ValueError(
                f"tenant_queue_bound must be >= 0 (0 inherits "
                f"frontier_max_pending), got {self.tenant_queue_bound}")
        if 0 < self.tenant_queue_bound < self.frontier_max_batch:
            # Same degenerate state the frontier_max_pending check
            # rejects: this knob OVERRIDES it as the effective bound.
            raise ValueError(
                f"tenant_queue_bound ({self.tenant_queue_bound}) must be "
                f">= frontier_max_batch ({self.frontier_max_batch}) — a "
                "bound below one batch sheds traffic a single flush "
                "could have carried")
        if self.device_pairing not in ("auto", "on", "off"):
            raise ValueError(
                f"device_pairing must be auto|on|off, got "
                f"{self.device_pairing!r} (a typo here would silently "
                "keep the pairing on the host)")
        if self.crypto_backend not in ("cuda", "cpu"):
            raise ValueError(
                f"crypto_backend must be cuda|cpu, got "
                f"{self.crypto_backend!r} (this is the PyTorch/CUDA "
                "port: \"cuda\" runs the TPU backend's work on the card)")
        if self.mesh != "off":
            raise ValueError(
                f"mesh must be off, got {self.mesh!r}: the multi-GPU "
                "mesh is not ported (ROADMAP item 14)")
        if self.g2_table_msm:
            raise ValueError(
                "g2_table_msm = true: the G2 table MSM is not ported "
                "(ROADMAP item 11)")
        if self.supervisor_step_threshold < 1:
            raise ValueError(
                f"supervisor_step_threshold must be >= 1, got "
                f"{self.supervisor_step_threshold} — the ladder would "
                "step down on every single failure or never")
        if self.supervisor_probe_successes < 1:
            raise ValueError(
                f"supervisor_probe_successes must be >= 1, got "
                f"{self.supervisor_probe_successes}")
        if self.supervisor_probe_cooldown_s < 0:
            raise ValueError(
                f"supervisor_probe_cooldown_s must be >= 0, got "
                f"{self.supervisor_probe_cooldown_s}")
        if 0 < self.straggler_ratio < 1:
            raise ValueError(
                f"straggler_ratio must be >= 1 (or <= 0 to disable), "
                f"got {self.straggler_ratio} — a sub-1 ratio flags "
                "every device below the median")

    @property
    def device_pairing_flag(self) -> Optional[bool]:
        """The CudaBlsCrypto ctor form: None = auto (device-dependent),
        True/False = forced."""
        return {"auto": None, "on": True, "off": False}[self.device_pairing]

    @property
    def effective_tenant_queue_bound(self) -> int:
        """The per-tenant bound actually applied: tenant_queue_bound,
        or frontier_max_pending when left at 0 ("inherit")."""
        return self.tenant_queue_bound or self.frontier_max_pending

    @classmethod
    def load(cls, path: str,
             section: str = "consensus_overlord") -> "ConsensusConfig":
        """Read one named TOML section with per-field defaults (the
        reference's read_toml + serde-default shape, src/config.rs:52-56)."""
        if tomllib is None:
            raise RuntimeError(
                "TOML config loading requires Python >= 3.11 (tomllib); "
                "construct ConsensusConfig directly or via from_dict()")
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        table = doc.get(section, {})
        return cls.from_dict(table)

    @classmethod
    def from_dict(cls, table: dict) -> "ConsensusConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in table.items():
            if key not in known:
                continue  # unknown keys ignored, serde-style
            if key == "log_config" and isinstance(value, dict):
                log_known = {f.name for f in dataclasses.fields(LogConfig)}
                value = LogConfig(**{k: v for k, v in value.items()
                                     if k in log_known})
            kwargs[key] = value
        return cls(**kwargs)
