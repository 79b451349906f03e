"""The port's consensus microservice (consensus_overlord_tpu_torch/service
and sim/grpc_fakes.py) on the CPU, held against the JAX package's
service: the hand-written messages byte for byte against the generated
pb2 module, the config against the reference's on the same TOML, and
twins of tests/test_service.py's end-to-end runs on both transports —
four nodes committing height 2 over the gRPC wire (crypto_backend "cpu")
and over LoopbackTransport with node 0 on CudaBlsCrypto's CPU twin
(every kernel's plain version), CheckBlock on the committed proof and a
tampered one, the NotReady / module-guard / health gates, and the
cita_cloud method paths.  Then the service without jax, grpc,
prometheus_client or google.protobuf in a subprocess, and chip_smoke.py's
service phase at 4 validators.  Tolerance: none (bytes, codes and
verdicts)."""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from consensus_overlord_tpu.service.config import (
    ConsensusConfig as RefConfig)
from consensus_overlord_tpu.service.pb import pb2 as ref_pb2
from consensus_overlord_tpu_torch.crypto.cuda_provider import CudaBlsCrypto
from consensus_overlord_tpu_torch.crypto.provider import CpuBlsCrypto
from consensus_overlord_tpu_torch.service.config import ConsensusConfig
from consensus_overlord_tpu_torch.service.consensus import Consensus, _make_crypto
from consensus_overlord_tpu_torch.service.main import ServiceRuntime
from consensus_overlord_tpu_torch.service.pb import pb2
from consensus_overlord_tpu_torch.service.rpc import (
    CONSENSUS_SERVICE, HEALTH_SERVICE, NETWORK_MSG_HANDLER_SERVICE, Code,
    GrpcTransport, LoopbackTransport, RetryClient, RpcError,
    full_service_name, generic_handler, set_proto_compat)
from consensus_overlord_tpu_torch.service.server import (
    ConsensusServer, build_server)
from consensus_overlord_tpu_torch.sim.grpc_fakes import (
    FakeController, NetworkFabric, start_fake_controller, start_fake_network)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NODES = 4
KEYS = [0x5EED + 31 * i for i in range(N_NODES)]
TRANSPORTS = {"grpc": GrpcTransport, "loopback": LoopbackTransport}


# -- messages -------------------------------------------------------------------

MESSAGES = ["Empty", "StatusCode", "Proposal", "ProposalResponse",
            "ProposalWithProof", "ConsensusConfiguration",
            "ConsensusConfigurationResponse", "NetworkMsg", "RegisterInfo",
            "HealthCheckRequest", "HealthCheckResponse"]


def _value(kind, sub, rng, depth):
    """A seeded field value as (port value, reference value); defaults
    (0, empty) come up often, so omission is exercised too."""
    zero = rng.random() < 0.25
    if kind == "uint32":
        v = 0 if zero else int(rng.integers(0, 2**32, dtype=np.uint64))
    elif kind == "uint64":
        v = 0 if zero else int(rng.integers(0, 2**64, dtype=np.uint64))
    elif kind == "enum":
        v = int(rng.integers(0, 3))
    elif kind == "bytes":
        v = b"" if zero else rng.bytes(int(rng.integers(1, 200)))
    elif kind == "string":
        v = "" if zero else "".join(
            chr(int(c)) for c in rng.integers(32, 0x3000,
                                              int(rng.integers(1, 20))))
    elif kind == "repeated_bytes":
        v = [rng.bytes(int(rng.integers(0, 60)))
             for _ in range(int(rng.integers(0, 5)))]
    else:
        return _message(sub.__name__, rng, depth + 1)
    return v, v


def _message(name, rng, depth=0):
    cls, ref_cls = getattr(pb2, name), getattr(ref_pb2, name)
    port_kw, ref_kw = {}, {}
    for _, field, kind, sub in cls._FIELDS:
        if kind == "message" and rng.random() < 0.3:
            continue  # an unset nested message
        port_kw[field], ref_kw[field] = _value(kind, sub, rng, depth)
    return cls(**port_kw), ref_cls(**ref_kw)


@pytest.mark.parametrize("name", MESSAGES)
def test_messages_serialize_as_the_generated_module(name):
    """Seeded field values: the port's bytes equal pb2's, each parses the
    other's bytes to an equal message, and nested-message presence
    agrees."""
    rng = np.random.default_rng(MESSAGES.index(name) + 8)
    for _ in range(40):
        msg, ref = _message(name, rng)
        data = msg.SerializeToString()
        assert data == ref.SerializeToString()
        assert ref_pb2.__dict__[name].FromString(data) == ref
        back = getattr(pb2, name).FromString(ref.SerializeToString())
        assert back == msg and back.SerializeToString() == data
        for _, field, kind, _ in msg._FIELDS:
            if kind == "message":
                assert back.HasField(field) == ref.HasField(field)


def test_message_wire_details():
    """The issue's example bytes, unknown fields skipped, nested
    defaults, the enum's names and malformed input."""
    msg = pb2.NetworkMsg(module="consensus", type="x", origin=3, msg=b"ab")
    assert msg.SerializeToString() == b'\n\tconsensus\x12\x01x\x18\x03"\x02ab'
    # field 9 (varint), 10 (length), 11 (fixed64), 12 (fixed32): skipped
    extra = (b"\x48\x05" + b"\x52\x02zz" + b"\x59" + b"\x00" * 8
             + b"\x65" + b"\x00" * 4)
    assert pb2.StatusCode.FromString(extra + b"\x08\x04").code == 4
    resp = pb2.ConsensusConfigurationResponse()
    assert not resp.HasField("config") and resp.config.height == 0
    assert pb2.HealthCheckResponse.ServingStatus.Name(2) == "NOT_SERVING"
    assert pb2.HealthCheckResponse.SERVING == \
        ref_pb2.HealthCheckResponse.SERVING
    for bad in (b"\x08", b"\x12\x05ab", b"\x0f"):
        with pytest.raises(pb2.DecodeError):
            pb2.Proposal.FromString(bad)


# -- config ---------------------------------------------------------------------

_TOML = """
[consensus_overlord]
network_port = 51230
consensus_port = 51231
controller_port = 51234
server_retry_interval = 3
wal_path = "/var/lib/overlord_wal"
enable_metrics = false
metrics_port = 61234
metrics_buckets = [1.0, 2.0, 8.0]
domain = "chain.example"
crypto_backend = "cpu"
frontier_max_batch = 512
frontier_linger_ms = 7.5
frontier_max_pending = 4096
tenant_weight = 3
tenant_queue_bound = 1024
tenant_priority_lanes = false
device_pairing = "on"
dispatch_deadline_s = 12.5
flight_recorder_capacity = 128
health_stall_window_s = 90.0
statusz_tail = 16
profile_dir = "/tmp/profiles"
profile_every_n_rounds = 10
telemetry_sample_every_s = 2.0
statusz_public = true
straggler_ratio = 2.0
fleet_peers = ["10.0.0.2:60001", "10.0.0.3:60001"]
fleet_host_name = "host-a"
proto_compat = "cita_cloud"
not_a_field = 1

[consensus_overlord.log_config]
max_level = "debug"
filter = "warn"
service_name = "overlord"
rolling_file_path = "/var/log/overlord.log"
agent_endpoint = "127.0.0.1:6831"
"""


def test_config_loads_the_reference_fields_from_toml(tmp_path):
    path = tmp_path / "config.toml"
    path.write_text(_TOML)
    got = dataclasses.asdict(ConsensusConfig.load(str(path)))
    want = dataclasses.asdict(RefConfig.load(str(path)))
    assert got == want
    defaults = dataclasses.asdict(ConsensusConfig())
    ref_defaults = dataclasses.asdict(RefConfig())
    assert defaults.pop("crypto_backend") == "cuda"
    assert ref_defaults.pop("crypto_backend") == "tpu"
    assert defaults == ref_defaults


@pytest.mark.parametrize("fields, match", [
    ({"crypto_backend": "tpu"}, '"cuda"'),
    ({"mesh": "ici"}, "off\\|local\\|global"),
    ({"mesh": "GLOBAL"}, "off\\|local\\|global"),
    ({"frontier_max_batch": 0}, "frontier_max_batch"),
    ({"device_pairing": "maybe"}, "device_pairing"),
    ({"straggler_ratio": 0.5}, "straggler_ratio"),
])
def test_config_refuses(fields, match):
    with pytest.raises(ValueError, match=match):
        ConsensusConfig.from_dict(fields)
    if "crypto_backend" not in fields:
        with pytest.raises(ValueError):
            RefConfig.from_dict(fields)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_config_accepts_the_mesh_modes(mode):
    """The reference's mesh modes load as its config does, and
    _make_crypto builds the provider over _make_mesh's lanes: on the CPU
    one lane, so the single-card kernel set, with a MeshSupervisor
    attached by the service."""
    config = ConsensusConfig.from_dict({"mesh": mode})
    assert config.mesh == RefConfig.from_dict({"mesh": mode}).mesh == mode
    crypto = _make_crypto("cuda", 0x5EED, config, device="cpu")
    assert crypto._kernels.lanes == 1
    assert crypto.mesh_device_names() == []
    assert crypto._current_lane_names() == ["cpu:0"]


@pytest.mark.parametrize("on", [True, False])
def test_config_g2_table_msm_reaches_the_provider(on):
    """The config takes g2_table_msm as the reference's does, and
    _make_crypto hands it to CudaBlsCrypto (the G2 table MSM, ROADMAP
    item 11)."""
    config = ConsensusConfig.from_dict({"g2_table_msm": on})
    assert config.g2_table_msm is on
    assert RefConfig.from_dict({"g2_table_msm": on}).g2_table_msm is on
    crypto = _make_crypto("cuda", 0x5EED, config, device="cpu")
    assert crypto._use_g2_tables is on
    assert crypto.degraded_status()["g2_table_msm"] is on


# -- the service end to end -----------------------------------------------------


async def _siblings(transport, validators, block_interval):
    fabric = NetworkFabric(transport)
    fabric.set_validators(validators)
    controller = FakeController(validators, block_interval=block_interval,
                                transport=transport)
    ctrl_server, ctrl_port = await start_fake_controller(controller)
    return fabric, controller, ctrl_server, ctrl_port


async def _check_block(addr, transport, controller, height, timeout=10.0):
    client = RetryClient(addr, "ConsensusService", CONSENSUS_SERVICE,
                         retries=1, transport=transport)
    try:
        good = pb2.ProposalWithProof(
            proposal=pb2.Proposal(height=height,
                                  data=controller.chain[height]),
            proof=controller.proofs[height])
        bad = pb2.ProposalWithProof(
            proposal=pb2.Proposal(height=height,
                                  data=controller.chain[height] + b"x"),
            proof=controller.proofs[height])
        return ((await client.call("CheckBlock", good, timeout)).code,
                (await client.call("CheckBlock", bad, timeout)).code)
    finally:
        await client.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read()


def test_four_node_grpc_consensus():
    """Twin of tests/test_service.py test_four_node_grpc_consensus on the
    gRPC wire: four ServiceRuntimes (crypto_backend "cpu"), four fake
    network siblings and one fake controller commit height 2; the
    committed proof passes CheckBlock, a tampered one fails; node 0's
    exporter serves the RPC and hot-path families and /statusz."""

    async def main():
        transport = GrpcTransport()
        validators = [CpuBlsCrypto(k).pub_key for k in KEYS]
        fabric, controller, ctrl_server, ctrl_port = await _siblings(
            transport, validators, 1)
        servers, runtimes = [ctrl_server], []
        tmp = tempfile.TemporaryDirectory()
        try:
            for i in range(N_NODES):
                net_server, net_port = await start_fake_network(fabric, i)
                servers.append(net_server)
                config = ConsensusConfig(
                    network_port=net_port, consensus_port=0,
                    controller_port=ctrl_port, server_retry_interval=1,
                    wal_path=f"{tmp.name}/wal{i}", enable_metrics=(i == 0),
                    metrics_port=0, crypto_backend="cpu")
                rt = ServiceRuntime(config, KEYS[i], host="localhost",
                                    transport=transport)
                port = await rt.start()
                controller.consensus_addrs.append(f"localhost:{port}")
                runtimes.append(rt)
            await controller.wait_for_height(2, timeout=120)
            assert await _check_block(
                f"localhost:{runtimes[0].bound_port}", transport,
                controller, 1) == (Code.SUCCESS, Code.PROPOSAL_CHECK_ERROR)
            port = runtimes[0].metrics_port
            body = await asyncio.to_thread(
                _get, f"http://localhost:{port}/metrics")
            for family in (b"grpc_server_handling_ms", b"ProcessNetworkMsg",
                           b"frontier_batch_size_count",
                           b"wal_append_ms_count",
                           b"consensus_commit_latency_seconds_count"):
                assert family in body, family
            status = json.loads(await asyncio.to_thread(
                _get, f"http://localhost:{port}/statusz"))
            assert status["consensus"]["height"] >= 1
            assert {"round", "leader"} <= set(status["consensus"])
            assert status["commits"]["commits"] >= 1
            assert "enter_round" in [e["kind"] for e in status["flightrec"]]
            assert any(rt.consensus.frontier.stats.batches > 0
                       for rt in runtimes)
        finally:
            for rt in runtimes:
                await rt.stop(0.5)
            for server in servers:
                await server.stop(0.5)
            await controller.close()
            await fabric.close()
            tmp.cleanup()

    asyncio.run(main())


def test_four_node_loopback_consensus_on_the_cuda_twin():
    """The same run over LoopbackTransport, node 0 built as a Consensus
    with an injected CudaBlsCrypto(device="cpu", thresholds 1) served by
    a ConsensusServer: its pubkeys, QC paths and CheckBlock run the
    kernels' plain versions, and its verdicts are exact."""
    torch.set_num_threads(1)

    async def main():
        transport = LoopbackTransport()
        validators = [CpuBlsCrypto(k).pub_key for k in KEYS]
        fabric, controller, ctrl_server, ctrl_port = await _siblings(
            transport, validators, 1)
        servers, runtimes, task = [ctrl_server], [], None
        prov = CudaBlsCrypto(KEYS[0], device="cpu", device_threshold=1,
                             qc_device_threshold=1)
        tmp = tempfile.TemporaryDirectory()
        try:
            for i in range(N_NODES):
                net_server, net_port = await start_fake_network(fabric, i)
                servers.append(net_server)
                config = ConsensusConfig(
                    network_port=net_port, consensus_port=0,
                    controller_port=ctrl_port, server_retry_interval=1,
                    wal_path=f"{tmp.name}/wal{i}", enable_metrics=False,
                    crypto_backend="cpu", frontier_linger_ms=100.0)
                if i:
                    rt = ServiceRuntime(config, KEYS[i], host="localhost",
                                        transport=transport)
                    port = await rt.start()
                    runtimes.append(rt)
                else:
                    node0 = Consensus(config, KEYS[0], crypto=prov,
                                      transport=transport)
                    server, port = build_server(
                        ConsensusServer(node0), host="localhost",
                        transport=transport)
                    await server.start()
                    servers.insert(0, server)
                    assert await node0.network.register_network_msg_handler(
                        "consensus", "localhost", port) == Code.SUCCESS
                    while node0.reconfigure is None:
                        await node0.ping_controller()
                    task = asyncio.get_running_loop().create_task(
                        node0.run())
                controller.consensus_addrs.append(f"localhost:{port}")
            await controller.wait_for_height(2, timeout=120)
            # Quiet the fleet first: node 0's frontier verifies every vote
            # batch on the plain kernels, and CheckBlock queues behind it.
            for rt in runtimes:
                rt.consensus.stop()
            node0.stop()
            before = prov.degraded_status()["calls"]["verify_aggregated"]
            assert await _check_block(
                controller.consensus_addrs[0], transport, controller,
                1, timeout=60.0) == (Code.SUCCESS, Code.PROPOSAL_CHECK_ERROR)
            st = prov.degraded_status()
            # (+1 at least: a QC verify the stopped engine had queued may
            # still land.)
            assert st["calls"]["verify_aggregated"]["device"] >= \
                before["device"] + 1
            assert st["pubkey_updates"] == {"device": 1, "host": 0}
            for path in ("verify_batch", "aggregate", "verify_aggregated"):
                assert st["calls"][path]["host"] == 0, st
            assert st["calls"]["verify_batch"]["device"] >= 1
            assert st["total_failures"] == 0
            assert node0.frontier.stats.device_faults == 0
        finally:
            node0.stop()
            if task is not None:
                task.cancel()
            for rt in runtimes:
                await rt.stop(0.5)
            for server in servers:
                await server.stop(0.5)
            await node0.close()
            await controller.close()
            await fabric.close()
            tmp.cleanup()

    asyncio.run(main())


@pytest.mark.parametrize("wire", sorted(TRANSPORTS))
def test_not_ready_module_guard_health(wire):
    """Twin of tests/test_service.py test_not_ready_module_guard_health:
    before any reconfiguration CheckBlock → NOT_READY; a foreign module →
    INVALID_ARGUMENT (RpcError on either transport); a garbage payload is
    dropped with SUCCESS; Health → SERVING."""

    async def main():
        transport = TRANSPORTS[wire]()
        fabric = NetworkFabric(transport)
        net_server, net_port = await start_fake_network(fabric, 0)
        tmp = tempfile.TemporaryDirectory()
        config = ConsensusConfig(
            network_port=net_port, consensus_port=0,
            controller_port=1,  # nothing listens: stays NotReady
            server_retry_interval=1, wal_path=f"{tmp.name}/wal",
            enable_metrics=False, crypto_backend="cpu")
        rt = ServiceRuntime(config, 0xABCDEF, host="localhost",
                            transport=transport)
        clients = []
        try:
            addr = f"localhost:{await rt.start()}"
            cons, net, health = clients[:] = [
                RetryClient(addr, name, methods, retries=1,
                            transport=transport)
                for name, methods in (
                    ("ConsensusService", CONSENSUS_SERVICE),
                    ("NetworkMsgHandlerService",
                     NETWORK_MSG_HANDLER_SERVICE),
                    ("Health", HEALTH_SERVICE))]
            resp = await cons.call("CheckBlock", pb2.ProposalWithProof(
                proposal=pb2.Proposal(height=1, data=b"x"), proof=b""))
            assert resp.code == Code.NOT_READY
            with pytest.raises(RpcError) as err:
                await net.call("ProcessNetworkMsg", pb2.NetworkMsg(
                    module="storage", type="SignedVote", msg=b""))
            assert err.value.code == "INVALID_ARGUMENT"
            resp = await net.call("ProcessNetworkMsg", pb2.NetworkMsg(
                module="consensus", type="SignedVote", msg=b"\xff\xff"))
            assert resp.code == Code.SUCCESS
            resp = await health.call("Check",
                                     pb2.HealthCheckRequest(service=""))
            assert resp.status == pb2.HealthCheckResponse.SERVING
        finally:
            for c in clients:
                await c.close()
            await rt.stop(0.5)
            await net_server.stop(0.5)
            await fabric.close()
            tmp.cleanup()

    asyncio.run(main())


@pytest.mark.parametrize("wire", sorted(TRANSPORTS))
def test_cita_cloud_method_paths_round_trip(wire):
    """Twin of tests/test_service.py ProtoCompat: in cita_cloud mode the
    served and dialed paths are the reference mesh's names, a compat
    client round-trips, the literal path answers on the raw channel, and
    the native path is not served (UNIMPLEMENTED)."""

    class _Health:
        async def check(self, request, context):
            return pb2.HealthCheckResponse(
                status=pb2.HealthCheckResponse.SERVING)

    async def main():
        transport = TRANSPORTS[wire]()
        set_proto_compat("cita_cloud")
        try:
            assert full_service_name("ConsensusService") == \
                "consensus.ConsensusService"
            assert full_service_name("NetworkService") == \
                "network.NetworkService"
            assert full_service_name("Consensus2ControllerService") == \
                "controller.Consensus2ControllerService"
            assert full_service_name("Health") == "grpc.health.v1.Health"
            server, port = transport.server(
                (generic_handler("Health", HEALTH_SERVICE, _Health()),),
                port=0, host="127.0.0.1")
            await server.start()
            addr = f"127.0.0.1:{port}"
            client = RetryClient(addr, "Health", HEALTH_SERVICE, retries=1,
                                 transport=transport)
            chan = transport.channel(addr)
            try:
                resp = await client.call(
                    "Check", pb2.HealthCheckRequest(service=""))
                assert resp.status == pb2.HealthCheckResponse.SERVING
                raw = await chan.unary(
                    "/grpc.health.v1.Health/Check",
                    pb2.HealthCheckRequest(service="").SerializeToString(),
                    5.0)
                assert pb2.HealthCheckResponse.FromString(raw).status == \
                    pb2.HealthCheckResponse.SERVING
                with pytest.raises(RpcError) as err:
                    await chan.unary("/consensus_overlord_tpu.Health/Check",
                                     b"", 5.0)
                assert err.value.code == "UNIMPLEMENTED"
            finally:
                await client.close()
                await chan.close()
                await server.stop(0.5)
        finally:
            set_proto_compat("native")
        assert full_service_name("Health") == "consensus_overlord_tpu.Health"

    asyncio.run(main())


# -- without the wire's packages ------------------------------------------------

_BLOCKED = ("jax", "grpc", "prometheus_client", "google.protobuf")

_SMOKE_PHASE = """
import asyncio, json, sys
for m in {blocked!r}:
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
import chip_smoke
from consensus_overlord_tpu_torch.obs import logctx, metrics
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.service.main import main as cli

transport = chip_smoke.service_transport()
print("TRANSPORT", transport.name)
doc = asyncio.run(chip_smoke.drive_service(
    kernels, 4, "cpu", transport, 1, 1, 1, 60.0,
    chip_smoke.SERVICE_LINGER_MS))
print("REPORT", json.dumps(chip_smoke.service_report(doc, 4, 1)))
print("CLI", cli(["run", "-c", sys.argv[1], "-p", sys.argv[2]]))
for name in ("TraceContextInterceptor", "MetricsInterceptor"):
    try:
        getattr(logctx if name[0] == "T" else metrics, name)
    except ImportError:
        print("NO", name)
print("LOADED", sorted(m for m, v in sys.modules.items()
      if v is not None and (m.split(".")[0] in
      ("jax", "jaxlib", "grpc", "prometheus_client",
       "consensus_overlord_tpu") or m.startswith("google.protobuf"))))
"""


def _python(code, *args):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_smoke_service_phase_without_jax_grpc_prometheus_or_protobuf(
        tmp_path):
    """chip_smoke.py's service phase at 4 validators on CudaBlsCrypto's
    CPU twin, in a subprocess with jax, grpc, prometheus_client and
    google.protobuf blocked: the phase falls back to LoopbackTransport,
    the heights commit, every CheckBlock verdict is exact, node 0 serves
    /metrics and its /statusz sections, and the phase's checks name what
    ran on the host (4 keys and 3-voter QCs sit below the service's
    device threshold of 32).  The grpc interceptors are the only names
    that need grpc, and `service.main run`, which listens on gRPC,
    exits 3 naming grpcio."""
    out = _python(_SMOKE_PHASE.format(blocked=list(_BLOCKED)),
                  *_cli_files(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "grpcio" in out.stderr
    lines = dict(line.split(" ", 1) for line in
                 out.stdout.strip().splitlines()
                 if line.split(" ", 1)[0] in ("TRANSPORT", "REPORT", "CLI",
                                              "LOADED"))
    assert lines["TRANSPORT"] == "loopback" and lines["CLI"] == "3"
    assert lines["LOADED"] == "[]"
    assert out.stdout.count("NO ") == 2
    report = json.loads(lines["REPORT"])
    assert report["transport"] == "loopback" and report["committed"] >= 2
    assert report["check_block"]["wrong"] == []
    assert report["check_block"]["calls"] == 3
    assert report["check_block"]["on"] == {"device": 0, "host": 2}
    assert report["update_pubkeys"] == {"device": 0, "host": 4}
    assert report["surface"]["commit_latency_seconds"]
    assert set(chip_smoke.SERVICE_SECTIONS) <= set(
        report["surface"]["sections"])
    assert report["breaker_failures"] == report["device_faults"] == 0
    bad = chip_smoke.service_failures(report)
    assert [b.split(":")[0].split(" ran")[0] for b in bad] == [
        "the measured heights never launched ['fq_mul', 'g1_add', "
        "'g2_add', 'miller_product', 'final_exp', 'fq_inv']",
        "update_pubkeys",
        "aggregate",
        "qc_verify", "CheckBlock's signature checks did not run on the card"]


def test_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    """`service.main run --device cuda` (the default) exits non-zero where
    no card is visible: there is no quiet move to the CPU."""
    from consensus_overlord_tpu_torch.service import main as service_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, key = _cli_files(tmp_path)
    assert service_main.main(["run", "-c", cfg, "-p", key]) == 3


def _cli_files(tmp_path):
    (tmp_path / "config.toml").write_text(
        "[consensus_overlord]\ncrypto_backend = \"cuda\"\n")
    (tmp_path / "key").write_text("0x5eed\n")
    return str(tmp_path / "config.toml"), str(tmp_path / "key")


# -- chip_smoke.py's service phase ----------------------------------------------


def test_smoke_service_failures_pass_a_clean_run():
    """service_failures is empty for a run that kept every path on the
    card, and names each fault the phase must fail on."""
    clean = {"launches": {k: 3 for k in chip_smoke.SERVICE_KERNELS},
             "breaker_failures": 0, "pairing_host_fallbacks": 0,
             "reverified": 0, "device_faults": 0,
             "update_pubkeys": {"device": 64, "host": 0},
             "aggregate": {"device": 6, "host": 0},
             "qc_verify": {"device": 384, "host": 0},
             "check_block": {"calls": 9, "signature_checks": 6,
                             "wrong": [],
                             "on": {"device": 6, "host": 0}},
             "surface": {"commit_latency_seconds": True,
                         "sections": list(chip_smoke.SERVICE_SECTIONS)}}
    assert chip_smoke.service_failures(clean) == []
    faults = [("device_faults", 1), ("pairing_host_fallbacks", 1),
              ("reverified", 1), ("breaker_failures", 2)]
    for key, value in faults:
        assert key in chip_smoke.service_failures({**clean, key: value})[0]
    wrong = {**clean, "check_block": {**clean["check_block"],
                                      "wrong": [{"height": 2}]}}
    assert "wrong CheckBlock" in chip_smoke.service_failures(wrong)[0]
    stale = {**clean, "surface": {"commit_latency_seconds": False,
                                  "sections": ["crypto"]}}
    assert len(chip_smoke.service_failures(stale)) == 2
