"""The provider protocol, the host BLS12-381 provider (CPU oracle) and
the provider error type.

The pieces of consensus_overlord_tpu/crypto/provider.py this port needs,
kept as its own copy: `CryptoProvider` (what the engine needs from a
crypto backend: the Overlord `Crypto` trait surface, reference
src/consensus.rs:385-463), `CryptoError` (reference error.rs:20-44
`ConsensusError::CryptoErr`) and `CpuBlsCrypto`, the reference-faithful
min-sig provider whose per-signature verify is the exact fallback of the
device paths.  The simulation-grade providers the sim fleet runs on
(`SimHashCrypto`, `Ed25519Crypto` where the `cryptography` package is
importable, `sim_crypto`) and `SimDeviceCrypto`, the simulated device
path with a circuit breaker that the sim wraps around breaker-less
providers, are copied too.
"""

from __future__ import annotations

import time
from typing import List, Protocol, Sequence, runtime_checkable

from ..core.sm3 import sm3_hash
from . import bls12381 as bls


class CryptoError(Exception):
    """Crypto failure (reference error.rs:20-44 `ConsensusError::CryptoErr`)."""


@runtime_checkable
class CryptoProvider(Protocol):
    """What the engine needs from a crypto backend."""

    @property
    def pub_key(self) -> bytes:
        """This node's identity: serialized public key bytes, doubling as its
        validator address (reference src/consensus.rs:352-357)."""
        ...

    def hash(self, data: bytes) -> bytes: ...

    def sign(self, hash32: bytes) -> bytes: ...

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool: ...

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes: ...

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool: ...


def load_private_key(path: str) -> int:
    """Read a hex-encoded 32-byte scalar (reference src/consensus.rs:348-350,
    example/private_key)."""
    with open(path, "r", encoding="utf-8") as f:
        hex_str = f.read().strip()
    if hex_str.startswith("0x"):
        hex_str = hex_str[2:]
    return int(hex_str, 16)


class CpuBlsCrypto:
    """Reference-faithful BLS12-381 min-sig provider (CPU oracle).

    `common_ref` is the signing domain string — "" in the reference
    (src/consensus.rs:351)."""

    def __init__(self, private_key: int, common_ref: bytes = b""):
        self._sk = private_key % bls.R
        if self._sk == 0:
            raise CryptoError("private key is zero mod r")
        self._common_ref = common_ref
        self._pk = bls.sk_to_pk(self._sk)

    @property
    def pub_key(self) -> bytes:
        return self._pk

    def hash(self, data: bytes) -> bytes:
        return sm3_hash(data)

    def sign(self, hash32: bytes) -> bytes:
        return bls.sign(self._sk, hash32, self._common_ref)

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        return bls.verify(voter, hash32, signature, self._common_ref)

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        # Length check mirrors reference src/consensus.rs:424-429.
        if len(signatures) != len(voters):
            raise CryptoError(
                f"signatures x voters length mismatch "
                f"{len(signatures)} x {len(voters)}")
        try:
            return bls.aggregate_signatures(signatures)
        except ValueError as e:
            raise CryptoError(str(e)) from e

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        return bls.aggregate_verify_same_message(
            voters, hash32, agg_sig, self._common_ref)

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        """Per-signature loop (the device provider batches this)."""
        return [self.verify_signature(s, h, v)
                for s, h, v in zip(signatures, hashes, voters)]


class Ed25519Crypto:
    """Fast host-CPU provider for large simulations (Ed25519 via the
    `cryptography` package).  Aggregation is concatenation + per-signature
    verification — crypto-agility for fleets where pairing cost would mask
    the engine behavior under test.  Addresses are 32-byte Ed25519 pubkeys."""

    SIG_LEN = 64

    def __init__(self, seed32: bytes):
        from cryptography.hazmat.primitives.asymmetric import ed25519

        self._ed25519 = ed25519
        self._sk = ed25519.Ed25519PrivateKey.from_private_bytes(seed32)
        from cryptography.hazmat.primitives import serialization

        self._pk = self._sk.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    @property
    def pub_key(self) -> bytes:
        return self._pk

    def hash(self, data: bytes) -> bytes:
        return sm3_hash(data)

    def sign(self, hash32: bytes) -> bytes:
        return self._sk.sign(hash32)

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        try:
            pk = self._ed25519.Ed25519PublicKey.from_public_bytes(bytes(voter))
            pk.verify(bytes(signature), bytes(hash32))
            return True
        except Exception:
            return False

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        if len(signatures) != len(voters):
            raise CryptoError(
                f"signatures x voters length mismatch "
                f"{len(signatures)} x {len(voters)}")
        for sig in signatures:
            if len(sig) != self.SIG_LEN:
                raise CryptoError("bad ed25519 signature length")
        return b"".join(signatures)

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        if not voters:  # match CpuBlsCrypto: an empty QC never verifies
            return False
        if len(agg_sig) != self.SIG_LEN * len(voters):
            return False
        return all(
            self.verify_signature(
                agg_sig[i * self.SIG_LEN:(i + 1) * self.SIG_LEN], hash32, v)
            for i, v in enumerate(voters))

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        """Loop fallback for the batching-frontier interface."""
        return [self.verify_signature(s, h, v)
                for s, h, v in zip(signatures, hashes, voters)]


def default_sim_crypto_class():
    """The best available fast provider for simulations: Ed25519Crypto
    when the optional `cryptography` package is importable, else the
    dependency-free SimHashCrypto (CI installs no `cryptography`; an
    environment without it should lose signature realism, not the whole
    simulation)."""
    import importlib.util

    return (Ed25519Crypto if importlib.util.find_spec("cryptography")
            else SimHashCrypto)


def sim_crypto(seed32: bytes):
    """One simulation-grade provider from a 32-byte seed (see
    default_sim_crypto_class)."""
    return default_sim_crypto_class()(seed32)


class SimHashCrypto:
    """Simulation-grade provider: NOT CRYPTOGRAPHY.  A 'signature' is
    sm3(pubkey || hash) — anyone can forge one, so this proves nothing
    about signatures.  What it buys: microsecond sign/verify with zero
    dependencies, so protocol-behavior simulations (chaos schedules,
    Byzantine timing, 10k-validator floods) measure the ENGINE, not a
    pure-Python pairing — and run in environments without the
    `cryptography` package (CI installs none; Ed25519Crypto raises at
    construction there).  Aggregation is concatenation, mirroring
    Ed25519Crypto's shape so QC plumbing stays exercised."""

    SIG_LEN = 32

    def __init__(self, seed32: bytes):
        self._pk = sm3_hash(b"simhash-pk:" + bytes(seed32))

    @property
    def pub_key(self) -> bytes:
        return self._pk

    def hash(self, data: bytes) -> bytes:
        return sm3_hash(data)

    def sign(self, hash32: bytes) -> bytes:
        return sm3_hash(self._pk + bytes(hash32))

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        return bytes(signature) == sm3_hash(bytes(voter) + bytes(hash32))

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        if len(signatures) != len(voters):
            raise CryptoError(
                f"signatures x voters length mismatch "
                f"{len(signatures)} x {len(voters)}")
        for sig in signatures:
            if len(sig) != self.SIG_LEN:
                raise CryptoError("bad simhash signature length")
        return b"".join(signatures)

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        if not voters:  # match CpuBlsCrypto: an empty QC never verifies
            return False
        if len(agg_sig) != self.SIG_LEN * len(voters):
            return False
        return all(
            self.verify_signature(
                agg_sig[i * self.SIG_LEN:(i + 1) * self.SIG_LEN], hash32, v)
            for i, v in enumerate(voters))

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        return [self.verify_signature(s, h, v)
                for s, h, v in zip(signatures, hashes, voters)]


class SimDeviceCrypto:
    """A simulated device path around any host provider, gated by the
    SAME CircuitBreaker + fault-injection machinery as CudaBlsCrypto.

    The sim fleet's providers (SimHashCrypto / Ed25519Crypto) have no
    accelerator, so the breaker's open → host-fallback → half-open →
    closed cycle — the degraded mode the chaos `device_fault` event
    exercises — never runs in a CPU-only chaos lane.  This wrapper
    routes every verify/aggregate call through a fake "device" whose
    only failure mode is the breaker's injected-fault window; the
    device result is the exact host twin (it IS the base provider), so
    chaos runs exercise the real decision logic (crypto/breaker.py)
    and the real metric surface (crypto_device_failures_total /
    host_fallbacks / breaker_transitions) with zero hardware.

    Signing and hashing stay direct (keys are host-side on the real
    provider too, SURVEY.md §7 hard part (e))."""

    def __init__(self, base, breaker=None, metrics=None):
        from .breaker import CircuitBreaker

        self._base = base
        #: Short cooldown: sim chains commit every tens of ms, so the
        #: half-open probe must come up within a run, not after 5 s.
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=3, cooldown_s=0.25)
        self.metrics = metrics
        #: Optional obs.prof.DeviceProfiler: the simulated device path
        #: records the same staged per-call profiles as CudaBlsCrypto
        #: (here the whole 'device' round-trip is one host call, so the
        #: dispatch stage carries it and occupancy is always 1.0) — CPU
        #: fleets exercise the full profile surface with zero hardware.
        self.prof = None

    def bind_metrics(self, metrics) -> None:
        self.metrics = metrics
        self.breaker.metrics = metrics

    def bind_profiler(self, prof) -> None:
        self.prof = prof

    def degraded_status(self) -> dict:
        """Breaker + fallback state for /statusz ("crypto" section)."""
        return self.breaker.status()

    @property
    def pub_key(self) -> bytes:
        return self._base.pub_key

    def hash(self, data: bytes) -> bytes:
        return self._base.hash(data)

    def sign(self, hash32: bytes) -> bytes:
        return self._base.sign(hash32)

    def _device_call(self, path: str, fn, *args, batch: int = 1):
        """The CudaBlsCrypto dispatch posture in miniature: ask the
        breaker, 'dispatch' (fault-injection window = the device
        failing), report the outcome, fall back to the host oracle —
        which here is the same function, so results are always exact.
        A bound profiler sees the same staged-profile surface as the
        real device path (dispatch = the simulated device call)."""
        if not self.breaker.allow():
            if self.metrics is not None:
                self.metrics.host_fallbacks.labels(path=path).inc()
            return fn(*args)
        try:
            self.breaker.raise_if_injected(path)
        except Exception as e:  # noqa: BLE001 — injected device fault
            self.breaker.record_failure(f"{path}: {type(e).__name__}")
            if self.metrics is not None:
                self.metrics.device_failures.labels(path=path).inc()
                self.metrics.host_fallbacks.labels(path=path).inc()
            if self.prof is not None:
                # The failed device call rings ok=False (no stages ran
                # — the fault hit before dispatch), mirroring the real
                # provider's posture, so chaos post-mortems see the
                # degraded window in the profile ring too.
                self.prof.begin(path, batch).finish(ok=False)
            return fn(*args)
        if self.prof is None:
            result = fn(*args)
            self.breaker.record_success()
            return result
        call = self.prof.begin(path, batch)
        call.pad(batch, batch)  # no pad ladder: the sim batch ships as-is
        t0 = time.perf_counter()
        try:
            result = fn(*args)
        except BaseException:  # a raising call must not ring as ok
            call.observe("dispatch", time.perf_counter() - t0)
            call.finish(ok=False)
            raise
        call.observe("dispatch", time.perf_counter() - t0)
        call.finish()
        self.breaker.record_success()
        return result

    def verify_signature(self, signature: bytes, hash32: bytes,
                         voter: bytes) -> bool:
        return self._device_call("verify_batch", self._base.verify_signature,
                                 signature, hash32, voter)

    def aggregate_signatures(self, signatures: Sequence[bytes],
                             voters: Sequence[bytes]) -> bytes:
        return self._device_call("aggregate", self._base.aggregate_signatures,
                                 signatures, voters, batch=len(signatures))

    def verify_aggregated_signature(self, agg_sig: bytes, hash32: bytes,
                                    voters: Sequence[bytes]) -> bool:
        return self._device_call("verify_aggregated",
                                 self._base.verify_aggregated_signature,
                                 agg_sig, hash32, voters,
                                 batch=len(voters))

    def verify_batch(self, signatures: Sequence[bytes],
                     hashes: Sequence[bytes],
                     voters: Sequence[bytes]) -> List[bool]:
        return self._device_call("verify_batch", self._base.verify_batch,
                                 signatures, hashes, voters,
                                 batch=len(signatures))
