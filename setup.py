"""Package build for consensus_overlord_tpu (used by the Dockerfile and CI;
the C extension in csrc/ is optional — the pure-JAX/Python paths cover every
capability, the extension accelerates host-side crypto)."""

from setuptools import find_packages, setup

setup(
    name="consensus_overlord_tpu",
    version="0.2.0",
    description=("TPU-native BFT consensus framework with the capabilities "
                 "of cita-cloud/consensus_overlord"),
    packages=find_packages(include=["consensus_overlord_tpu",
                                    "consensus_overlord_tpu.*",
                                    "consensus_overlord_tpu_torch",
                                    "consensus_overlord_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[],  # jax/grpcio/protobuf provided by the image/env
)
