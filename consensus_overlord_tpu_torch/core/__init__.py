"""Core wire types, RLP codec, SM3 hashing, voter bitmaps (the port's own
copies of consensus_overlord_tpu/core/)."""
