"""Multi-device serving (data-parallel shards)."""
