"""Multi-device paths: data-parallel serving shards and the data-parallel
training group."""
