"""Port of ``repro.sharding``."""
