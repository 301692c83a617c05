"""Tools of the port that are not on the render path (probes, benchmarks)."""
