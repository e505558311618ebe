"""The harness: cells, traffic, traces, statistics and the yardstick."""
