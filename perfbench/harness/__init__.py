"""The harness: finds a cell's files by name, drives the port through the
cell's traffic for a measured window, and reduces stamps, spans,
counters and the profiler's trace to the cell's metrics."""
