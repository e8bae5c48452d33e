"""The general parts of the benchmark: the manifest, the host environment,
the spans and the trace reduction, the work counts and the result line."""
