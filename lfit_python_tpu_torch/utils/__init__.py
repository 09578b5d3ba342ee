"""Host-side utilities of the port: the input-file reader, chain files
and their ArviZ form, sampler checkpoints, plots, notifications and
profiling hooks."""
